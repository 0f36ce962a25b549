"""The window gap-run scan of the positional engines: wrappers and plain
versions.

Port of kcftools_tpu/engine/device_prefix.py::_scan_core, the per-window
gap-run state machine of Plugins/GetVariants.java:219-273, in the two
forms its callers take:

- ``slab_scan_join``: one slab of the device-join engine from the routed
  join counts (kcftools_tpu/engine/device_join.py::_slab_scan): gather
  through the slot map, unsigned presence test, the five statistics and
  the count sums. (6, win_pad) int64.
- ``rows_scan``: the S presence rows of a dprefix group over one slab
  (device_prefix.py::_score_batch / _score_runs, vmapped there). (5, S,
  win_pad) int64.

On CUDA tensors each launches the hand-written kernel ``csrc/gapscan.cu``
(bound in ``_kernels.py``): chunk summaries, then one warp per window; on
CPU tensors it takes its plain version, which is the torch-op scan the
port ran before (``_scan_core``: cumsum, cummax, flipped cummin and
boundary gathers; all prefix sums int64). A CUDA tensor never reaches the
plain version. ``slab_scan_join.launches`` and ``rows_scan.launches``
count the kernel's launches.

Presence lies inside the valid bitmap on every path: the join's presence
test includes it, the native packers (``kcf_pack_posbits``,
``kcf_ordpack``) set no bit outside it and the run decode masks with it.
The kernel masks ``rows_scan``'s rows with it; the plain version reads
them as given, so the two agree on every such input.
"""

import torch

_FIELDS_JOIN = 6
_FIELDS_ROWS = 5
_CHUNK = 1024  # positions per chunk summary of the kernel
_SUM_WORDS = 5  # int64 words per stored chunk summary (40 bytes)


def _cummin_rev(x):
    return torch.flip(torch.cummin(torch.flip(x, [0]), 0).values, [0])


def _scan_core(pr, cs_tot, w_start, w_hi, *, k: int):
    """One sample's window statistics from per-position presence.

    pr: (n,) bool presence over k-mer start positions; cs_tot: (n+1,)
    int64 prefix counts of valid k-mers; w_start / w_hi: (win_pad,)
    int64 first / last k-mer start of each window (inclusive, slab
    coordinates). Returns (5, win_pad) int64 rows: observed,
    variations, inner, left, right.
    """
    n = pr.shape[0]
    dev = pr.device
    vidx = cs_tot[1:] - 1  # valid ordinal at each position (where valid)
    pos = torch.arange(n, device=dev)
    s = w_start
    hi = w_hi
    total = cs_tot[hi + 1] - cs_tot[s]
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    minus1 = torch.full((1,), -1, dtype=torch.int64, device=dev)

    pres_ord = torch.where(pr, vidx, -1)
    prev_ord = torch.cummax(torch.cat([minus1, pres_ord[:-1]]), 0).values
    next_ge = _cummin_rev(torch.where(pr, pos, n))
    last_le = torch.cummax(torch.where(pr, pos, -1), 0).values

    cs_obs = torch.cat([zero, torch.cumsum(pr, 0, dtype=torch.int64)])
    gap = vidx - prev_ord - 1
    closed = pr & (prev_ord >= 0) & (gap > 0)
    d = gap - (k - 1)
    dist = torch.where(d > 0, d, torch.abs(d + 1))
    cs_var = torch.cat([zero, torch.cumsum(closed, 0, dtype=torch.int64)])
    cs_dist = torch.cat([zero, torch.cumsum(torch.where(closed, dist, 0), 0)])

    observed = cs_obs[hi + 1] - cs_obs[s]
    has = observed > 0
    fp = torch.clamp(next_ge[s], 0, n - 1)
    lp = torch.clamp(last_le[hi], 0, n - 1)
    left = torch.where(has, cs_tot[fp] - cs_tot[s], 0)
    right = torch.where(has, cs_tot[hi + 1] - cs_tot[lp + 1], total)
    inner = torch.where(has, cs_dist[hi + 1] - cs_dist[fp + 1], 0)
    var_int = torch.where(has, cs_var[hi + 1] - cs_var[fp + 1], 0)
    variations = torch.where(
        has,
        var_int + (left > 0).long() + (right > 0).long(),
        (total > 0).long(),
    )
    return torch.stack([observed, variations, inner, left, right])


def _unpack_bits(b8):
    """(n/8,) uint8 LSB-first bitmap -> (n,) bool."""
    shifts = torch.arange(8, dtype=torch.int32, device=b8.device)
    return ((b8.int()[:, None] >> shifts) & 1).reshape(-1) != 0


def _cs_tot(valid_bits):
    """(n+1,) int64 prefix counts of valid positions, from the packed
    (n/8,) uint8 valid bitmap."""
    bits = _unpack_bits(valid_bits)
    zero = torch.zeros(1, dtype=torch.int64, device=bits.device)
    return torch.cat([zero, torch.cumsum(bits, 0, dtype=torch.int64)])


def slab_scan_join_ref(routed_flat, slot_map, valid_bits, w_start, w_hi, *,
                       k: int, min_count: int):
    """Plain version of ``slab_scan_join``."""
    valid = _unpack_bits(valid_bits)
    zero = torch.zeros(1, dtype=torch.int64, device=valid.device)
    cs_tot = torch.cat([zero, torch.cumsum(valid, 0, dtype=torch.int64)])
    # the counts are uint32 bit patterns: compare them unsigned
    cnts = routed_flat.index_select(0, slot_map).long() & 0xFFFFFFFF
    pr = (cnts >= min_count) & valid
    five = _scan_core(pr, cs_tot, w_start, w_hi, k=k)
    csq = torch.cat([zero, torch.cumsum(torch.where(pr, cnts, 0), 0)])
    count_sum = csq[w_hi + 1] - csq[w_start]
    return torch.cat([five, count_sum[None, :]], dim=0)


def rows_scan_ref(presence, valid_bits, w_start, w_hi, *, k: int):
    """Plain version of ``rows_scan``: the rows scanned one at a time (a
    row's scan holds about a dozen slab-sized int64 temporaries)."""
    cs_tot = _cs_tot(valid_bits)
    out = torch.empty((_FIELDS_ROWS, presence.shape[0], w_start.shape[0]),
                      dtype=torch.int64, device=presence.device)
    for r in range(presence.shape[0]):
        out[:, r] = _scan_core(_unpack_bits(presence[r]), cs_tot, w_start,
                               w_hi, k=k)
    return out


def _check(what, valid_bits, w_start, w_hi, *others):
    """Device, dtype, shape, contiguity and alignment of the operands;
    returns n (positions)."""
    dev = valid_bits.device
    for t in (valid_bits, w_start, w_hi, *others):
        if t.device != dev:
            raise ValueError(f"{what}: operands on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: contiguous operands")
    for name, t in (("valid_bits", valid_bits), ("w_start", w_start),
                    ("w_hi", w_hi)):
        if t.dim() != 1:
            raise ValueError(f"{what}: {name} must be 1-D")
    if valid_bits.dtype != torch.uint8:
        raise TypeError(f"{what}: uint8 valid_bits, got {valid_bits.dtype}")
    if w_start.dtype != torch.int64 or w_hi.dtype != torch.int64:
        raise TypeError(f"{what}: int64 window bounds")
    if w_start.shape != w_hi.shape:
        raise ValueError(f"{what}: w_start and w_hi differ in shape")
    if valid_bits.numel() % 4:
        raise ValueError(f"{what}: the positions must be a multiple of 32")
    if dev.type == "cuda" and valid_bits.data_ptr() % 4:
        raise ValueError(f"{what}: valid_bits must be 4-byte aligned")
    return 8 * valid_bits.numel()


def _launch(wrapper, presence, routed, slot_map, valid_bits, w_start, w_hi,
            n, S, fields, k, min_count):
    """The kernel's output for the wrapper; counts the launch."""
    from ._kernels import launch_gapscan

    dev = valid_bits.device
    out = torch.empty((fields, S, w_start.numel()), dtype=torch.int64,
                      device=dev)
    if out.numel() == 0:
        return out
    chunks = torch.empty(max(1, S * (-(-n // _CHUNK)) * _SUM_WORDS),
                         dtype=torch.int64, device=dev)
    launch_gapscan(presence, routed, slot_map, valid_bits, w_start, w_hi,
                   chunks, out, n, S, int(k), int(min_count))
    wrapper.launches += 1
    return out


def slab_scan_join(routed_flat, slot_map, valid_bits, w_start, w_hi, *,
                   k: int, min_count: int):
    """One slab's per-window stats from the routed join counts.

    routed_flat: (R,) int32 (uint32 count bits); slot_map: (n,) int32,
    the routed slot of each position (read where valid); valid_bits:
    (n/8,) uint8 LSB-first, n a multiple of 32; w_start, w_hi: (W,)
    int64 inclusive window bounds. Returns (6, W) int64: observed,
    variations, inner, left, right, count_sum."""
    n = _check("slab_scan_join", valid_bits, w_start, w_hi, routed_flat,
               slot_map)
    for name, t in (("routed_flat", routed_flat), ("slot_map", slot_map)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"slab_scan_join: {name} must be 1-D int32")
    if slot_map.numel() != n:
        raise ValueError(f"slab_scan_join: slot_map has {slot_map.numel()} "
                         f"positions, the valid bitmap {n}")
    dev = valid_bits.device
    if dev.type == "cpu":
        return slab_scan_join_ref(routed_flat, slot_map, valid_bits, w_start,
                                  w_hi, k=k, min_count=min_count)
    if dev.type != "cuda":
        raise RuntimeError(f"slab_scan_join: no kernel for device {dev}")
    return _launch(slab_scan_join, None, routed_flat, slot_map, valid_bits,
                   w_start, w_hi, n, 1, _FIELDS_JOIN, k, min_count)[:, 0]


def rows_scan(presence, valid_bits, w_start, w_hi, *, k: int):
    """The window stats of S presence rows over one slab.

    presence: (S, n/8) uint8 LSB-first bitmaps, inside the valid bitmap;
    valid_bits: (n/8,) uint8, n a multiple of 32; w_start, w_hi: (W,)
    int64 inclusive window bounds. Returns (5, S, W) int64: observed,
    variations, inner, left, right."""
    n = _check("rows_scan", valid_bits, w_start, w_hi, presence)
    if presence.dtype != torch.uint8 or presence.dim() != 2:
        raise TypeError("rows_scan: presence must be (S, n/8) uint8")
    if presence.shape[1] != valid_bits.numel():
        raise ValueError(f"rows_scan: presence rows of {presence.shape[1]} "
                         f"bytes, valid bitmap of {valid_bits.numel()}")
    dev = valid_bits.device
    if dev.type == "cpu":
        return rows_scan_ref(presence, valid_bits, w_start, w_hi, k=k)
    if dev.type != "cuda":
        raise RuntimeError(f"rows_scan: no kernel for device {dev}")
    if presence.data_ptr() % 4:
        raise ValueError("rows_scan: presence must be 4-byte aligned")
    return _launch(rows_scan, presence, None, None, valid_bits, w_start,
                   w_hi, n, presence.shape[0], _FIELDS_ROWS, k, 0)


slab_scan_join.launches = 0
rows_scan.launches = 0
