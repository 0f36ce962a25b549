"""The window gap-run scan of the positional engines: wrappers and plain
versions.

Port of kcftools_tpu/engine/device_prefix.py::_scan_core, the per-window
gap-run state machine of Plugins/GetVariants.java:219-273, in the forms
its callers take:

- ``slabs_scan_join``: every slab of one device-join sample from the
  routed join counts (kcftools_tpu/engine/device_join.py::_slab_scan,
  mapped over the slabs by ``_score_sample``): gather through each slab's
  slot map, unsigned presence test, the five statistics and the count
  sums. (S_slab, 6, win_pad) int64.
- ``rows_scan``: the S presence bitmaps of a dprefix group over one slab
  (device_prefix.py::_score_batch). (5, S, win_pad) int64.
- ``runs_scan``: the S absent-run streams of a dprefix group over one
  slab (device_prefix.py::_score_runs), decoded and scanned. (5, S,
  win_pad) int64.

On CUDA tensors each calls the hand-written kernel ``csrc/gapscan.cu``
(bound in ``_kernels.py``) once, through one C entry point whose
launches all run on the current stream; on CPU tensors it takes its
plain version, the torch-op scan (``_scan_core``: cumsum, cummax, flipped
cummin and boundary gathers; all prefix sums int64) and, for the run
streams, the torch-op decode (``_runs_presence``, ``_pack_bits``). A CUDA
tensor never reaches a plain version. Each wrapper's ``.launches``
counts those calls.

Presence lies inside the valid bitmap on every path: the join's presence
test includes it, the native packers (``kcf_pack_posbits``,
``kcf_ordpack``) set no bit outside it and the run decode masks with it.
The kernel masks ``rows_scan``'s rows with it; the plain version reads
them as given, so the two agree on every such input.
"""

import torch

_FIELDS_JOIN = 6
_FIELDS_ROWS = 5
_CHUNK = 1024  # positions per chunk summary of the JOIN mode
_SUM_WORDS = 5  # int64 words per stored chunk summary (40 bytes)
_RUN_SEG = 1024  # run entries per segment of the kernel's run decode


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


def _pack_bits(pr):
    """(S, n) bool -> (S, n/8) uint8 LSB-first bitmaps."""
    weights = torch.tensor([1 << b for b in range(8)], dtype=torch.uint8,
                           device=pr.device)
    b8 = pr.view(pr.shape[0], -1, 8).to(torch.uint8).mul_(weights)
    return b8.sum(-1, dtype=torch.uint8)


def _cs_tot(valid_bits):
    """(n+1,) int64 prefix counts of valid positions, from the packed
    (n/8,) uint8 valid bitmap."""
    bits = _unpack_bits(valid_bits)
    zero = torch.zeros(1, dtype=torch.int64, device=bits.device)
    return torch.cat([zero, torch.cumsum(bits, 0, dtype=torch.int64)])


def _runs_presence(dl, valid):
    """Presence over n positions from ABSENT-RUN payloads (native
    kcf_bits_to_runs encoding: delta u8 from the previous run's end with
    (255, 0) fillers, length u8 with (0, 255) continuations, zero-padded
    with (0, 0)). dl: (..., 2, run_cap) uint8, one payload per row;
    valid: (n,) bool. Returns (..., n) bool.

    Absent stretches are disjoint, so +1 at each run's start, -1 at its
    end and one prefix sum give 1 exactly inside a run. Empty entries
    (fillers and padding) add +1 and -1 at one position and are sent to
    a discarded position n instead, so no position below n takes more
    than one +1 and one -1 and the int8 prefix stays in {0, 1}; starts
    and ends at or past n (a trailing run that ends at n) go there too.
    Positions the encoding trims or skips are invalid and masked by
    ``valid``, so the result is exact. No step waits for the host (no
    boolean-mask indexing), so the scans of several devices overlap."""
    n = valid.shape[0]
    lead = dl.shape[:-2]
    dl = dl.reshape(-1, 2, dl.shape[-1])
    d = dl[:, 0].long()
    ln = dl[:, 1].long()
    ends = torch.cumsum(d + ln, 1)
    starts = ends - ln
    rows = torch.arange(dl.shape[0], device=valid.device)[:, None]
    rows = rows.expand(ends.shape)
    delta = torch.zeros((dl.shape[0], n + 1), dtype=torch.int8,
                        device=valid.device)
    for idx, v in ((starts, 1), (ends, -1)):
        idx = torch.where((ln > 0) & (idx < n), idx, n)
        delta.index_put_(
            (rows, idx), torch.full(idx.shape, v, dtype=torch.int8,
                                    device=idx.device),
            accumulate=True,
        )
    absent = torch.cumsum(delta[:, :n], 1, dtype=torch.int8) > 0
    return (~absent & valid).reshape(*lead, n)


def slab_scan_join_ref(routed_flat, slot_map, valid_bits, w_start, w_hi, *,
                       k: int, min_count: int):
    """One slab of ``slabs_scan_join_ref``: (6, W) int64."""
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


def slabs_scan_join_ref(routed_flat, slot_maps, valid_bits, w_starts, w_his,
                        *, k: int, min_count: int):
    """Plain version of ``slabs_scan_join``: the slabs one at a time."""
    out = torch.empty((slot_maps.shape[0], _FIELDS_JOIN, w_starts.shape[1]),
                      dtype=torch.int64, device=slot_maps.device)
    for si in range(slot_maps.shape[0]):
        out[si] = slab_scan_join_ref(routed_flat, slot_maps[si],
                                     valid_bits[si], w_starts[si], w_his[si],
                                     k=k, min_count=min_count)
    return out


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


def runs_scan_ref(dl, valid_bits, w_start, w_hi, *, k: int):
    """Plain version of ``runs_scan``: the streams decoded for all rows at
    once (``_runs_presence``), packed (``_pack_bits``) and scanned
    (``rows_scan_ref``)."""
    pr = _runs_presence(dl, _unpack_bits(valid_bits))
    return rows_scan_ref(_pack_bits(pr), valid_bits, w_start, w_hi, k=k)


def _check(what, valid_bits, w_start, w_hi, *others, dims=1):
    """Device, dtype, shape, contiguity and alignment of the operands
    (bitmap and bounds of ``dims`` dimensions); returns n (positions)."""
    dev = valid_bits.device
    for t in (valid_bits, w_start, w_hi, *others):
        if t.device != dev:
            raise ValueError(f"{what}: operands on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: contiguous operands")
    for name, t in (("valid_bits", valid_bits), ("w_start", w_start),
                    ("w_hi", w_hi)):
        if t.dim() != dims:
            raise ValueError(f"{what}: {name} must be {dims}-D")
    if valid_bits.dtype != torch.uint8:
        raise TypeError(f"{what}: uint8 valid_bits, got {valid_bits.dtype}")
    if w_start.dtype != torch.int64 or w_hi.dtype != torch.int64:
        raise TypeError(f"{what}: int64 window bounds")
    if w_start.shape != w_hi.shape:
        raise ValueError(f"{what}: w_start and w_hi differ in shape")
    nb = valid_bits.shape[-1]
    if nb % 4:
        raise ValueError(f"{what}: the positions must be a multiple of 32")
    if dev.type == "cuda" and valid_bits.data_ptr() % 4:
        raise ValueError(f"{what}: valid_bits must be 4-byte aligned")
    return 8 * nb


def _on_card(what, dev):
    """True for a CUDA device, False for the CPU (the plain version);
    raises for any other."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {dev}")
    return True


def _scratch(dev, *sizes):
    """int64 scratch tensors of at least one element each."""
    return [torch.empty(max(1, s), dtype=torch.int64, device=dev)
            for s in sizes]


def _rows_scratch(W):
    """int64 words of ``kcf_gapscan_rows``' scratch: the long windows'
    list (W int32) and its two int32 counters."""
    return -(-(W + 2) // 2)


def _runs_scratch(S, n, R, W):
    """int64 words of ``kcf_gapscan_runs``' scratch: the absent bitmaps
    (rows of n/32 uint32 words rounded up to a multiple of 4), an offset
    a row and run segment, a stream end a row, then the ROWS mode's
    scratch."""
    stride = -(-(n // 32) // 4) * 4
    return (S * stride // 2 + S * max(1, -(-R // _RUN_SEG)) + S
            + _rows_scratch(W))


def slabs_scan_join(routed_flat, slot_maps, valid_bits, w_starts, w_his, *,
                    k: int, min_count: int):
    """The per-window stats of every slab of one sample from the routed
    join counts, in one launch.

    routed_flat: (R,) int32 (uint32 count bits); slot_maps: (S, n) int32,
    each slab's routed slot of each position (read where valid);
    valid_bits: (S, n/8) uint8 LSB-first, n a multiple of 32; w_starts,
    w_his: (S, W) int64 inclusive window bounds. Returns (S, 6, W) int64:
    observed, variations, inner, left, right, count_sum."""
    from ._kernels import launch

    what = "slabs_scan_join"
    n = _check(what, valid_bits, w_starts, w_his, routed_flat, slot_maps,
               dims=2)
    if routed_flat.dtype != torch.int32 or routed_flat.dim() != 1:
        raise TypeError(f"{what}: routed_flat must be 1-D int32")
    if slot_maps.dtype != torch.int32 or slot_maps.dim() != 2:
        raise TypeError(f"{what}: slot maps must be 2-D int32")
    if slot_maps.shape[-1] != n:
        raise ValueError(f"{what}: slot maps of {slot_maps.shape[-1]} "
                         f"positions, valid bitmaps of {n}")
    if not (slot_maps.shape[0] == valid_bits.shape[0] == w_starts.shape[0]):
        raise ValueError(f"{what}: slot maps, valid bitmaps and window "
                         "bounds differ in their slab count")
    dev = valid_bits.device
    if not _on_card(what, dev):
        return slabs_scan_join_ref(routed_flat, slot_maps, valid_bits,
                                   w_starts, w_his, k=k, min_count=min_count)
    S, W = slot_maps.shape[0], w_starts.shape[1]
    out = torch.empty((S, _FIELDS_JOIN, W), dtype=torch.int64, device=dev)
    if out.numel() == 0:
        return out
    if slot_maps.data_ptr() % 16:
        raise ValueError(f"{what}: slot maps must be 16-byte aligned")
    presence, wsum, chunks = _scratch(dev, S * n // 64, S * n // 32,
                                      S * -(-n // _CHUNK) * _SUM_WORDS)
    launch("kcf_gapscan_join", routed_flat, routed_flat.numel(), slot_maps,
           valid_bits, w_starts, w_his, presence, wsum, chunks, out, n, S, W,
           int(k), int(min_count))
    slabs_scan_join.launches += 1
    return out


def rows_scan(presence, valid_bits, w_start, w_hi, *, k: int):
    """The window stats of S presence rows over one slab.

    presence: (S, n/8) uint8 LSB-first bitmaps, inside the valid bitmap;
    valid_bits: (n/8,) uint8, n a multiple of 32; w_start, w_hi: (W,)
    int64 inclusive window bounds. Returns (5, S, W) int64: observed,
    variations, inner, left, right."""
    from ._kernels import launch

    n = _check("rows_scan", valid_bits, w_start, w_hi, presence)
    if presence.dtype != torch.uint8 or presence.dim() != 2:
        raise TypeError("rows_scan: presence must be (S, n/8) uint8")
    if presence.shape[1] != valid_bits.numel():
        raise ValueError(f"rows_scan: presence rows of {presence.shape[1]} "
                         f"bytes, valid bitmap of {valid_bits.numel()}")
    dev = valid_bits.device
    if not _on_card("rows_scan", dev):
        return rows_scan_ref(presence, valid_bits, w_start, w_hi, k=k)
    if presence.data_ptr() % 4:
        raise ValueError("rows_scan: presence must be 4-byte aligned")
    S, W = presence.shape[0], w_start.numel()
    out = torch.empty((_FIELDS_ROWS, S, W), dtype=torch.int64, device=dev)
    if out.numel() == 0:
        return out
    (scratch,) = _scratch(dev, _rows_scratch(W))
    launch("kcf_gapscan_rows", presence, valid_bits, w_start, w_hi, scratch,
           out, n, S, W, int(k))
    rows_scan.launches += 1
    return out


def runs_scan(dl, valid_bits, w_start, w_hi, *, k: int):
    """The window stats of S rows over one slab from their absent-run
    streams.

    dl: (S, 2, run_cap) uint8 in the native ``kcf_bits_to_runs``
    encoding (see ``_runs_presence``); valid_bits: (n/8,) uint8, n a
    multiple of 32; w_start, w_hi: (W,) int64 inclusive window bounds.
    Returns (5, S, W) int64: observed, variations, inner, left, right.
    On the card one call decodes the streams into absent bitmaps (no
    torch op touches the S x n rows) and scans them."""
    from ._kernels import launch

    n = _check("runs_scan", valid_bits, w_start, w_hi, dl)
    if dl.dtype != torch.uint8 or dl.dim() != 3 or dl.shape[1] != 2:
        raise TypeError("runs_scan: dl must be (S, 2, run_cap) uint8")
    dev = valid_bits.device
    if not _on_card("runs_scan", dev):
        return runs_scan_ref(dl, valid_bits, w_start, w_hi, k=k)
    S, R, W = dl.shape[0], dl.shape[2], w_start.numel()
    out = torch.empty((_FIELDS_ROWS, S, W), dtype=torch.int64, device=dev)
    if out.numel() == 0:
        return out
    (scratch,) = _scratch(dev, _runs_scratch(S, n, R, W))
    launch("kcf_gapscan_runs", dl, R, valid_bits, w_start, w_hi, scratch,
           out, n, S, W, int(k))
    runs_scan.launches += 1
    return out


slabs_scan_join.launches = 0
rows_scan.launches = 0
runs_scan.launches = 0
