"""The device join's reference routing and sample tiling on the scorer's
device.

From the sorted unique reference k-mers, ``route_reference`` builds the
(P, Tq) quantile query tiles of the join (``pjoin_join``) and the routed
slot of each key; from the slabs' reference ordinals, ``route_slabs``
builds the window scan's slot maps and valid bitmaps
(``slabs_scan_join``); from a sample's sorted unique keys and counts,
``tile_sample`` builds the join's (P, Tt) table operand. Bit for bit they
equal the host code they replace: ``ops/pjoin.py::tile_sorted`` (which
stays, as the tests' reference and the mesh's packer's fallback), the
slot map ``slot_of_ord[r_idx]`` with ``np.packbits(r_idx >= 0,
bitorder="little")``, and the native packer's flat [hi | lo | counts]
buffer (``kcf_pjoin_pack``; ``tile_sorted`` + ``pack_planar``).

On CUDA tensors each launches the hand-written kernels of
``csrc/route.cu`` (bound in ``_kernels.py``); on CPU tensors it takes
its plain torch version. A CUDA tensor never reaches a plain version.
Each wrapper's ``.launches`` counts its calls on the card.

Keys travel as int64 tensors holding the uint64 bits, counts as int32
tensors holding the uint32 bits. torch on the CPU has no uint64 shifts,
so the plain version takes the partition id's top 32 bits with masked
shifts, and halves the quantile function F before its top bits are
taken, so that no int64 step overflows.
"""

import torch

from .pjoin import LANE, round_up


def _check_keys(keys, k, b, who="route_reference"):
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise TypeError(f"{who}: keys must be 1-D int64 (uint64 bits)")
    if not keys.is_contiguous():
        raise ValueError(f"{who}: contiguous keys")
    if not 1 <= k <= 32:
        raise ValueError(f"{who}: k = {k} outside 1..32")
    if not 0 <= b <= 30:
        raise ValueError(f"{who}: b = {b} outside 0..30")


def _i32_bits(x):
    """int64 values in [0, 2^32) as an int32 tensor with the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def partition_ids(keys, k, b):
    """``ops/pjoin.py::quantile_partition_ids`` of int64-held uint64 keys,
    in int64 arithmetic that never overflows: x = the key's top 32 of 2k
    bits, F >> 1 = x * 2^31 - ceil(floor(x^2 / 2) / 2) (< 2^62), the id
    F >> (63 - b) = (F >> 1) >> (62 - b), clamped to 2^b - 1."""
    if 2 * k >= 32:
        x = (keys >> (2 * k - 32)) & 0xFFFFFFFF
    else:
        x = (keys << (32 - 2 * k)) & 0xFFFFFFFF
    a, c = x >> 16, x & 0xFFFF
    h = ((a * a) << 31) + ((a * c) << 16) + ((c * c) >> 1)  # x*x >> 1
    half = (x << 31) - ((h + 1) >> 1)
    return torch.clamp(half >> (62 - b), max=(1 << b) - 1)


def _ranks(keys, k, b):
    """Each sorted key's partition and rank in it, and the most keys in
    any partition: the bincount and cumsum of ``tile_sorted``."""
    part = partition_ids(keys, k, b)
    per = torch.bincount(part, minlength=1 << b)
    start = torch.cumsum(per, 0) - per
    rank = torch.arange(keys.shape[0], device=keys.device) - start[part]
    return part, rank, int(per.max())


def _halves(keys, k, slot, size):
    """(size,) int32 planes of each key's hi and lo bits
    (``split_hi_lo``) at its slot, zeros elsewhere."""
    n_lo = k - min(k, 16)
    hi = torch.zeros(size, dtype=torch.int32, device=keys.device)
    lo = torch.zeros_like(hi)
    hi[slot] = _i32_bits((keys >> (2 * n_lo)) & 0xFFFFFFFF)
    lo[slot] = _i32_bits(keys & ((1 << (2 * n_lo)) - 1))
    return hi, lo


def route_reference_ref(keys, k, b):
    """Plain version of ``route_reference``: the bincount, cumsum and
    scatter of ``tile_sorted`` in torch ops."""
    P = 1 << b
    part, rank, mx = _ranks(keys, k, b)
    Tq = max(LANE, round_up(mx, LANE))
    _check_slots(P, Tq)
    slot = part * Tq + rank
    qh, ql = _halves(keys, k, slot, P * Tq)
    return qh.view(P, Tq), ql.view(P, Tq), slot.to(torch.int32)


def _check_slots(P, T, who="route_reference"):
    if P * T >= 1 << 31:
        raise ValueError(f"{who}: P * T = {P} * {T} slots do not fit int32 "
                         "slot maps (and the join)")


def _starts(keys, counts, k, b):
    """The card's partition starts of sorted keys and the two numbers
    read back: (start, (the largest partition, the largest count)), the
    count 0 where ``counts`` is None."""
    from ._kernels import launch

    start = torch.empty((1 << b) + 1, dtype=torch.int64, device=keys.device)
    maxima = torch.empty(2, dtype=torch.int64, device=keys.device)
    launch("kcf_route_starts", keys, keys.shape[0], counts, k, b, start,
           maxima)
    return start, maxima.tolist()


def route_reference(keys, k, b):
    """The join's query tiles of the sorted unique reference k-mers.

    keys: (n,) int64 holding the sorted uint64 keys' bits; k <= 32;
    P = 2^b partitions. Returns (qh, ql, slot_of_ord): (P, Tq) int32 tiles
    of each key's hi / lo bits at slot p * Tq + rank (zeros elsewhere),
    Tq = max(128, the largest partition rounded up to 128), and (n,) int32
    slot of each key, all on the keys' device. The card reads the largest
    partition back between its two launches."""
    _check_keys(keys, k, b)
    dev = keys.device
    if dev.type == "cpu":
        return route_reference_ref(keys, k, b)
    if dev.type != "cuda":
        raise RuntimeError(f"route_reference: no kernel for device {dev}")
    from ._kernels import launch

    n, P = keys.shape[0], 1 << b
    start, (width, _) = _starts(keys, None, k, b)
    Tq = max(LANE, round_up(width, LANE))
    _check_slots(P, Tq)
    qh = torch.empty((P, Tq), dtype=torch.int32, device=dev)
    ql = torch.empty_like(qh)
    slot_of_ord = torch.empty(n, dtype=torch.int32, device=dev)
    launch("kcf_route_tiles", keys, n, k, b, start, Tq, qh, ql, slot_of_ord)
    route_reference.launches += 1
    return qh, ql, slot_of_ord


def route_slabs_ref(r_idx, slot_of_ord):
    """Plain version of ``route_slabs``."""
    from .gapscan import _pack_bits

    live = r_idx >= 0
    slot_maps = torch.zeros_like(r_idx)
    slot_maps[live] = slot_of_ord[r_idx[live].long()]
    return slot_maps, _pack_bits(live)


def route_slabs(r_idx, slot_of_ord):
    """The window scan's statics of stacked slabs.

    r_idx: (S, n) int32 reference ordinal of each position (-1: no valid
    k-mer starts there), n a multiple of 32; slot_of_ord: (n_ref,) int32
    from ``route_reference``, on the same device. Returns (slot_maps,
    valid_bits): (S, n) int32 slot of each live position (0 elsewhere)
    and (S, n/8) uint8 LSB-first bitmaps of the live positions."""
    if r_idx.dtype != torch.int32 or r_idx.dim() != 2:
        raise TypeError("route_slabs: r_idx must be 2-D int32")
    if slot_of_ord.dtype != torch.int32 or slot_of_ord.dim() != 1:
        raise TypeError("route_slabs: slot_of_ord must be 1-D int32")
    if r_idx.device != slot_of_ord.device:
        raise ValueError("route_slabs: operands on different devices")
    if not (r_idx.is_contiguous() and slot_of_ord.is_contiguous()):
        raise ValueError("route_slabs: contiguous operands")
    S, n = r_idx.shape
    if n % 32:
        raise ValueError(f"route_slabs: {n} positions, not a multiple of 32")
    dev = r_idx.device
    if S * n == 0:
        return (torch.empty_like(r_idx),
                torch.empty((S, n // 8), dtype=torch.uint8, device=dev))
    if dev.type == "cpu":
        return route_slabs_ref(r_idx, slot_of_ord)
    if dev.type != "cuda":
        raise RuntimeError(f"route_slabs: no kernel for device {dev}")
    from ._kernels import launch

    slot_maps = torch.empty_like(r_idx)
    valid_bits = torch.empty((S, n // 8), dtype=torch.uint8, device=dev)
    launch("kcf_route_slabs", r_idx, S * n, slot_of_ord, slot_maps,
           valid_bits)
    route_slabs.launches += 1
    return slot_maps, valid_bits


def sample_tile(need, tile=None):
    """The table width Tt of a sample whose largest partition holds
    ``need`` keys, given the width ``tile`` an earlier sample of the run
    took (None: the first): that width while the sample fits it, else
    ``need`` and 64 of headroom rounded up to 128, so that later samples
    of about the same size keep one shape."""
    if tile is not None and need <= tile:
        return tile
    return round_up(need + 64, LANE)


def tile_sample_ref(keys, counts, k, b, tile=None):
    """Plain version of ``tile_sample``: ``tile_sorted`` and
    ``pack_planar`` in torch ops."""
    P = 1 << b
    part, rank, width = _ranks(keys, k, b)
    cnt = counts.long() & 0xFFFFFFFF
    packed = int(cnt.max()) <= 0xFF if cnt.numel() else True
    Tt = sample_tile(width, tile)
    _check_slots(P, Tt, "tile_sample")
    slot = part * Tt + rank
    hi, lo = _halves(keys, k, slot, P * Tt)
    if packed:
        W = Tt // 4
        words = torch.zeros(P * W, dtype=torch.int64, device=keys.device)
        words.index_add_(0, part * W + rank % W, cnt << (8 * (rank // W)))
        c = _i32_bits(words)
    else:
        c = torch.zeros(P * Tt, dtype=torch.int32, device=keys.device)
        c[slot] = counts
    return torch.cat([hi, lo, c]), Tt, packed


def tile_sample(keys, counts, k, b, tile=None):
    """A sample's table operand of the join, on the keys' device.

    keys: (n,) int64 holding the sample's sorted unique uint64 keys;
    counts: (n,) int32 holding their uint32 counts; k <= 32; P = 2^b
    partitions; tile: the table width an earlier sample took (None: the
    first). Returns (buf, Tt, packed): buf the flat int32 [hi | lo |
    counts] buffer of (P, Tt) planes, each key's halves at slot
    p * Tt + rank and zeros elsewhere, Tt = ``sample_tile`` of the largest
    partition; packed where every count is <= 255, the counts plane then
    (P, Tt / 4) words in ``pack_planar``'s layout. The card reads two
    numbers back (the largest partition and the largest count) between
    its two launches."""
    _check_keys(keys, k, b, "tile_sample")
    if counts.dtype != torch.int32 or counts.shape != keys.shape:
        raise TypeError("tile_sample: counts must be int32 (uint32 bits), "
                        "one a key")
    if counts.device != keys.device or not counts.is_contiguous():
        raise ValueError("tile_sample: contiguous counts on the keys' "
                         "device")
    dev = keys.device
    if dev.type == "cpu":
        return tile_sample_ref(keys, counts, k, b, tile)
    if dev.type != "cuda":
        raise RuntimeError(f"tile_sample: no kernel for device {dev}")
    from ._kernels import launch

    P = 1 << b
    start, (width, top) = _starts(keys, counts, k, b)
    Tt = sample_tile(width, tile)
    _check_slots(P, Tt, "tile_sample")
    packed = top <= 0xFF
    nt = P * Tt
    buf = torch.empty(2 * nt + (nt // 4 if packed else nt),
                      dtype=torch.int32, device=dev)
    launch("kcf_sample_tiles", keys, counts, start, k, b, Tt, int(packed),
           buf)
    tile_sample.launches += 1
    return buf, Tt, packed


route_reference.launches = 0
route_slabs.launches = 0
tile_sample.launches = 0
