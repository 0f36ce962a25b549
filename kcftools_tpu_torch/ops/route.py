"""The device join's reference routing on the scorer's device.

From the sorted unique reference k-mers, ``route_reference`` builds the
(P, Tq) quantile query tiles of the join (``pjoin_join``) and the routed
slot of each key; from the slabs' reference ordinals, ``route_slabs``
builds the window scan's slot maps and valid bitmaps
(``slabs_scan_join``). Bit for bit they equal the host numpy they
replace: ``ops/pjoin.py::tile_sorted`` (which stays, as the tests'
reference and the native packer's fallback) and the slot map
``slot_of_ord[r_idx]`` with ``np.packbits(r_idx >= 0,
bitorder="little")``.

On CUDA tensors each launches the hand-written kernels of
``csrc/route.cu`` (bound in ``_kernels.py``); on CPU tensors it takes
its plain torch version. A CUDA tensor never reaches a plain version.
Each wrapper's ``.launches`` counts its calls on the card.

Keys travel as int64 tensors holding the uint64 bits. torch on the CPU
has no uint64 shifts, so the plain version takes the partition id's top
32 bits with masked shifts, and halves the quantile function F before
its top bits are taken, so that no int64 step overflows.
"""

import torch

from .pjoin import LANE, round_up


def _check_keys(keys, k, b):
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise TypeError("route_reference: keys must be 1-D int64 (uint64 "
                        "bits)")
    if not keys.is_contiguous():
        raise ValueError("route_reference: contiguous keys")
    if not 1 <= k <= 32:
        raise ValueError(f"route_reference: k = {k} outside 1..32")
    if not 0 <= b <= 30:
        raise ValueError(f"route_reference: b = {b} outside 0..30")


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


def route_reference_ref(keys, k, b):
    """Plain version of ``route_reference``: the bincount, cumsum and
    scatter of ``tile_sorted`` in torch ops."""
    n = keys.shape[0]
    P = 1 << b
    part = partition_ids(keys, k, b)
    per = torch.bincount(part, minlength=P)
    mx = int(per.max()) if n else 0
    Tq = max(LANE, round_up(mx, LANE))
    _check_slots(P, Tq)
    start = torch.cumsum(per, 0) - per
    slot = part * Tq + (torch.arange(n, device=keys.device) - start[part])
    n_lo = k - min(k, 16)
    qh = torch.zeros(P * Tq, dtype=torch.int32, device=keys.device)
    ql = torch.zeros_like(qh)
    qh[slot] = _i32_bits((keys >> (2 * n_lo)) & 0xFFFFFFFF)
    ql[slot] = _i32_bits(keys & ((1 << (2 * n_lo)) - 1))
    return qh.view(P, Tq), ql.view(P, Tq), slot.to(torch.int32)


def _check_slots(P, Tq):
    if P * Tq >= 1 << 31:
        raise ValueError(f"route_reference: P * Tq = {P} * {Tq} slots do "
                         "not fit int32 slot maps (and the join)")


def route_reference(keys, k, b):
    """The join's query tiles of the sorted unique reference k-mers.

    keys: (n,) int64 holding the sorted uint64 keys' bits; k <= 32;
    P = 2^b partitions. Returns (qh, ql, slot_of_ord): (P, Tq) int32 tiles
    of each key's hi / lo bits at slot p * Tq + rank (zeros elsewhere),
    Tq = max(128, the largest partition rounded up to 128), and (n,) int32
    slot of each key, all on the keys' device. The card reads one scalar
    back (the largest partition) between its two launches."""
    _check_keys(keys, k, b)
    dev = keys.device
    if dev.type == "cpu":
        return route_reference_ref(keys, k, b)
    if dev.type != "cuda":
        raise RuntimeError(f"route_reference: no kernel for device {dev}")
    from ._kernels import launch

    n, P = keys.shape[0], 1 << b
    start = torch.empty(P + 1, dtype=torch.int64, device=dev)
    width = torch.empty(1, dtype=torch.int64, device=dev)
    launch("kcf_route_starts", keys, n, k, b, start, width)
    Tq = max(LANE, round_up(int(width.item()), LANE))
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


route_reference.launches = 0
route_slabs.launches = 0
