"""Partitioned all-pairs k-mer join: host tiling and the join wrapper.

Port of kcftools_tpu/ops/pjoin.py. Keys are split into (hi, lo) 32-bit
halves and both the reference's query keys and the sample's table keys
are cut into P partitions of fixed-width tiles, so that the join is,
for every partition p and query slot q,

    out[p, q] = sum_t [qh[p,q] == th[p,t] and ql[p,q] == tl[p,t]] * tc[p,t]

- the exact count of the query's key in its partition's table tile, or
0 (keys are unique, so at most one real slot matches; padding slots are
key (0, 0) with count 0).

Here the join is one hand-written CUDA kernel for both count layouts
(``csrc/pjoin.cu``, bound in ``_kernels.py``) and ``pjoin_join_ref``, its
plain torch version. ``pjoin_join`` takes the plain version only for
CPU tensors; on CUDA tensors it launches the kernel or raises.

The uint32 data travels as int32 tensors holding the same bits (torch
has no full uint32 arithmetic): equality does not depend on sign, and
a planar byte unpacks as ``(w >> 8b) & 0xFF`` - the mask undoes the sign
extension of the arithmetic shift. The output is the uint32 sum's bit
pattern in an int32 tensor; read it as ``out.long() & 0xFFFFFFFF``.

The numpy host helpers (``quantile_partition_ids``, ``tile_sorted``,
``build_pjoin_table``, ``route_queries``) are copies of the JAX
module's, which cannot be imported without jax. One difference:
``quantile_partition_ids`` clamps to P-1 the key whose top 32 bits are
all set (the k=32 palindrome T^16A^16, or any such key of a forward-only
database), which the JAX function sends one past the last partition.
"""

import numpy as np
import torch

from .._host import Logger, bucket_hashes_np, sort_pairs, split_hi_lo

_CLASS = "PJoin"

DEFAULT_TILE = 512
_LANE = 128

# plain version: elements of the (B, Tq, Tt) match mask per partition block
_REF_BLOCK_ELEMS = 1 << 24


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _next_pow2(x):
    n = 1
    while n < x:
        n <<= 1
    return n


def partition_of(hi, lo, P):
    """Partition id of each (hi, lo) key for the hashed table layout:
    the two-choice table's first bucket hash masked to P."""
    h1, _ = bucket_hashes_np(hi, lo, P)
    return h1


class PJoinTable:
    """Host-layout partitioned table: (P, T_t) uint32 hi / lo / cnt."""

    def __init__(self, th, tl, tc, k, n_keys, both_strands=True):
        self.th = th
        self.tl = tl
        self.tc = tc
        self.k = k
        self.n_keys = n_keys
        self.P = th.shape[0]
        self.tile = th.shape[1]
        self.both_strands = both_strands

    @property
    def nbytes(self):
        return self.th.nbytes + self.tl.nbytes + self.tc.nbytes


def build_pjoin_table(keys_u64, counts, k, tile=DEFAULT_TILE,
                      fill=0.65, both_strands=True):
    """Hashed partition + pad. Grows the tile if any partition
    overflows (rare at the default fill)."""
    keys_u64 = np.asarray(keys_u64, np.uint64)
    counts = np.ascontiguousarray(counts, np.uint32)
    n = keys_u64.shape[0]
    hi, lo = split_hi_lo(keys_u64, k)
    P = max(1, _next_pow2(int(np.ceil(n / (tile * fill)))))
    while True:
        part = partition_of(hi, lo, P)
        per = np.bincount(part, minlength=P)
        mx = int(per.max()) if n else 0
        if mx <= tile:
            break
        tile = _round_up(mx, _LANE)
    th = np.zeros((P, tile), np.uint32)
    tl = np.zeros((P, tile), np.uint32)
    tc = np.zeros((P, tile), np.uint32)
    if n:
        order = np.argsort(part, kind="stable")
        ps = part[order]
        rank = np.arange(n) - np.concatenate(([0], np.cumsum(per)))[ps]
        th[ps, rank] = hi[order]
        tl[ps, rank] = lo[order]
        tc[ps, rank] = counts[order]
    tbl = PJoinTable(th, tl, tc, k, n, both_strands)
    Logger.info(
        _CLASS,
        f"Built pjoin table: {n} keys, {P} partitions x {tile} "
        f"({n / max(1, P * tile):.2f} fill, {tbl.nbytes / 1e6:.1f} MB)",
    )
    return tbl


def route_queries(kmers_u64, k, P, tile=None):
    """Group a query batch by hashed partition: (q_hi, q_lo) (P, T_q)
    uint32 tiles + src (P, T_q) int32 source indices (-1 = padding)."""
    kmers_u64 = np.asarray(kmers_u64, np.uint64)
    n = kmers_u64.shape[0]
    hi, lo = split_hi_lo(kmers_u64, k)
    part = partition_of(hi, lo, P)
    per = np.bincount(part, minlength=P)
    mx = int(per.max()) if n else 0
    if tile is None:
        tile = max(_LANE, _next_pow2(mx))
    elif mx > tile:
        raise ValueError(f"query tile {tile} < max partition {mx}")
    comp = (part.astype(np.uint64) << np.uint64(32)) | np.arange(
        n, dtype=np.uint64
    )
    comp_s, _ = sort_pairs(comp, np.empty(n, np.uint32))
    order = (comp_s & np.uint64(0xFFFFFFFF)).astype(np.int64)
    ps = (comp_s >> np.uint64(32)).astype(np.int64)
    rank = np.arange(n) - np.concatenate(([0], np.cumsum(per)))[ps]
    qh = np.zeros((P, tile), np.uint32)
    ql = np.zeros((P, tile), np.uint32)
    src = np.full((P, tile), -1, np.int32)
    qh[ps, rank] = hi[order]
    ql[ps, rank] = lo[order]
    src[ps, rank] = order.astype(np.int32)
    return qh, ql, src


def raw_quantile_ids(keys_u64, b, k):
    """The quantile partition function before the clamp: top b bits of
    F'(x) = (x << 32) - (x*x >> 1), x = the key's top 32 bits. Equals
    2^b (one past the last partition) only where x = 2^32-1."""
    keys_u64 = np.asarray(keys_u64, np.uint64)
    x = (keys_u64 << np.uint64(64 - 2 * k) >> np.uint64(32)).astype(
        np.uint64
    )
    F = (x << np.uint64(32)) - ((x * x) >> np.uint64(1))
    return (F >> np.uint64(63 - b)).astype(np.int64)


def quantile_partition_ids(keys_u64, b, k):
    """Monotone analytic equal-mass partition of canonical k-mer values
    (see kcftools_tpu/ops/pjoin.py for the derivation), clamped to
    P-1 = 2^b - 1. The clamp keeps the ids monotone, so a sorted key
    array still has non-decreasing ids and tiling stays pure slicing."""
    return np.minimum(raw_quantile_ids(keys_u64, b, k), (1 << b) - 1)


def tile_sorted(keys_sorted, k, b, tile=None, counts=None):
    """Pad a SORTED key array into (P, tile) uint32 quantile tiles
    (P = 2^b). Returns (hi_tiles, lo_tiles, cnt_tiles-or-None, rank,
    part): key i sits at slot part[i] * tile + rank[i]. Raises if any
    partition overflows ``tile``."""
    keys_sorted = np.asarray(keys_sorted, np.uint64)
    n = keys_sorted.shape[0]
    P = 1 << b
    part = quantile_partition_ids(keys_sorted, b, k)
    per = np.bincount(part, minlength=P)
    mx = int(per.max()) if n else 0
    if tile is None:
        tile = max(_LANE, _round_up(mx, _LANE))
    elif mx > tile:
        raise OverflowError(
            f"partition {int(per.argmax())} has {mx} > tile {tile}"
        )
    starts = np.concatenate(([0], np.cumsum(per)))
    rank = np.arange(n) - starts[part]
    hi, lo = split_hi_lo(keys_sorted, k)
    th = np.zeros((P, tile), np.uint32)
    tl = np.zeros((P, tile), np.uint32)
    th[part, rank] = hi
    tl[part, rank] = lo
    tc = None
    if counts is not None:
        tc = np.zeros((P, tile), np.uint32)
        tc[part, rank] = counts
    return th, tl, tc, rank, part


def pack_planar(tc):
    """(P, Tt) counts <= 255 -> (P, Tt/4) uint32 words in the planar
    byte layout the native packer writes: byte b of word j holds the
    count of slot b*(Tt/4)+j."""
    tc = np.asarray(tc, np.uint32)
    P, Tt = tc.shape
    c = tc.reshape(P, 4, Tt // 4)
    return (
        c[:, 0] | (c[:, 1] << np.uint32(8)) | (c[:, 2] << np.uint32(16))
        | (c[:, 3] << np.uint32(24))
    )


def as_i32(a):
    """A uint32 numpy array as an int32 CPU tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def unpack_planar(w):
    """(B, Tt/4) planar-packed count words -> (B, Tt) int64 counts."""
    return torch.cat(
        [(w.long() >> (8 * b)) & 0xFF for b in range(4)], dim=-1
    )


def pjoin_join_ref(qh, ql, th, tl, tc, packed):
    """Plain torch version of the join, a block of partitions at a time
    (the whole (P, Tq, Tt) match mask is ~10^10 elements at main-path
    sizes). Same operands and result as ``pjoin_join``."""
    P, Tq = qh.shape
    Tt = th.shape[1]
    out = torch.empty((P, Tq), dtype=torch.int32, device=qh.device)
    blk = max(1, _REF_BLOCK_ELEMS // max(1, Tq * Tt))
    for p0 in range(0, P, blk):
        p1 = min(P, p0 + blk)
        cnt = (unpack_planar(tc[p0:p1]) if packed
               else tc[p0:p1].long() & 0xFFFFFFFF)
        m = (qh[p0:p1, :, None] == th[p0:p1, None, :]) & (
            ql[p0:p1, :, None] == tl[p0:p1, None, :]
        )
        s = torch.where(m, cnt[:, None, :], 0).sum(dim=2) & 0xFFFFFFFF
        # uint32 bit pattern -> int32: subtract 2^32 above 2^31 - 1
        out[p0:p1] = (s - ((s >> 31) << 32)).to(torch.int32)
    return out


def _check_operands(qh, ql, th, tl, tc, packed):
    ops = (qh, ql, th, tl, tc)
    dev = qh.device
    for t in ops:
        if t.device != dev:
            raise ValueError("pjoin_join: operands on different devices")
        if t.dtype != torch.int32:
            raise TypeError(f"pjoin_join: int32 operands, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError("pjoin_join: 2-D contiguous operands")
    P, Tq = qh.shape
    Tt = th.shape[1]
    if ql.shape != (P, Tq) or th.shape != (P, Tt) or tl.shape != (P, Tt):
        raise ValueError("pjoin_join: query/table shapes disagree")
    if packed and Tt % 4:
        raise ValueError(f"pjoin_join: packed counts need Tt % 4 == 0, Tt={Tt}")
    if tc.shape != (P, Tt // 4 if packed else Tt):
        raise ValueError(f"pjoin_join: count operand shape {tuple(tc.shape)}")
    if P * Tq >= 1 << 31 or P * Tt >= 1 << 31:
        raise ValueError("pjoin_join: P*Tq and P*Tt must be < 2^31")
    return P, Tq, Tt


def pjoin_join(qh, ql, th, tl, tc, packed):
    """(P, Tq) int32 join counts (uint32 bits). qh, ql: (P, Tq) query
    tiles; th, tl: (P, Tt) table tiles; tc: (P, Tt) counts, or (P, Tt/4)
    planar byte-packed words when ``packed``. All int32, contiguous, on
    one device. CPU tensors take the plain version; CUDA tensors launch
    the kernel. ``pjoin_join.launches_packed`` and
    ``pjoin_join.launches_u32`` count the launches of its two variants."""
    P, Tq, Tt = _check_operands(qh, ql, th, tl, tc, packed)
    dev = qh.device
    if dev.type == "cpu":
        return pjoin_join_ref(qh, ql, th, tl, tc, packed)
    if dev.type != "cuda":
        raise RuntimeError(f"pjoin_join: no kernel for device {dev}")
    if P * Tq == 0 or Tt == 0:
        return torch.zeros((P, Tq), dtype=torch.int32, device=dev)
    from ._kernels import launch_pjoin

    out = torch.empty((P, Tq), dtype=torch.int32, device=dev)
    launch_pjoin(qh, ql, th, tl, tc, out, P, Tq, Tt, packed)
    if packed:
        pjoin_join.launches_packed += 1
    else:
        pjoin_join.launches_u32 += 1
    return out


pjoin_join.launches_packed = 0
pjoin_join.launches_u32 = 0
