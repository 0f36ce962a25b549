"""Bucketed two-choice hash table for device k-mer lookups.

Replaces the reference's signature-map + prefix-LUT + binary-search
lookup (reference: Data/KMC.java:292-326) with a TPU-friendly layout:
keys live in buckets of 4 slots; every key is in one of two buckets
derived from two 32-bit mixes of its (hi, lo) halves. The device array
is ONE interleaved (nb, 12) uint32 array - row = [hi x4 | lo x4 |
cnt x4] - so a batched lookup is exactly two 48-byte row gathers +
vectorized compares per query, fixed shape, no data-dependent control
flow. (Measured on v5e: the previous (nb, 8) x 3-array layout cost six
32-byte gathers per query and ran 4-6x slower - row size, not compute,
is the lookup's speed-of-light.)

The table is built on host with vectorized round-based insertion (each
round places every still-homeless key into the emptier of its two
buckets, resolving per-bucket contention with a stable sort); if a key
cannot be placed the table grows and the build restarts. Two-choice
hashing with 4-slot buckets sustains load factors well above 0.9; the
default 0.8 leaves margin so rebuilds are rare.

Empty slots are marked by count == 0, which cannot collide with a real
entry: KMC databases only store k-mers with count >= 1.
"""

import numpy as np

from .encode import split_hi_lo
from ..utils.logger import Logger

_CLASS = "KmerTable"

BUCKET_SLOTS = 4

# 32-bit mix constants (murmur3 finalizer structure)
_C1A = np.uint32(0x9E3779B1)
_C1B = np.uint32(0x85EBCA77)
_C2A = np.uint32(0xC2B2AE3D)
_C2B = np.uint32(0x27D4EB2F)


def _fmix32(h):
    h = h.astype(np.uint32) if isinstance(h, np.ndarray) else h
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def bucket_hashes_np(hi, lo, n_buckets: int):
    """The two candidate bucket indices of each (hi, lo) key. Must stay
    bit-identical with ops.lookup.bucket_hashes_jnp."""
    hi = np.atleast_1d(np.asarray(hi, np.uint32))
    lo = np.atleast_1d(np.asarray(lo, np.uint32))
    mask = np.uint32(n_buckets - 1)
    with np.errstate(over="ignore"):
        h1 = _fmix32(hi * _C1A + lo * _C1B + np.uint32(0xA5A5A5A5)) & mask
        h2 = _fmix32(hi * _C2A + lo * _C2B + np.uint32(0x3C6EF372)) & mask
    return h1, h2


def _next_pow2(x: int) -> int:
    n = 1
    while n < x:
        n <<= 1
    return n


class KmerTable:
    """Device-layout hash table: one interleaved (nb, 3*S) uint32 array
    ``tbl`` with row = [hi x S | lo x S | cnt x S]. ``hi``/``lo``/
    ``counts`` are views into it for host-side code and tests."""

    def __init__(self, tbl, k, n_keys, both_strands=True):
        S = tbl.shape[1] // 3
        self.tbl = tbl
        self.slots = S
        self.hi = tbl[:, :S]
        self.lo = tbl[:, S : 2 * S]
        self.counts = tbl[:, 2 * S :]
        self.k = k
        self.n_keys = n_keys
        self.n_buckets = tbl.shape[0]
        self.both_strands = both_strands

    @property
    def nbytes(self):
        return self.tbl.nbytes

    def lookup_np(self, kmers_u64):
        """Host (numpy) lookup of packed canonical k-mers -> counts.
        Mirrors the device kernel; used for tests and CPU fallback."""
        hi, lo = split_hi_lo(np.asarray(kmers_u64, np.uint64), self.k)
        out = np.zeros(hi.shape, np.uint32)
        h1, h2 = bucket_hashes_np(hi, lo, self.n_buckets)
        for b, use in ((h1, None), (h2, h2 != h1)):
            rows_hi = self.hi[b]  # (n, 8)
            rows_lo = self.lo[b]
            rows_cnt = self.counts[b]
            match = (rows_hi == hi[:, None]) & (rows_lo == lo[:, None]) & (
                rows_cnt != 0
            )
            contrib = (rows_cnt * match).sum(axis=1, dtype=np.uint32)
            if use is not None:
                contrib = np.where(use, contrib, 0)
            out += contrib
        return out


def build_fixed(hi, lo, counts, nb):
    """Two-choice build at a FIXED bucket count; the interleaved
    (nb, 3*S) array or None on overflow (caller grows and retries).
    The native path emits the interleaved layout directly (no final
    copy); the numpy fallback concatenates its three arrays."""
    from ..native import build_table_native, get_lib

    if get_lib() is not None:
        return build_table_native(hi, lo, counts, nb, slots=BUCKET_SLOTS)
    table = _try_build(hi, lo, counts, nb)
    if table is None:
        return None
    t_hi, t_lo, t_cnt = table
    return np.ascontiguousarray(np.concatenate([t_hi, t_lo, t_cnt], axis=1))


def suggest_buckets(n: int, load_factor: float = 0.8) -> int:
    return _next_pow2(max(2, int(np.ceil(n / (BUCKET_SLOTS * load_factor)))))


def build_table(
    kmers_u64: np.ndarray,
    counts: np.ndarray,
    k: int,
    load_factor: float = 0.8,
    both_strands: bool = True,
) -> KmerTable:
    if k > 32:
        raise ValueError(
            f"k={k} > 32: the (hi, lo)-uint32 device table holds "
            "uint64-packed k-mers only (wide k stays on the host "
            "merge tier)"
        )
    kmers_u64 = np.asarray(kmers_u64, np.uint64)
    counts = np.asarray(counts, np.uint32)
    n = kmers_u64.shape[0]
    hi, lo = split_hi_lo(kmers_u64, k)

    nb = suggest_buckets(n, load_factor)
    while True:
        tbl = build_fixed(hi, lo, counts, nb)
        if tbl is not None:
            Logger.info(
                _CLASS,
                f"Built table: {n} keys, {nb} buckets x {BUCKET_SLOTS} "
                f"({n / (nb * BUCKET_SLOTS):.2f} load, "
                f"{tbl.nbytes / 1e6:.1f} MB)",
            )
            return KmerTable(tbl, k, n, both_strands)
        nb *= 2
        Logger.warning(_CLASS, f"Hash table overflow; growing to {nb} buckets")


def build_table_sharded(
    kmers_u64: np.ndarray,
    counts: np.ndarray,
    k: int,
    t_axis: int,
    load_factor: float = 0.8,
    both_strands: bool = True,
) -> KmerTable:
    """In-RAM analog of the streaming loader's placement: keys are
    routed to the shard owning the top bits of their first bucket hash
    and placed two-choice WITHIN that shard (parallel/sharded.py
    lookup scheme). Every shard keeps the same local bucket count so
    the concatenated table shards evenly across the mesh's table axis."""
    kmers_u64 = np.asarray(kmers_u64, np.uint64)
    counts = np.asarray(counts, np.uint32)
    hi, lo = split_hi_lo(kmers_u64, k)
    return build_sharded_hilo(hi, lo, counts, k, t_axis,
                              load_factor=load_factor,
                              both_strands=both_strands)


def build_sharded_hilo(hi, lo, counts, k, t_axis, load_factor=0.8,
                       both_strands=True, nb_total=None):
    n = hi.shape[0]
    if nb_total is None:
        nb_total = max(suggest_buckets(n, load_factor), t_axis * 2)
    while True:
        nb_local = nb_total // t_axis
        h1, _h2 = bucket_hashes_np(hi, lo, nb_total)
        shard = (h1 // np.uint32(nb_local)).astype(np.int64)
        parts = []
        for s in range(t_axis):
            sel = shard == s
            part = build_fixed(hi[sel], lo[sel], counts[sel], nb_local)
            if part is None:
                parts = None
                break
            parts.append(part)
        if parts is not None:
            tbl = np.concatenate(parts, axis=0)
            Logger.info(
                _CLASS,
                f"Built sharded table: {n} keys, {t_axis} shards x "
                f"{nb_local} buckets ({tbl.nbytes / 1e6:.1f} MB)",
            )
            return KmerTable(tbl, k, n, both_strands)
        nb_total *= 2
        Logger.warning(
            _CLASS, f"Shard overflow; growing to {nb_total} buckets"
        )


def _try_build(hi, lo, counts, nb):
    n = hi.shape[0]
    t_hi = np.zeros((nb, BUCKET_SLOTS), np.uint32)
    t_lo = np.zeros((nb, BUCKET_SLOTS), np.uint32)
    t_cnt = np.zeros((nb, BUCKET_SLOTS), np.uint32)
    fill = np.zeros(nb, np.int32)

    b1, b2 = bucket_hashes_np(hi, lo, nb)
    remaining = np.arange(n)
    for _round in range(64):
        if remaining.size == 0:
            return t_hi, t_lo, t_cnt
        rb1 = b1[remaining]
        rb2 = b2[remaining]
        target = np.where(fill[rb1] <= fill[rb2], rb1, rb2).astype(np.int64)
        order = np.argsort(target, kind="stable")
        t_sorted = target[order]
        # rank of each key within its target-bucket group
        grp_start = np.flatnonzero(
            np.concatenate(([True], t_sorted[1:] != t_sorted[:-1]))
        )
        grp_id = np.cumsum(
            np.concatenate(([0], (t_sorted[1:] != t_sorted[:-1]).astype(np.int64)))
        )
        rank = np.arange(t_sorted.size) - grp_start[grp_id]
        space = BUCKET_SLOTS - fill[t_sorted]
        placed = rank < space
        slot = fill[t_sorted] + rank
        rows = t_sorted[placed]
        cols = slot[placed]
        src = remaining[order][placed]
        t_hi[rows, cols] = hi[src]
        t_lo[rows, cols] = lo[src]
        t_cnt[rows, cols] = counts[src]
        np.add.at(fill, rows, 1)
        remaining = remaining[order][~placed]
        # keys whose both buckets are full need cuckoo eviction; the
        # vectorized rounds leave only a tiny tail (<<0.1%), so a scalar
        # random-walk is fine
        stuck_mask = (fill[b1[remaining]] >= BUCKET_SLOTS) & (
            fill[b2[remaining]] >= BUCKET_SLOTS
        )
        if stuck_mask.any():
            stuck = remaining[stuck_mask]
            remaining = remaining[~stuck_mask]
            if not _evict_place(hi, lo, counts, t_hi, t_lo, t_cnt, fill, stuck, nb):
                return None
    return None


def _evict_place(hi, lo, counts, t_hi, t_lo, t_cnt, fill, stuck, nb):
    """Cuckoo random-walk placement for keys whose two buckets are full."""
    rng = np.random.default_rng(0xC0FFEE)
    for idx in stuck:
        cur = (np.uint32(hi[idx]), np.uint32(lo[idx]), np.uint32(counts[idx]))
        b = int(bucket_hashes_np(cur[0], cur[1], nb)[0][0])
        ok = False
        for _step in range(2000):
            if fill[b] < BUCKET_SLOTS:
                slot = fill[b]
                t_hi[b, slot], t_lo[b, slot], t_cnt[b, slot] = cur
                fill[b] += 1
                ok = True
                break
            victim = int(rng.integers(0, BUCKET_SLOTS))
            vkey = (t_hi[b, victim], t_lo[b, victim], t_cnt[b, victim])
            t_hi[b, victim], t_lo[b, victim], t_cnt[b, victim] = cur
            cur = vkey
            v1, v2 = bucket_hashes_np(cur[0], cur[1], nb)
            v1, v2 = int(v1[0]), int(v2[0])
            b = v2 if v1 == b else v1
        if not ok:
            return False
    return True
