"""Join operands that hold the partitioned join to its whole contract.

Beyond what real tiles hold (unique keys, sorted rows), the join must
sum every matching slot and wrap that sum mod 2^32, and no key value may
be special. The operands here have unsorted rows whose keys share their
top bits (as a quantile partition's do), duplicate keys, a duplicate
pair whose uint32 counts wrap, the all-ones key (a hash table's natural
EMPTY marker) twice as a table key and as a query, the all-A key 0 as a
real key, padding slots (key (0, 0), count 0), and queries that hit,
miss, or hit a duplicate. numpy only: shared by the CPU tests (the
port's plain join against the JAX package's Pallas kernel) and the card
tests (the CUDA kernel against the plain join).
"""

import numpy as np

from kcftools_tpu_torch.ops.pjoin import pack_planar

ONES = np.uint32(0xFFFFFFFF)

# (P, Tq, Tt) that reach every path of the CUDA kernel: the staged
# variant at the main path's widths, table rows too wide to stage (the
# chunked variant, five builds), query rows too wide to stage (the
# chunked variant, one build), widths off every multiple of 128 and of 4
# (unaligned rows; packed rounds Tt down to a multiple of 4), fewer
# partitions than the persistent grid, and one partition
EDGE_SHAPES = [
    (64, 1024, 1024),
    (3, 700, 9000),
    (2, 20000, 64),
    (5, 77, 999),
    (100, 256, 512),
    (1, 1024, 1024),
]


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def hard_join_operands(seed, P, Tq, Tt, packed):
    """(qh, ql, th, tl, tc) uint32 arrays: queries (P, Tq), table keys
    (P, Tt), counts (P, Tt), or (P, Tt / 4) planar words when
    ``packed`` (Tt a multiple of 4)."""
    rng = np.random.default_rng(seed)
    th = (_u32(rng, (P, Tt)) >> np.uint32(8)) | (
        (np.arange(P, dtype=np.uint32) * np.uint32(2654435761))[:, None]
        & np.uint32(0xFF000000)
    )
    tl = _u32(rng, (P, Tt))
    if packed:
        cnt = rng.integers(0, 256, (P, Tt)).astype(np.uint32)
    else:
        cnt = _u32(rng, (P, Tt))
    pad = Tt - Tt // 5
    th[:, pad:] = 0
    tl[:, pad:] = 0
    cnt[:, pad:] = 0
    rows = np.arange(P)[:, None]
    if pad > 5:  # random duplicates, away from the fixed slots below
        n_dup = max(1, pad // 8)
        src = rng.integers(5, pad, (P, n_dup))
        dst = rng.integers(5, pad, (P, n_dup))
        th[rows, dst] = th[rows, src]
        tl[rows, dst] = tl[rows, src]
    if pad >= 5:
        th[::3, :2] = ONES  # the all-ones key, twice
        tl[::3, :2] = ONES
        th[::7, 2] = 0  # the all-A k-mer, a real key
        tl[::7, 2] = 0
        th[:, 4] = th[:, 3]  # a duplicate pair
        tl[:, 4] = tl[:, 3]
        if not packed:  # whose sum wraps 2^32, as does the ones key's
            cnt[:, 3] = 0xFFFFFFF0
            cnt[:, 4] = 0x20
            cnt[::3, :2] = 0xFFFFFFFF
    idx = rng.integers(0, Tt, (P, Tq))
    qh = np.take_along_axis(th, idx, 1)
    ql = np.take_along_axis(tl, idx, 1)
    miss = rng.random((P, Tq)) < 0.3
    qh[miss] = _u32(rng, int(miss.sum()))
    ql[miss] = _u32(rng, int(miss.sum()))
    if Tq >= 3 and pad >= 5:
        qh[:, 0] = ONES
        ql[:, 0] = ONES
        qh[:, 1] = 0
        ql[:, 1] = 0
        qh[:, 2] = th[:, 3]
        ql[:, 2] = tl[:, 3]
    tc = pack_planar(cnt) if packed else cnt
    return qh, ql, th, tl, tc


def layout_width(Tt, packed):
    """The table width a layout takes for an EDGE_SHAPES entry."""
    return Tt - Tt % 4 if packed else Tt
