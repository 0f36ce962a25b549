"""Operands of the window gap-run scan (kcftools_tpu_torch/ops/gapscan.py)
that reach every path of its kernel (csrc/gapscan.cu: the JOIN mode's
1,024-position chunks of 32-bit words; the ROWS and RUNS modes'
128-position quads, a lane's for a short window, split into pieces and
lane stretches of warps for a long one): windows that tile, slide with
heavy overlap or
come unsorted (feature windows, one as long as the slab); windows that
start or end on and beside chunk and word edges, lie inside one chunk,
are shorter than k, empty (w_hi = w_start - 1), padding ([0, 0]) or, on
request, inverted (w_hi < w_start - 1); presence dense with SNP-like
absent runs, sparse, all absent or all present, with position 0 present;
N runs, one across a chunk edge, and an invalid slab tail; several rows;
counts that fit a byte, reach 2^31 and 2^32 - 1; several slabs of one
sample over shared routed counts; absent-run streams with (255, 0)
fillers, (0, 255) continuations, zero padding, a run that ends at n, runs
past n and across invalid positions, an all-absent row and an empty
stream. The long cases (``long_rows_case``, ``long_runs_case``) add, over
slabs of LONG_N and ODD_N positions (16-byte and word loads), windows
longer than LONG_WINDOW (lane stretches of more than one batch of
loads), one over the whole slab, windows that start and end on quad and
lane-stretch edges and beside them, groups of 1, 8 and 9 rows, and run
streams of many decode segments (RUN_SEG entries) whose runs share words
and whose segment edges fall inside words. numpy only:
shared by the CPU tests (the port's plain scan and models of the kernel
against the JAX package) and the card tests (the kernel against the plain
scan).
"""

import numpy as np

KERNEL_CHUNK = 1024
N = 4 * KERNEL_CHUNK + 96  # four whole chunks and a partial one
QUAD = 128  # positions of a 16-byte quad of the ROWS / RUNS kernel
SHORT_QUADS = 64  # quads of a window one lane folds, at most
LONG_WINDOW = 2 * SHORT_QUADS * QUAD  # 16,384: split over warps
LONG_N = 8 * LONG_WINDOW  # a multiple of 128: 16-byte loads
ODD_N = LONG_N + 96  # not a multiple of 128: word loads
RUN_SEG = 1024  # run entries of a segment of the run decode
PRESENCE_KINDS = ("dense", "sparse", "absent", "present")


def valid_mask(rng, n):
    valid = rng.random(n) > 0.02
    valid[n // 3 : n // 3 + 90] = False
    if n > 2 * KERNEL_CHUNK:
        valid[KERNEL_CHUNK - 40 : KERNEL_CHUNK + 70] = False
    valid[n - 64 :] = False  # slab padding
    valid[0] = True
    return valid


def presence(rng, valid, kind, k):
    """(n,) bool inside ``valid``."""
    n = valid.shape[0]
    if kind == "absent":
        return np.zeros(n, bool)
    if kind == "present":
        return valid.copy()
    pr = rng.random(n) < (0.97 if kind == "dense" else 0.4)
    for a in rng.integers(0, n, n // 100):
        pr[a : a + int(rng.integers(1, 2 * k))] = False
    pr[n // 2 : n // 2 + 700] = False  # an absent stretch over a chunk edge
    pr[0] = True
    return pr & valid


def windows(rng, n, k, inverted=False):
    """(w_start, w_hi) int64 of every kind, in no order."""
    c = KERNEL_CHUNK
    ws, wh = [], []

    def add(s, h):
        ws.append(s)
        wh.append(h)

    for s in range(0, n, 333):  # tiling
        add(s, min(s + 332, n - 1))
    for s in range(10, n - 700, 150):  # sliding, ~5x overlap
        add(s, s + 699)
    for s, h in ((0, n - 1), (c - 1, c), (c, 2 * c - 1), (c, 2 * c),
                 (c - 1, 3 * c), (1000, 3100), (31, 32), (32, 63),
                 (0, 0), (n - 1, n - 1), (2 * c + 5, 2 * c + 5 + k - 2),
                 (777, 776), (0, -1), (n - 1, n - 2)):
        add(s, h)
    for _ in range(12):  # feature windows of any length
        s = int(rng.integers(0, n))
        add(s, int(rng.integers(s - 1, n)))
    add(0, 0)  # padding entries
    add(0, 0)
    if inverted:
        add(600, 100)
        add(n - 1, -1)
        add(3 * c + 7, c - 3)
    order = rng.permutation(len(ws))
    return (np.asarray(ws, np.int64)[order], np.asarray(wh, np.int64)[order])


def rows_case(seed, k, kinds=PRESENCE_KINDS, n=N, inverted=False):
    """(presence (S, n) bool, valid (n,) bool, w_start, w_hi): one row
    per presence kind."""
    rng = np.random.default_rng(seed)
    valid = valid_mask(rng, n)
    pr = np.stack([presence(rng, valid, kind, k) for kind in kinds])
    ws, wh = windows(rng, n, k, inverted)
    return pr, valid, ws, wh


def join_case(seed, min_count, n=N, n_routed=3000, inverted=False):
    """(routed (R,) uint32, slot_map (n,) int32, valid, w_start, w_hi):
    counts 0..5 with every seventh at or above 2^31 and one 2^32 - 1;
    the slot map reads 0 at invalid positions."""
    rng = np.random.default_rng(seed)
    routed = rng.integers(0, 6, n_routed).astype(np.uint32)
    big = routed[::7].shape[0]
    routed[::7] = rng.integers(1 << 31, 1 << 32, big,
                               dtype=np.uint64).astype(np.uint32)
    routed[1] = 0xFFFFFFFF
    valid = valid_mask(rng, n)
    slot_map = np.where(valid, rng.integers(0, n_routed, n), 0)
    slot_map[0] = 1
    ws, wh = windows(rng, n, 31, inverted)
    return routed, slot_map.astype(np.int32), valid, ws, wh


def bits(a):
    """(..., n) bool -> (..., n/8) uint8 LSB-first."""
    return np.packbits(a, axis=-1, bitorder="little")


def slabs_case(seed, min_count, n_slabs=3, n=N, inverted=False):
    """(routed, slot_maps (S, n) int32, valid (S, n) bool, w_starts,
    w_his (S, W) int64): the slabs of one sample, each with its own slot
    map, valid mask and windows, over the first slab's routed counts."""
    cases = [join_case(seed + i, min_count, n=n, inverted=inverted)
             for i in range(n_slabs)]
    return (cases[0][0], *(np.stack([c[i] for c in cases])
                           for i in range(1, 5)))


def encode_runs(runs):
    """The native kcf_bits_to_runs encoding of sorted disjoint runs
    [s, e): (delta, length) uint8 with (255, 0) fillers and (0, 255)
    continuations."""
    d, ln = [], []
    prev = 0
    for s, e in runs:
        gap = s - prev
        while gap > 255:
            d.append(255)
            ln.append(0)
            gap -= 255
        take = min(e - s, 255)
        d.append(gap)
        ln.append(take)
        rest = e - s - take
        while rest > 0:
            take = min(rest, 255)
            d.append(0)
            ln.append(take)
            rest -= take
        prev = e
    return np.array([d, ln], np.uint8).reshape(2, -1)


def absent_runs(pr):
    """The maximal absent stretches [s, e) of a presence row."""
    edges = np.flatnonzero(np.diff(np.r_[1, pr.astype(np.int8), 1]))
    return list(zip(edges[::2].tolist(), edges[1::2].tolist()))


def runs_case(seed, k, n=N, pad=9):
    """(dl (S, 2, R) uint8, valid (n,) bool, w_start, w_hi): the streams
    of a dense and a sparse presence row (absent stretches over invalid
    positions kept whole, long present stretches and runs longer than
    255), an all-absent row (one run [0, n), continuations to the end),
    an empty stream, and a row whose last runs reach and start past n;
    ``pad`` zero entries after the longest stream."""
    rng = np.random.default_rng(seed)
    valid = valid_mask(rng, n)
    dense = presence(rng, valid, "dense", k) | ~valid
    sparse = presence(rng, valid, "sparse", k) | ~valid
    dense[1500:2400] = True  # > 255 present positions: fillers
    dense[3000:3400] = False  # > 255 absent: continuations
    streams = [
        encode_runs(absent_runs(dense)),
        encode_runs(absent_runs(sparse)),
        encode_runs([(0, n)]),
        np.zeros((2, 0), np.uint8),
        encode_runs([(40, 90), (n - 10, n + 20), (n + 50, n + 60)]),
    ]
    R = max(st.shape[1] for st in streams) + pad
    dl = np.zeros((len(streams), 2, R), np.uint8)
    for r, st in enumerate(streams):
        dl[r, :, : st.shape[1]] = st
    ws, wh = windows(rng, n, k)
    return dl, valid, ws, wh


def runs_presence(dl, valid):
    """Presence of each row of ``dl``: the valid positions outside every
    run (runs clamped to n)."""
    n = valid.shape[0]
    out = np.tile(valid, (dl.shape[0], 1))
    for r in range(dl.shape[0]):
        ends = np.cumsum(dl[r, 0].astype(np.int64) + dl[r, 1])
        for e, ln in zip(ends.tolist(), dl[r, 1].tolist()):
            if ln and e - ln < n:
                out[r, e - ln : min(e, n)] = False
    return out


def long_windows(rng, n, k, inverted=False):
    """(w_start, w_hi) int64 over a slab of n >= 8 * LONG_WINDOW
    positions: the whole slab; windows of exactly LONG_WINDOW positions
    and one position more; windows of nq quads on either side of the
    short/long edge (SHORT_QUADS) and of the lane-stretch and piece
    edges of long windows, aligned to quads and one position off;
    -w 5000 tiling and sliding windows; feature windows of 1-60 kb,
    unsorted and overlapping; empty, padding and, on request, inverted
    ones; in no order."""
    q, t = QUAD, LONG_WINDOW
    pairs = [(0, n - 1), (5, n - 6), (0, t - 1), (q, q + t - 1), (1, t),
             (q - 1, q + t - 1), (t, 2 * t - 1), (t - 1, 3 * t),
             (0, 4 * t - 1), (n - t, n - 1), (n - t - 1, n - 1)]
    for nq in (1, 31, 32, 33, 64, 65, 100, 127, 128, 129, 255, 256, 257,
               300, 511, 512, 513, 900):
        lo = q * int(rng.integers(0, (n - nq * q) // q))
        pairs += [(lo, lo + nq * q - 1), (lo + 1, lo + nq * q - 2),
                  (lo + 5, lo + nq * q + 3)]
    span = 5000 - k + 1
    pairs += [(s, s + span - 1) for s in range(0, n - span, span)]
    pairs += [(s, s + span - 1) for s in range(7, n - span, span // 2)]
    for _ in range(30):  # feature windows: transcripts of genes
        length = int(np.exp(rng.uniform(np.log(1000), np.log(60000))))
        s = int(rng.integers(0, n - length))
        pairs.append((s, s + length - 1))
    pairs += [(0, 0), (0, 0), (777, 776), (0, -1), (n - 1, n - 1)]
    if inverted:
        pairs += [(2 * t, 10), (n - 1, -1), (3 * t + 5, t - 3)]
    pairs = [(s, min(h, n - 1)) for s, h in pairs]
    order = rng.permutation(len(pairs))
    ws, wh = np.asarray(pairs, np.int64)[order].T
    return np.ascontiguousarray(ws), np.ascontiguousarray(wh)


def long_rows_case(seed, k, rows, n=LONG_N, inverted=False):
    """(presence (rows, n) bool, valid, w_start, w_hi): the presence
    kinds in turn, over a long slab with long windows."""
    rng = np.random.default_rng(seed)
    valid = valid_mask(rng, n)
    pr = np.stack([presence(rng, valid, PRESENCE_KINDS[r % 4], k)
                   for r in range(rows)])
    ws, wh = long_windows(rng, n, k, inverted)
    return pr, valid, ws, wh


def long_runs_case(seed, k, rows, n=LONG_N, pad=16):
    """(dl (rows, 2, R) uint8, valid, w_start, w_hi) over a long slab:
    in turn a row of ~9,000 one-position runs (many share a word; the
    stream spans many decode segments, whose edges fall inside words), a
    dense and a sparse SNP-like row, an all-absent row
    (continuations to the end), an empty stream, a row whose runs reach
    and start past n, and a row with 9,000 zero entries in the middle of
    its stream (zeros are empty entries anywhere, not only as padding).
    R is the longest stream plus ``pad`` zero
    entries (pad 16 from a stream length that is a multiple of 16: 16-byte
    loads)."""
    rng = np.random.default_rng(seed)
    valid = valid_mask(rng, n)
    many = np.ones(n, bool)
    many[1000 : 1000 + 18000 : 2] = False
    many[40000:40300] = False  # one run over a segment's continuations
    kinds = [
        lambda: absent_runs(many),
        lambda: absent_runs(presence(rng, valid, "dense", k) | ~valid),
        lambda: absent_runs(presence(rng, valid, "sparse", k) | ~valid),
        lambda: [(0, n)],
        lambda: [],
        lambda: [(40, 90), (n - 10, n + 20), (n + 50, n + 60)],
        lambda: [(s, s + 3) for s in range(100, n - 100, 2000)],
    ]
    streams = [encode_runs(kinds[r % len(kinds)]()) for r in range(rows)]
    if rows > 6:  # zeros in the middle of the seventh stream
        mid = streams[6].shape[1] // 2
        streams[6] = np.concatenate(
            [streams[6][:, :mid], np.zeros((2, 9000), np.uint8),
             streams[6][:, mid:]], axis=1)
    longest = max(st.shape[1] for st in streams)
    R = -(-longest // 16) * 16 + pad
    dl = np.zeros((rows, 2, R), np.uint8)
    for r, st in enumerate(streams):
        dl[r, :, : st.shape[1]] = st
    ws, wh = long_windows(rng, n, k)
    return dl, valid, ws, wh
