"""Operands of the hash engine's scoring (kcftools_tpu_torch/ops/
hashscan.py) that reach every path of its kernels (csrc/hashscan.cu:
probe stretches of STRETCH starts a lane in warp tiles of 32 stretches,
1,024-position scan chunks of 32-bit words): rows longer than a chunk
with an N run across a chunk edge, windows of length 0, k - 1, k and
Lp - 32, an all-N window, N at the first and last base, ACGT runs of
exactly k and k - 1 bases, bytes other than 4 that are invalid, bases
past win_len up to the row's end, the last valid start at and beside a
stretch's and a warp tile's edge; counts that sit around min_count, are
all 0, reach 2^31 and wrap; tables built from the rows' k-mers, and
hand-made ones of 1 and 2 buckets holding a key in both of its buckets
(counts that wrap past 2^32) and in two slots of one bucket. numpy
only: shared by the CPU tests (the port's plain versions and models of
the kernels against the JAX package), the card tests and chip_smoke.py
(the kernels against the plain versions).
"""

import numpy as np

from kcftools_tpu_torch.engine.hashtable import bucket_hashes_np

PAD = 32  # PAD_MARGIN: k-mer starts are the first Lp - 32 positions
KS = (11, 16, 17, 31, 32)
CHUNK = 1024
LP = 3 * CHUNK + 96  # three whole chunks and a partial one, plus PAD
MIN_COUNTS = (0, 1, 3)
STRETCH = 4  # consecutive starts a lane of the probe owns (kStretch)
STRETCHES = (STRETCH, 8, 16)  # the rolling build's model runs at each


def rows_case(seed, k, Lp=LP):
    """(u8 (B, Lp) uint8, win_len (B,) int64): one row per edge case."""
    rng = np.random.default_rng(seed)
    n_out = Lp - PAD
    rows, lens = [], []

    def add(win, fill=4):
        row = np.full(Lp, fill, np.uint8)
        row[:win] = rng.integers(0, 4, win)
        rows.append(row)
        lens.append(win)
        return row

    row = add(n_out)  # the longest window, scattered N, a run over a chunk
    row[rng.random(Lp) < 0.01] = 4
    row[CHUNK - 40 : CHUNK + 60] = 4
    add(0)  # a padding row
    add(k - 1)  # shorter than k
    add(k)  # one k-mer
    add(500)[:500] = 4  # all N
    row = add(800)  # N at the first and last base
    row[0] = row[799] = 4
    row = add(600)  # runs of exactly k and k - 1 bases
    at = 0
    for run in (k, k - 1, k, k - 1, 1, k):
        row[at + run] = 4
        at += run + 1
    # bases past win_len, to the row's end; the last start at bit 30 of
    # a 32-position word
    row = add(46 * 32 + 30 + k, fill=0)
    row[rng.random(Lp) < 0.005] = 4
    row = add(2 * CHUNK + k)  # bytes other than 4 that are invalid
    row[rng.integers(0, 2 * CHUNK, 40)] = rng.choice([5, 77, 200, 255], 40)
    add(CHUNK + k - 1)  # the last start exactly at a chunk's end
    add(int(rng.integers(k, n_out)))
    add(int(rng.integers(k, n_out)))
    return np.stack(rows), np.array(lens, np.int64)


def stretch_edges_case(seed, k, Lp=LP, stretches=STRETCHES):
    """(u8, win_len): one row for each last valid start (win_len - k)
    one before, at and one after the first and third stretch edge and
    the first two warp-tile edges (32 stretches) of each stretch size,
    and at n_out - 2 and n_out - 1; random bases with ~1% N, the
    sentinel past the window in every other row and bases there in the
    rest."""
    rng = np.random.default_rng(seed)
    n_out = Lp - PAD
    edges = {e + d for s in stretches for e in (s, 3 * s, 32 * s, 64 * s)
             for d in (-1, 0, 1)}
    lasts = sorted(x for x in edges | {n_out - 2, n_out - 1}
                   if 0 <= x < n_out)
    rows = rng.integers(0, 4, (len(lasts), Lp)).astype(np.uint8)
    rows[rng.random(rows.shape) < 0.01] = 4
    lens = np.array(lasts, np.int64) + k
    for r in range(0, len(lasts), 2):
        rows[r, lens[r]:] = 4
    return rows, lens


def counts_case(seed, u8):
    """(B, Lp - 32) uint32 counts, by row: around min_count, all 0, all
    at or above 2^31, and full-range; invalid starts hold counts too."""
    rng = np.random.default_rng(seed)
    B, Lp = u8.shape
    n = Lp - PAD
    counts = np.empty((B, n), np.uint32)
    for r in range(B):
        kind = r % 4
        if kind == 0:
            counts[r] = rng.integers(0, 5, n)
        elif kind == 1:
            counts[r] = 0
        elif kind == 2:
            counts[r] = rng.integers(1 << 31, 1 << 32, n, dtype=np.uint64)
        else:
            counts[r] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    return counts


def kernel_kmers(u8, k, both_strands):
    """The probe kernel's k-mers, in numpy: for every start, the 64-bit
    forward value and reverse complement built byte by byte, the
    canonical min of the two (or the forward one), split into (hi, lo)
    by 64-bit shifts (hi the first min(k, 16) bases); and whether all k
    bytes are bases. Returns (hi, lo) uint32 and ok bool, (B, Lp - 32)."""
    B, Lp = u8.shape
    n = Lp - PAD
    f = np.zeros((B, n), np.uint64)
    r = np.zeros((B, n), np.uint64)
    bad = np.zeros((B, n), bool)
    for u in range(k):
        c = u8[:, u : u + n].astype(np.uint64)
        bad |= c >= 4
        f = (f << np.uint64(2)) | (c & np.uint64(3))
        r |= (~c & np.uint64(3)) << np.uint64(2 * u)
    key = np.minimum(f, r) if both_strands else f
    n_lo = np.uint64(2 * max(k - 16, 0))
    hi = (key >> n_lo).astype(np.uint32)
    lo = (key & ((np.uint64(1) << n_lo) - np.uint64(1))).astype(np.uint32)
    return hi, lo, ~bad


def rolling_kmers(u8, win_len, k, both_strands, stretch=STRETCH, align=0):
    """The probe kernel's rolling k-mer build, in numpy, every lane of
    every warp tile at once. The rows lie in one buffer from byte
    ``align`` (mod 16) with random bytes around them; a warp tile of 32
    x ``stretch`` starts is staged as the aligned 16-byte granules that
    hold its bytes and the k - 1 after it (a granule that starts past
    the row stages zeros; one that starts inside it brings the next
    row's bytes, or the buffer's, past the row); a lane reads k - 1
    bytes of prologue from its stretch's first start, then shifts in one
    byte a start: f = (f << 2 | c) & kmask, r = r >> 2 | (3 - c) << 2(k -
    1), and a count of consecutive bases that resets at any byte >= 4. A
    start is live where the count reaches k, it is at most win_len - k
    and below n_out. Returns (keys uint64: min(f, r), or f, where live;
    live bool), both (B, Lp - PAD)."""
    B, Lp = u8.shape
    n = Lp - PAD
    tile = 32 * stretch
    stage = tile + 48  # kStage: up to 15 bytes before, k - 1 <= 31 after
    rng = np.random.default_rng(Lp + align)
    mem = rng.integers(0, 256, 16 + align + B * Lp + 64).astype(np.uint8)
    mem[16 + align : 16 + align + B * Lp] = u8.ravel()
    kmask = np.uint64((1 << (2 * k)) - 1)
    up = np.uint64(2 * (k - 1))
    two, three = np.uint64(2), np.uint64(3)
    keys = np.zeros((B, n), np.uint64)
    live = np.zeros((B, n), bool)
    s0 = np.arange(0, n, stretch)  # every lane's first start
    lo = s0 // tile * tile  # its warp tile's
    for row in range(B):
        row0 = 16 + align + row * Lp
        off = (row0 + lo) & 15  # the tile's first byte in its granules
        g0 = row0 + lo - off
        f = np.zeros(s0.shape, np.uint64)
        r = np.zeros(s0.shape, np.uint64)
        run = np.zeros(s0.shape, np.int64)
        for u in range(k - 1 + stretch):
            p = off + (s0 - lo) + u  # the byte's place in the staged tile
            assert (p < stage).all()
            granule = g0 + p // 16 * 16
            c = np.where(granule < row0 + Lp, mem[g0 + p], 0).astype(
                np.uint64)
            run = np.where(c < 4, run + 1, 0)
            f = ((f << two) | (c & three)) & kmask
            r = (r >> two) | ((~c & three) << up)
            if u >= k - 1:
                s = s0 + u - (k - 1)
                ok = (run >= k) & (s <= win_len[row] - k) & (s < n)
                key = np.minimum(f, r) if both_strands else f
                keys[row, s[ok]] = key[ok]
                live[row, s[ok]] = True
    return keys, live


def kmer_valid(u8, win_len, k):
    """(B, Lp - 32) bool: all k bytes are bases and start <= win_len - k."""
    _hi, _lo, ok = kernel_kmers(u8, k, False)
    pos = np.arange(ok.shape[1])[None, :]
    return ok & (pos <= win_len[:, None] - k)


def table_keys(seed, u8, win_len, k, both_strands, frac=0.7, extra=500):
    """(keys uint64 packed k-mers, counts uint32) for ``build_table``:
    ``frac`` of the rows' distinct valid k-mers and ``extra`` random
    keys; counts up to 2^32 - 1, a third at or above 2^31."""
    rng = np.random.default_rng(seed)
    hi, lo, _ok = kernel_kmers(u8, k, both_strands)
    n_lo = np.uint64(2 * max(k - 16, 0))
    keys = (hi.astype(np.uint64) << n_lo) | lo.astype(np.uint64)
    keys = np.unique(keys[kmer_valid(u8, win_len, k)])
    keys = keys[rng.random(keys.shape[0]) < frac]
    more = rng.integers(0, 1 << 62, extra, dtype=np.uint64) & np.uint64(
        (1 << (2 * k)) - 1)
    keys = np.unique(np.concatenate([keys, more]))
    counts = rng.integers(1, 1 << 32, keys.shape[0], dtype=np.uint64)
    counts[::3] |= np.uint64(1 << 31)
    return keys, counts.astype(np.uint32)


def hand_table(u8, win_len, k, both_strands, nb):
    """A hand-made (nb, 12) uint32 table over the rows' first valid
    k-mers: a key in both of its buckets (where they differ) with counts
    0xFFFFFFF0 and 0x20, which wrap to 0x10; a key in two slots of one
    bucket, likewise; keys with counts >= 2^31 and 1."""
    hi, lo, _ok = kernel_kmers(u8, k, both_strands)
    valid = kmer_valid(u8, win_len, k)
    pairs = []
    for h, lw in zip(hi[valid], lo[valid]):
        if (h, lw) not in pairs:
            pairs.append((h, lw))
        if len(pairs) == 4 * nb:
            break
    tbl = np.zeros((nb, 12), np.uint32)
    fill = np.zeros(nb, np.int64)

    def put(b, h, lw, c):
        s = fill[b]
        if s < 4:
            tbl[b, s], tbl[b, 4 + s], tbl[b, 8 + s] = h, lw, c
            fill[b] += 1

    for i, (h, lw) in enumerate(pairs):
        h1, h2 = (int(x[0]) for x in bucket_hashes_np(h, lw, nb))
        if i == 0:
            put(h1, h, lw, 0xFFFFFFF0)
            put(h2, h, lw, 0x20)  # the same bucket when h1 == h2
        else:
            put(h1 if i % 2 else h2, h, lw, 0x80000001 if i % 3 else 1)
    return tbl
