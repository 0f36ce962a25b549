"""Operands of the window gap-run scan (kcftools_tpu_torch/ops/gapscan.py)
that reach every path of its kernel (csrc/gapscan.cu, 1,024-position
chunks of 32-bit words): windows that tile, slide with heavy overlap or
come unsorted (feature windows, one as long as the slab); windows that
start or end on and beside chunk and word edges, lie inside one chunk,
are shorter than k, empty (w_hi = w_start - 1), padding ([0, 0]) or, on
request, inverted (w_hi < w_start - 1); presence dense with SNP-like
absent runs, sparse, all absent or all present, with position 0 present;
N runs, one across a chunk edge, and an invalid slab tail; several rows;
counts that fit a byte, reach 2^31 and 2^32 - 1. numpy only: shared by
the CPU tests (the port's plain scan and a model of the kernel against
the JAX package) and the card tests (the kernel against the plain scan).
"""

import numpy as np

KERNEL_CHUNK = 1024
N = 4 * KERNEL_CHUNK + 96  # four whole chunks and a partial one
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
