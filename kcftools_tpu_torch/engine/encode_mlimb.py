"""Arbitrary-k k-mer support (64 < k <= 256): big-endian byte records.

A k-mer is represented as a fixed-width big-endian byte string of
``ceil(k/4)`` bytes - 4 bases per byte, first base in the top 2 bits,
zero-padded at the FRONT when k % 4 != 0 (matching the KMC suffix byte
layout, docs/formats/kmc.md). The records live in numpy ``S{nb}``
arrays, whose comparisons are memcmp-equivalent for fixed-width keys,
so ``np.sort`` / ``np.unique`` / ``np.searchsorted`` give exactly the
base-lexicographic (= numeric) k-mer order the narrow (uint64) and wide
(two-limb) paths use. Canonical = min(fwd, revcomp) by that order, as
in the reference (Data/Kmer.java:72-79,406-414; long[] k-mers at
Data/Kmer.java:17,44 support the same envelope - KMC itself caps k at
256).

This is the envelope tier: throughput matters less than correctness,
so everything is vectorized numpy feeding the SAME per-position
machinery (r_idx + u8 merge counts) as the fast paths - the native
window scan and the device engine are key-width agnostic from there on.
"""

import numpy as np


def n_bytes(k: int) -> int:
    return (k + 3) // 4


def pack_kmer_bytes(codes, valid, k: int):
    """All k-mers of a 2-bit code array as big-endian S{nb} records.

    Returns (keys (n_pos,) S{nb}, kvalid (n_pos,) bool). Invalid
    positions (any non-ACGT base in the k-mer) still carry packed
    bytes; kvalid masks them.
    """
    codes = np.ascontiguousarray(codes, np.uint8)
    n = codes.shape[0]
    n_pos = n - k + 1
    nb = n_bytes(k)
    if n_pos <= 0:
        return np.empty(0, f"S{nb}"), np.empty(0, bool)
    pad = nb * 4 - k  # leading zero bases in byte 0
    out = np.zeros((n_pos, nb), np.uint8)
    for i in range(pad, 4):  # byte 0: 4 - pad leading bases
        out[:, 0] |= codes[i - pad : i - pad + n_pos] << np.uint8(2 * (3 - i))
    for j in range(1, nb):
        o = 4 * j - pad
        out[:, j] = (
            (codes[o : o + n_pos] << np.uint8(6))
            | (codes[o + 1 : o + 1 + n_pos] << np.uint8(4))
            | (codes[o + 2 : o + 2 + n_pos] << np.uint8(2))
            | codes[o + 3 : o + 3 + n_pos]
        )
    cv = np.concatenate(([0], np.cumsum(valid.astype(np.int64))))
    kvalid = (cv[k:] - cv[:-k]) == k
    return out.view(f"S{nb}").ravel(), kvalid


def canonical_kmer_bytes(codes, valid, k: int, canonical: bool = True):
    """(keys, kvalid) with keys canonicalized when requested.

    revcomp is computed by packing the reverse-complemented sequence:
    rc(kmer at p) == kmer at (n_pos - 1 - p) of revcomp(seq)."""
    fwd, kvalid = pack_kmer_bytes(codes, valid, k)
    if not canonical or fwd.size == 0:
        return fwd, kvalid
    rcc = np.ascontiguousarray((np.uint8(3) - codes)[::-1])
    rc, _ = pack_kmer_bytes(rcc, valid[::-1], k)
    rc = rc[::-1]
    return np.where(fwd <= rc, fwd, rc), kvalid


def keys_to_bases(keys, k: int):
    """(n, k) uint8 base codes from S{nb} records."""
    nb = n_bytes(k)
    pad = nb * 4 - k
    arr = np.frombuffer(keys.tobytes(), np.uint8).reshape(-1, nb)
    bases = np.empty((arr.shape[0], k), np.uint8)
    for t in range(k):
        j, i = divmod(t + pad, 4)
        bases[:, t] = (arr[:, j] >> np.uint8(2 * (3 - i))) & np.uint8(3)
    return bases


def signatures_bytes(keys, k: int, sig_len: int, norm, chunk: int = 1 << 18):
    """KMC signature per key: min over all sig_len-mers of the norm map
    (Signature.java:23-76, Kmer.java:105-118)."""
    n = keys.shape[0]
    out = np.empty(n, np.uint32)
    n_off = k - sig_len + 1
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        bases = keys_to_bases(keys[lo:hi], k)
        mm = np.zeros((hi - lo, n_off), np.uint32)
        for i in range(sig_len):
            mm = (mm << np.uint32(2)) | bases[:, i : i + n_off]
        out[lo:hi] = norm[mm.astype(np.int64)].min(axis=1)
    return out


def merge_counts_u8_bytes(ref_sorted, db_sorted, db_counts, lo=0, hi=None,
                          out=None):
    """Sorted merge join for byte-record keys: u8-saturated counts over
    ref_sorted[lo:hi) plus the (index, exact uint32) exception list for
    counts >= 255 - the same contract as native merge_counts_u8."""
    if hi is None:
        hi = ref_sorted.shape[0]
    ref = ref_sorted[lo:hi]
    idx = np.searchsorted(db_sorted, ref)
    idxc = np.minimum(idx, max(db_sorted.shape[0] - 1, 0))
    if db_sorted.shape[0]:
        match = (idx < db_sorted.shape[0]) & (db_sorted[idxc] == ref)
    else:
        match = np.zeros(ref.shape[0], bool)
    c32 = np.where(match, db_counts[idxc], 0).astype(np.uint32)
    if out is None:
        out = np.empty(ref.shape[0], np.uint8)
    np.minimum(c32, 255, out=out, casting="unsafe")
    big = np.flatnonzero(c32 >= 255)
    return out, (big + lo).astype(np.int32), c32[big].astype(np.uint32)
