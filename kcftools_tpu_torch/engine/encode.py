"""Host-side vectorized 2-bit k-mer packing and canonicalization.

Packing convention (shared with io.kmc and the device pipeline): a k-mer
occupies the low 2k bits of a uint64, first base in the most-significant
2-bit group (A=0 C=1 G=2 T=3). Lexicographic order of the base string
equals unsigned numeric order of the packed value, so canonical =
min(fwd, revcomp) matches the reference's big-endian long-array compare
(reference: Data/Kmer.java:72-79,406-414).
"""

import numpy as np

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_M8 = np.uint64(0x00FF00FF00FF00FF)
_M16 = np.uint64(0x0000FFFF0000FFFF)


def revcomp64(kmers: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of packed k-mers, vectorized bit-twiddling."""
    x = np.asarray(kmers, dtype=np.uint64)
    mask = np.uint64((1 << (2 * k)) - 1) if k < 32 else np.uint64(0xFFFFFFFFFFFFFFFF)
    y = (~x) & mask
    # reverse the 32 2-bit groups of the 64-bit word
    y = ((y & _M2) << np.uint64(2)) | ((y >> np.uint64(2)) & _M2)
    y = ((y & _M4) << np.uint64(4)) | ((y >> np.uint64(4)) & _M4)
    y = ((y & _M8) << np.uint64(8)) | ((y >> np.uint64(8)) & _M8)
    y = ((y & _M16) << np.uint64(16)) | ((y >> np.uint64(16)) & _M16)
    y = (y << np.uint64(32)) | (y >> np.uint64(32))
    return y >> np.uint64(64 - 2 * k)


def canonicalize(kmers: np.ndarray, k: int) -> np.ndarray:
    return np.minimum(kmers, revcomp64(kmers, k))


def pack_kmers(codes: np.ndarray, valid: np.ndarray, k: int):
    """All k-mers of a code sequence.

    Returns (kmers uint64 (L-k+1,), kmer_valid bool (L-k+1,)) where
    kmer_valid[i] means all k bases starting at i are ACGT - the engine's
    equivalent of the reference's N-reset k-mer extraction
    (Data/Fasta.java:90-127).
    """
    codes = np.asarray(codes, dtype=np.uint64)
    valid = np.asarray(valid, dtype=bool)
    n = codes.shape[0] - k + 1
    if n <= 0:
        return np.empty(0, np.uint64), np.empty(0, bool)
    kmers = np.zeros(n, dtype=np.uint64)
    for t in range(k):
        kmers |= codes[t : t + n] << np.uint64(2 * (k - 1 - t))
    cv = np.concatenate(([0], np.cumsum(valid.astype(np.int64))))
    kmer_valid = (cv[k:] - cv[:-k]) == k
    return kmers, kmer_valid


def split_hi_lo(kmers: np.ndarray, k: int):
    """Split packed k-mers into (hi, lo) uint32: hi = first min(k,16)
    bases, lo = the remaining k-16 (0 when k <= 16). This is the key
    layout used by the hash table and the device pipeline (TPUs have no
    native 64-bit integers)."""
    kmers = np.asarray(kmers, dtype=np.uint64)
    n_hi = min(k, 16)
    n_lo = k - n_hi
    hi = (kmers >> np.uint64(2 * n_lo)).astype(np.uint32)
    lo = (kmers & np.uint64((1 << (2 * n_lo)) - 1)).astype(np.uint32)
    return hi, lo


def join_hi_lo(hi, lo, k: int) -> np.ndarray:
    n_lo = k - min(k, 16)
    return (np.asarray(hi, np.uint64) << np.uint64(2 * n_lo)) | np.asarray(
        lo, np.uint64
    )


def kmer_to_str(kmer: int, k: int) -> str:
    return "".join("ACGT"[(int(kmer) >> (2 * (k - 1 - i))) & 3] for i in range(k))


def str_to_kmer(s: str) -> int:
    v = 0
    for ch in s:
        v = (v << 2) | "ACGT".index(ch)
    return v
