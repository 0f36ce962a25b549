"""Wide k-mer support (32 < k <= 64): two-limb uint64 arithmetic.

A wide k-mer is conceptually a 2k-bit big-endian packed value v. Two
representations are used:

* base-split (A, B): A = first n_hi = min(k, 32) bases, B = the
  remaining n_lo = k - 32 bases, each packed in the low bits of a
  uint64 (what the packing and reverse-complement math naturally
  produce);
* value limbs (hi, lo): hi = v >> 64, lo = v & 2^64-1 (what the native
  sort/search/merge functions compare as unsigned __int128).

Numeric order of v equals lexicographic base order in both cases, so
canonical = min(fwd, rc) is a (A, B) lexicographic comparison.

The reference supports arbitrary k via long[] arrays
(Data/Kmer.java:17,44); this covers the practical KMC envelope k <= 64.
The wide path feeds the hybrid (prefix-decomposition) engine; the device
hash engine remains k <= 32.
"""

import numpy as np

from .encode import pack_kmers, revcomp64

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def split_counts(k: int):
    n_hi = min(k, 32)
    return n_hi, k - n_hi


def pack_kmers_wide(codes, valid, k: int):
    """All k-mers as base-split (A, B) plus validity; k in (32, 64]."""
    n_hi, n_lo = split_counts(k)
    n_pos = codes.shape[0] - k + 1
    if n_pos <= 0:
        e = np.empty(0, np.uint64)
        return e, e, np.empty(0, bool)
    a_all, _ = pack_kmers(codes, np.ones_like(valid), n_hi)
    b_all, _ = pack_kmers(codes, np.ones_like(valid), n_lo)
    A = a_all[:n_pos]
    B = b_all[n_hi : n_hi + n_pos]
    cv = np.concatenate(([0], np.cumsum(valid.astype(np.int64))))
    kvalid = (cv[k:] - cv[:-k]) == k
    return A, B, kvalid


def revcomp_wide(A, B, k: int):
    """Reverse complement in base-split form."""
    n_hi, n_lo = split_counts(k)
    rcA = revcomp64(A, n_hi)  # rc of the first block (n_hi bases)
    rcB = revcomp64(B, n_lo)  # rc of the second block (n_lo bases)
    # rc(kmer) = rc(B) || rc(A); re-split into (first n_hi, last n_lo)
    if n_lo == n_hi:  # k == 64: the blocks swap wholesale
        return rcB, rcA
    out_A = (rcB << np.uint64(2 * (n_hi - n_lo))) | (rcA >> np.uint64(2 * n_lo))
    out_B = rcA & ((np.uint64(1) << np.uint64(2 * n_lo)) - np.uint64(1))
    return out_A, out_B


def canonicalize_wide(A, B, k: int):
    rA, rB = revcomp_wide(A, B, k)
    use_rc = (rA < A) | ((rA == A) & (rB < B))
    return np.where(use_rc, rA, A), np.where(use_rc, rB, B)


def to_value_limbs(A, B, k: int):
    """(A, B) base-split -> (hi, lo) 128-bit value limbs."""
    _n_hi, n_lo = split_counts(k)
    s = 2 * n_lo
    if s == 64:
        return A.astype(np.uint64), B.astype(np.uint64)
    lo = ((A << np.uint64(s)) & _M64) | B
    hi = A >> np.uint64(64 - s)
    return hi, lo


def from_value_limbs(hi, lo, k: int):
    _n_hi, n_lo = split_counts(k)
    s = 2 * n_lo
    if s == 64:
        return hi.astype(np.uint64), lo.astype(np.uint64)
    B = lo & ((np.uint64(1) << np.uint64(s)) - np.uint64(1))
    A = (lo >> np.uint64(s)) | ((hi << np.uint64(64 - s)) & _M64)
    return A, B


def wide_kmer_to_str(hi, lo, k: int) -> str:
    v = (int(hi) << 64) | int(lo)
    return "".join("ACGT"[(v >> (2 * (k - 1 - i))) & 3] for i in range(k))


def str_to_wide_kmer(s: str):
    v = 0
    for ch in s:
        v = (v << 2) | "ACGT".index(ch)
    return np.uint64(v >> 64), np.uint64(v & 0xFFFFFFFFFFFFFFFF)
