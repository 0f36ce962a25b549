"""Canonical k-mer extraction over padded window batches, in torch.

Port of kcftools_tpu/ops/kmerize.py. k-mers are (hi, lo) pairs of 32-bit
values: hi = the first min(k, 16) bases big-endian, lo = the remaining
k - 16. Both halves of both strands come from two 16-base rolling packs
built with 16 shift-or passes. Let c[j] be the 2-bit code at position j
(windows padded with zeros):

  w32[j]   = sum_t c[j+t] * 4^(15-t)      (big-endian 16-mer at j)
  rcw32[j] = sum_t (3-c[j+t]) * 4^t       (little-endian complement)

then for a k-mer starting at i with n_hi = min(k, 16), n_lo = k - 16:

  fwd_hi = w32[i]        >> 2*(16-n_hi)
  fwd_lo = w32[i+n_hi]   >> 2*(16-n_lo)
  rc_hi  = rcw32[i+k-n_hi] & (4^n_hi - 1)
  rc_lo  = rcw32[i]        & (4^n_lo - 1)

Canonical = lexicographic min (Data/Kmer.java:72-79). These build the
plain version's k-mers (ops/hashscan.py::hash_probe_ref); on the card the
probe kernel csrc/hashscan.cu builds each one as a 64-bit value.

torch has no uint32 shifts or compares on the CPU, so the 32-bit values
are carried in int64 tensors. Every value stays in [0, 2^32), where
int64 shifts and compares are the unsigned ones.
"""

import torch


def rolling_pack_u32(codes_padded):
    """codes_padded: (..., Lp) int64 codes in 0..3 (padded with >= 16
    zeros past any queried offset). Returns (w32, rcw32), (..., Lp-16)
    int64 in [0, 2^32)."""
    n = codes_padded.shape[-1] - 16
    w32 = torch.zeros(codes_padded.shape[:-1] + (n,), dtype=torch.int64,
                      device=codes_padded.device)
    rcw32 = torch.zeros_like(w32)
    for t in range(16):
        c = codes_padded[..., t : t + n]
        w32 |= c << (2 * (15 - t))
        rcw32 |= ((3 - c) & 3) << (2 * t)
    return w32, rcw32


def assemble_kmers(w32, rcw32, k: int, n_out: int):
    """(fwd_hi, fwd_lo, rc_hi, rc_lo) for k-mer start positions
    0..n_out-1. w32/rcw32 must cover offsets up to n_out + k."""
    n_hi = min(k, 16)
    n_lo = k - n_hi
    fwd_hi = w32[..., 0:n_out]
    if n_hi < 16:
        fwd_hi = fwd_hi >> (2 * (16 - n_hi))
    if n_lo > 0:
        fwd_lo = w32[..., n_hi : n_hi + n_out] >> (2 * (16 - n_lo))
    else:
        fwd_lo = torch.zeros_like(fwd_hi)
    rc_hi = rcw32[..., k - n_hi : k - n_hi + n_out] & ((1 << (2 * n_hi)) - 1)
    if n_lo > 0:
        rc_lo = rcw32[..., 0:n_out] & ((1 << (2 * n_lo)) - 1)
    else:
        rc_lo = torch.zeros_like(rc_hi)
    return fwd_hi, fwd_lo, rc_hi, rc_lo


def canonical_select(fwd_hi, fwd_lo, rc_hi, rc_lo):
    use_rc = (rc_hi < fwd_hi) | ((rc_hi == fwd_hi) & (rc_lo < fwd_lo))
    return torch.where(use_rc, rc_hi, fwd_hi), torch.where(use_rc, rc_lo,
                                                           fwd_lo)
