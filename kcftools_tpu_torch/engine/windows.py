"""Window generation and fixed-shape batching for the device pipeline.

Window semantics follow the reference exactly
(Plugins/GetVariants.java:278-352):

* tiling (step == 0): consecutive windows overlap by k-1 bases so no
  k-mer spans a boundary unseen; windows shorter than k are dropped.
* sliding (step > 0): starts at multiples of step, same drop rule.
* gene/transcript: one window per GTF feature, scored on its spliced
  sequence.

Variable-length windows are padded into (B, Lp) batches; gene windows
are bucketed by padded length (powers of two) to bound recompilation.
"""

import numpy as np

# extra zero codes after the longest window (>= 32; see ops.kmerize);
# lives here so the host tier can import it without pulling in JAX
PAD_MARGIN = 32


def tiling_windows(seq_len: int, window_size: int, k: int):
    """Reference tiling loop: start = max(0, lastEnd - k + 1)."""
    starts, ends = [], []
    last_end = 0
    while last_end < seq_len:
        start = max(0, last_end - k + 1)
        end = min(start + window_size, seq_len)
        if end - start >= k:
            starts.append(start)
            ends.append(end)
        if end <= last_end:
            break  # no progress (window_size <= k-1); reference would hang
        last_end = end
    return np.array(starts, np.int64), np.array(ends, np.int64)


def sliding_windows(seq_len: int, window_size: int, step: int, k: int):
    starts, ends = [], []
    pos = 0
    while pos < seq_len:
        start = pos
        end = min(start + window_size, seq_len)
        if end - start >= k:
            starts.append(start)
            ends.append(end)
        pos += step
    return np.array(starts, np.int64), np.array(ends, np.int64)


def batch_subsequences(codes, valid, starts, ends, pad_len: int):
    """Gather windows [start, end) of a chromosome-level code array into a
    zero-padded (B, pad_len) batch. pad_len must be >= max window length
    + PAD_MARGIN."""
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    win_len = ends - starts
    B = len(starts)
    idx = starts[:, None] + np.arange(pad_len, dtype=np.int64)[None, :]
    in_win = idx < ends[:, None]
    idx = np.minimum(idx, codes.shape[0] - 1)
    bcodes = codes[idx].astype(np.uint32)
    bvalid = valid[idx] & in_win
    bcodes = np.where(bvalid, bcodes, 0).astype(np.uint32)
    return bcodes, bvalid, win_len.astype(np.int32)


def pad_batch_varlen(code_list, valid_list, pad_len: int):
    """Stack variable-length (codes, valid) pairs into a padded batch."""
    B = len(code_list)
    bcodes = np.zeros((B, pad_len), np.uint32)
    bvalid = np.zeros((B, pad_len), bool)
    win_len = np.zeros(B, np.int32)
    for i, (c, v) in enumerate(zip(code_list, valid_list)):
        n = len(c)
        win_len[i] = n
        bcodes[i, :n] = np.where(v, c, 0)
        bvalid[i, :n] = v
    return bcodes, bvalid, win_len


def bucket_pad_len(length: int, k: int) -> int:
    """Power-of-two padded length for a variable-length window."""
    need = max(length + PAD_MARGIN, k + PAD_MARGIN, 64)
    p = 64
    while p < need:
        p <<= 1
    return p
