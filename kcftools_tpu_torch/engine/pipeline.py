"""The on-chip hash engine's window scoring pipeline.

Port of kcftools_tpu/engine/pipeline.py, the engine behind
``getVariations -f gene|transcript --engine device`` (k <= 32). For a
padded batch of windows it computes, on the device with no sequential
host loops:

  sentinel-coded bytes -> canonical k-mers -> bucketed hash-table
  lookups -> per-window gap-run statistics.

On the card a batch is two kernel launches (ops/hashscan.py:
``hash_probe``, then ``hash_scan``; csrc/hashscan.cu). On the CPU they
take their plain versions, the torch ops that ``score_windows_core``
composes (``hash_probe_ref``'s k-mers, any lookup, ``hash_scan_ref``):
the gap-run state machine of Plugins/GetVariants.java:219-251 as a
data-parallel formulation (``gap_scan_core``, ops/hashscan.py) in which,
with ``vidx`` the ordinal of each valid k-mer and ``prev`` the ordinal
of the previous present k-mer (an exclusive running max), every gap
statistic is an elementwise expression plus a masked sum, with the
reference's distance correction d <= 0 -> |d+1| (GetVariants.java:
267-273). Effective length (ACGT stretches >= k, Data/Fasta.java:
140-167) uses the same running-max trick on base-level validity runs.

All sums are int64: the count sum is exact, where the JAX version sums
in float64 (exact below 2^53). Besides padded window batches
(``score_batch_async``), a scorer takes the chunked interface
(``score_chunk_async``, ``_score_chunk``): one chromosome chunk uploaded
once, its windows gathered on the device. The mesh-sharded version of
this engine is parallel/sharded.py.
"""

import numpy as np
import torch

from ..ops import hashscan
from ..ops.hashscan import (  # noqa: F401  (the plain scan, re-exported)
    FIELDS,
    gap_scan_core,
    hash_probe,
    hash_scan,
    hash_scan_ref,
    kmers_ref,
)

# sentinel code for non-ACGT / out-of-window positions in uint8 inputs
SENTINEL = np.uint8(hashscan.SENTINEL)


def score_windows_core(codes, valid, win_len, lookup_fn, *, k: int,
                       min_count: int, both_strands: bool):
    """codes: (B, Lp) int64 2-bit codes (zero padded; Lp >= longest
    window + PAD_MARGIN); valid: (B, Lp) bool, ACGT and inside the
    window; win_len: (B,) int64 window lengths. ``lookup_fn`` maps
    (hi, lo) query tensors to int64 counts.

    The two plain versions composed on the sentinel-coded rows: the
    k-mers of ``hash_probe_ref`` looked up by ``lookup_fn``, then
    ``hash_scan_ref``. Returns a dict of (B,) int64: total, observed,
    variations, inner, left, right, count_sum, eff_length."""
    u8 = torch.where(valid, codes, int(SENTINEL))
    hi, lo = kmers_ref(u8, k=k, both_strands=both_strands)
    res = hash_scan_ref(u8, lookup_fn(hi, lo), win_len, k=k,
                        min_count=min_count)
    return dict(zip(FIELDS, res))


def _score_u8_batch(u8, win_len, tbl, *, k, min_count, both_strands):
    """u8: (B, Lp) uint8 codes with SENTINEL marking invalid positions;
    tbl: the (nb, 12) int32 table. Two launches on the card
    (``hash_probe``, ``hash_scan``). Returns one (8, B) int64 tensor
    (FIELDS order)."""
    counts = hash_probe(u8, win_len, tbl, k=k, both_strands=both_strands)
    return hash_scan(u8, counts, win_len, k=k, min_count=min_count)


def _score_chunk(chunk_u8, starts, win_len, tbl, *, Lp, k, min_count,
                 both_strands):
    """chunk_u8: (C,) uint8 sentinel codes of a chromosome chunk;
    starts / win_len: (B,) int64. The windows are gathered on the
    device, so the host uploads each base once. Returns (8, B) int64."""
    idx = starts[:, None] + torch.arange(Lp, device=chunk_u8.device)
    u8 = chunk_u8[torch.clamp(idx, max=chunk_u8.shape[0] - 1)]
    pos = torch.arange(Lp, device=chunk_u8.device)[None, :]
    u8 = torch.where(pos < win_len[:, None], u8, int(SENTINEL))
    return _score_u8_batch(u8, win_len, tbl, k=k, min_count=min_count,
                           both_strands=both_strands)


def combine_u8(codes: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Host-side: merge (codes, valid) into sentinel-coded uint8."""
    return np.where(valid, codes.astype(np.uint8), SENTINEL)


def _unstack(arr: np.ndarray):
    return {f: arr[i] for i, f in enumerate(FIELDS)}


def _table_tensor(table, device):
    """The host table's (nb, 3*S) uint32 array as an int32 tensor with
    the same bits, on ``device``."""
    return torch.from_numpy(
        np.ascontiguousarray(table.tbl, np.uint32).view(np.int32)
    ).to(device)


class WindowScorer:
    """A KmerTable on the device + scoring of padded window batches: one
    uint8 upload and one (8, B) int64 result per batch."""

    def __init__(self, table, device, min_count: int = 1):
        self.k = table.k
        self.min_count = int(min_count)
        self.both_strands = table.both_strands
        self.device = torch.device(device)
        self.tbl = _table_tensor(table, self.device)

    def set_table(self, table):
        """Swap in a new sample's table (same k and strandedness), so
        that one scorer serves every sample of a run."""
        if table.k != self.k or table.both_strands != self.both_strands:
            raise ValueError("table k/strandedness changed; new scorer needed")
        self.tbl = _table_tensor(table, self.device)

    def score_batch_async(self, codes, valid, win_len):
        """Dispatch one padded batch; returns the (8, B) device tensor."""
        u8 = combine_u8(np.asarray(codes), np.asarray(valid))
        return _score_u8_batch(
            torch.from_numpy(u8).to(self.device),
            torch.from_numpy(np.asarray(win_len, np.int64)).to(self.device),
            self.tbl, k=self.k, min_count=self.min_count,
            both_strands=self.both_strands,
        )

    def score_batch(self, codes, valid, win_len):
        return self.collect(self.score_batch_async(codes, valid, win_len))

    def score_chunk_async(self, chunk_u8, starts, win_len, Lp: int):
        """chunk_u8: (C,) sentinel codes (a host array or a device
        tensor); starts / win_len: (B,) window starts in the chunk and
        lengths. Returns the (8, B) device tensor."""
        if not isinstance(chunk_u8, torch.Tensor):
            chunk_u8 = torch.from_numpy(np.asarray(chunk_u8, np.uint8))
        return _score_chunk(
            chunk_u8.to(self.device),
            torch.from_numpy(np.asarray(starts, np.int64)).to(self.device),
            torch.from_numpy(np.asarray(win_len, np.int64)).to(self.device),
            self.tbl, Lp=int(Lp), k=self.k, min_count=self.min_count,
            both_strands=self.both_strands,
        )

    @staticmethod
    def collect(handle) -> dict:
        """Resolve a batch's device tensor into a dict of host arrays."""
        return _unstack(handle.cpu().numpy())
