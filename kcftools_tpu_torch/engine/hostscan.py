"""Host-side ordinal-space window scanner.

The fused positional scan (native kcf_window_scan_u8) pays one random
gather into the merge output per k-mer position, every sample. When
MANY samples are screened against one reference, it is cheaper to
build the slab's occurrence map once (positions sorted by reference
ordinal, identity-run segments - the same statics the device engine
uses) and score each sample with sequential streams:

    ordpack            presence bitmap + count-sum corrections
                       (no gather; work only on absent / non-unit
                       count lanes)
    window_stats_bits  gap-run state machine over bit words
    count_sum          observed + corrections

Results are bit-identical to window_scan_u8 (tests/test_ordpack.py
pins all fields). The build cost (one radix sort over the positions,
~80 ms per 5 Mbp) amortizes across samples; callers choose this path
when the sample count clears ``WORTH_SAMPLES``.

Reference semantics replaced: Plugins/GetVariants.java:202-261 (the
per-k-mer count lookup + gap-run machine).
"""

import numpy as np

from ..native import (
    _uniform_window_map,
    build_ordmap,
    ordpack,
    window_stats_bits,
)

# rough break-even: the one-time ordinal map build vs per-sample
# savings over the gather-based scan
WORTH_SAMPLES = 12


class OrdinalWindowScanner:
    """Per-(chromosome, windows) host scanner; score many samples."""

    def __init__(self, r_idx, w_start, w_hi, k, min_count=1):
        self.k = int(k)
        self.min_count = int(min_count)
        self.w_start = np.ascontiguousarray(w_start, np.int32)
        self.w_hi = np.ascontiguousarray(w_hi, np.int32)
        n_pos = r_idx.shape[0]
        self.n_pos = n_pos
        self.nbb = (n_pos + 7) // 8
        vb = np.packbits(
            np.ascontiguousarray(r_idx, np.int32) >= 0, bitorder="little"
        )
        if vb.shape[0] < self.nbb:
            vb = np.concatenate(
                [vb, np.zeros(self.nbb - vb.shape[0], np.uint8)]
            )
        self.valid_bits = vb
        self.ordmap = build_ordmap(r_idx)
        self.uni = _uniform_window_map(self.w_start, self.w_hi)

    @staticmethod
    def usable(w_start, w_hi) -> bool:
        """Sorted, non-overlapping windows (the corr window mapping's
        requirement; tiling mode and most feature layouts)."""
        n = len(w_start)
        if n < 2:
            return True
        ws = np.asarray(w_start)
        wh = np.asarray(w_hi)
        return bool((ws[1:] > wh[:-1]).all() and (ws[1:] >= ws[:-1]).all())

    def score(self, counts_u8, exc_idx, exc_val):
        """One sample's window statistics (same fields and values as
        native.window_scan_u8), or None when the native stats walk is
        unavailable (caller falls back)."""
        occ_ord, occ_pos, seg_off, seg_ord = self.ordmap
        pres, corr = ordpack(
            counts_u8, exc_idx, exc_val, occ_ord, occ_pos,
            self.min_count, self.w_start, self.w_hi, self.valid_bits,
            self.nbb, uni=self.uni, seg_off=seg_off, seg_ord=seg_ord,
        )
        st = window_stats_bits(
            pres, self.valid_bits, self.n_pos, self.k, self.w_start,
            self.w_hi,
        )
        if st is None:
            return None
        st["count_sum"] = st["observed"] + corr
        return st
