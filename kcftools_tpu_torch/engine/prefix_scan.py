"""O(L + n_windows) window scoring via global prefix decomposition.

The reference recomputes the gap-run state machine per window, O(W) per
window with windows overlapping k-1 bases. But every per-window statistic
decomposes over *global* per-chromosome arrays:

* totals/observed/count sums - prefix-sum differences over k-mer start
  positions [s, e-k];
* interior gaps - a gap between two consecutive present k-mers is a
  property of the chromosome, not the window: a window's interior gaps
  are exactly the global gaps whose both endpoints fall in its range, so
  per-present-k-mer prefix sums of gap counts / corrected distances
  (GetVariants.java:267-273 semantics) give each window's variations and
  inner distance as two differences;
* leading/trailing tails - valid-k-mer ordinal differences to the
  first/last present k-mer in range (binary search into the present
  position list);
* effective length - ACGT runs clipped to the window: two clipped edge
  runs plus a prefix sum over fully-contained runs >= k.

Everything is vectorized numpy over all windows at once. This is the
default engine for fixed/sliding windows; the device engines (see
pipeline.py) remain for spliced features and sharded tables and produce
identical results (tests/test_engines_agree.py).
"""

import numpy as np


def chromosome_stats(counts_pos, kmer_valid_pos, base_valid, min_count, k,
                     r_idx=None):
    """Precompute global arrays for one chromosome.

    counts_pos: (n_pos,) uint32 count of the k-mer starting at each
    position (0 where invalid); kmer_valid_pos: (n_pos,) bool;
    base_valid: (L,) bool. When ``r_idx`` (int32, -1 = invalid) is given,
    the fused native C++ pass is used.
    """
    if r_idx is not None:
        from ..native import chrom_stats_native

        st = chrom_stats_native(counts_pos, r_idx, base_valid, min_count, k)
        if st is not None:
            return st
    return chromosome_stats_numpy(
        counts_pos, kmer_valid_pos, base_valid, min_count, k
    )


def chromosome_stats_indirect(counts_r, r_idx, base_valid, min_count, k):
    """counts_r is the per-unique-kmer count table. The per-position
    gather runs as its own tight pass (a dedicated gather loop overlaps
    cache misses far better than a gather fused into the stats scan),
    then the fused native stats pass consumes the positional counts."""
    from ..native import gather_counts

    counts_pos = gather_counts(np.asarray(counts_r, np.uint32), r_idx)
    return chromosome_stats(
        counts_pos, r_idx >= 0, base_valid, min_count, k, r_idx=r_idx
    )


def chromosome_stats_numpy(counts_pos, kmer_valid_pos, base_valid, min_count, k):
    n_pos = counts_pos.shape[0]
    present_pos = (counts_pos >= np.uint32(min_count)) & kmer_valid_pos

    cs_tot = np.zeros(n_pos + 1, np.int64)
    np.cumsum(kmer_valid_pos, out=cs_tot[1:])
    cs_obs = np.zeros(n_pos + 1, np.int64)
    np.cumsum(present_pos, out=cs_obs[1:])
    cs_cnt = np.zeros(n_pos + 1, np.int64)
    np.cumsum(np.where(present_pos, counts_pos, 0).astype(np.int64), out=cs_cnt[1:])

    pp = np.flatnonzero(present_pos)  # positions of present k-mers
    # gap before each present k-mer, in valid-k-mer ordinals
    ords = cs_tot[pp]  # ordinal of each present k-mer
    gaps = np.empty(pp.shape[0], np.int64)
    if pp.size:
        gaps[0] = 0  # the global-first gap is never interior
        gaps[1:] = ords[1:] - ords[:-1] - 1
    d = gaps - (k - 1)
    dist = np.where(d > 0, d, np.abs(d + 1))
    has_gap = gaps > 0
    p_var = np.zeros(pp.shape[0] + 1, np.int64)
    np.cumsum(has_gap, out=p_var[1:])
    p_dist = np.zeros(pp.shape[0] + 1, np.int64)
    np.cumsum(np.where(has_gap, dist, 0), out=p_dist[1:])

    # base-validity runs for effective length
    bv = np.asarray(base_valid, bool)
    padded = np.concatenate(([False], bv, [False]))
    diff = np.diff(padded.astype(np.int8))
    run_start = np.flatnonzero(diff == 1)
    run_end = np.flatnonzero(diff == -1)  # exclusive
    run_len = run_end - run_start
    qual = np.where(run_len >= k, run_len, 0)
    f_run = np.zeros(run_start.shape[0] + 1, np.int64)
    np.cumsum(qual, out=f_run[1:])

    return {
        "cs_tot": cs_tot,
        "cs_obs": cs_obs,
        "cs_cnt": cs_cnt,
        "pp": pp,
        "p_var": p_var,
        "p_dist": p_dist,
        "run_start": run_start,
        "run_end": run_end,
        "f_run": f_run,
        "k": k,
    }


def static_window_stats(r_idx, base_valid, k, starts, ends):
    """Sample-independent per-window fields (total k-mers, effective
    length), computed once per (reference, window geometry) and reused
    across samples by the fused-scan and device engines."""
    zeros = np.zeros(r_idx.shape[0], np.uint32)
    st = chromosome_stats_numpy(zeros, r_idx >= 0, base_valid, 1, k)
    res = window_stats(st, starts, ends)
    return res["total"], res["eff_length"]


def window_stats(st, starts, ends):
    """Vectorized per-window statistics from chromosome_stats arrays.

    starts/ends: (B,) window ranges (half-open, base coordinates,
    end - start >= k). Returns the engine's standard 8-field dict.
    """
    k = st["k"]
    # match index dtypes to the stats arrays: searchsorted silently
    # promotes (and copies) the searched array on dtype mismatch
    idx_dtype = st["pp"].dtype if st["pp"].size else np.int64
    starts = np.asarray(starts).astype(idx_dtype)
    ends = np.asarray(ends).astype(idx_dtype)
    s = starts
    hi = ends - k  # last k-mer start position (inclusive)

    cs_tot, cs_obs, cs_cnt = st["cs_tot"], st["cs_obs"], st["cs_cnt"]
    total = cs_tot[hi + 1] - cs_tot[s]
    observed = cs_obs[hi + 1] - cs_obs[s]
    count_sum = cs_cnt[hi + 1] - cs_cnt[s]

    pp, p_var, p_dist = st["pp"], st["p_var"], st["p_dist"]
    jf = np.searchsorted(pp, s, side="left")
    jl = np.searchsorted(pp, hi, side="right") - 1
    has_present = observed > 0

    jf_c = np.minimum(jf, max(pp.size - 1, 0))
    jl_c = np.maximum(jl, 0)
    if pp.size:
        first_p = pp[jf_c]
        last_p = pp[jl_c]
    else:
        first_p = np.zeros_like(s)
        last_p = np.zeros_like(s)

    left = np.where(has_present, cs_tot[first_p] - cs_tot[s], 0)
    right = np.where(
        has_present,
        cs_tot[hi + 1] - cs_tot[np.minimum(last_p + 1, len(cs_tot) - 1)],
        total,  # nothing present: the whole window is one trailing gap
    )
    pj_hi = np.minimum(jl_c + 1, len(p_dist) - 1)
    pj_lo = np.minimum(jf_c + 1, len(p_dist) - 1)
    inner = np.where(has_present, p_dist[pj_hi] - p_dist[pj_lo], 0)
    var_interior = np.where(has_present, p_var[pj_hi] - p_var[pj_lo], 0)
    variations = np.where(
        has_present,
        var_interior + (left > 0) + (right > 0),
        (total > 0).astype(np.int64),
    )

    # effective length
    rs, re, f_run = st["run_start"], st["run_end"], st["f_run"]
    a = np.searchsorted(re, s, side="right")  # first run ending after s
    b = np.searchsorted(rs, ends, side="left") - 1  # last run starting before e
    eff = np.zeros(len(s), np.int64)
    if rs.size:
        a_c = np.minimum(a, rs.size - 1)
        b_c = np.maximum(b, 0)
        one_run = (a == b) & (a <= b)
        multi = a < b
        # single overlapping run, clipped both sides
        len1 = np.minimum(re[a_c], ends) - np.maximum(rs[a_c], s)
        eff = np.where(one_run & (len1 >= k), len1, 0)
        # first run clipped left, last clipped right, middles full
        len_a = re[a_c] - np.maximum(rs[a_c], s)
        len_b = np.minimum(re[b_c], ends) - rs[b_c]
        mid = f_run[np.maximum(b_c, a_c)] - f_run[np.minimum(a_c + 1, len(f_run) - 1)]
        eff = np.where(
            multi,
            np.where(len_a >= k, len_a, 0)
            + np.where(len_b >= k, len_b, 0)
            + mid,
            eff,
        )

    return {
        "total": total,
        "observed": observed,
        "variations": variations,
        "inner": inner,
        "left": left,
        "right": right,
        "count_sum": count_sum,
        "eff_length": eff,
    }
