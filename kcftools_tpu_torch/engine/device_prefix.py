"""The gap-run prefix scan and the slab layout, in torch.

Port of the device-independent parts of
kcftools_tpu/engine/device_prefix.py that the device-join engine runs:
``_scan_core`` (the per-window gap-run state machine of
Plugins/GetVariants.java:219-273 as prefix scans plus O(1) boundary
gathers) and ``_Layout`` / ``_FIELDS`` (host code, carried over
unchanged because the JAX module cannot be imported without jax).

The scans are plain torch ops: ``torch.cumsum``, ``torch.cummax``, a
reverse cummin as flip / cummin / flip, and index gathers. All prefix
sums are int64, so the inner-distance sum is exact where the JAX
version keeps a uint32 modular prefix. The rest of the JAX module
(``DevicePrefixScorer``, ``_score_runs``, ``_score_batch``) is not
ported yet.
"""

import numpy as np
import torch

_POS_BUCKET = 1 << 20  # slab position padding granularity
_WIN_BUCKET = 1 << 10  # slab window padding granularity
_SEG_ALIGN = 64  # segments start on bit-word boundaries
_SCAN_BLK = 512  # small-slab padding granule


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _cummin_rev(x):
    return torch.flip(torch.cummin(torch.flip(x, [0]), 0).values, [0])


def _scan_core(pr, cs_tot, w_start, w_hi, *, k: int):
    """One sample's window statistics from per-position presence.

    pr: (n,) bool presence over k-mer start positions; cs_tot: (n+1,)
    int64 prefix counts of valid k-mers; w_start / w_hi: (win_pad,)
    int64 first / last k-mer start of each window (inclusive, slab
    coordinates). Returns (5, win_pad) int64 rows: observed,
    variations, inner, left, right.
    """
    n = pr.shape[0]
    dev = pr.device
    vidx = cs_tot[1:] - 1  # valid ordinal at each position (where valid)
    pos = torch.arange(n, device=dev)
    s = w_start
    hi = w_hi
    total = cs_tot[hi + 1] - cs_tot[s]
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    minus1 = torch.full((1,), -1, dtype=torch.int64, device=dev)

    pres_ord = torch.where(pr, vidx, -1)
    prev_ord = torch.cummax(torch.cat([minus1, pres_ord[:-1]]), 0).values
    next_ge = _cummin_rev(torch.where(pr, pos, n))
    last_le = torch.cummax(torch.where(pr, pos, -1), 0).values

    cs_obs = torch.cat([zero, torch.cumsum(pr, 0, dtype=torch.int64)])
    gap = vidx - prev_ord - 1
    closed = pr & (prev_ord >= 0) & (gap > 0)
    d = gap - (k - 1)
    dist = torch.where(d > 0, d, torch.abs(d + 1))
    cs_var = torch.cat([zero, torch.cumsum(closed, 0, dtype=torch.int64)])
    cs_dist = torch.cat([zero, torch.cumsum(torch.where(closed, dist, 0), 0)])

    observed = cs_obs[hi + 1] - cs_obs[s]
    has = observed > 0
    fp = torch.clamp(next_ge[s], 0, n - 1)
    lp = torch.clamp(last_le[hi], 0, n - 1)
    left = torch.where(has, cs_tot[fp] - cs_tot[s], 0)
    right = torch.where(has, cs_tot[hi + 1] - cs_tot[lp + 1], total)
    inner = torch.where(has, cs_dist[hi + 1] - cs_dist[fp + 1], 0)
    var_int = torch.where(has, cs_var[hi + 1] - cs_var[fp + 1], 0)
    variations = torch.where(
        has,
        var_int + (left > 0).long() + (right > 0).long(),
        (total > 0).long(),
    )
    return torch.stack([observed, variations, inner, left, right])


class _Layout:
    """Chromosomes -> window-aligned segments -> fixed-shape slabs."""

    def __init__(self, k, slab_pos):
        self.k = int(k)
        self.slab_pos = int(slab_pos)
        self._chroms = []  # (name, r_idx, w_start, w_hi)
        self.slabs = None

    def add_chrom(self, name, r_idx, starts, ends):
        w_start = np.ascontiguousarray(starts, np.int32)
        w_hi = (np.asarray(ends, np.int64) - self.k).astype(np.int32)
        self.add_chrom_kcoords(name, r_idx, w_start, w_hi)

    def add_chrom_kcoords(self, name, r_idx, w_start, w_hi):
        """Windows already in k-mer start coordinates (feature mode).
        Windows shorter than k (w_hi < w_start) clamp to the empty
        range [s, s-1]: zero totals, zero stats."""
        w_start = np.ascontiguousarray(w_start, np.int32)
        w_hi = np.maximum(
            np.ascontiguousarray(w_hi, np.int32), w_start - 1
        )
        self._chroms.append(
            (name, np.ascontiguousarray(r_idx, np.int32), w_start, w_hi)
        )

    def _segments(self):
        """Split each chromosome's window list into runs whose position
        span fits one slab. Window k-mer ranges never straddle a
        segment, so per-window stats are exact under any split."""
        segs = []
        for name, r_idx, w_start, w_hi in self._chroms:
            n_win = len(w_start)
            i = 0
            while i < n_win:
                base = int(w_start[i])
                j = i
                endp = int(w_hi[i])
                while j + 1 < n_win:
                    ne = max(endp, int(w_hi[j + 1]))
                    nb = min(base, int(w_start[j + 1]))
                    if ne - nb + 1 > self.slab_pos:
                        break
                    j += 1
                    endp = ne
                    base = nb
                endp = min(endp, r_idx.shape[0] - 1)
                if endp < base:
                    endp = base
                segs.append(
                    {
                        "chrom": name,
                        "r_idx": r_idx[base : endp + 1],
                        "w_start": w_start[i : j + 1] - base,
                        "w_hi": np.minimum(w_hi[i : j + 1], endp) - base,
                        "c_off": i,
                    }
                )
                i = j + 1
        return segs

    def finalize(self, n_parts: int = 1):
        if self.slabs is not None:
            return
        if n_parts > 1:
            # shard the genome across devices: aim for >= n_parts slabs
            # (window-aligned, so per-window stats stay exact)
            total = sum(c[1].shape[0] for c in self._chroms)
            self.slab_pos = max(
                _SEG_ALIGN, min(self.slab_pos, -(-total // n_parts))
            )
        segs = self._segments()
        # first-fit in order into slabs of <= slab_pos positions
        groups = []
        cur, cur_pos = [], 0
        for seg in segs:
            seg_len = _round_up(seg["r_idx"].shape[0], _SEG_ALIGN)
            if cur and cur_pos + seg_len > self.slab_pos:
                groups.append(cur)
                cur, cur_pos = [], 0
            cur.append(seg)
            cur_pos += seg_len
        if cur:
            groups.append(cur)

        if not groups:
            self.pos_pad = _SEG_ALIGN
            self.win_pad = 64
            self.slabs = []
            self.chrom_n_win = {
                name: len(ws) for name, _r, ws, _h in self._chroms
            }
            return
        # shared padded shapes for every slab; big layouts bucket
        # coarsely, small ones pad only to the bit-word grid
        maxp = max(
            sum(_round_up(s["r_idx"].shape[0], _SEG_ALIGN) for s in g)
            for g in groups
        )
        maxw = max(sum(len(s["w_start"]) for s in g) for g in groups)
        pos_pad = _round_up(
            maxp, _POS_BUCKET if maxp >= _POS_BUCKET else _SCAN_BLK
        )
        win_pad = _round_up(maxw, _WIN_BUCKET if maxw >= _WIN_BUCKET else 64)
        self.pos_pad = pos_pad
        self.win_pad = win_pad

        self.slabs = []
        for g in groups:
            r_idx = np.full(pos_pad, -1, np.int32)
            w_start = np.zeros(win_pad, np.int32)
            w_hi = np.zeros(win_pad, np.int32)
            wins = []  # (chrom, chrom_win_off, slab_win_off, count)
            p_off = 0
            w_off = 0
            for seg in g:
                sl = seg["r_idx"].shape[0]
                nw = len(seg["w_start"])
                r_idx[p_off : p_off + sl] = seg["r_idx"]
                w_start[w_off : w_off + nw] = seg["w_start"] + p_off
                w_hi[w_off : w_off + nw] = seg["w_hi"] + p_off
                wins.append((seg["chrom"], seg["c_off"], w_off, nw))
                p_off += _round_up(sl, _SEG_ALIGN)
                w_off += nw
            cs_tot = np.zeros(pos_pad + 1, np.int32)
            np.cumsum(r_idx >= 0, out=cs_tot[1:])
            self.slabs.append(
                {
                    "r_idx": r_idx,
                    "cs_tot": cs_tot,
                    "w_start": w_start,
                    "w_hi": w_hi,
                    "n_win": w_off,
                    "wins": wins,
                }
            )
        self.chrom_n_win = {
            name: len(ws) for name, _r, ws, _h in self._chroms
        }


_FIELDS = ("observed", "variations", "inner", "left", "right")
