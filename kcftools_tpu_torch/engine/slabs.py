"""The slab layout the two device engines share.

Port of kcftools_tpu/engine/device_prefix.py::_Layout. The chromosomes'
window lists are cut into window-aligned segments, and the segments are
packed in order into slabs of one padded shape, so no window straddles
a slab and every slab is one row of a scan. The dprefix engine
(``device_prefix.py``) packs a sample's presence into each slab; the
device join (``device_join.py``) routes its join counts through each
slab's slot map.
"""

import numpy as np

from ..ops.pjoin import round_up

POS_BUCKET = 1 << 20  # slab position padding granularity
WIN_BUCKET = 1 << 10  # slab window padding granularity
SEG_ALIGN = 64  # segments start on bit-word boundaries
SCAN_BLK = 512  # small-slab padding granule

# the rows of a scan's result, in order
FIELDS = ("observed", "variations", "inner", "left", "right")


class Layout:
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
                SEG_ALIGN, min(self.slab_pos, -(-total // n_parts))
            )
        segs = self._segments()
        # first-fit in order into slabs of <= slab_pos positions
        groups = []
        cur, cur_pos = [], 0
        for seg in segs:
            seg_len = round_up(seg["r_idx"].shape[0], SEG_ALIGN)
            if cur and cur_pos + seg_len > self.slab_pos:
                groups.append(cur)
                cur, cur_pos = [], 0
            cur.append(seg)
            cur_pos += seg_len
        if cur:
            groups.append(cur)

        if not groups:
            self.pos_pad = SEG_ALIGN
            self.win_pad = 64
            self.slabs = []
            self.chrom_n_win = {
                name: len(ws) for name, _r, ws, _h in self._chroms
            }
            return
        # shared padded shapes for every slab; big layouts bucket
        # coarsely, small ones pad only to the bit-word grid
        maxp = max(
            sum(round_up(s["r_idx"].shape[0], SEG_ALIGN) for s in g)
            for g in groups
        )
        maxw = max(sum(len(s["w_start"]) for s in g) for g in groups)
        pos_pad = round_up(
            maxp, POS_BUCKET if maxp >= POS_BUCKET else SCAN_BLK
        )
        win_pad = round_up(maxw, WIN_BUCKET if maxw >= WIN_BUCKET else 64)
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
                p_off += round_up(sl, SEG_ALIGN)
                w_off += nw
            self.slabs.append(
                {
                    "r_idx": r_idx,
                    "w_start": w_start,
                    "w_hi": w_hi,
                    "n_win": w_off,
                    "wins": wins,
                }
            )
        self.chrom_n_win = {
            name: len(ws) for name, _r, ws, _h in self._chroms
        }
