"""The plain reference: what ``getVariations`` must write, worked out
from the benchmark's own inputs, and the comparison that decides
``correct``.

Independent of the program: it reads the generated sequence, the
generated genes and each sample's generated (k-mer, count) set, never a
file or a cache the program wrote, and imports nothing of the program.
Plain torch ops, on whichever device holds the inputs.

Semantics (the reference tool's GetVariants.processWindow, Fasta,
Data.computeScore, and the KCF row format):

- A window is a sequence of bases: a tiling window [start, end) of a
  contig (consecutive windows overlap by k - 1 bases; start =
  max(0, last end - k + 1); windows shorter than k are dropped), or a
  gene: the bases of the union of its transcripts' exons, in order.
- Its valid k-mers (k ACGT bases inside the window) in order; a k-mer
  is present when its canonical form is in the sample with a count >=
  min_count. total = valid k-mers, observed = present ones, count_sum =
  their counts' sum. Every maximal run of absent k-mers is one
  variation; a run before the first present k-mer adds its length to
  the left distance, a run after the last one (or a window with none
  present) to the right distance, and a run between two adds d = len -
  (k - 1), or |d + 1| where d <= 0, to the inner distance.
- eff_length: the bases in maximal ACGT runs of at least k bases.
- KD = count_sum / observed (0 without a count), SC = ((wr * observed /
  total) + (wi * (1 - inner / eff)) + (wt * (1 - (left + right) / eff)))
  * 100 in doubles in that order (0 when observed, total or eff is 0);
  both printed with two decimals, rounding the exact double half up.
"""

from decimal import ROUND_HALF_UP, Decimal

import numpy as np
import torch

FIELDS = ("total", "observed", "variations", "inner", "left", "right",
          "count_sum", "eff_length")
WEIGHTS = (0.3, 0.3, 0.4)  # wi, wt, wr: getVariations' defaults
_D2 = Decimal("0.01")


def tiling_windows(length: int, window: int, k: int):
    starts, ends = [], []
    last_end = 0
    while last_end < length:
        start = max(0, last_end - k + 1)
        end = min(start + window, length)
        if end - start >= k:
            starts.append(start)
            ends.append(end)
        if end <= last_end:
            break
        last_end = end
    return starts, ends


def exon_union(transcripts):
    """The 1-based inclusive intervals covered by any exon, in order."""
    ivs = sorted(iv for exons in transcripts for iv in exons)
    out = []
    for a, b in ivs:
        if out and a <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Windows:
    """Every window of a call as base ranges: for each window, one or
    more [start, end) ranges (0-based) of a contig, in order; and the
    row label of each window (chrom, start, end, id)."""

    def __init__(self):
        self.ranges = []  # (window, contig, start, end)
        self.labels = []

    @classmethod
    def tiling(cls, inputs, window):
        w = cls()
        for ci, c in enumerate(inputs.contigs):
            starts, ends = tiling_windows(c.codes.shape[0], window, inputs.k)
            for s, e in zip(starts, ends):
                w.ranges.append((len(w.labels), ci, s, e))
                w.labels.append((c.name, s, e, f"{c.name}_{s}"))
        return w

    @classmethod
    def genes(cls, inputs):
        """One window a gene, in the order of the KCF: contigs in FASTA
        order, genes by start (the generator's starts increase)."""
        w = cls()
        by_contig = sorted(inputs.genes, key=lambda g: (g.contig, g.start))
        for g in by_contig:
            for a, b in exon_union(g.transcripts):
                w.ranges.append((len(w.labels), g.contig, a - 1, b))
            w.labels.append((inputs.contigs[g.contig].name, g.start, g.end,
                             g.gene_id))
        return w


def _runs(flag, first, last):
    """Maximal runs of True within segments: (start index, length) of
    each, with ``first`` / ``last`` marking each segment's first / last
    element."""
    prev = torch.zeros_like(flag)
    prev[1:] = flag[:-1]
    nxt = torch.zeros_like(flag)
    nxt[:-1] = flag[1:]
    s = torch.nonzero(flag & (first | ~prev)).squeeze(1)
    e = torch.nonzero(flag & (last | ~nxt)).squeeze(1)
    return s, e - s + 1


def _seg_edges(seg):
    n = seg.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=seg.device)
    last = torch.ones(n, dtype=torch.bool, device=seg.device)
    if n > 1:
        first[1:] = seg[1:] != seg[:-1]
        last[:-1] = seg[1:] != seg[:-1]
    return first, last


def window_stats(inputs, windows, keys, counts, k, min_count=1,
                 device=None):
    """The eight fields of every window (numpy int64 arrays) and the
    problem's sizes: ``bases`` (bases in the windows), ``kmers`` (valid
    k-mers in the windows), ``distinct`` (distinct canonical k-mers
    among them)."""
    dev = device or keys.device
    keys = keys.to(dev)
    counts = counts.to(dev)
    offs = np.cumsum([0] + [c.codes.shape[0] for c in inputs.contigs])
    gcodes = torch.cat([c.codes for c in inputs.contigs]).to(dev)
    gvalid = torch.cat([c.valid for c in inputs.contigs]).to(dev)
    r = np.array(windows.ranges, np.int64).reshape(-1, 4)
    n_win = len(windows.labels)
    r_win = torch.from_numpy(r[:, 0]).to(dev)
    r_gs = torch.from_numpy(offs[r[:, 1]] + r[:, 2]).to(dev)
    r_len = torch.from_numpy(r[:, 3] - r[:, 2]).to(dev)
    n = int(r_len.sum())
    rid = torch.repeat_interleave(torch.arange(r.shape[0], device=dev), r_len)
    r_off = torch.cumsum(r_len, 0) - r_len
    gpos = r_gs[rid] + (torch.arange(n, device=dev) - r_off[rid])
    seg = r_win[rid]
    del rid, r_off
    bases = gcodes[gpos]
    bvalid = gvalid[gpos]
    del gpos, gcodes, gvalid
    first, last = _seg_edges(seg)

    # eff_length: ACGT runs of at least k bases
    rs, rl = _runs(bvalid, first, last)
    long = rl >= k
    eff = torch.zeros(n_win, dtype=torch.int64, device=dev)
    eff.index_add_(0, seg[rs[long]], rl[long])

    # the k-mer at each base: inside its window, all k bases ACGT
    seg_len = torch.zeros(n_win, dtype=torch.int64, device=dev)
    seg_len.index_add_(0, seg, torch.ones_like(seg))
    seg_end = torch.cumsum(seg_len, 0)
    idx = torch.arange(n, device=dev)
    inside = idx + k <= seg_end[seg]
    bad = torch.zeros(n + k, dtype=torch.int64, device=dev)
    bad[1: n + 1] = torch.cumsum((~bvalid).to(torch.int64), 0)
    bad[n + 1:] = bad[n]
    ok = inside & ((bad[k: n + k] - bad[:n]) == 0)
    del bad, inside, idx, bvalid
    padded = torch.zeros(n + k, dtype=torch.int64, device=dev)
    padded[:n] = bases.to(torch.int64)
    fwd = torch.zeros(n, dtype=torch.int64, device=dev)
    rev = torch.zeros(n, dtype=torch.int64, device=dev)
    for t in range(k):
        x = padded[t: t + n]
        fwd <<= 2
        fwd |= x
        rev |= (3 - x) << (2 * t)
    del padded, bases
    canon = torch.minimum(fwd, rev)[ok]
    del fwd, rev
    w = seg[ok]
    del seg, first, last

    hit_at = torch.searchsorted(keys, canon).clamp(max=keys.shape[0] - 1)
    found = keys[hit_at] == canon
    cnt = torch.where(found, counts[hit_at], 0)
    present = cnt >= min_count
    distinct = int(torch.unique(canon).shape[0])
    del hit_at, found, canon

    def wsum(sel, values):
        out = torch.zeros(n_win, dtype=torch.int64, device=dev)
        out.index_add_(0, sel, values)
        return out

    res = {
        "total": wsum(w, torch.ones_like(w)),
        "observed": wsum(w, present.to(torch.int64)),
        "count_sum": wsum(w, torch.where(present, cnt, 0)),
        "eff_length": eff,
    }
    first, last = _seg_edges(w)
    rs, rl = _runs(~present, first, last)
    rw = w[rs]
    lead = first[rs]
    trail = last[rs + rl - 1]
    res["variations"] = wsum(rw, torch.ones_like(rw))
    res["right"] = wsum(rw[trail], rl[trail])
    sel = lead & ~trail
    res["left"] = wsum(rw[sel], rl[sel])
    sel = ~lead & ~trail
    d = rl[sel] - (k - 1)
    d = torch.where(d <= 0, (d + 1).abs(), d)
    res["inner"] = wsum(rw[sel], d)
    sizes = {"bases": n, "kmers": int(w.shape[0]), "distinct": distinct}
    return {f: res[f].cpu().numpy() for f in FIELDS}, sizes


def f2(x: float) -> str:
    """Two decimals, the exact double rounded half up."""
    return str(Decimal(float(x)).quantize(_D2, rounding=ROUND_HALF_UP))


def rows(windows, st, weights=WEIGHTS):
    """The KCF data rows (one sample) of the windows' statistics."""
    wi, wt, wr = weights
    ob = st["observed"].astype(np.float64)
    tot = st["total"].astype(np.float64)
    eff = st["eff_length"].astype(np.float64)
    inner = st["inner"].astype(np.float64)
    tail = (st["left"] + st["right"]).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        sc = ((wr * (ob / tot)) + (wi * (1.0 - inner / eff))
              + (wt * (1.0 - tail / eff))) * 100.0
        kd = st["count_sum"] / np.maximum(st["observed"], 1)
    sc = np.where((ob == 0) | (tot == 0) | (eff == 0), 0.0, sc)
    kd = np.where(st["count_sum"] > 0, kd, 0.0)
    out = []
    for i, (chrom, start, end, wid) in enumerate(windows.labels):
        o, v = int(st["observed"][i]), int(st["variations"][i])
        s = f2(sc[i])
        info = (f"EFFLEN={int(st['eff_length'][i])};IS={s};XS={s};MS={s};"
                f"IO={o};XO={o};MO={f2(np.float32(o))};IV={v};XV={v};"
                f"MV={_float_str(v)}")
        fmt = (f"N:{v}:{o}:{int(st['inner'][i])}:{int(st['left'][i])}:"
               f"{int(st['right'][i])}:{f2(kd[i])}:{s}")
        out.append("\t".join((chrom, str(start), str(end), wid,
                              str(int(st["total"][i])), info,
                              "GT:VA:OB:ID:LD:RD:KD:SC", fmt)))
    return out


def _float_str(v: int) -> str:
    """A count as a float32 printed the shortest way with '.0' (exact
    below 2^24 and 10^7, which every window's count is)."""
    if not 0 <= v < 10 ** 7:
        raise ValueError(f"count {v} out of the printed range")
    return f"{v}.0"


def kcf_rows(path):
    """The data rows of a KCF file (every line not starting with #)."""
    with open(path) as fh:
        return [ln.rstrip("\n") for ln in fh if not ln.startswith("#")]


def bad_rows(got, want) -> int:
    """Rows that differ, plus rows missing or extra."""
    n = min(len(got), len(want))
    return sum(1 for i in range(n) if got[i] != want[i]) + abs(
        len(got) - len(want))


def saturated(counts: torch.Tensor) -> torch.Tensor:
    """The control: counts kept in one byte (KMC's -cs255), the width
    below the configuration's exact counts."""
    return torch.clamp(counts, max=255)
