"""findIBS: label consecutive windows with score >= cutoff (or < cutoff
with --var) into numbered IBS blocks (reference: Plugins/FindIBS.java).

Replication notes:

* The reference iterates chromosomes via java.util.HashMap keySet
  (FindIBS.java:124,168), so both the output window order and the block
  numbering follow Java's hash-bucket order - emulated exactly by
  utils.jhash, INCLUDING treeified bins (scaffold-heavy assemblies),
  pinned by tests/fixtures/jhash_orders.json. The input-order fallback
  remains only for the pathological non-String tiebreak, which
  distinct chromosome names cannot reach.
* With a stepped input KCF, --min is overridden to windowSize/stepSize
  (FindIBS.java:81-84).
* A new block starts when numNA > min (strict) or the chromosome changed;
  block numbers continue across chromosomes; the NA counter resets per
  chromosome (FindIBS.java:118-161).
* The block sweep itself is vectorized per (sample, chromosome batch):
  block increments are a cumulative sum over gap/chrom-change conditions.

Unlike the reference (which loads the whole KCF into RAM,
FindIBS.java:85-116), the sweep STREAMS: a first pass records each
chromosome's byte ranges, then chromosomes are processed in hash order
in bounded row batches with carried sweep state (last-IBS position,
running block number, open summary run with a resumable f32 score
accumulator), so peak memory is one batch regardless of input size.
Outputs are byte-identical to the materialized sweep.
"""

import numpy as np

from ..io.kcf import KCFReader, KCFWriter
from ..utils import javafmt, jhash
from ..utils.logger import Logger
from ._common import get_command_line

_CLASS = "FindIBS"

_BATCH_ROWS = 200_000


def add_parser(subparsers):
    p = subparsers.add_parser("findIBS", help="Find IBS windows in a KCF file")
    p.add_argument("-i", "--input", required=True, help="Input KCF file name")
    p.add_argument("-o", "--output", required=True, help="Output KCF file name")
    p.add_argument(
        "--var",
        action="store_true",
        help="Detect Variable Regions instead of IBS",
    )
    p.add_argument(
        "--min",
        dest="min_consecutive",
        type=int,
        default=4,
        help="Minimum number of consecutive windows",
    )
    p.add_argument("--score", type=float, default=95.0, help="Score cut-off")
    p.add_argument("--summary", action="store_true", help="Write summary tsv file")
    p.add_argument("--bed", action="store_true", help="Write bed file")
    p.set_defaults(func=run)
    return p


def _scan_chrom_ranges(path):
    """Pass 1: byte ranges of each chromosome's data rows, file order."""
    ranges = {}
    order = []
    off = 0
    with open(path, "rb") as fh:
        for line in fh:
            ln = len(line)
            if not line.startswith(b"#") and line.strip():
                chrom = line.split(b"\t", 1)[0].decode()
                lst = ranges.get(chrom)
                if lst is None:
                    ranges[chrom] = lst = []
                    order.append(chrom)
                if lst and lst[-1][1] == off:
                    lst[-1] = (lst[-1][0], off + ln)
                else:
                    lst.append((off, off + ln))
            off += ln
    return ranges, order


def _iter_range_lines(path, byte_ranges, batch_rows):
    """Yield lists of data-row strings from the given byte ranges."""
    buf = []
    with open(path, "rb") as fh:
        for a, b in byte_ranges:
            fh.seek(a)
            rem = b - a
            tail = b""
            while rem > 0:
                chunk = fh.read(min(rem, 1 << 23))
                rem -= len(chunk)
                parts = (tail + chunk).split(b"\n")
                tail = parts.pop()
                for p in parts:
                    if p:
                        buf.append(p.decode())
                        if len(buf) >= batch_rows:
                            yield buf
                            buf = []
            if tail:
                buf.append(tail.decode())
    if buf:
        yield buf


class _RunState:
    """One open summary block for one sample (resumable across batches)."""

    __slots__ = ("bid", "chrom", "start", "end", "total", "ibs", "acc",
                 "pending")

    def __init__(self, bid, chrom, start):
        self.bid = bid
        self.chrom = chrom
        self.start = start
        self.end = 0
        self.total = 0
        self.ibs = 0
        self.acc = np.float32(0.0)
        # scores of trailing NA windows since the last IBS member: they
        # join the block only if another same-id IBS follows within
        # --min windows, else they are discarded at flush
        self.pending = []


def run(args):
    out_file = args.output
    if not out_file.endswith(".kcf"):
        out_file += ".kcf"

    reader = KCFReader(args.input)
    header = reader.header
    min_consecutive = args.min_consecutive
    if header.step_size > 0:
        min_consecutive = header.window_size // header.step_size
        Logger.warning(
            _CLASS,
            "Input KCF file is created with step size. Hence we are using the "
            f"--min = windowSize/stepSize [{min_consecutive}]",
        )
    # score cutoff: the reference compares double score against a float
    # cutoff, which widens the float32 to double
    cutoff = float(np.float32(args.score))

    ranges, file_chrom_order = _scan_chrom_ranges(args.input)
    try:
        chrom_order = jhash.hashmap_iteration_order(file_chrom_order)
        chrom_order = jhash.hashmap_iteration_order(chrom_order)
    except RuntimeError:
        Logger.warning(
            _CLASS, "HashMap order emulation unavailable; using input order"
        )
        chrom_order = file_chrom_order

    samples = header.samples
    S = len(samples)
    # BED output is only produced alongside --summary, mirroring the
    # reference (writeBedFile is called inside the writeSummary branch,
    # FindIBS.java:175-216)
    want_bed = args.bed and args.summary
    want_runs = args.summary
    block_num = [0] * S
    first_found = [False] * S
    open_run = [None] * S
    summary_rows = [[] for _ in range(S)] if args.summary else None
    bed_rows = [[] for _ in range(S)] if want_bed else None

    def _flush(j):
        run = open_run[j]
        if run is None:
            return
        open_run[j] = None
        if args.summary:
            mean = run.acc / np.float32(run.total) if run.total else np.float32(0)
            prop = np.float32(run.ibs) / np.float32(run.total)
            f2 = javafmt.f2
            summary_rows[j].append(
                f"{run.bid}\t{samples[j]}\t{run.chrom}\t{run.start}\t"
                f"{run.end}\t{run.end - run.start}\t{run.total}\t{run.ibs}\t"
                f"{f2(float(prop))}\t{f2(float(mean))}\n"
            )
        if want_bed:
            bed_rows[j].append(f"{run.chrom}\t{run.start}\t{run.end}\n")

    header.is_ibs = True
    header.add_command_line(get_command_line())
    with KCFWriter(out_file) as writer:
        writer.write_header(header)
        for chrom in chrom_order:
            last_ibs = [-1] * S  # chrom-scan index of the last IBS window
            scan_off = 0
            for lines in _iter_range_lines(args.input, ranges[chrom],
                                           _BATCH_ROWS):
                blk = reader._parse_lines(lines)
                n = len(blk)
                is_ibs = (
                    (blk.score < cutoff) if args.var else (blk.score >= cutoff)
                )
                blk.ibs[:] = -1
                for j in range(S):
                    pos = np.flatnonzero(is_ibs[j])
                    labels = None
                    if pos.size:
                        gpos = pos + scan_off
                        gaps = np.empty(pos.size, np.int64)
                        gaps[0] = gpos[0] - last_ibs[j] - 1
                        gaps[1:] = np.diff(pos) - 1
                        inc = gaps > min_consecutive
                        if last_ibs[j] < 0:
                            # first IBS of the chromosome: the reference
                            # increments on chromosome change, which holds
                            # whenever an earlier chromosome (or batch of a
                            # previous chromosome) produced a block
                            inc[0] = first_found[j]
                        base = block_num[j] if first_found[j] else 1
                        labels = base + np.cumsum(inc.astype(np.int64))
                        blk.ibs[j, pos] = labels
                        block_num[j] = int(labels[-1])
                        first_found[j] = True
                        last_ibs[j] = int(gpos[-1])
                    if want_runs:
                        _update_runs(
                            args, j, blk, pos, labels, chrom,
                            min_consecutive, open_run, _flush,
                        )
                writer.write_block(blk)
                scan_off += n
            for j in range(S):
                _flush(j)  # blocks never span chromosomes

    if args.summary:
        summary_path = out_file[: -len(".kcf")] + ".summary.tsv"
        with open(summary_path, "w") as sw:
            sw.write(
                "Block\tSample\tChromosome\tStart\tEnd\tLength\tTotalBlocks\t"
                "IBSBlocks\tIBSProportion\tMeanScore\n"
            )
            for j in range(S):
                sw.writelines(summary_rows[j])
    if want_bed:
        for j, sample in enumerate(samples):
            with open(out_file[: -len(".kcf")] + f".{sample}.bed", "w") as bw:
                bw.writelines(bed_rows[j])


def _update_runs(args, j, blk, pos, labels, chrom, min_consecutive,
                 open_run, flush):
    """Fold one batch into sample j's summary-run state. A block's
    members are the contiguous scan span from its first to its last IBS
    window (interior NA windows attach, leading/trailing are discarded),
    mirroring the buffered grouping of FindIBS.java:181-203."""
    from ..native import f32_seq_sum

    scores = blk.score[j]
    n = len(blk)
    run = open_run[j]
    if pos.size == 0:
        if run is not None:
            if len(run.pending) + n > min_consecutive:
                flush(j)
            else:
                run.pending.extend(scores.tolist())
        return
    # runs among this batch's IBS windows
    ids = labels
    starts_idx = np.flatnonzero(np.concatenate(([True], ids[1:] != ids[:-1])))
    run_first = pos[starts_idx]
    run_last = pos[np.append(starts_idx[1:] - 1, pos.size - 1)]
    run_ids = ids[starts_idx]
    run_counts = np.diff(np.append(starts_idx, pos.size))

    g0 = 0
    if run is not None:
        if run.bid == int(run_ids[0]):
            # continuation: pending NAs + the span up to this id's last IBS
            lo, hi = 0, int(run_last[0])
            span = scores[lo : hi + 1]
            if run.pending:
                run.acc = f32_seq_sum(np.asarray(run.pending), run.acc)
                run.total += len(run.pending)
                run.pending = []
            run.acc = f32_seq_sum(span, run.acc)
            run.total += hi - lo + 1
            run.ibs += int(run_counts[0])
            run.end = int(blk.end[run_last[0]])
            g0 = 1
        else:
            flush(j)
    for g in range(g0, len(run_ids)):
        fr, lr = int(run_first[g]), int(run_last[g])
        r = _RunState(int(run_ids[g]), chrom, int(blk.start[fr]))
        r.end = int(blk.end[lr])
        r.total = lr - fr + 1
        r.ibs = int(run_counts[g])
        r.acc = f32_seq_sum(scores[fr : lr + 1])
        if open_run[j] is not None:
            flush(j)
        open_run[j] = r
    # trailing NAs after the last IBS wait as pending members
    tail_lo = int(run_last[-1]) + 1
    if tail_lo < n and open_run[j] is not None:
        if (n - tail_lo) > min_consecutive:
            flush(j)
        else:
            open_run[j].pending = scores[tail_lo:].tolist()
