"""cohort: merge N single-sample KCFs into one multi-sample KCF.

Windows are matched by windowId against the first file; headers must be
compatible (reference: Plugins/Cohort.java:71-119, KCFHeader.equals).
Output keeps file-0 window order.

Unlike the reference (which materializes every input file in RAM,
Cohort.java:80-119), the merge STREAMS: all files are read in lockstep
batches keyed to file 0's window order, so peak memory is one batch per
file regardless of genome scale. Windows that arrive out of order
relative to file 0 wait in a per-file carry buffer (bounded by the
reorder distance; exact fallback to the reference's hash-match
semantics); a window id unknown to file 0 is fatal, like the
reference's lookup failure.
"""

import copy

import numpy as np

from ..io.kcf import KCFReader, KCFWriter, WindowBlock
from ..utils.logger import Logger
from ._common import get_command_line

_CLASS = "Cohort"

# target in-flight cells (windows x files) per lockstep round
_BATCH_CELLS = 4_000_000

_ROW_FIELDS = (
    "present", "ibs", "va", "ob", "inner", "left", "right", "kmer_count",
)


def add_parser(subparsers):
    p = subparsers.add_parser("cohort", help="Create a cohort of samples kcf files")
    p.add_argument("-o", "--output", required=True, help="Output file name")
    p.add_argument(
        "-i", "--input", default=None, help="Comma-separated list of kcf files"
    )
    p.add_argument(
        "-l", "--list", dest="list_file", default=None, help="File with kcf paths"
    )
    p.set_defaults(func=run)
    return p


def run(args):
    if not args.input and not args.list_file:
        Logger.error(_CLASS, "No input files provided")
    if args.list_file:
        with open(args.list_file) as fh:
            in_files = [line.rstrip("\n") for line in fh if line.strip()]
    else:
        in_files = args.input.split(",")

    readers = [KCFReader(path) for path in in_files]
    # merge into a deep copy: the readers' own headers must keep their
    # per-file sample lists, which drive row parsing in batches()
    header = copy.deepcopy(readers[0].header)
    row_off = [0, len(header.samples)]
    for reader in readers[1:]:
        h = reader.header
        header.check_compatible(h)
        for s in h.samples:
            if s in header.samples:
                Logger.error(_CLASS, f"Sample {s} already exists in window data")
        header.merge(copy.deepcopy(h))
        row_off.append(len(header.samples))
    header.add_command_line(get_command_line())
    weights = header.weights

    batch_rows = max(10_000, _BATCH_CELLS // max(1, len(in_files)))
    gens = [r.batches(batch_rows) for r in readers]
    carries = [{} for _ in in_files]  # wid -> (block, src_row)

    with KCFWriter(args.output) as writer:
        writer.write_header(header)
        for base in gens[0]:
            n = len(base)
            out = WindowBlock(n, header.samples)
            out.seq_names = base.seq_names
            out.window_id = base.window_id
            out.start = base.start
            out.end = base.end
            out.total_kmers = base.total_kmers
            out.eff_length = base.eff_length
            out.present[:] = False
            _copy_cols(out, 0, base, np.arange(n), np.arange(n))
            idx = {wid: j for j, wid in enumerate(base.window_id)}
            for fi in range(1, len(in_files)):
                _fill_from_file(
                    out, row_off[fi], gens[fi], carries[fi], idx, n,
                    in_files[fi],
                )
            out.finalize(weights)
            writer.write_block(out)
        # windows left over in any file are unknown to file 0: fatal,
        # mirroring the reference's failed windowId lookup
        for fi in range(1, len(in_files)):
            leftover = next(iter(carries[fi]), None)
            if leftover is None:
                blk = next(gens[fi], None)
                if blk is not None and len(blk):
                    leftover = blk.window_id[0]
            if leftover is not None:
                Logger.error(
                    _CLASS,
                    f"Windows mismatch found in sample: {in_files[fi]} at "
                    f"window: '{leftover}'",
                )


def _copy_cols(out, row_start, blk, src_cols, dst_cols):
    rows = slice(row_start, row_start + blk.n_samples)
    for name in _ROW_FIELDS:
        getattr(out, name)[rows][:, dst_cols] = getattr(blk, name)[:, src_cols]


def _copy_one(out, row_start, blk, src_col, dst_col):
    rows = slice(row_start, row_start + blk.n_samples)
    for name in _ROW_FIELDS:
        getattr(out, name)[rows][:, dst_col] = getattr(blk, name)[:, src_col]


def _fill_from_file(out, row_start, gen, carry, idx, n_need, path):
    """Copy one lockstep round's worth of windows for one input file,
    matching by windowId; out-of-order rows wait in ``carry``."""
    filled = 0
    if carry:
        hits = [wid for wid in carry if wid in idx]
        for wid in hits:
            blk, j = carry.pop(wid)
            _copy_one(out, row_start, blk, j, idx[wid])
        filled += len(hits)
    while filled < n_need:
        blk = next(gen, None)
        if blk is None:
            missing = next(
                wid
                for wid, j in idx.items()
                if not out.present[row_start][j]
            )
            Logger.error(
                _CLASS,
                f"Windows mismatch found in sample: {path} at window: "
                f"'{missing}' (missing)",
            )
        dst = np.fromiter(
            (idx.get(w, -1) for w in blk.window_id), np.int64, len(blk)
        )
        hit = dst >= 0
        if hit.any():
            _copy_cols(out, row_start, blk, np.flatnonzero(hit), dst[hit])
            filled += int(hit.sum())
        for j in np.flatnonzero(~hit):
            carry[blk.window_id[j]] = (blk, j)
