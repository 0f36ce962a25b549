"""splitKCF: demux a KCF by chromosome into <outDir>/<chrom>.kcf
(reference: Plugins/SplitKCF.java:57-98).

The reference LRU-caps open writers at 100 and *truncates* a chromosome's
file when it is re-opened after eviction (new FileWriter), silently
dropping windows for >100 interleaved chromosomes; here evicted files are
re-opened in append mode so every window survives.
"""

import os

import numpy as np

from ..io.kcf import KCFReader, format_block_rows
from ..utils.logger import Logger

_CLASS = "SplitKCF"
_MAX_OPEN = 100


def add_parser(subparsers):
    p = subparsers.add_parser("splitKCF", help="Split KCF file for each chromosome")
    p.add_argument("-k", "--kcf", required=True, help="KCF file name")
    p.add_argument("-o", "--output", required=True, help="Output directory")
    p.add_argument("-t", "--threads", type=int, default=2, help="Number of threads")
    p.set_defaults(func=run)
    return p


def run(args):
    if os.path.isdir(args.output):
        Logger.info(_CLASS, f"Output directory already exists: {args.output}")
    else:
        Logger.info(_CLASS, f"Creating output directory: {args.output}")
        os.makedirs(args.output, exist_ok=True)

    reader = KCFReader(args.kcf)
    header_str = reader.header.to_string()

    open_handles = {}  # chrom -> file handle (LRU by insertion)
    started = set()

    def get_handle(chrom):
        if chrom in open_handles:
            fh = open_handles.pop(chrom)
            open_handles[chrom] = fh  # refresh LRU position
            return fh
        path = os.path.join(args.output, f"{chrom}.kcf")
        if chrom in started:
            fh = open(path, "a")
        else:
            fh = open(path, "w")
            fh.write(header_str)
            started.add(chrom)
        if len(open_handles) >= _MAX_OPEN:
            oldest = next(iter(open_handles))
            open_handles.pop(oldest).close()
        open_handles[chrom] = fh
        return fh

    for block in reader.batches():
        names = np.array(block.seq_names, dtype=object)
        # group rows by chromosome in first-appearance order; within-chrom
        # row order is preserved by the ascending index selection
        seen = list(dict.fromkeys(block.seq_names))
        for chrom in seen:
            idx = np.flatnonzero(names == chrom)
            sub = block.select(idx)
            fh = get_handle(chrom)
            for row in format_block_rows(sub):
                fh.write(row)
                fh.write("\n")

    for fh in open_handles.values():
        fh.close()
