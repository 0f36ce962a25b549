"""kcf2matrix: Tassel-style genotype matrix export (taxa x window).

The reference ships this class but removed it from the CLI registry in
v0.3.0 in favor of kcf2gt (CHANGELOG; Plugins/KCFToMatrix.java exists
unregistered). Provided here for inventory completeness with the same
outputs: <prefix>.matrix.tsv (taxa header row; missing -1 printed as 1,
KCFToMatrix.java:172), <prefix>.map.tsv (name/chromosome/position) and
<prefix>.contigsMap.tsv, with the same allele thresholds, MAF/missing
filters, and the chrs-skip index quirk shared with kcf2plink. The
optional RData conversion shells out to Rscript when available.
"""

import os
import shutil
import subprocess
import time

from ..io.kcf import KCFReader
from ..utils.logger import Logger
from .kcf2gt import alleles_from_scores, bad_windows, read_chrs_file

_CLASS = "KCFToMatrix"


def add_parser(subparsers):
    p = subparsers.add_parser(
        "kcf2matrix",
        help="Convert KCF to a Tassel-style genotype matrix "
        "(superseded by kcf2gt in the reference)",
    )
    p.add_argument("-i", "--input", required=True, help="Input KCF file")
    p.add_argument("-o", "--output", required=True, help="Output prefix")
    p.add_argument("-a", "--score_a", type=float, default=95.0)
    p.add_argument("-b", "--score_b", type=float, default=60.0)
    p.add_argument("--score_n", type=float, default=30.0)
    p.add_argument("-r", "--rdata", action="store_true", help="Convert to RData")
    p.add_argument("--maf", type=float, default=0.05)
    p.add_argument("--max-missing", dest="max_missing", type=float, default=0.8)
    p.add_argument("--chrs", default=None)
    p.set_defaults(func=run)
    return p


def run(args):
    chrs = read_chrs_file(args.chrs)
    reader = KCFReader(args.input)
    header = reader.header
    samples = header.samples
    s = len(samples)
    block = reader.read_all()
    n = len(block)

    alleles = alleles_from_scores(
        block.score, args.score_a, args.score_b, args.score_n
    )
    bad_flags = bad_windows(alleles, args.maf, args.max_missing)

    matrix_cols = []
    map_rows = [None] * max(header.window_count, n)
    contigs_map = []
    seen = set()
    bad_set = set()
    matrix = {}
    i = 0
    for w in range(n):
        name = block.seq_names[w]
        contig_id = header.get_contig_id(name) + 1
        map_rows[i] = f"{i}\t{contig_id}\t{block.start[w]}"
        entry = f"{name}\t{contig_id}"
        if entry not in seen:
            seen.add(entry)
            contigs_map.append(entry)
        matrix[i] = alleles[:, w]
        if chrs is not None and name not in chrs:
            bad_set.add(i)
            continue  # index reuse quirk, as in the reference
        if bad_flags[w]:
            bad_set.add(i)
        i += 1

    with open(args.output + ".map.tsv", "w") as mw:
        mw.write("name\tchromosome\tposition\n")
        for m in range(i):
            if map_rows[m] is not None and m not in bad_set:
                mw.write(map_rows[m] + "\n")
    Logger.info(_CLASS, f"Generated Map file: {args.output}.map.tsv")

    with open(args.output + ".contigsMap.tsv", "w") as cm:
        for entry in contigs_map:
            cm.write(entry + "\n")
    Logger.info(_CLASS, f"Generated Contigs Map file: {args.output}.contigsMap.tsv")

    keep = [kk for kk in range(i) if kk not in bad_set]
    with open(args.output + ".matrix.tsv", "w") as wtr:
        wtr.write("taxa")
        for kk in keep:
            wtr.write(f"\t{kk}")
        wtr.write("\n")
        for j in range(s):
            wtr.write(samples[j])
            for kk in keep:
                v = int(matrix[kk][j])
                wtr.write(f"\t{1 if v == -1 else v}")
            wtr.write("\n")
    Logger.info(_CLASS, f"Generated Matrix file: {args.output}.matrix.tsv")

    if args.rdata:
        _to_rdata(args.output + ".matrix.tsv", args.output + ".map.tsv")


def _to_rdata(matrix_file, map_file):
    if shutil.which("Rscript") is None:
        Logger.error(
            _CLASS, "Rscript is not installed. Please install Rscript and try again."
        )
    Logger.info(_CLASS, "Converting matrix to RData")
    script = f"convertGTmatrixToRdata_{int(time.time() * 1000)}.R"
    with open(script, "w") as fh:
        fh.write(f'df <- read.table("{matrix_file}", head = TRUE, sep = "\\t")\n')
        fh.write(f'save(df, file = "{matrix_file[:-4]}.RData")\n')
        fh.write(f'df <- read.table("{map_file}", head = TRUE, sep = "\\t")\n')
        fh.write(f'save(df, file = "{map_file[:-4]}.RData")\n')
    try:
        subprocess.run(["Rscript", script], check=True)
    finally:
        os.unlink(script)
