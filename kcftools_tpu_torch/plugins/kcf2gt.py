"""kcf2gt: score -> genotype table (reference: Plugins/KCFToGenotypeTable.java).

Allele coding: score >= score_a -> 0 (hom ref); >= score_b -> 2 (hom
alt); <= score_n -> -1 (missing); else 1 (het). MAF / max-missing filters
apply only when explicitly tightened (:128)."""

import numpy as np

from ..io.kcf import KCFReader
from ..utils import javafmt
from ..utils.logger import Logger

_CLASS = "KCFToGenotypeTable"


def add_parser(subparsers):
    p = subparsers.add_parser("kcf2gt", help="Convert KCF to Genotype Table")
    p.add_argument("-i", "--input", required=True, help="Input KCF file")
    p.add_argument("-o", "--output", required=True, help="Output file")
    p.add_argument("--score_a", type=float, default=95.0)
    p.add_argument("--score_b", type=float, default=60.0)
    p.add_argument("--score_n", type=float, default=30.0)
    p.add_argument("--maf", type=float, default=0.0)
    p.add_argument("--max-missing", dest="max_missing", type=float, default=1.0)
    p.add_argument("--chrs", default=None, help="List file with chromosomes")
    p.set_defaults(func=run)
    return p


def _validate_scores(args):
    if not 0.0 <= args.score_a <= 100.0:
        Logger.error(_CLASS, "Score A must be between 0.0 and 100.0")
    if not 0.0 <= args.score_b <= 100.0:
        Logger.error(_CLASS, "Score B must be between 0.0 and 100.0")
    if not 0.0 <= args.score_n <= 100.0:
        Logger.error(_CLASS, "Score N must be between 0.0 and 100.0")
    if args.score_a <= args.score_b:
        Logger.error(_CLASS, "Score A must be greater than Score B")
    if args.score_b == args.score_n:
        Logger.warning(
            _CLASS,
            "Score B is equal to Score N. There would be no alleles scored as het (1).",
        )
        args.score_n = args.score_b
    if args.score_b == 0.0 and args.score_n != 0.0:
        Logger.warning(
            _CLASS,
            "Score B is not greater than Score N. There would be no alleles "
            "scored as missing (-1) or het (1).",
        )
        args.score_n = 0.0


def read_chrs_file(path):
    if path is None:
        return None
    chrs = set()
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            chrs.add(line.strip())
    return chrs


def alleles_from_scores(score, score_a, score_b, score_n):
    """(S, N) scores -> (S, N) allele codes 0/2/1/-1."""
    out = np.full(score.shape, 1, np.int64)
    out = np.where(score <= score_n, -1, out)
    out = np.where(score >= score_b, 2, out)
    out = np.where(score >= score_a, 0, out)
    return out


def bad_windows(alleles, min_maf, max_missing):
    """Vectorized badWindow() (reference :159-172). alleles: (S, N)."""
    s = alleles.shape[0]
    c0 = (alleles == 0).sum(axis=0)
    c1 = (alleles == 1).sum(axis=0)
    c2 = (alleles == 2).sum(axis=0)
    cn = (alleles == -1).sum(axis=0)
    valid = s - cn
    mono = (c0 == s) | (c1 == s) | (c2 == s) | (cn == s)
    maf_bad = (valid > 0) & ((c0 <= min_maf * valid) | (c2 <= min_maf * valid))
    miss_bad = (cn >= max_missing * s) | ((cn + c1) >= max_missing * s)
    return mono | maf_bad | miss_bad


def run(args):
    _validate_scores(args)
    chrs = read_chrs_file(args.chrs)

    reader = KCFReader(args.input)
    header = reader.header
    samples = header.samples

    dbl = javafmt.dbl
    with open(args.output, "w") as out, open(
        args.output + ".contigsMap.tsv", "w"
    ) as cm:
        out.write(
            f"# Genotype Table 0:{dbl(args.score_a)} - 100.00, "
            f"2:{dbl(args.score_b)} - {dbl(args.score_a)}, "
            f"1:{dbl(args.score_n)} - {dbl(args.score_b)}, "
            f"-1: <={dbl(args.score_n)}\n"
        )
        out.write("ID\tCHR\tSTART\tEND")
        for sample in samples:
            out.write("\t" + sample)
        out.write("\n")

        apply_filter = args.maf > 0.0 or args.max_missing < 1.0
        contigs_map = []
        seen_contigs = set()
        # every decision is window-local, so the table streams in
        # bounded batches (unlike the reference's full read, :75-140)
        for block in reader.batches():
            alleles = alleles_from_scores(
                block.score, args.score_a, args.score_b, args.score_n
            )
            bad = bad_windows(alleles, args.maf, args.max_missing)
            for i in range(len(block)):
                name = block.seq_names[i]
                contig_id = header.get_contig_id(name) + 1
                entry = f"{name}\t{contig_id}"
                if entry not in seen_contigs:
                    seen_contigs.add(entry)
                    contigs_map.append(entry)
                if chrs is not None and name not in chrs:
                    continue
                if bad[i] and apply_filter:
                    continue
                row = [
                    block.window_id[i],
                    str(contig_id),
                    str(block.start[i]),
                    str(block.end[i]),
                ]
                row.extend(str(a) for a in alleles[:, i])
                out.write("\t".join(row) + "\n")
        Logger.info(_CLASS, f"Genotype table written to: {args.output}")

        cm.write("contigName\tcontigID\n")
        for entry in contigs_map:
            cm.write(entry + "\n")
        Logger.info(
            _CLASS, f"Generated Contigs Map file: {args.output}.contigsMap.tsv"
        )
