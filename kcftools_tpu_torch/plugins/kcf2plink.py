"""kcf2plink: score -> PLINK .ped/.map/.contigsMap
(reference: Plugins/KCFToPed.java).

Faithfully replicates the reference's index bookkeeping, including the
quirk that a window skipped by --chrs marks its (reused) matrix index as
bad, so the next window landing on that index is also excluded
(KCFToPed.java:115-122)."""

import numpy as np

from ..io.kcf import KCFReader
from ..utils.logger import Logger
from .kcf2gt import alleles_from_scores, bad_windows, read_chrs_file

_CLASS = "KCFToPed"

_PED_ALLELES = {0: "\tA\tA", 2: "\tG\tG", 1: "\tA\tG", -1: "\t0\t0"}


def add_parser(subparsers):
    p = subparsers.add_parser("kcf2plink", help="Convert KCF windows to PED format")
    p.add_argument("-i", "--input", required=True, help="Input KCF file")
    p.add_argument("-o", "--output", required=True, help="Output PED file prefix")
    p.add_argument("-a", "--score_a", type=float, default=95.0)
    p.add_argument("-b", "--score_b", type=float, default=60.0)
    p.add_argument("--score_n", type=float, default=30.0)
    p.add_argument("--chrs", default=None, help="List file with chromosomes")
    p.add_argument("--maf", type=float, default=0.05)
    p.add_argument("--max-missing", dest="max_missing", type=float, default=0.8)
    p.set_defaults(func=run)
    return p


def run(args):
    Logger.warning(_CLASS, "This is an experimental feature, use with caution!")
    chrs = read_chrs_file(args.chrs)

    reader = KCFReader(args.input)
    header = reader.header
    samples = header.samples
    s = len(samples)

    # PED rows are sample-major (transposed), so the allele matrix must
    # materialize - but as int8 (codes -1..2) filled from streamed
    # batches: 8x smaller than the reference's per-window objects
    window_count = header.window_count
    cap = max(window_count, 1)
    matrix = np.zeros((s, cap), np.int8)
    map_rows = [None] * cap
    contigs_map = []
    seen_contigs = set()
    bad_windows_set = set()
    i = 0
    for block in reader.batches():
        n = len(block)
        if i + n > cap:
            grow = max(cap * 2, i + n)
            matrix = np.concatenate(
                [matrix, np.zeros((s, grow - cap), np.int8)], axis=1
            )
            map_rows.extend([None] * (grow - cap))
            cap = grow
        alleles = alleles_from_scores(
            block.score, args.score_a, args.score_b, args.score_n
        )
        bad_flags = bad_windows(alleles, args.maf, args.max_missing)
        for w in range(n):
            name = block.seq_names[w]
            contig_id = header.get_contig_id(name) + 1
            map_rows[i] = f"{contig_id}\t{i}\t0\t{block.start[w]}"
            entry = f"{name}\t{contig_id}"
            if entry not in seen_contigs:
                seen_contigs.add(entry)
                contigs_map.append(entry)
            matrix[:, i] = alleles[:, w]
            if chrs is not None and name not in chrs:
                bad_windows_set.add(i)
                continue  # i intentionally NOT incremented (reference quirk)
            if bad_flags[w]:
                bad_windows_set.add(i)
            i += 1

    with open(args.output + ".map", "w") as mw:
        for m in range(i):
            if map_rows[m] is not None and m not in bad_windows_set:
                mw.write(map_rows[m] + "\n")
    Logger.info(_CLASS, f"Generated Map file: {args.output}.map.tsv")

    with open(args.output + ".contigsMap", "w") as cm:
        for entry in contigs_map:
            cm.write(entry + "\n")
    Logger.info(_CLASS, f"Generated Contigs Map file: {args.output}.contigsMap.tsv")

    with open(args.output + ".ped", "w") as pw:
        for j in range(s):
            pw.write(f"{samples[j]}\t{samples[j]}\t0\t0\t0\t-9")
            for k in range(i):
                if k not in bad_windows_set:
                    pw.write(_PED_ALLELES.get(int(matrix[j, k]), "\t0\t0"))
            pw.write("\n")
    Logger.info(_CLASS, f"Generated Matrix file: {args.output}.matrix.tsv")
