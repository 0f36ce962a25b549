"""scoreRecalc: rewrite a KCF with scores recomputed under new weights
(reference: Plugins/ScoreRecalc.java:49-67)."""

from ..io.kcf import KCFReader, KCFWriter
from ..utils.logger import Logger

_CLASS = "ScoreRecalc"


def add_parser(subparsers):
    p = subparsers.add_parser("scoreRecalc", help="Recalculate scores in a KCF file")
    p.add_argument("-i", "--input", required=True, help="Input KCF file")
    p.add_argument("-o", "--output", required=True, help="Output KCF file")
    p.add_argument("--wi", type=float, default=0.3, help="Inner kmer distance weight")
    p.add_argument("--wt", type=float, default=0.3, help="Tail kmer distance weight")
    p.add_argument("--wr", type=float, default=0.4, help="Kmer ratio weight")
    p.set_defaults(func=run)
    return p


def run(args):
    weights = (args.wi, args.wt, args.wr)
    reader = KCFReader(args.input)
    header = reader.header
    header.set_weights(args.wi, args.wt, args.wr)
    with KCFWriter(args.output) as writer:
        writer.write_header(header)
        for block in reader.batches():
            block.recalc_scores(weights)
            writer.write_block(block)
    Logger.info(_CLASS, f"Recalculated scores and wrote to {args.output}")
