"""kcf2tsv: per-sample IBSpy-like TSV export
(reference: Plugins/KCFToTSV.java:62-103, Window.toTSV, Data.toTSV)."""

from ..io.kcf import KCFReader
from ..utils import javafmt
from ..utils.logger import Logger

_CLASS = "KCFToTSV"

_HEADER = (
    "window_id\tseqname\tstart\tend\teff_len\ttotal_kmers\tobserved_kmers\t"
    "variations\tkmer_distance\tmean_kmer_depth\tscore\n"
)


def add_parser(subparsers):
    p = subparsers.add_parser(
        "kcf2tsv", help="Convert KCF file to TSV file (IBSpy like)"
    )
    p.add_argument("-i", "--input", required=True, help="KCF file name")
    p.add_argument("-o", "--output", required=True, help="Output file name prefix")
    p.add_argument("-s", "--sample", default=None, help="Sample name")
    p.set_defaults(func=run)
    return p


def run(args):
    reader = KCFReader(args.input)
    header = reader.header
    if args.sample is not None:
        if not header.has_sample(args.sample):
            Logger.error(_CLASS, f"Sample {args.sample} not found in KCF file")
        samples = [args.sample]
    else:
        samples = header.samples

    f2 = javafmt.f2
    # one open file per sample; windows stream in bounded batches
    outs = {s: open(f"{args.output}.{s}.tsv", "w") for s in samples}
    try:
        for out in outs.values():
            out.write(_HEADER)
        seen = 0
        for block in reader.batches():
            seen += len(block)
            if seen > header.window_count:
                Logger.error(
                    _CLASS,
                    f"KCF has {seen}+ windows but header nwindow="
                    f"{header.window_count}",
                )
            tail = block.tail
            for sample in samples:
                j = block.samples.index(sample)
                out = outs[sample]
                for i in range(len(block)):
                    out.write(
                        f"{block.window_id[i]}\t{block.seq_names[i]}\t{block.start[i]}\t"
                        f"{block.end[i]}\t{block.eff_length[i]}\t{block.total_kmers[i]}\t"
                        f"{block.ob[j, i]}\t{block.va[j, i]}\t"
                        f"{block.inner[j, i] + tail[j, i]}\t"
                        f"{f2(block.mean_kd[j, i])}\t{f2(block.score[j, i])}\n"
                    )
    finally:
        for out in outs.values():
            out.close()
