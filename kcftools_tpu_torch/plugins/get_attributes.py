"""getAttributes: export per-attribute TSV matrices (window x sample)
(reference: Plugins/GetAttributes.java:60-160)."""

from ..io.kcf import KCFReader
from ..utils import javafmt
from ..utils.logger import Logger

_CLASS = "GetAttributes"

ALL_ATTRIBUTES = ["obs", "var", "kd", "score", "totalkmers", "winlen", "inDist", "tailDist"]


def add_parser(subparsers):
    p = subparsers.add_parser(
        "getAttributes", help="Extract attributes from KCF files"
    )
    p.add_argument("-i", "--input", required=True, help="KCF file name")
    p.add_argument("-o", "--output", required=True, help="Output file name prefix")
    p.add_argument(
        "-a",
        "--attributes",
        default=None,
        help="Comma-separated attributes (obs,var,kd,score,totalkmers,winlen,"
        "inDist,tailDist). Default: all",
    )
    p.set_defaults(func=run)
    return p


def run(args):
    reader = KCFReader(args.input)
    header = reader.header
    samples = header.samples

    attrs = (
        args.attributes.split(",") if args.attributes else list(ALL_ATTRIBUTES)
    )
    for a in attrs:
        if a not in ALL_ATTRIBUTES:
            Logger.error(_CLASS, f"Unsupported attribute: {a}")
    Logger.info(_CLASS, "Extracting attributes: " + ", ".join(attrs))

    writers = {}
    for a in attrs:
        fh = open(f"{args.output}.{a}.tsv", "w")
        if a == "totalkmers":
            fh.write("window_id\ttotal_kmers")
        elif a == "winlen":
            fh.write("window_id\twindow_length")
        else:
            fh.write("window_id")
            for s in samples:
                fh.write("\t" + s)
        fh.write("\n")
        writers[a] = fh

    f2 = javafmt.f2
    for block in reader.batches():
        tail = block.tail
        per_sample = {
            "obs": lambda j, i: str(block.ob[j, i]),
            "var": lambda j, i: str(block.va[j, i]),
            "kd": lambda j, i: f2(block.mean_kd[j, i]),
            "score": lambda j, i: f2(block.score[j, i]),
            "inDist": lambda j, i: str(block.inner[j, i]),
            "tailDist": lambda j, i: str(tail[j, i]),
        }
        for i in range(len(block)):
            wid = block.window_id[i]
            for a, fh in writers.items():
                if a == "totalkmers":
                    fh.write(f"{wid}\t{block.total_kmers[i]}\n")
                elif a == "winlen":
                    fh.write(f"{wid}\t{block.eff_length[i]}\n")
                else:
                    getter = per_sample[a]
                    fh.write(
                        wid
                        + "".join(
                            "\t" + getter(j, i) for j in range(len(samples))
                        )
                        + "\n"
                    )

    for fh in writers.values():
        fh.close()
