"""compareIBS: all-vs-all comparison of IBS blocks between two references
through one KMC database.

The reference ships this plugin disabled ("under development, DO NOT
USE"; Plugins/CompareIBS.java:24, registry line commented out in
KCFTOOLS.java:23). It is provided here - registered but marked
experimental - with the same inputs/outputs: two findIBS summary TSVs,
two reference FASTAs, one KMC DB; for each sample present in both
summaries, every block pair gets a row

  chrom1 start1 end1 chrom2 start2 end2 n_kmers1 n_kmers2 n_common n_in_db

where n_kmers1/2 count all valid k-mers of each block (with duplicates,
as the reference's kmer list does), n_common is the count of unique
k-mers present in both block sequences, and n_in_db counts how many of
those are found in the KMC database. The reference queries the forward
(non-canonical) form here (CompareIBS.java:143-147) even against
canonical databases; that behavior is preserved for fidelity.

The per-block-pair thread pool of the reference becomes vectorized
numpy set intersections. Every supported k (<= 256, the full KMC
envelope) goes through ONE representation: fixed-width big-endian byte
records (engine/encode_mlimb layout), whose memcmp order makes
np.unique / np.intersect1d / np.searchsorted exact for any width - the
k <= 32 hash table the earlier revision used silently rejected wide
databases.
"""

import numpy as np

from ..engine.encode_mlimb import n_bytes, pack_kmer_bytes
from ..io.fasta import FastaIndex
from ..io.kmc import KMCReader
from ..utils.logger import Logger

_CLASS = "CompareIBS"


def _db_key_bytes(kmc, k):
    """The database's (forward-form) keys as sorted big-endian S{nb}
    records, whatever width tier the reader decoded them into."""
    nb = n_bytes(k)
    if getattr(kmc, "kmers_bytes", None) is not None:  # k > 64
        keys = kmc.kmers_bytes
    elif kmc.kmers is not None:  # k <= 32: packed uint64
        b = kmc.kmers.astype(">u8").view(np.uint8).reshape(-1, 8)
        keys = np.ascontiguousarray(b[:, 8 - nb :]).view(f"S{nb}").ravel()
    else:  # 32 < k <= 64: 128-bit value limbs
        hi = kmc.kmers_hi.astype(">u8").view(np.uint8).reshape(-1, 8)
        lo = kmc.kmers_lo.astype(">u8").view(np.uint8).reshape(-1, 8)
        full = np.concatenate([hi, lo], axis=1)
        keys = np.ascontiguousarray(full[:, 16 - nb :]).view(f"S{nb}").ravel()
    return np.sort(keys)


def add_parser(subparsers):
    p = subparsers.add_parser(
        "compareIBS",
        help="Compare IBS windows between two mappings and build an "
        "all-vs-all matrix (experimental)",
    )
    p.add_argument("--refOne", required=True, help="Reference one file name")
    p.add_argument("--refTwo", required=True, help="Reference two file name")
    p.add_argument(
        "--kcfOne", required=True, help="findIBS summary output for reference one"
    )
    p.add_argument(
        "--kcfTwo", required=True, help="findIBS summary output for reference two"
    )
    p.add_argument("--kmc", required=True, help="KMC file prefix")
    p.add_argument("--output", required=True, help="Output file name")
    p.add_argument("-t", "--threads", type=int, default=2)
    p.set_defaults(func=run)
    return p


def _read_summary(path):
    out = {}
    with open(path) as fh:
        for line in fh:
            fields = line.rstrip("\n").split("\t")
            if not fields or fields[0] == "Block":
                continue
            out.setdefault(fields[1], []).append(fields)
    return out


def _block_kmers(index, chrom, start, length, k):
    """(total_valid_kmer_count, unique_kmers) of a block sequence, as
    big-endian byte records (forward form, matching the reference's
    non-canonical queries at CompareIBS.java:143-147)."""
    codes, valid = index.sequence_codes(chrom, start, length)
    kmers, kv = pack_kmer_bytes(codes, valid, k)
    kept = kmers[kv]
    return int(kept.size), np.unique(kept)


def run(args):
    Logger.warning(_CLASS, "This is an experimental feature, use with caution!")
    one = _read_summary(args.kcfOne)
    two = _read_summary(args.kcfTwo)
    index_one = FastaIndex(args.refOne)
    index_two = FastaIndex(args.refTwo)
    kmc = KMCReader(args.kmc)
    k = kmc.kmer_length
    db_keys = _db_key_bytes(kmc, k)

    with open(args.output, "w") as out:
        for sample, one_list in one.items():
            if sample not in two:
                continue
            two_list = two[sample]
            # pre-extract kmer sets per block once
            one_sets = []
            for f in one_list:
                if f[2] not in index_one.entries:
                    Logger.error(
                        _CLASS, f"Sequence {f[2]} not found in reference one"
                    )
                one_sets.append(_block_kmers(index_one, f[2], int(f[3]), int(f[5]), k))
            two_sets = [
                _block_kmers(index_two, f[2], int(f[3]), int(f[5]), k)
                for f in two_list
            ]
            for f1, (n1, s1) in zip(one_list, one_sets):
                for f2, (n2, s2) in zip(two_list, two_sets):
                    common = np.intersect1d(s1, s2, assume_unique=True)
                    # forward-form lookup, as the reference does
                    pos = np.searchsorted(db_keys, common)
                    pos = np.minimum(pos, db_keys.shape[0] - 1)
                    in_db = int(
                        (db_keys[pos] == common).sum()
                    ) if db_keys.size else 0
                    row = [
                        f1[2], f1[3], f1[4],
                        f2[2], f2[3], f2[4],
                        str(n1), str(n2), str(len(common)), str(in_db),
                    ]
                    out.write("\t".join(row) + "\n")
    Logger.info(_CLASS, f"Wrote comparison matrix to {args.output}")
