"""count: built-in canonical k-mer counter producing KMC3-format
databases.

This has no reference equivalent (the reference requires an external KMC3
installation; README.md:147-150): kcftools-tpu ships its own counter so
the full pipeline runs standalone. Counting is vectorized numpy
(pack -> canonicalize -> np.unique) over chromosome chunks; the output
database is byte-compatible with KMC3 (io.kmc.write_kmc_db) and readable
by the reference Java tool.
"""

import numpy as np

from ..engine.encode import canonicalize, pack_kmers
from ..io.fasta import FastaIndex
from ..io.kmc import write_kmc_db
from ..utils.logger import Logger

_CLASS = "Count"

_CHUNK = 1 << 24  # bases per counting chunk


def add_parser(subparsers):
    p = subparsers.add_parser(
        "count",
        help="Count canonical k-mers of FASTA file(s) into a KMC3-format DB "
        "(no external KMC needed)",
    )
    p.add_argument(
        "-i", "--input", required=True, help="Comma-separated FASTA files"
    )
    p.add_argument("-o", "--output", required=True, help="Output DB prefix")
    p.add_argument("-k", "--kmer-size", type=int, default=31, help="K-mer length")
    p.add_argument(
        "-ci", "--min-count", type=int, default=1, help="Minimum count to keep"
    )
    p.add_argument(
        "-cx",
        "--max-count",
        type=int,
        default=1_000_000_000,
        help="Counts are capped at this value",
    )
    p.add_argument(
        "-b",
        "--single-strand",
        action="store_true",
        help="Count forward strand only (no canonicalization)",
    )
    p.set_defaults(func=run)
    return p


def count_fasta_kmers(paths, k, canonical=True):
    """Return (unique_kmers uint64, counts uint64) across all sequences.
    For k > 32 returns ((hi, lo) value-limb tuple, counts)."""
    wide_mode = 32 < k <= 64
    ml_mode = k > 64
    all_kmers = []
    for path in paths:
        index = FastaIndex(path)
        for name in index.get_sequence_names():
            L = index.get_sequence_length(name)
            for off in range(0, L, _CHUNK):
                end = min(off + _CHUNK + k - 1, L)
                codes, valid = index.sequence_codes(name, off, end - off)
                if ml_mode:
                    from ..engine.encode_mlimb import canonical_kmer_bytes

                    keys, kvalid = canonical_kmer_bytes(
                        codes, valid, k, canonical
                    )
                    if kvalid.any():
                        all_kmers.append(keys[kvalid])
                elif wide_mode:
                    from ..engine.encode_wide import (
                        canonicalize_wide,
                        pack_kmers_wide,
                        to_value_limbs,
                    )

                    A, B, kvalid = pack_kmers_wide(codes, valid, k)
                    if canonical and A.size:
                        A, B = canonicalize_wide(A, B, k)
                    vhi, vlo = to_value_limbs(A, B, k)
                    if kvalid.any():
                        all_kmers.append((vhi[kvalid], vlo[kvalid]))
                else:
                    kmers, kvalid = pack_kmers(codes, valid, k)
                    kmers = kmers[kvalid]
                    if canonical:
                        kmers = canonicalize(kmers, k)
                    if kmers.size:
                        all_kmers.append(kmers)
                if end == L:
                    break
    if ml_mode:
        from ..engine.encode_mlimb import n_bytes

        if not all_kmers:
            return np.empty(0, f"S{n_bytes(k)}"), np.empty(0, np.uint64)
        uniq, counts = np.unique(
            np.concatenate(all_kmers), return_counts=True
        )
        return uniq, counts.astype(np.uint64)
    if wide_mode:
        from ..native import wide as wide_ops

        if not all_kmers:
            e = np.empty(0, np.uint64)
            return (e, e), e
        hi = np.concatenate([p[0] for p in all_kmers])
        lo = np.concatenate([p[1] for p in all_kmers])
        uh, ul, counts = wide_ops.sort_unique(hi, lo)
        return (uh, ul), counts
    if not all_kmers:
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    merged = np.concatenate(all_kmers)
    uniq, counts = np.unique(merged, return_counts=True)
    return uniq, counts.astype(np.uint64)


def run(args):
    paths = args.input.split(",")
    k = args.kmer_size
    if k < 10 or k > 256:
        Logger.error(_CLASS, "k must be in [10, 256] (signature length 9)")
    canonical = not args.single_strand
    Logger.info(_CLASS, f"Counting {k}-mers in {paths}")
    uniq, counts = count_fasta_kmers(paths, k, canonical)
    keep = counts >= args.min_count
    if isinstance(uniq, tuple):
        uniq = (uniq[0][keep], uniq[1][keep])
        n_distinct = uniq[0].size
    else:
        uniq = uniq[keep]
        n_distinct = uniq.size
    counts = counts[keep]
    counts = np.minimum(counts, args.max_count)
    Logger.info(_CLASS, f"{n_distinct} distinct k-mers")
    write_kmc_db(
        args.output,
        uniq,
        counts,
        k,
        both_strands=canonical,
        min_count=args.min_count,
        max_count=args.max_count,
    )
    Logger.info(_CLASS, f"Wrote {args.output}.kmc_pre / .kmc_suf")
