"""getVariations for the port: screen reference k-mers against KMC
databases and write KCF.

Port of kcftools_tpu/plugins/get_variations.py. Its host half is
copied here as it is: the parser (``add_parser``), ``_validate``, the
KMC ingest helpers (``_merge_streamed``, ``_db_fits_ram``,
``_sort_db``), the window plan (``_build_window_plan``), the positional
engines' per-sample assembly and KCF write (``_run_one_sample``, without
the on-chip hash branch), ``_make_block``, ``_chunk_geometry`` and the
host engine's scans (``_score_fixed_windows_hybrid``,
``_score_feature_windows_hybrid``). What the port owns is the engine
routing and the device engines. On one device:

- ``--engine device``, window mode, k <= 32: the DeviceJoinScorer (the
  join on the card);
- ``--engine device``, gene/transcript features, k <= 32: the on-chip
  hash engine (a per-sample hash table on the card, WindowScorer), with
  its own header/assembly/write step (``_run_hash_sample``);
- ``--engine dprefix``, every mode and any k: the DevicePrefixScorer (the
  gap-run scans on the card), also behind the streamed low-memory
  ingest;
- ``--engine hybrid``, and ``auto`` on at most one device, run the host
  engine (the native merge join and window scan), as the JAX package
  does.

On more than one device (``torchinit.resolve_devices``), as in the JAX
package: ``auto`` takes dprefix, whose slabs spread over every slot;
``--engine device`` (window and gene/transcript, k <= 32) takes the
mesh-sharded hash engine (parallel/sharded.py), its table streamed onto
the mesh by the loader (parallel/loader.py) unless ``--memory``, with a
table axis sized from the table estimate or ``KCFTOOLS_TABLE_AXIS``.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..engine.device_join import DeviceJoinScorer
from ..engine.device_prefix import DevicePrefixScorer, _phase
from ..engine.hashtable import build_table
from ..engine.hostscan import WORTH_SAMPLES, OrdinalWindowScanner
from ..engine.pipeline import WindowScorer, combine_u8
from ..engine.prefix_scan import (
    chromosome_stats_indirect,
    static_window_stats,
    window_stats,
)
from ..engine.refindex import FeatureKmerIndex, RefKmerIndex
from ..engine.windows import (
    PAD_MARGIN,
    batch_subsequences,
    bucket_pad_len,
    pad_batch_varlen,
    sliding_windows,
    tiling_windows,
)
from ..io.fasta import FastaIndex
from ..io.gtf import GTF
from ..io.kcf import KCFHeader, KCFWriter, WindowBlock
from ..io.kmc import KMCReader, load_sorted_cache, save_sorted_cache
from ..native import (
    get_lib,
    merge_counts,
    merge_counts_u8,
    set_threads,
    sort_pairs,
    window_scan_u8,
)
from ..parallel.loader import ShardedTableLoader
from ..parallel.mesh import make_mesh
from ..parallel.sharded import ShardedWindowScorer
from ..torchinit import ENV, VIRTUAL_ENV, process_index, resolve_devices
from ..utils.logger import Logger
from ..utils.stagetimer import (
    count as stage_count,
    dump as stage_dump,
    reset as stage_reset,
    stage,
)
from ._common import clean_sample_name, get_command_line

_CLASS = "GetVariants"

# target number of base positions per device batch
_BATCH_POSITIONS = 1 << 22

# bump when the semantics of the cached window-plan arrays change
_PLAN_VERSION = 1


def add_parser(subparsers):
    p = subparsers.add_parser(
        "getVariations",
        help="Screen for reference kmers that are not present in the KMC "
        "database, and detect variation",
    )
    p.add_argument("-r", "--reference", required=True, help="Reference file name")
    p.add_argument(
        "-k",
        "--kmc",
        required=True,
        help="KMC database prefix (comma-separated list for multi-sample runs)",
    )
    p.add_argument(
        "-o",
        "--output",
        required=True,
        help="Output file name (multi-sample: comma-separated list or a "
        "directory)",
    )
    p.add_argument(
        "-s",
        "--sample",
        required=True,
        help="Sample name (comma-separated list for multi-sample runs)",
    )
    p.add_argument(
        "-f",
        "--feature",
        required=True,
        help='Feature type ("window" or "gene" or "transcript")',
    )
    p.add_argument(
        "-t", "--threads", type=int, default=2,
        help="Number of threads for the native host tier [2]",
    )
    p.add_argument(
        "-m",
        "--memory",
        action="store_true",
        help="Materialize the KMC database in host RAM before merging "
        "(faster for small DBs). Without it the database is STREAMED in "
        "bounded slabs - per-sample host memory stays flat no matter "
        "how large the table is, and the multi-chip device engine "
        "streams shards straight onto the mesh (parallel/loader.py); "
        "the analog of the reference's mmap low-memory default "
        "(Data/KMC.java:84-102)",
    )
    p.add_argument("--wi", type=float, default=0.3, help="Inner kmer distance weight")
    p.add_argument("--wt", type=float, default=0.3, help="Tail kmer distance weight")
    p.add_argument("--wr", type=float, default=0.4, help="Kmer ratio weight")
    p.add_argument("-w", "--window", type=int, default=0, help="Window size")
    p.add_argument("-g", "--gtf", default=None, help="GTF file name")
    p.add_argument(
        "-c", "--min-k-count", type=int, default=1, help="Minimum kmer count"
    )
    p.add_argument(
        "-p", "--step", type=int, default=0, help="Step size for sliding window"
    )
    p.add_argument(
        "--engine",
        choices=["auto", "hybrid", "device", "dprefix"],
        default="auto",
        help="Lookup engine: 'hybrid' resolves k-mer counts on host via a "
        "sorted-merge join against a cached reference k-mer index plus a "
        "fused per-window scan (fast path for window mode); 'dprefix' "
        "keeps the reference index resident on the accelerator(s) and "
        "runs the whole positional pipeline there (genome sharded "
        "across chips, samples batched per dispatch; any k); 'device' "
        "runs hash-table lookups on the accelerator (k <= 32; tables "
        "shardable across the mesh and streamable from disk)",
    )
    p.set_defaults(func=run)
    return p


def _validate(args):
    if args.feature == "window":
        if args.window <= 0:
            Logger.error(_CLASS, "Window size is required for window model")
        if args.gtf:
            Logger.error(_CLASS, "GTF file is not valid for window model")
    elif args.feature in ("gene", "transcript"):
        if not args.gtf:
            Logger.error(_CLASS, "GTF file is required for targeted model")
        if args.window > 0:
            Logger.error(_CLASS, "Window size is not valid for targeted model")
    else:
        Logger.error(
            _CLASS,
            f"Invalid model type: {args.feature}. Supported models are "
            "'window' or 'gene' or 'transcript'",
        )
    if args.threads <= 0:
        Logger.error(_CLASS, "Number of threads should be greater than 0")
    if args.min_k_count < 1:
        Logger.error(_CLASS, "Minimum kmer count should be at least 1")


def _resolve_engine(args):
    """The concrete engine for this run (see the module docstring).
    KCFTOOLS_ENGINE overrides --engine; KCFTOOLS_NO_DEVICE_PROBE=1 keeps
    ``auto`` on the host engine without looking for devices, as does a
    host without CUDA where no device was asked for."""
    engine = os.environ.get("KCFTOOLS_ENGINE") or args.engine
    if engine != "auto":
        return engine
    if args.feature != "window" or os.environ.get("KCFTOOLS_NO_DEVICE_PROBE"):
        return "hybrid"
    if not torch.cuda.is_available() and not (
        os.environ.get(ENV) or os.environ.get(VIRTUAL_ENV)
    ):
        return "hybrid"
    n_dev = len(resolve_devices())
    if n_dev > 1:
        Logger.info(
            _CLASS,
            f"auto engine: {n_dev} devices visible -> dprefix engine "
            "(genome sharded across devices)",
        )
        return "dprefix"
    return "hybrid"


def run(args):
    """Single- or multi-sample screening (-k a,b,c -s sa,sb,sc): the
    reference parse, k-mer index and window plan are built once and
    every sample adds one KMC ingest, one join and the window stats.
    With KCFTOOLS_STAGE_JSON set, the call is the stage
    ``getVariations`` and its stages are written when it closes."""
    _validate(args)
    stage_reset()
    with stage("getVariations"):
        _screen(args)
    stage_dump()


def _screen(args):
    args.engine = _resolve_engine(args)
    devices = []
    if args.engine in ("device", "dprefix"):
        devices = resolve_devices()
    # the mesh-sharded hash engine takes --engine device on > 1 device
    mesh_hash = args.engine == "device" and len(devices) > 1
    set_threads(args.threads)
    kmc_list = args.kmc.split(",")
    samples = [
        clean_sample_name(s, _CLASS) for s in args.sample.split(",")
    ]
    if len(samples) != len(kmc_list):
        Logger.error(_CLASS, "Number of samples must match number of KMC DBs")
    if len(kmc_list) > 1:
        if "," in args.output:
            outputs = args.output.split(",")
            if len(outputs) != len(kmc_list):
                Logger.error(
                    _CLASS, "Number of outputs must match number of KMC DBs"
                )
        else:
            os.makedirs(args.output, exist_ok=True)
            outputs = [
                os.path.join(args.output, f"{s}.kcf") for s in samples
            ]
    else:
        outputs = [args.output]

    with stage("fasta_index"):
        index = FastaIndex(args.reference)
    gtf = None
    if args.feature in ("gene", "transcript"):
        with stage("gtf_parse"):
            gtf = GTF(args.gtf)

    def _ingest(db_prefix):
        """KMC decode + key sort (or the sorted sidecar), or for the
        on-chip hash engine the sample's hash table, on a worker thread
        for sample i+1 while sample i is scored. Returns (kmc,
        positional, db_sorted, table): ``positional`` is whether the
        sample takes a merge-join engine (host, dprefix, device-join);
        ``db_sorted`` None there means the streamed merge."""
        kmc = KMCReader(db_prefix, materialize=False)
        k = kmc.kmer_length
        positional = args.engine in ("hybrid", "dprefix") or (
            args.feature == "window" and k <= 32 and not mesh_hash
        )
        db_sorted = table = None
        with stage("ingest"):
            if positional:
                if k <= 64:
                    db_sorted = load_sorted_cache(db_prefix, k)
                # the device-join engine needs the full sorted table; the
                # budget gate only applies to the streamed alternative
                if db_sorted is None and (
                    args.memory or _db_fits_ram(kmc, k)
                    or args.engine == "device"
                ):
                    kmc._read_records()
                    db_sorted = _sort_db(kmc, k, db_prefix=db_prefix)
            elif k <= 32 and (args.memory or not mesh_hash):
                # (the mesh without --memory streams the table instead)
                if kmc.kmers is None:
                    kmc._read_records()
                table = build_table(kmc.kmers, kmc.counts, k,
                                    both_strands=kmc.both_strands)
        return kmc, positional, db_sorted, table

    pool = (
        ThreadPoolExecutor(max_workers=1) if len(kmc_list) > 1 else None
    )
    pending = pool.submit(_ingest, kmc_list[0]) if pool else None

    refidx = None
    plan = None
    dscorer = None
    hash_scorer = None  # on-chip hash engine, reused across samples
    group = []  # device-engine samples submitted but not yet written

    def _flush_group():
        for key, g_kmc, g_k, g_sample, g_out in group:
            _run_one_sample(
                args, index, gtf, refidx, g_kmc, g_k, g_sample, g_out,
                plan, dscorer, dkey=key,
            )
            dscorer.discard(key)
        group.clear()

    for i, (db_prefix, sample, out_path) in enumerate(
        zip(kmc_list, samples, outputs)
    ):
        if pool is not None:
            kmc, positional, db_sorted, table = pending.result()
            if i + 1 < len(kmc_list):
                pending = pool.submit(_ingest, kmc_list[i + 1])
        else:
            kmc, positional, db_sorted, table = _ingest(db_prefix)
        k = kmc.kmer_length
        if not positional:
            if k > 32:
                Logger.error(
                    _CLASS,
                    f"k={k} > 32 requires the hybrid or dprefix engine; "
                    "--engine device supports k <= 32",
                )
            if mesh_hash:
                scorer = _make_mesh_scorer(args, kmc, db_prefix, table,
                                           devices)
                _run_hash_sample(args, index, gtf, k, scorer, sample,
                                 out_path)
                continue
            with _phase("hash_table_upload", devices[0].device):
                if hash_scorer is None or hash_scorer.k != k or (
                    hash_scorer.both_strands != kmc.both_strands
                ):
                    hash_scorer = WindowScorer(table, devices[0].device,
                                               min_count=args.min_k_count)
                else:
                    hash_scorer.set_table(table)
            _run_hash_sample(args, index, gtf, k, hash_scorer, sample,
                             out_path)
            continue
        if refidx is None or refidx.k != k or (
            refidx.canonical != kmc.both_strands
        ):
            if group:
                _flush_group()  # a k change invalidates the device state
            if args.feature == "window":
                with stage("refindex_load"):
                    refidx = RefKmerIndex.load_or_build(
                        args.reference, index, k, canonical=kmc.both_strands
                    )
                with stage("plan_load"):
                    plan = _build_window_plan(args, index, refidx, k)
            else:
                refidx = FeatureKmerIndex.build(
                    index, gtf, k, kmc.both_strands,
                    args.feature == "gene",
                )
                plan = None
            dscorer = None
        if args.engine in ("device", "dprefix") and dscorer is None:
            dscorer = _make_positional_scorer(
                args, refidx, plan, k, devices, len(kmc_list)
            )
        if dscorer is not None:
            # submit now; assemble + write once the group fills
            _submit_sample(refidx, kmc, k, db_sorted, dscorer, i)
            group.append((i, kmc, k, sample, out_path))
            if len(group) >= dscorer.batch:
                _flush_group()
            continue
        _run_one_sample(
            args, index, gtf, refidx, kmc, k, sample, out_path, plan,
            db_sorted=db_sorted,
        )
    if group:
        _flush_group()
    if pool is not None:
        pool.shutdown(wait=False)
    if dscorer is not None:
        dscorer.close()


def _make_positional_scorer(args, refidx, plan, k, devices, n_samples):
    """The device-join (``--engine device``, window mode, one device) or
    dprefix scorer (over every local slot) for one reference index,
    with its windows registered. A group holds the run's sample count
    (capped at 16) unless KCFTOOLS_DEVICE_BATCH sets it."""
    batch = (
        min(n_samples, 16)
        if not os.environ.get("KCFTOOLS_DEVICE_BATCH")
        else None
    )
    if args.engine == "device":
        scorer = DeviceJoinScorer(
            refidx, k, devices[0].device, min_count=args.min_k_count,
            batch=batch,
        )
    else:
        rank = process_index()
        scorer = DevicePrefixScorer(
            refidx, k, min_count=args.min_k_count, batch=batch,
            devices=[s for s in devices if s.process_index == rank],
        )
    if args.feature == "window":
        for name, pl in plan.items():
            if pl is not None:
                scorer.add_chrom(
                    name, refidx.chrom_r_idx[name], pl["starts"], pl["ends"]
                )
    else:
        for name, pl in refidx.chrom_plans.items():
            if pl is not None:
                scorer.add_chrom_kcoords(
                    name, pl["r_idx"], pl["w_start"], pl["w_hi"]
                )
    return scorer


def _submit_sample(refidx, kmc, k, db_sorted, dscorer, key):
    """Merge one sample and enqueue it under ``key``: the sorted table's
    merge, or the streamed low-memory merge (stage ``merge_streamed``)
    when the ingest left ``db_sorted`` None."""
    ref_keys = (
        (refidx.kmers_hi, refidx.kmers_lo) if 32 < k <= 64 else refidx.kmers
    )
    if db_sorted is None:
        with stage("merge_streamed"):
            u8, ei, ev = _merge_streamed(kmc, ref_keys, k)
        dscorer.submit_counts(key, u8, ei, ev)
    else:
        db_keys, dbc = db_sorted
        dscorer.submit(key, ref_keys, db_keys, dbc)


def _merge_streamed(kmc, ref_keys, k):
    """Low-memory merge: stream KMC slabs (bounded RAM), sort each slab
    and fold its merge join into one u8 pack. Every canonical k-mer
    lives in exactly one slab, so a per-element maximum across slab
    merges reconstructs the exact full-table merge. Host peak memory is
    one slab + the u8 pack, independent of database size - the analog
    of the reference's mmap mode (Data/KMC.java:84-102)."""
    n_ref = ref_keys[0].shape[0] if isinstance(ref_keys, tuple) else \
        ref_keys.shape[0]
    out = np.zeros(n_ref, np.uint8)
    tmp = np.empty(n_ref, np.uint8)
    exc_i, exc_v = [], []
    # Each slab's merge scans ALL ref keys, so slab count is the cost
    # multiplier: size slabs to ~1/8 of the database (bounded to keep
    # the per-slab sort scratch modest). A 3G-key DB then streams in 8
    # passes instead of ~180 with the fixed 2^26 default.
    slab_records = int(os.environ.get(
        "KCFTOOLS_STREAM_SLAB",
        str(min(1 << 29, max(1 << 26, -(-kmc.total_kmers // 8)))),
    ))
    for keys, counts in kmc.iter_slabs(slab_records):
        if k > 64:
            order = np.argsort(keys)
            ks, cs = keys[order], counts[order].astype(np.uint32)
        elif k > 32:
            from ..native import wide

            kh, kl, cs = wide.sort_unique(keys[0], keys[1], counts)
            ks, cs = (kh, kl), cs.astype(np.uint32)
        else:
            ks, cs = sort_pairs(keys, counts)
        u8, ei, ev = merge_counts_u8(ref_keys, ks, cs, out=tmp)
        np.maximum(out, u8, out=out)
        if ei.size:
            exc_i.append(ei)
            exc_v.append(ev)
    if exc_i:
        ei = np.concatenate(exc_i)
        ev = np.concatenate(exc_v)
        order = np.argsort(ei)  # the scan binary-searches exc_idx
        ei, ev = ei[order], ev[order]
    else:
        ei = np.empty(0, np.int32)
        ev = np.empty(0, np.uint32)
    return out, ei, ev


def _db_fits_ram(kmc, k) -> bool:
    """Whether this database may be materialized + sidecar-cached in
    sorted order instead of streamed. The gate is the estimated PEAK
    working set of decode + radix sort (~24 bytes per record: decoded
    keys+counts plus the sort's ping-pong copies - the on-disk files
    are ~3-4x smaller than that), against a 2 GiB default budget
    (KCFTOOLS_SORT_CACHE_BUDGET bytes overrides; the sorted sidecar
    written afterwards is ~12 bytes per record). Wheat-scale databases
    stay on the bounded-RAM streamed path.

    NOTE: this means a run WITHOUT --memory may still use up to the
    budget of host RAM and write a .kcfsorted sidecar next to the
    input DB (sidecar write failure is a warning, never an error).
    Set KCFTOOLS_SORT_CACHE_BUDGET=0 to force strict bounded-RAM
    streaming and suppress sidecar creation for every non---memory
    run (documented in docs/usage/cli.md)."""
    if k > 64:
        return False
    budget = int(
        os.environ.get("KCFTOOLS_SORT_CACHE_BUDGET", str(2 << 30))
    )
    return kmc.total_kmers * 24 <= budget


def _sort_db(kmc, k, db_prefix=None):
    """Sample table in plain sorted key order for the merge join.
    k <= 32: uint64; 33..64: (hi, lo) limb pair; > 64: S{nb} records.
    With ``db_prefix``, the result is saved as a staleness-checked
    sidecar so later runs skip the decode + sort."""
    if k > 64:
        order = np.argsort(kmc.kmers_bytes)
        return kmc.kmers_bytes[order], kmc.counts[order].astype(np.uint32)
    if k > 32:
        from ..native import wide

        dbh, dbl, dbc = wide.sort_unique(
            kmc.kmers_hi, kmc.kmers_lo, kmc.counts
        )
        res = (dbh, dbl), dbc.astype(np.uint32)
    else:
        res = sort_pairs(kmc.kmers, kmc.counts)
    if db_prefix is not None:
        save_sorted_cache(db_prefix, k, res[0], res[1])
    return res


def _build_window_plan(args, index, refidx, k):
    """Per-chromosome window geometry + sample-independent stats (total
    k-mers, effective length), computed once per (reference, k, window
    geometry) and reused by every sample's fused scan. The stats are
    cached in a staleness-checked sidecar next to the reference (like
    the k-mer index cache) so repeated runs skip the prefix-sum pass."""
    names = index.get_sequence_names()
    cache = (
        f"{args.reference}.kcfplan.k{k}.w{args.window}.p{args.step}.npz"
    )
    cached = None
    if os.path.exists(cache) and os.path.getmtime(cache) >= os.path.getmtime(
        args.reference
    ):
        try:
            with np.load(cache, allow_pickle=False) as z:
                if (
                    "format_version" in z.files
                    and int(z["format_version"][0]) == _PLAN_VERSION
                    and [str(n) for n in z["chrom_names"]] == list(names)
                ):
                    cached = {
                        str(n): (z[f"total_{i}"], z[f"eff_{i}"])
                        for i, n in enumerate(names)
                        if f"total_{i}" in z.files
                    }
        except Exception as e:
            Logger.warning(_CLASS, f"Ignoring bad plan cache {cache}: {e}")
    plan = {}
    for name in names:
        seq_len = index.get_sequence_length(name)
        if args.step > 0:
            starts, ends = sliding_windows(seq_len, args.window, args.step, k)
        else:
            starts, ends = tiling_windows(seq_len, args.window, k)
        if len(starts) == 0:
            plan[name] = None
            continue
        if cached is not None and name in cached:
            total, eff = cached[name]
        else:
            r_idx = refidx.chrom_r_idx[name]
            _codes, valid = index.sequence_codes(name)
            total, eff = static_window_stats(r_idx, valid, k, starts, ends)
        plan[name] = {
            "starts": starts,
            "ends": ends,
            "total": total,
            "eff": eff,
        }
    stage_count("plan_built", int(cached is None))
    if cached is None:
        try:
            payload = {
                "format_version": np.array([_PLAN_VERSION]),
                "chrom_names": np.array(list(names)),
            }
            for i, name in enumerate(names):
                if plan[name] is not None:
                    payload[f"total_{i}"] = plan[name]["total"]
                    payload[f"eff_{i}"] = plan[name]["eff"]
            # Write-then-rename so a concurrent reader never sees a
            # truncated sidecar and two writers cannot interleave.
            tmp = f"{cache}.{os.getpid()}.tmp.npz"
            np.savez(tmp, **payload)
            os.replace(tmp, cache)
        except Exception as e:
            Logger.warning(_CLASS, f"Could not cache plan at {cache}: {e}")
    return plan


def _run_one_sample(args, index, gtf, refidx, kmc, k, sample, out_path,
                    plan=None, dscorer=None, db_sorted=None, dkey=None):
    """One sample through a positional engine: the host engine merges
    and scans it here; a device scorer (dprefix, the device join) has
    it already merged and submitted under ``dkey``. Then score every
    chromosome's windows and write the KCF. A copy of the JAX package's
    function without its on-chip hash branch (``use_hybrid=False``; the
    port runs it through ``_run_hash_sample``) and without the device
    scorers' unbatched merge, which ``run`` never takes."""
    counts_r = None
    u8_pack = None
    if dkey is None:
        ref_keys = (
            (refidx.kmers_hi, refidx.kmers_lo)
            if 32 < k <= 64
            else refidx.kmers
        )
        _merge_timer = stage("merge")
        _merge_timer.__enter__()
        if db_sorted is None:
            # low-memory mode: stream the database in bounded slabs
            # and fold each slab's merge into one u8 pack
            u8_pack = _merge_streamed(kmc, ref_keys, k)
            if get_lib() is None:
                # no native scan: widen (exceptions carry exact values)
                # for the numpy prefix engine
                u8, ei, ev = u8_pack
                counts_r = u8.astype(np.uint32)
                counts_r[ei] = ev
                u8_pack = None
            db_keys = dbc = None
        else:
            db_keys, dbc = db_sorted
        if db_keys is None:
            pass  # streamed above
        elif k > 64:
            # byte-record merge is numpy either way; the native window
            # scan consumes the u8 pack when available, the prefix
            # fallback widens it
            u8_pack = merge_counts_u8(ref_keys, db_keys, dbc)
            if get_lib() is None:
                u8, ei, ev = u8_pack
                counts_r = u8.astype(np.uint32)
                counts_r[ei] = ev
                u8_pack = None
        elif get_lib() is not None:
            u8_pack = merge_counts_u8(ref_keys, db_keys, dbc)
        elif k > 32:
            from ..native import wide

            counts_r = wide.merge_counts(
                ref_keys[0], ref_keys[1], db_keys[0], db_keys[1], dbc
            )
        else:
            counts_r = merge_counts(ref_keys, db_keys, dbc)
        _merge_timer.__exit__()
    # else: device engine, batched flow: the sample was already merged
    # and submitted under dkey; only assembly + writing remain

    header = KCFHeader()
    header.reference = args.reference
    header.add_command_line(get_command_line())
    header.add_sample(sample)
    header.window_size = args.window
    header.step_size = args.step
    header.kmer_size = k
    header.is_ibs = False
    header.set_weights(args.wi, args.wt, args.wr)
    weights = (args.wi, args.wt, args.wr)

    Logger.info(_CLASS, "Generating windows...")
    pending = []
    with stage("scan"):
        for name in index.get_sequence_names():
            header.add_contig(name, index.get_sequence_length(name))
            if args.feature == "window":
                block = _score_fixed_windows_hybrid(
                    args, index, refidx, counts_r, name, k, sample,
                    plan=plan, u8_pack=u8_pack, dscorer=dscorer,
                    dkey=dkey,
                )
            else:
                block = _score_feature_windows_hybrid(
                    args, refidx, counts_r, name, k, sample, u8_pack,
                    dscorer=dscorer, dkey=dkey
                )
            if block is not None:
                pending.append(block)

    blocks = []
    total_windows = 0
    for block in pending:
        if len(block) > 0:
            # reference sorts each chromosome's windows by start
            order = np.argsort(block.start, kind="stable")
            blocks.append(block.select(order))
            total_windows += len(block)
    Logger.info(_CLASS, f"Number of windows: {total_windows}")
    header.window_count = total_windows
    with stage("write"), KCFWriter(out_path) as writer:
        writer.write_header(header)
        for block in blocks:
            block.finalize(weights)
            writer.write_block(block)
    Logger.info(
        _CLASS, f"Wrote {total_windows} windows to {out_path}"
    )


def _make_block(sample, name, starts, ends, ids, res, k):
    n = len(starts)
    block = WindowBlock(n, [sample])
    block.seq_names = [name] * n if isinstance(name, str) else list(name)
    block.start = np.asarray(starts, np.int64)
    block.end = np.asarray(ends, np.int64)
    block.window_id = list(ids)
    block.total_kmers = res["total"].astype(np.int64)
    block.eff_length = res["eff_length"].astype(np.int64)
    block.ob[0] = res["observed"]
    block.va[0] = res["variations"]
    block.inner[0] = res["inner"]
    block.left[0] = res["left"]
    block.right[0] = res["right"]
    block.kmer_count[0] = res["count_sum"].astype(np.int64)
    return block


def _chunk_geometry(window: int, step: int, k: int):
    """Fixed chunk length / windows-per-call so the whole run compiles
    exactly one program regardless of chromosome sizes. Chunks are large
    (8 Mbp) to amortize per-call host<->device latency."""
    Lp = window + PAD_MARGIN
    C = 1 << 23
    while C < 4 * Lp:
        C <<= 1
    c_step = C - Lp
    stride = step if step > 0 else max(1, window - k + 1)
    B = c_step // stride + 2
    return C, c_step, Lp, B


def _score_fixed_windows_hybrid(args, index, refidx, counts_r, name, k,
                                sample, plan=None, u8_pack=None,
                                dscorer=None, dkey=None):
    """Hybrid engine. Default path: the fused native scan - per-window
    gap-run state machine replayed directly over the cached per-position
    index with counts gathered from the u8 merge output; static fields
    (total, eff_length) come from the per-reference window plan. The
    'dprefix' variant runs the same positional pipeline on the device
    against a resident reference index. Fallback (no native library):
    the numpy global prefix decomposition (engine/prefix_scan.py)."""
    pl = plan[name] if plan is not None else None
    if pl is None and plan is not None:
        return None
    if pl is not None:
        starts, ends = pl["starts"], pl["ends"]
    else:
        seq_len = index.get_sequence_length(name)
        if args.step > 0:
            starts, ends = sliding_windows(seq_len, args.window, args.step, k)
        else:
            starts, ends = tiling_windows(seq_len, args.window, k)
        if len(starts) == 0:
            return None

    r_idx = refidx.chrom_r_idx[name]  # (L-k+1,)
    if dscorer is not None:
        res = (
            dict(dscorer.collect(dkey)[name])
            if dkey is not None
            else dscorer.score_chrom(name)
        )
        res["total"] = pl["total"]
        res["eff_length"] = pl["eff"]
    elif u8_pack is not None:
        u8, exc_idx, exc_val = u8_pack
        res = None
        scanner = pl.get("scanner") if pl is not None else None
        if (
            scanner is None
            and pl is not None
            and args.kmc.count(",") + 1 >= WORTH_SAMPLES
            and get_lib() is not None
        ):
            # many samples against one reference: build the ordinal
            # occurrence map once and score every sample with
            # sequential streams instead of the per-position gather.
            # Maps are retained across samples (that is the point), so
            # cap their cumulative size - huge genomes keep the
            # constant-memory gather scan for the remaining chromosomes
            budget = int(os.environ.get(
                "KCFTOOLS_SCANNER_BUDGET", str(2 << 30)
            ))
            spent = getattr(args, "_scanner_bytes", 0)
            need = 9 * int(r_idx.shape[0])  # occ map + bitmaps
            w_hi = (ends - k).astype(np.int32)
            if spent + need <= budget and OrdinalWindowScanner.usable(
                starts, w_hi
            ):
                scanner = OrdinalWindowScanner(
                    r_idx, starts, w_hi, k, args.min_k_count
                )
                pl["scanner"] = scanner
                args._scanner_bytes = spent + need
        if scanner is not None:
            res = scanner.score(u8, exc_idx, exc_val)
        if res is None:
            res = window_scan_u8(
                u8, exc_idx, exc_val, r_idx, args.min_k_count, k, starts,
                ends - k,
            )
        res["total"] = pl["total"]
        res["eff_length"] = pl["eff"]
    else:
        # numpy fallback: memoize the validity mask on the plan so a
        # multi-sample run decodes each chromosome once, not per sample
        valid = pl.get("valid") if pl is not None else None
        if valid is None:
            valid = index.sequence_codes(name)[1]
            if pl is not None:
                pl["valid"] = valid
        st = chromosome_stats_indirect(
            counts_r, r_idx, valid, args.min_k_count, k
        )
        res = window_stats(st, starts, ends)
    ids = [f"{name}_{s}" for s in starts]
    return _make_block(sample, name, starts, ends, ids, res, k)


def _score_feature_windows_hybrid(args, fidx, counts_r, name, k, sample,
                                  u8_pack, dscorer=None, dkey=None):
    """Hybrid engine for gene/transcript features: each feature is one
    window over the per-chromosome spliced-feature concatenation built
    by FeatureKmerIndex; per-sample counts come from the same u8 merge
    join as fixed windows, scored by the fused native scan. Supports
    every k the encoders support (k <= 64). Reference semantics:
    GetVariants.java:324-348 (feature windows), :202-261 (scoring)."""
    pl = fidx.chrom_plans.get(name)
    if pl is None:
        return None
    r_idx = pl["r_idx"]
    w_start, w_hi = pl["w_start"], pl["w_hi"]
    fields = ("observed", "variations", "inner", "left", "right",
              "count_sum")
    if dscorer is not None:
        res = (
            dict(dscorer.collect(dkey)[name])
            if dkey is not None
            else dscorer.score_chrom(name)
        )
    elif u8_pack is not None:
        u8, exc_idx, exc_val = u8_pack
        res = None
        scanner = pl.get("scanner")
        if (
            scanner is None
            and args.kmc.count(",") + 1 >= WORTH_SAMPLES
            and get_lib() is not None
            and "scanner" not in pl
        ):
            # feature windows over the spliced concatenation are
            # usually disjoint; reuse the multi-sample ordinal scanner
            # where they are (overlapping features keep the scan)
            budget = int(os.environ.get(
                "KCFTOOLS_SCANNER_BUDGET", str(2 << 30)
            ))
            spent = getattr(args, "_scanner_bytes", 0)
            need = 9 * int(r_idx.shape[0])
            if spent + need <= budget and OrdinalWindowScanner.usable(
                w_start, w_hi
            ):
                scanner = OrdinalWindowScanner(
                    r_idx, w_start, w_hi, k, args.min_k_count
                )
                args._scanner_bytes = spent + need
            pl["scanner"] = scanner  # None caches "not usable" too
        if scanner is not None:
            res = scanner.score(u8, exc_idx, exc_val)
        if res is None:
            res = window_scan_u8(
                u8, exc_idx, exc_val, r_idx, args.min_k_count, k,
                w_start, w_hi,
            )
    else:
        # numpy fallback: prefix decomposition over the concatenation;
        # features shorter than k keep zeros
        res = {f: np.zeros(len(w_start), np.int64) for f in fields}
        ok = np.flatnonzero(w_hi >= w_start)
        if ok.size:
            st = chromosome_stats_indirect(
                counts_r, r_idx, pl["valid"], args.min_k_count, k
            )
            sub = window_stats(st, w_start[ok], w_hi[ok] + k)
            for f in fields:
                res[f][ok] = sub[f]
    res["total"] = pl["total"]
    res["eff_length"] = pl["eff"]
    feats = pl["feats"]
    ids = [f[0] for f in feats]
    chroms = [f[1] for f in feats]
    starts = [f[2] for f in feats]
    ends = [f[3] for f in feats]
    return _make_block(sample, chroms, starts, ends, ids, res, k)


def _make_mesh_scorer(args, kmc, db_prefix, table, devices):
    """The mesh-sharded hash engine for one sample (JAX
    ``_make_scorer``, get_variations.py:597-639): window batches over
    the data axis, and a table axis once the table estimate (15 bytes a
    key) passes 4 GiB per device, or as KCFTOOLS_TABLE_AXIS says, cut to
    a divisor of the device count. Without --memory the KMC database
    streams straight into the table shards (KCFTOOLS_RAM_BUDGET bytes of
    host staging, 8 GiB by default); with it, the ingest's host table is
    re-placed shard-locally. Either is timed as the stage
    ``mesh_place``."""
    n_dev = len(devices)
    est_table = kmc.total_kmers * 15
    table_axis = 1
    if est_table > 4 << 30:
        table_axis = 2
        while est_table // table_axis > 4 << 30 and table_axis < n_dev:
            table_axis *= 2
    env_axis = os.environ.get("KCFTOOLS_TABLE_AXIS")
    if env_axis:
        table_axis = min(int(env_axis), n_dev)
    while n_dev % table_axis:
        table_axis //= 2
    mesh = make_mesh(data=n_dev // table_axis, table=table_axis)
    Logger.info(
        _CLASS,
        f"Using {n_dev} devices: mesh data={n_dev // table_axis} "
        f"table={table_axis}",
    )
    with stage("mesh_place"):
        if table is None:
            budget = int(os.environ.get("KCFTOOLS_RAM_BUDGET",
                                        str(8 << 30)))
            loader = ShardedTableLoader(db_prefix, mesh,
                                        ram_budget_bytes=budget)
            return loader.load_scorer(min_count=args.min_k_count)
        return ShardedWindowScorer(table, mesh, min_count=args.min_k_count)


def _run_hash_sample(args, index, gtf, k, scorer, sample, out_path):
    """One sample through the on-chip hash engine (gene/transcript
    features, or fixed windows on the mesh): score every chromosome's
    windows, then write the KCF as the JAX package's
    ``_run_one_sample`` does."""
    header = KCFHeader()
    header.reference = args.reference
    header.add_command_line(get_command_line())
    header.add_sample(sample)
    header.window_size = args.window
    header.step_size = args.step
    header.kmer_size = k
    header.is_ibs = False
    header.set_weights(args.wi, args.wt, args.wr)
    weights = (args.wi, args.wt, args.wr)

    Logger.info(_CLASS, "Generating windows...")
    blocks = []
    with stage("scan"):
        for name in index.get_sequence_names():
            header.add_contig(name, index.get_sequence_length(name))
            if args.feature == "window":
                block = _score_fixed_windows(args, index, name, k, scorer,
                                             sample)
            else:
                block = _score_feature_windows(args, index, gtf, name, k,
                                               scorer, sample)
            if block is not None and len(block) > 0:
                # reference sorts each chromosome's windows by start
                order = np.argsort(block.start, kind="stable")
                blocks.append(block.select(order))
    total_windows = sum(len(b) for b in blocks)
    Logger.info(_CLASS, f"Number of windows: {total_windows}")
    header.window_count = total_windows
    with stage("write"), KCFWriter(out_path) as writer:
        writer.write_header(header)
        for block in blocks:
            block.finalize(weights)
            writer.write_block(block)
    Logger.info(_CLASS, f"Wrote {total_windows} windows to {out_path}")


def _score_fixed_windows(args, index, name, k, scorer, sample):
    """One chromosome's fixed windows through the hash engine. A scorer
    with the chunked interface (WindowScorer) gets each chromosome base
    uploaded once, as sentinel-coded uint8 chunks whose windows are
    gathered on the device; a mesh-sharded scorer gets padded window
    batches (``_score_fixed_windows_batched``)."""
    seq_len = index.get_sequence_length(name)
    if args.step > 0:
        starts, ends = sliding_windows(seq_len, args.window, args.step, k)
    else:
        starts, ends = tiling_windows(seq_len, args.window, k)
    if len(starts) == 0:
        return None
    codes, valid = index.sequence_codes(name)
    if not hasattr(scorer, "score_chunk_async"):
        return _score_fixed_windows_batched(
            args, name, k, scorer, sample, codes, valid, starts, ends
        )
    with stage("hash_pad"):
        u8 = combine_u8(codes, valid)
    C, c_step, Lp, B = _chunk_geometry(args.window, args.step, k)
    win_len = (ends - starts).astype(np.int64)
    chunk_of = starts // c_step
    # rows: what this chromosome needs, rounded to a 128 granule
    B = min(B, -(-int(np.bincount(chunk_of).max()) // 128) * 128)
    handles = []
    for c in range(0, (seq_len // c_step) + 1):
        sel = np.flatnonzero(chunk_of == c)
        if sel.size == 0:
            continue
        with stage("hash_pad"):
            base = c * c_step
            chunk = u8[base : base + C]
            if chunk.shape[0] < C:
                chunk = np.concatenate(
                    [chunk, np.full(C - chunk.shape[0], 4, np.uint8)]
                )
            cstarts = np.zeros(B, np.int64)
            cwl = np.zeros(B, np.int64)
            cstarts[: sel.size] = starts[sel] - base
            cwl[: sel.size] = win_len[sel]
        handles.append(
            (scorer.score_chunk_async(chunk, cstarts, cwl, Lp), sel)
        )
    res = {}
    with stage("hash_fetch"):
        for handle, sel in handles:
            for key, v in scorer.collect(handle).items():
                res.setdefault(key, np.zeros(len(starts), np.int64))[sel] = (
                    v[: sel.size]
                )
    ids = [f"{name}_{s}" for s in starts]
    return _make_block(sample, name, starts, ends, ids, res, k)


def _score_fixed_windows_batched(args, name, k, scorer, sample, codes,
                                 valid, starts, ends):
    """Padded window batches of about 2^22 positions for mesh-sharded
    scorers; the scorer pads each batch to its data axis."""
    pad_len = args.window + PAD_MARGIN
    bsz = max(1, _BATCH_POSITIONS // pad_len)
    handles = []
    for off in range(0, len(starts), bsz):
        with stage("hash_pad"):
            bcodes, bvalid, win_len = batch_subsequences(
                codes, valid, starts[off : off + bsz],
                ends[off : off + bsz], pad_len,
            )
        handles.append(scorer.score_batch_async(bcodes, bvalid, win_len))
    parts = {}
    with stage("hash_fetch"):
        for handle in handles:
            for key, v in scorer.collect(handle).items():
                parts.setdefault(key, []).append(v)
    res = {key: np.concatenate(vs) for key, vs in parts.items()}
    ids = [f"{name}_{s}" for s in starts]
    return _make_block(sample, name, starts, ends, ids, res, k)


def _score_feature_windows(args, index, gtf, name, k, scorer, sample):
    """One chromosome's gene/transcript features through the hash
    engine: splice each feature, bucket by padded length, score the
    buckets in batches of about 2^22 positions."""
    is_gene = args.feature == "gene"
    feats = []  # (window_id, chrom, start, end)
    genes = gtf.get_genes(name)
    if not genes and not is_gene:
        Logger.warning(
            _CLASS, f"No genes found in GTF file for sequence: {name}"
        )
    for gene in genes:
        if is_gene:
            chrom, start, end, _ = gtf.get_loci(gene)
            feats.append((gene, chrom, start, end))
        else:
            transcripts = gtf.get_transcripts(gene)
            if not transcripts:
                Logger.error(
                    _CLASS,
                    f"No transcripts found for gene: {gene} in GTF file for "
                    f"sequence: {name}",
                )
            for tr in transcripts:
                chrom, start, end, _ = gtf.get_loci(tr)
                feats.append((tr, chrom, start, end))
    if not feats:
        return None

    spliced = []
    with stage("hash_splice"):
        for wid, _chrom, _start, _end in feats:
            cv = gtf.spliced_codes(wid, index, is_gene)
            if cv is None:
                Logger.error(_CLASS,
                             f"Fasta object is null for window: {wid}")
            spliced.append(cv)

    buckets = {}
    for i, (c, _v) in enumerate(spliced):
        buckets.setdefault(bucket_pad_len(len(c), k), []).append(i)

    # the submits stay outside the stages: they queue work on the
    # device and return, and a stage would not wait for it
    handles = []
    for pad_len, idxs in buckets.items():
        bsz = max(1, _BATCH_POSITIONS // pad_len)
        for off in range(0, len(idxs), bsz):
            part = idxs[off : off + bsz]
            with stage("hash_pad"):
                bcodes, bvalid, win_len = pad_batch_varlen(
                    [spliced[i][0] for i in part],
                    [spliced[i][1] for i in part],
                    pad_len,
                )
            handles.append(
                (scorer.score_batch_async(bcodes, bvalid, win_len), part)
            )

    res = {}
    with stage("hash_fetch"):
        for handle, part in handles:
            for key, v in scorer.collect(handle).items():
                res.setdefault(key, np.zeros(len(feats), np.int64))[part] = v
    return _make_block(
        sample, [f[1] for f in feats], [f[2] for f in feats],
        [f[3] for f in feats], [f[0] for f in feats], res, k,
    )
