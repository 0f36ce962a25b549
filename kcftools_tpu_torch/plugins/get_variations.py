"""getVariations for the port: screen reference k-mers against KMC
databases and write KCF.

Port of kcftools_tpu/plugins/get_variations.py::run. The parser, the
validation, the window plan, the KMC ingest helpers and the per-sample
assembly and KCF writer (``_run_one_sample``) are the JAX package's
host code, reused as they are. What the port owns is the engine
routing and the device engine:

- ``--engine device`` at k <= 32 on one GPU runs the port's
  DeviceJoinScorer (the join on the card);
- ``--engine hybrid``, and ``auto`` on at most one GPU, run the host
  engine (the native merge join and window scan), as the JAX package
  does;
- ``--engine dprefix``, gene/transcript features with ``--engine
  device``, and any engine choice that would spread over more than one
  GPU are not yet ported (ROADMAP) and raise; they never run on another
  engine instead.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import torch

from .._host import (
    GTF,
    FastaIndex,
    FeatureKmerIndex,
    KMCReader,
    Logger,
    RefKmerIndex,
    _common,
    get_variations as _host,
    load_sorted_cache,
    set_threads,
    stagetimer,
)
from ..engine.device_join import DeviceJoinScorer
from ..torchinit import device_count, resolve_device

_CLASS = "GetVariants"


def add_parser(subparsers):
    p = _host.add_parser(subparsers)
    p.set_defaults(func=run)
    return p


def _not_ported(what):
    Logger.error(_CLASS, f"{what} is not yet ported (ROADMAP)")


def _resolve_engine(args):
    """The concrete engine for this run (see the module docstring).
    KCFTOOLS_ENGINE overrides --engine; KCFTOOLS_NO_DEVICE_PROBE=1 keeps
    ``auto`` on the host engine without looking for GPUs."""
    engine = os.environ.get("KCFTOOLS_ENGINE") or args.engine
    if engine == "auto":
        if args.feature != "window" or os.environ.get(
            "KCFTOOLS_NO_DEVICE_PROBE"
        ):
            return "hybrid"
        n_dev = torch.cuda.device_count()
        if n_dev > 1:
            _not_ported(
                f"auto engine with {n_dev} GPUs (the genome sharded "
                "across GPUs)"
            )
        return "hybrid"
    if engine == "dprefix":
        _not_ported("--engine dprefix")
    if engine == "device" and args.feature != "window":
        _not_ported(f"-f {args.feature} with --engine device")
    return engine


def run(args):
    """Single- or multi-sample screening (-k a,b,c -s sa,sb,sc): the
    reference parse, k-mer index and window plan are built once and
    every sample adds one KMC ingest, one join and the window stats."""
    _host._validate(args)
    stagetimer.reset()
    args.engine = _resolve_engine(args)
    device = None
    if args.engine == "device":
        device = resolve_device()
        n_dev = device_count(device)
        if n_dev > 1:
            _not_ported(f"--engine device over {n_dev} GPUs")
    set_threads(args.threads)
    kmc_list = args.kmc.split(",")
    samples = [
        _common.clean_sample_name(s, _CLASS) for s in args.sample.split(",")
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

    index = FastaIndex(args.reference)
    gtf = GTF(args.gtf) if args.feature in ("gene", "transcript") else None

    def _ingest(db_prefix):
        """KMC decode + key sort (or the sorted sidecar), on a worker
        thread for sample i+1 while sample i is scored."""
        kmc = KMCReader(db_prefix, materialize=False)
        k = kmc.kmer_length
        db_sorted = None
        with stagetimer.stage("ingest"):
            if k <= 64:
                db_sorted = load_sorted_cache(db_prefix, k)
            # the device-join engine needs the full sorted table; the
            # budget gate only applies to the host engine's streamed
            # alternative
            if db_sorted is None and (
                args.memory or _host._db_fits_ram(kmc, k)
                or (args.engine == "device" and k <= 32)
            ):
                kmc._read_records()
                db_sorted = _host._sort_db(kmc, k, db_prefix=db_prefix)
        return kmc, db_sorted

    pool = (
        ThreadPoolExecutor(max_workers=1) if len(kmc_list) > 1 else None
    )
    pending = pool.submit(_ingest, kmc_list[0]) if pool else None

    refidx = None
    plan = None
    dscorer = None
    group = []  # device-engine samples submitted but not yet written

    def _flush_group():
        for key, g_kmc, g_k, g_sample, g_out in group:
            _host._run_one_sample(
                args, index, gtf, refidx, g_kmc, g_k, g_sample, g_out,
                True, plan, dscorer, None, None, dkey=key,
            )
            dscorer.discard(key)
        group.clear()

    for i, (db_prefix, sample, out_path) in enumerate(
        zip(kmc_list, samples, outputs)
    ):
        if pool is not None:
            kmc, db_sorted = pending.result()
            if i + 1 < len(kmc_list):
                pending = pool.submit(_ingest, kmc_list[i + 1])
        else:
            kmc, db_sorted = _ingest(db_prefix)
        k = kmc.kmer_length
        if args.engine == "device" and k > 32:
            Logger.error(
                _CLASS,
                f"k={k} > 32: the device-join engine supports k <= 32 "
                "(use hybrid)",
            )
        if refidx is None or refidx.k != k or (
            refidx.canonical != kmc.both_strands
        ):
            if group:
                _flush_group()  # a k change invalidates the device state
            if args.feature == "window":
                refidx = RefKmerIndex.load_or_build(
                    args.reference, index, k, canonical=kmc.both_strands
                )
                plan = _host._build_window_plan(args, index, refidx, k)
            else:
                refidx = FeatureKmerIndex.build(
                    index, gtf, k, kmc.both_strands,
                    args.feature == "gene",
                )
                plan = None
            dscorer = None
        if args.engine == "device" and dscorer is None:
            batch = (
                min(len(kmc_list), 16)
                if not os.environ.get("KCFTOOLS_DEVICE_BATCH")
                else None
            )
            dscorer = DeviceJoinScorer(
                refidx, k, device, min_count=args.min_k_count, batch=batch
            )
            for name, pl in plan.items():
                if pl is not None:
                    dscorer.add_chrom(
                        name, refidx.chrom_r_idx[name], pl["starts"],
                        pl["ends"],
                    )
        if dscorer is not None:
            # submit now; assemble + write once the group fills
            _host._submit_sample(args, refidx, kmc, k, db_sorted, dscorer, i)
            group.append((i, kmc, k, sample, out_path))
            if len(group) >= dscorer.batch:
                _flush_group()
            continue
        _host._run_one_sample(
            args, index, gtf, refidx, kmc, k, sample, out_path, True,
            plan, None, db_sorted, db_prefix,
        )
    if group:
        _flush_group()
    if pool is not None:
        pool.shutdown(wait=False)
    if dscorer is not None:
        dscorer.close()
    stagetimer.dump()
