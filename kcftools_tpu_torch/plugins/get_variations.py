"""getVariations for the port: screen reference k-mers against KMC
databases and write KCF.

Port of kcftools_tpu/plugins/get_variations.py::run. The parser, the
validation, the window plan, the KMC ingest helpers and the per-sample
assembly and KCF writer of the positional engines (``_run_one_sample``)
are the JAX package's host code, reused as they are. What the port owns
is the engine routing and the device engines. On one device:

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

from .._host import (
    GTF,
    FastaIndex,
    FeatureKmerIndex,
    KCFHeader,
    KCFWriter,
    KMCReader,
    Logger,
    PAD_MARGIN,
    RefKmerIndex,
    _common,
    batch_subsequences,
    bucket_pad_len,
    build_table,
    get_variations as _host,
    load_sorted_cache,
    pad_batch_varlen,
    set_threads,
    sliding_windows,
    stagetimer,
    tiling_windows,
)
from ..engine.device_join import DeviceJoinScorer
from ..engine.device_prefix import DevicePrefixScorer
from ..engine.pipeline import WindowScorer, combine_u8
from ..parallel.loader import ShardedTableLoader
from ..parallel.mesh import make_mesh
from ..parallel.sharded import ShardedWindowScorer
from ..torchinit import ENV, VIRTUAL_ENV, process_index, resolve_devices

_CLASS = "GetVariants"


def add_parser(subparsers):
    p = _host.add_parser(subparsers)
    p.set_defaults(func=run)
    return p


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
    every sample adds one KMC ingest, one join and the window stats."""
    _host._validate(args)
    stagetimer.reset()
    args.engine = _resolve_engine(args)
    devices = []
    if args.engine in ("device", "dprefix"):
        devices = resolve_devices()
    # the mesh-sharded hash engine takes --engine device on > 1 device
    mesh_hash = args.engine == "device" and len(devices) > 1
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
        with stagetimer.stage("ingest"):
            if positional:
                if k <= 64:
                    db_sorted = load_sorted_cache(db_prefix, k)
                # the device-join engine needs the full sorted table; the
                # budget gate only applies to the streamed alternative
                if db_sorted is None and (
                    args.memory or _host._db_fits_ram(kmc, k)
                    or args.engine == "device"
                ):
                    kmc._read_records()
                    db_sorted = _host._sort_db(kmc, k, db_prefix=db_prefix)
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
        with stagetimer.stage("merge_streamed"):
            u8, ei, ev = _host._merge_streamed(kmc, ref_keys, k)
        dscorer.submit_counts(key, u8, ei, ev)
    else:
        db_keys, dbc = db_sorted
        dscorer.submit(key, ref_keys, db_keys, dbc)


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
    with stagetimer.stage("mesh_place"):
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
    header.add_command_line(_common.get_command_line())
    header.add_sample(sample)
    header.window_size = args.window
    header.step_size = args.step
    header.kmer_size = k
    header.is_ibs = False
    header.set_weights(args.wi, args.wt, args.wr)
    weights = (args.wi, args.wt, args.wr)

    Logger.info(_CLASS, "Generating windows...")
    blocks = []
    with stagetimer.stage("scan"):
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
    with stagetimer.stage("write"), KCFWriter(out_path) as writer:
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
    u8 = combine_u8(codes, valid)
    C, c_step, Lp, B = _host._chunk_geometry(args.window, args.step, k)
    win_len = (ends - starts).astype(np.int64)
    chunk_of = starts // c_step
    # rows: what this chromosome needs, rounded to a 128 granule
    B = min(B, -(-int(np.bincount(chunk_of).max()) // 128) * 128)
    handles = []
    for c in range(0, (seq_len // c_step) + 1):
        sel = np.flatnonzero(chunk_of == c)
        if sel.size == 0:
            continue
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
    for handle, sel in handles:
        for key, v in scorer.collect(handle).items():
            res.setdefault(key, np.zeros(len(starts), np.int64))[sel] = (
                v[: sel.size]
            )
    ids = [f"{name}_{s}" for s in starts]
    return _host._make_block(sample, name, starts, ends, ids, res, k)


def _score_fixed_windows_batched(args, name, k, scorer, sample, codes,
                                 valid, starts, ends):
    """Padded window batches of about 2^22 positions for mesh-sharded
    scorers; the scorer pads each batch to its data axis."""
    pad_len = args.window + PAD_MARGIN
    bsz = max(1, _host._BATCH_POSITIONS // pad_len)
    handles = []
    for off in range(0, len(starts), bsz):
        bcodes, bvalid, win_len = batch_subsequences(
            codes, valid, starts[off : off + bsz], ends[off : off + bsz],
            pad_len,
        )
        handles.append(scorer.score_batch_async(bcodes, bvalid, win_len))
    parts = {}
    for handle in handles:
        for key, v in scorer.collect(handle).items():
            parts.setdefault(key, []).append(v)
    res = {key: np.concatenate(vs) for key, vs in parts.items()}
    ids = [f"{name}_{s}" for s in starts]
    return _host._make_block(sample, name, starts, ends, ids, res, k)


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
    for wid, _chrom, _start, _end in feats:
        cv = gtf.spliced_codes(wid, index, is_gene)
        if cv is None:
            Logger.error(_CLASS, f"Fasta object is null for window: {wid}")
        spliced.append(cv)

    buckets = {}
    for i, (c, _v) in enumerate(spliced):
        buckets.setdefault(bucket_pad_len(len(c), k), []).append(i)

    handles = []
    for pad_len, idxs in buckets.items():
        bsz = max(1, _host._BATCH_POSITIONS // pad_len)
        for off in range(0, len(idxs), bsz):
            part = idxs[off : off + bsz]
            bcodes, bvalid, win_len = pad_batch_varlen(
                [spliced[i][0] for i in part],
                [spliced[i][1] for i in part],
                pad_len,
            )
            handles.append(
                (scorer.score_batch_async(bcodes, bvalid, win_len), part)
            )

    res = {}
    for handle, part in handles:
        for key, v in scorer.collect(handle).items():
            res.setdefault(key, np.zeros(len(feats), np.int64))[part] = v
    return _host._make_block(
        sample, [f[1] for f in feats], [f[2] for f in feats],
        [f[3] for f in feats], [f[0] for f in feats], res, k,
    )
