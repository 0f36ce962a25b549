#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (kcftools_tpu_torch) on one GPU.

    python3 chip_smoke.py [--mbp 40] [--samples 3] [--seed 0]
                          [--kernels-only]

Phases (any failure exits non-zero; ``--kernels-only`` runs 1-3 and
prints the kernels' record with no launch counts):
  1. device   - the card's name, and its name and power limit as
                nvidia-smi reports them;
  2. build    - nvcc builds the port's kernels from csrc/ (pjoin.cu,
                gapscan.cu, hashscan.cu and route.cu, and h2d.cu's staged
                host-to-device copy, all builds at once;
                their ptxas
                registers and spills are printed), and g++ the port's
                native host library into kcftools_tpu_torch/_build - timed;
  3. kernels  - each kernel against its plain torch version on the
                card. The join at the edge shapes (EDGE_SHAPES) and the
                main path's (P = 2^16 partitions, Tq = Tt = 1024), on
                operands with duplicate keys, wrapping uint32 sums and the
                all-ones key; the window scan in its three modes on the
                edge cases of tests/torch_gapscan_cases.py (the ROWS and
                RUNS modes also on its long cases: groups of 1, 8 and 9
                rows, windows past 8,192 positions, multi-segment streams)
                and at the main shapes (the JOIN mode over one 2^24-position
                slab and over the main path's own 4 slabs of 10,485,760
                positions in one launch; the ROWS mode over 3 rows of the
                dprefix slab, SCAN_ROWS_N positions; the RUNS mode over the
                native run streams of the same rows; 4,970-position tiling
                windows), then both dprefix modes at a full group
                (GROUP_ROWS x GROUP_N: 8 rows of 2^26 positions) in three
                window layouts (-w 5000 tiling, -p 2500 sliding, feature
                windows of 1-200 kb, unsorted and overlapping).
                Outputs must be bit-identical; at the main shapes each
                kernel's time twice: ``ms``, a wrapper call's (CUDA events
                around 20 calls, the wrapper's host work included), and
                ``device_ms``, the kernel's own (20 calls captured in a
                CUDA graph, its replay timed with events); beside them
                the plain and library (``torch.searchsorted`` for the
                join; none for the scans) times and the bound (bytes over
                HBM_BYTES_PER_S), with the shares taken of ``device_ms``;
                for the JOIN mode the sector floor (SECTOR_BYTES a
                gathered count) and for the RUNS mode its design floor
                (the bound plus the decoded bitmaps written and read back
                once). The hash engine's probe and scan on the edge cases
                of tests/torch_hash_cases.py and at a gene batch (512 x
                8,192), the mesh's window batch (833 x 5,032) and a
                long-feature batch (4 x 2^20) against a 2^24-bucket
                table of ~44 M keys, timed there beside the bound and the
                sector floor (HASH_SECTOR a probed bucket row; 32 B a
                sector of counts holding a valid k-mer's), the probe also
                beside two gather yardsticks of the same bucket rows
                (``gather_ms``: one ``torch.index_select``; ``take_ms``:
                one ``torch.take`` of their int64 words), the card's rate
                for random 48-byte rows through PyTorch. The device
                join's reference routing (route_reference: the query
                tiles; route_slabs: the slot maps and valid bitmaps) on
                the cases of tests/torch_route_cases.py and at the lettuce
                cell's shapes (ROUTE_KEYS keys in 2^16 partitions, 3 slabs
                of 2^24 positions), timed there beside the bound (and, for
                the slot maps, the sector floor of their gather) and the
                host numpy they replaced (``host_ms``). The sample tiling
                (tile_sample: the join's table operand) on the same cases
                with three count kinds and at the cell's two samples
                (SAMPLE_KEYS keys; byte counts, then counts up to
                2^32 - 1 at the first one's width), bit-exact there against
                the plain version and the native host packer, timed beside
                the bound and that packer (``host_ms``). Transfers
                (``check_transfers``): a 526,770,780-byte source (the
                cell's sample upload) from warm heap memory and from a
                fresh read-only map of a raw file, copied to the card by
                a pageable ``.to()``, by ``h2d_staged`` (the device
                join's pinned staging; every staged copy bit-exact) at
                its constants and over a sweep of chunk sizes and
                depths, and once whole from pinned memory (the link's
                ceiling), in GB/s (the record's ``transfers``);
  4. slice    - synthesises a 40 Mbp reference in 4 chromosomes (N runs
                sprinkled) and 3 KMC samples at 1% SNPs (the third with
                counts > 255 up to 2^32 - 1, so both kernel variants
                run), then runs ``getVariations -f window -w 5000
                --engine device`` (k = 31) through the port's CLI, cold
                and warm, with the kernel launch counters zeroed just
                before each (one join, one scan and one sample tiling
                launch per sample, one launch of each routing wrapper a
                call);
                checks the KCF bytes against the
                port's
                ``--engine hybrid`` (host) output, the window count and
                that jax never loaded; prints windows/s and the
                per-phase seconds (pack, upload, join, scan, fetch).
  5. engines  - on the same data, the port's other single-GPU engines,
                each output's KCF bytes against ``--engine hybrid``'s:
                ``--engine dprefix -f window -w 5000`` cold and warm (the
                absent-run program, ``_score_runs``; peak device memory
                of the warm run at the default slab); a ``-p 2500``
                sliding dprefix run on one sample with
                ``KCFTOOLS_DPREFIX_UPLINK=bitmap`` (the bitmap program,
                ``_score_batch``); a dprefix run with
                ``KCFTOOLS_SORT_CACHE_BUDGET=0`` on a copy of a database
                without its sorted sidecar (the streamed ingest); and
                ``-f gene`` / ``-f transcript`` with ``--engine device``
                (the on-chip hash engine: ``hash_probe`` and ``hash_scan``
                launches, one each a batch, and ``table_lookup`` never on
                the card) and
                ``--engine dprefix`` over a synthetic GTF (~4,000 genes of
                1-10 kb, 1-3 transcripts of 2-6 exons, both strands, a few
                genes shorter than k). Call counters, zeroed before each
                run, show that each program ran on the card, and the
                scan kernel's launch counts that each dprefix program
                call launched it once for all rows of its group (the run
                program through ``runs_scan``, the bitmap program through
                ``rows_scan``); prints
                windows/s per engine and the dprefix_* stage seconds.
  6. mesh     - the multi-device tier on the visible GPUs, or, with one
                card, on a virtual mesh of 4 slots that all run on
                cuda:0 (KCFTOOLS_TORCH_VIRTUAL_DEVICES=4; correct at full
                data size, but no multi-GPU speed): ``--engine auto``
                (must take dprefix, slabs on more than one slot);
                ``--engine device -f window`` with KCFTOOLS_TABLE_AXIS=2
                (the mesh-sharded hash engine: a ``hash_probe`` per table
                shard for each ``hash_scan``, no ``table_lookup``), streamed
                by the loader and with ``--memory``; ``-f gene --engine
                device`` on the mesh; every KCF equal to phase 4's / 5's
                ``--engine hybrid`` bytes. Then ``MeshJoinScorer`` on a
                (2, 2) mesh for the three samples against
                ``DeviceJoinScorer`` (pjoin launches rising by the table
                axis per sample, scan launches by its data rows) and
                ``dryrun_multichip(4)``. Prints each
                run's wall time and windows/s under the card's name and
                power limit.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside it, the script exits non-zero and prints no
result.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

K = 31
WINDOW = 5000
N_CHROMS = 4
WINDOW_ARGS = ("-f", "window", "-w", str(WINDOW))
GENES_PER_CHROM = 1000  # ~4,000 genes on 40 Mbp: rice's gene density
SHORT_GENES_PER_CHROM = 2  # genes shorter than k
MAIN_P, MAIN_TQ, MAIN_TT = 1 << 16, 1024, 1024
# (P, Tq, Tt) beside the main shapes that reach every path of the join
# kernel: table or query rows too wide to stage (the chunked variant, with
# five builds and with one), widths off every multiple of 128 and of 4
# (packed rounds Tt down to a multiple of 4), fewer partitions than the
# persistent grid, one partition
EDGE_SHAPES = [(3, 700, 9000), (2, 20000, 64), (5, 77, 999), (100, 256, 512),
               (1, 1024, 1024)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (80 GB HBM3), NVIDIA's data sheet
DJOIN_SLAB = 1 << 24  # the device join's default slab (positions)
SCAN_WIN = 5000 - K + 1  # k-mer positions of a -w 5000 window
SCAN_ROWS_N = 39 << 20  # the dprefix slab of the 40 Mbp slice (pos_pad)
# a full dprefix group: KCFTOOLS_DEVICE_BATCH rows of one default slab
# (KCFTOOLS_DPREFIX_SLAB), under three window layouts: -w 5000 tiling,
# -p 2500 sliding, and feature windows (transcripts of genes spaced
# FEATURE_GAP apart, genes of 1-200 kb log-uniform, 1-3 transcripts each,
# unsorted and overlapping)
GROUP_ROWS, GROUP_N = 8, 1 << 26
GROUP_LAYOUTS = ("tiling", "sliding", "feature")
SLIDE_STEP = 2500
FEATURE_GAP = 40_000
# the device join's slabs of the 40 Mbp slice: one 10 Mbp chromosome each
MAIN_SLABS, MAIN_SLAB_POS, MAIN_SLAB_SPAN = 4, 10 << 20, 10_000_000 - K + 1
SECTOR_BYTES = 32  # what one random 4-byte gather moves from device memory
# name -> (wrapper, its launch counter, source, what it replaces)
KERNELS = {
    "pjoin_packed": ("pjoin_join", "launches_packed", "csrc/pjoin.cu",
                     "kcftools_tpu/ops/pjoin.py:179"),
    "pjoin_u32": ("pjoin_join", "launches_u32", "csrc/pjoin.cu",
                  "kcftools_tpu/ops/pjoin.py:198"),
    "gapscan_join": ("slabs_scan_join", "launches", "csrc/gapscan.cu",
                     "kcftools_tpu/engine/device_join.py:58"),
    "gapscan_rows": ("rows_scan", "launches", "csrc/gapscan.cu",
                     "kcftools_tpu/engine/device_prefix.py:167"),
    "gapscan_runs": ("runs_scan", "launches", "csrc/gapscan.cu",
                     "kcftools_tpu/engine/device_prefix.py:187"),
    "hash_probe": ("hash_probe", "launches", "csrc/hashscan.cu",
                   "kcftools_tpu/ops/lookup.py:36"),
    "hash_scan": ("hash_scan", "launches", "csrc/hashscan.cu",
                  "kcftools_tpu/engine/pipeline.py:192"),
    # host work moved to kernels: no TPU kernel or XLA program
    "route_reference": ("route_reference", "launches", "csrc/route.cu",
                        "host numpy: kcftools_tpu_torch/ops/pjoin.py:170 "
                        "tile_sorted and the slot of each key"),
    "route_slabs": ("route_slabs", "launches", "csrc/route.cu",
                    "host numpy: the device join's slot maps "
                    "(slot_of_ord[r_idx]) and np.packbits"),
    "tile_sample": ("tile_sample", "launches", "csrc/route.cu",
                    "host native: kcf_pjoin_hist + kcf_pjoin_pack into an "
                    "np.zeros buffer, the sample's table tiles"),
}
MAIN_PATH = ("pjoin_packed", "pjoin_u32", "gapscan_join", "route_reference",
             "route_slabs", "tile_sample")  # phase 4
ROUTE = ("route_reference", "route_slabs")  # once a call
# the hash engine's shapes: a gene batch of ~2^22 positions (the
# power-of-two bucket of 4-8 kb features), the mesh's -w 5000 window
# batch (2^22 // 5032 rows) and the batch of the longest features (2^22
# // 2^20 rows of up to 2^20 - 32 bases), against a 2^24-bucket table
# (one smoke-40M sample's ~44 M keys)
HASH_GENE, HASH_WINDOW, HASH_LONG = (512, 8192), (833, 5032), (4, 1 << 20)
HASH_KEYS = 44_000_000
HASH_SECTOR = 64  # a 48-byte bucket row always spans two 32-byte sectors
# the device join's reference routing at the lettuce cell's shapes: ~39.9 M
# reference k-mers in 2^ROUTE_B quantile partitions, ROUTE_SLABS slabs of
# DJOIN_SLAB positions, ROUTE_DEAD of them with no valid k-mer
ROUTE_KEYS, ROUTE_B, ROUTE_SLABS, ROUTE_DEAD = 39_900_000, 16, 3, 0.05
# a sample's table at the lettuce cell's shape: ~43.9 M keys, its two
# samples' counts (bytes; up to 2^32 - 1), the second at the first's width
SAMPLE_KEYS, SAMPLE_TOPS = 43_900_000, (255, (1 << 32) - 1)
# the device join's host-to-device copies: a source the size of the
# lettuce cell's sample upload (its sorted keys and counts, 12 B a key),
# and the staging chunk sizes and depths that the sweep tries
XFER_BYTES = 526_770_780
XFER_CHUNKS = (4 << 20, 8 << 20, 16 << 20, 32 << 20)
XFER_DEPTHS = (4, 8, 12, 16)
XFER_REPS = 3


def _wrapper(name):
    from kcftools_tpu_torch.ops import gapscan, hashscan, pjoin, route

    fn = KERNELS[name][0]
    if fn == "pjoin_join":
        return pjoin.pjoin_join
    if fn.startswith(("route", "tile")):
        return getattr(route, fn)
    return getattr(hashscan if fn.startswith("hash") else gapscan, fn)


def zero_launches(names):
    for name in names:
        setattr(_wrapper(name), KERNELS[name][1], 0)


def read_launches(names):
    return {name: getattr(_wrapper(name), KERNELS[name][1])
            for name in names}


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# -- phase 3: kernels against their plain versions ------------------------

def _rand_i32(shape, g, dev):
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=g,
                         device=dev, dtype=torch.int64).to(torch.int32)


def _i32_bits(x):
    """int64 values in [0, 2^32) -> int32 tensor with the same low bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def join_operands(dev, seed, P, Tq, Tt, packed):
    """Join operands at any shape: random 64-bit keys (half of the hi
    words have bit 31 set, as k = 32 keys do), a fifth of each table
    tile left as padding (key 0, count 0), the all-A key 0 as a real key
    in every seventh partition and as a query in every partition, half
    the queries hits and half misses. Beyond what real tiles hold, every
    partition has a duplicate key pair (whose uint32 counts wrap 2^32),
    and every third partition the all-ones key twice (the kernel's EMPTY
    marker); both are queried in every partition. Counts are bytes when
    packed, else full-range uint32 (>255 and >= 2^31). Needs Tq >= 3 and
    Tt >= 7."""
    g = torch.Generator(device=dev).manual_seed(seed)
    th, tl = _rand_i32((P, Tt), g, dev), _rand_i32((P, Tt), g, dev)
    if packed:
        cnt = torch.randint(1, 256, (P, Tt), generator=g, device=dev)
    else:
        cnt = torch.randint(1, 1 << 32, (P, Tt), generator=g, device=dev)
    pad = Tt - Tt // 5
    th[:, pad:] = 0
    tl[:, pad:] = 0
    cnt[:, pad:] = 0
    th[::7, 0] = 0
    tl[::7, 0] = 0
    th[:, 2] = th[:, 1]  # the duplicate pair
    tl[:, 2] = tl[:, 1]
    th[::3, 3:5] = -1  # the all-ones key, twice
    tl[::3, 3:5] = -1
    if not packed:
        cnt[:, 1] = 0xFFFFFFF0
        cnt[:, 2] = 0x20
        cnt[::3, 3:5] = 0xFFFFFFFF
    idx = torch.randint(0, pad, (P, Tq), generator=g, device=dev)
    qh, ql = th.gather(1, idx), tl.gather(1, idx)
    miss = torch.rand((P, Tq), generator=g, device=dev) < 0.5
    qh = torch.where(miss, _rand_i32((P, Tq), g, dev), qh)
    ql = torch.where(miss, _rand_i32((P, Tq), g, dev), ql)
    qh[:, 0] = 0
    ql[:, 0] = 0
    qh[:, 1] = th[:, 1]
    ql[:, 1] = tl[:, 1]
    qh[:, 2] = -1
    ql[:, 2] = -1
    if packed:
        W = Tt // 4
        tc = _i32_bits(cnt[:, :W] | (cnt[:, W:2 * W] << 8)
                       | (cnt[:, 2 * W:3 * W] << 16) | (cnt[:, 3 * W:] << 24))
    else:
        tc = _i32_bits(cnt)
    return [t.contiguous() for t in (qh, ql, th, tl, tc)]


def library_join(ops, packed):
    """The nearest library formulation of the join, as a yardstick the
    port never calls: each table row sorted by its signed 64-bit key
    (not timed), then, timed, a batched ``torch.searchsorted`` of the
    queries' int64 keys, the gather and the equality mask. It returns
    one matching slot's count, not the sum over duplicates."""
    from kcftools_tpu_torch.ops.pjoin import unpack_planar

    qh, ql, th, tl, tc = ops
    tk = (th.long() << 32) | (tl.long() & 0xFFFFFFFF)
    cnt = unpack_planar(tc) if packed else tc.long() & 0xFFFFFFFF
    tk, order = tk.sort(dim=1)
    cnt = cnt.gather(1, order)
    qk = (qh.long() << 32) | (ql.long() & 0xFFFFFFFF)
    last = tk.shape[1] - 1
    del order

    def run():
        i = torch.searchsorted(tk, qk).clamp_(max=last)
        return torch.where(tk.gather(1, i) == qk, cnt.gather(1, i), 0)

    return run


def _event_ms(fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters=20):
    """The card's own time of one call of ``fn`` (built and warmed up
    already): ``iters`` calls captured in a CUDA graph and its replay
    timed with CUDA events, so the wrapper's host work (argument checks,
    allocations, the ctypes call) is not in it."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    ms = _event_ms(graph.replay, 3) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


def _kernel_times(fn, bound_bytes):
    """Three warm-up calls, then {ms (a wrapper call's, host work
    included), device_ms, bound_ms, bound_by, bound_share (of
    device_ms)}."""
    for _ in range(3):
        fn()
    row = {"ms": _event_ms(fn, 20), "device_ms": _device_ms(fn),
           "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes"}
    row["bound_share"] = row["bound_ms"] / row["device_ms"]
    return row


def _times(fn, ref, bound_bytes):
    """``_kernel_times`` and the plain version's ms (one call)."""
    row = _kernel_times(fn, bound_bytes)
    row["plain_ms"] = _event_ms(ref, 1)
    return row


def _check_exact(name, ops, packed, shape):
    from kcftools_tpu_torch.ops.pjoin import pjoin_join, pjoin_join_ref

    got = pjoin_join(*ops, packed=packed)
    want = pjoin_join_ref(*ops, packed=packed)
    torch.cuda.synchronize()
    err = int(((got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF))
              .abs().max())
    if not torch.equal(got, want):
        fail(f"{name} {shape}: kernel differs from the plain version "
             f"(max abs err {err})")
    return err, int((want != 0).sum())


def check_kernels(dev, seed, P, Tq, Tt):
    """Each join variant bit-exact against its plain version at the edge
    shapes and at the main path's, then timed at the main path's: the
    kernel, the plain version and the library yardstick, beside the
    least time the card could take (every operand byte read once and
    the output written once, at HBM_BYTES_PER_S)."""
    from kcftools_tpu_torch.ops.pjoin import pjoin_join, pjoin_join_ref

    rows = {}
    for name, packed in (("pjoin_packed", True), ("pjoin_u32", False)):
        for shape in EDGE_SHAPES:
            p, tq, tt = shape
            tt -= tt % 4 if packed else 0
            _check_exact(name, join_operands(dev, seed, p, tq, tt, packed),
                         packed, (p, tq, tt))
        ops = join_operands(dev, seed, P, Tq, Tt, packed)
        err, hits = _check_exact(name, ops, packed, (P, Tq, Tt))
        if hits < P * Tq // 4:
            fail(f"{name}: only {hits} nonzero join results - bad operands")
        nbytes = 4 * (sum(t.numel() for t in ops) + P * Tq)
        row = {"max_abs_err": err, **_times(
            lambda: pjoin_join(*ops, packed=packed),
            lambda: pjoin_join_ref(*ops, packed=packed), nbytes)}
        lib = library_join(ops, packed)
        for _ in range(2):
            lib()
        row["library_ms"] = _event_ms(lib, 20)
        del lib
        log(f"{name}: exact at {EDGE_SHAPES} and P={P} Tq={Tq} Tt={Tt} "
            f"(max_abs_err {err}, {hits} nonzero); {nbytes} bytes; "
            f"{json.dumps(row)}")
        rows[name] = row
        del ops
        torch.cuda.empty_cache()
    return rows


# -- phase 3: the window scan -------------------------------------------

def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _scan_valid(g, n, dev):
    """Valid positions: scattered invalid ones and an N run of 4,000
    positions every 250 kb."""
    valid = torch.rand(n, generator=g, device=dev) > 0.002
    for a in torch.randint(0, n - 4000, (n // 250_000,), generator=g,
                           device=dev).tolist():
        valid[a : a + 4000] = False
    return valid


def _snp_presence(g, rows, n, valid, dev):
    """(rows, n) presence as a sample at 1% SNPs shows it: a position is
    absent where one of the K positions up to it holds a SNP."""
    snp = (torch.rand((rows, n), generator=g, device=dev) < 0.01).int()
    cs = torch.cumsum(snp, 1, dtype=torch.int32)
    cs[:, K:] -= cs[:, :-K].clone()
    return (cs == 0) & valid


def _pad_windows(ws, wh, dev):
    """Window bounds padded with [0, 0] entries to a multiple of 1,024
    (the layout's window bucket)."""
    pad = torch.zeros(-ws.numel() % 1024, dtype=torch.int64, device=dev)
    return torch.cat([ws, pad]), torch.cat([wh, pad])


def _tiling(n, dev, span=None):
    """SCAN_WIN-position tiling windows over the first ``span`` (default
    n) positions, padded."""
    span = n if span is None else span
    ws = torch.arange(0, span - SCAN_WIN + 1, SCAN_WIN, device=dev)
    return _pad_windows(ws, ws + SCAN_WIN - 1, dev)


def _windows(layout, n, g, dev):
    """The window bounds of a layout over n positions, padded."""
    if layout == "tiling":
        return _tiling(n, dev)
    if layout == "sliding":
        ws = torch.arange(0, n - SCAN_WIN + 1, SLIDE_STEP, device=dev)
        return _pad_windows(ws, ws + SCAN_WIN - 1, dev)
    genes = n // FEATURE_GAP
    glen = torch.exp(torch.empty(genes, device=dev).uniform_(
        float(np.log(1000)), float(np.log(200_000)), generator=g)).long()
    gs = (torch.rand(genes, generator=g, device=dev) * (n - glen)).long()
    ntx = torch.randint(1, 4, (genes,), generator=g, device=dev)
    gene = torch.repeat_interleave(torch.arange(genes, device=dev), ntx)
    cut = torch.rand((2, gene.numel()), generator=g, device=dev) * 0.1
    ws = gs[gene] + (cut[0] * glen[gene]).long()
    wh = gs[gene] + glen[gene] - 1 - (cut[1] * glen[gene]).long()
    order = torch.randperm(ws.numel(), generator=g, device=dev)
    # a feature of bases [a, b] holds the k-mer starts [a, b - K + 1]
    return _pad_windows(ws[order], wh[order] - K + 1, dev)


def scan_join_operands(dev, seed, min_count, slabs=1, n=None, span=None):
    """The JOIN mode over ``slabs`` slabs of n (default DJOIN_SLAB)
    positions (one sample),
    each tiled over its first ``span`` positions (the rest invalid
    padding): every position holds a distinct slot of MAIN_P * MAIN_TQ
    routed counts (0 at invalid positions), present counts in
    [min_count, 255] and every thousandth at or above 2^31, absent ones
    below min_count. Returns (args, bytes the scan must move, the sector
    floor's bytes: the same with SECTOR_BYTES a gathered count)."""
    from kcftools_tpu_torch.ops.gapscan import _pack_bits

    g = torch.Generator(device=dev).manual_seed(seed)
    n = DJOIN_SLAB if n is None else n
    span = n if span is None else span
    valid = torch.stack([_scan_valid(g, n, dev) for _ in range(slabs)])
    valid[:, span:] = False
    pres = torch.cat([_snp_presence(g, 1, n, v, dev) for v in valid])
    n_routed = MAIN_P * MAIN_TQ
    slots = torch.randperm(n_routed, generator=g,
                           device=dev)[: slabs * n].view(slabs, n)
    cnt = torch.randint(min_count, 256, (slabs, n), generator=g, device=dev)
    big = cnt.view(-1)[::1000]
    cnt.view(-1)[::1000] = torch.randint(1 << 31, 1 << 32, big.shape,
                                         generator=g, device=dev)
    low = torch.randint(0, min_count, (slabs, n), generator=g, device=dev)
    routed = torch.zeros(n_routed, dtype=torch.int64, device=dev)
    routed[slots] = torch.where(pres, cnt, low)
    slot_map = torch.where(valid, slots, 0).to(torch.int32)
    ws, wh = _tiling(n, dev, span)
    args = [_i32_bits(routed), slot_map, _pack_bits(valid),
            ws.expand(slabs, -1).contiguous(), wh.expand(slabs, -1).contiguous()]
    n_valid = int(valid.sum())
    rest = slabs * (4 * n + n // 8 + (16 + 48) * ws.numel())
    return args, rest + 4 * n_valid, rest + SECTOR_BYTES * n_valid


def scan_rows_operands(dev, seed, rows, n=SCAN_ROWS_N):
    """The ROWS mode over one dprefix slab: ``rows`` presence bitmaps of
    n positions (default the slice's slab), tiling windows."""
    from kcftools_tpu_torch.ops.gapscan import _pack_bits

    g = torch.Generator(device=dev).manual_seed(seed)
    valid = _scan_valid(g, n, dev)
    pres = _pack_bits(_snp_presence(g, rows, n, valid, dev))
    return [pres, _pack_bits(valid[None])[0], *_tiling(n, dev)]


def window_bytes(ws, wh, n_bytes):
    """The bytes of an n_bytes bitmap that lie under the union of the
    windows (an inverted window's span [wh + 1, ws - 1] included): the
    only bitmap bytes the scan needs."""
    lo = torch.minimum(ws, wh + 1).clamp(0, 8 * n_bytes - 1) // 8
    hi = torch.maximum(wh, ws - 1).clamp(0, 8 * n_bytes - 1) // 8
    some = torch.maximum(wh, ws - 1) >= torch.minimum(ws, wh + 1)
    diff = torch.zeros(n_bytes + 1, dtype=torch.int32, device=ws.device)
    one = torch.ones(int(some.sum()), dtype=torch.int32, device=ws.device)
    diff.index_add_(0, lo[some], one)
    diff.index_add_(0, hi[some] + 1, -one)
    return int((torch.cumsum(diff, 0)[:-1] > 0).sum())


def rows_bytes(args):
    """The bytes the ROWS mode must move: every bitmap read once under
    the windows, the bounds, the output."""
    pres, vb, ws, wh = args
    rows = pres.shape[0]
    return ((rows + 1) * window_bytes(ws, wh, vb.numel())
            + (16 + 40 * rows) * ws.numel())


def scan_runs_operands(rows_args):
    """The RUNS mode at the same shapes: the absent-run streams that the
    native kcf_bits_to_runs makes of the ROWS mode's presence rows, in
    the dprefix engine's run budget (twice the longest stream, rounded up
    to 4,096 entries)."""
    from kcftools_tpu_torch.native import bits_to_runs

    pres, vb, ws, wh = rows_args
    n = 8 * vb.numel()
    vb_host = vb.cpu().numpy()
    streams = []
    for row in pres.cpu().numpy():
        d, ln, n_runs = bits_to_runs(row, vb_host, n, n // 16)
        if n_runs < 0:
            fail("run streams: the encoder overflowed its scratch")
        streams.append((d, ln, n_runs))
    R = max(4096, -(-2 * max(s[2] for s in streams) // 4096) * 4096)
    dl = np.zeros((len(streams), 2, R), np.uint8)
    for r, (d, ln, _n) in enumerate(streams):
        dl[r, 0], dl[r, 1] = d[:R], ln[:R]
    return [torch.from_numpy(dl).to(vb.device), vb, ws, wh]


def runs_bytes(args):
    """(bytes the RUNS mode must move: the streams, the valid bitmap
    under the windows, bounds and output; the design floor's bytes: the
    same plus the decoded bitmaps, the kernel's own scratch, written
    whole and read back under the windows)."""
    dl, vb, ws, wh = args
    rows, R = dl.shape[0], dl.shape[2]
    covered = window_bytes(ws, wh, vb.numel())
    nbytes = 2 * rows * R + covered + (16 + 40 * rows) * ws.numel()
    return nbytes, nbytes + rows * (vb.numel() + covered)


def _scan_exact(name, fn, ref, args, kw, what, timed=False):
    """One launch bit-exact against the plain version; returns the
    kernel's output and the max abs error (of the uint32 values an int32
    output holds), and with ``timed`` the plain call's ms (CUDA events)."""
    got = fn(*args, **kw)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = ref(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    g, w = got.long(), want.long()
    if got.dtype == torch.int32:
        g, w = g & 0xFFFFFFFF, w & 0xFFFFFFFF
    err = int((g - w).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        fail(f"{name} {what}: kernel differs from the plain version "
             f"(max abs err {err})")
    if timed:
        return got, err, start.elapsed_time(end)
    return got, err


def _scan_edges(dev, seed, modes):
    """Every mode on the edge cases of tests/torch_gapscan_cases.py (the
    ROWS and RUNS modes also on its long cases: groups of 1, 8 and 9
    rows over slabs of LONG_N and ODD_N positions); returns how many."""
    from tests.torch_gapscan_cases import (
        LONG_N,
        ODD_N,
        bits,
        join_case,
        long_rows_case,
        long_runs_case,
        rows_case,
        runs_case,
        slabs_case,
    )

    n_edge = 0
    for mc in (1, 3):
        for case in (seed, seed + 1):
            routed, slot_map, valid, ws, wh = join_case(case, mc,
                                                        inverted=True)
            args = _on(dev, routed.view(np.int32), slot_map[None],
                       bits(valid)[None], ws[None], wh[None])
            _scan_exact("gapscan_join", *modes["gapscan_join"], args,
                        {"k": K, "min_count": mc}, f"edge case {case}")
            routed, slot_maps, valid, ws, wh = slabs_case(case, mc,
                                                          inverted=True)
            args = _on(dev, routed.view(np.int32), slot_maps, bits(valid),
                       ws, wh)
            _scan_exact("gapscan_join", *modes["gapscan_join"], args,
                        {"k": K, "min_count": mc}, f"slabs case {case}")
            n_edge += 2
    for k in (17, 31, 45):
        pr, valid, ws, wh = rows_case(seed + k, k, inverted=True)
        _scan_exact("gapscan_rows", *modes["gapscan_rows"],
                    _on(dev, bits(pr), bits(valid), ws, wh), {"k": k},
                    f"edge case k={k}")
        dl, valid, ws, wh = runs_case(seed + k, k)
        _scan_exact("gapscan_runs", *modes["gapscan_runs"],
                    _on(dev, dl, bits(valid), ws, wh), {"k": k},
                    f"edge case k={k}")
        n_edge += 2
    for rows, n, pad in ((1, LONG_N, 16), (8, LONG_N, 16), (9, ODD_N, 9)):
        pr, valid, ws, wh = long_rows_case(seed + rows, K, rows, n,
                                           inverted=True)
        _scan_exact("gapscan_rows", *modes["gapscan_rows"],
                    _on(dev, bits(pr), bits(valid), ws, wh), {"k": K},
                    f"long case, {rows} rows of {n}")
        dl, valid, ws, wh = long_runs_case(seed + rows, K, rows, n, pad)
        _scan_exact("gapscan_runs", *modes["gapscan_runs"],
                    _on(dev, dl, bits(valid), ws, wh), {"k": K},
                    f"long case, {rows} rows of {n}")
        n_edge += 2
    return n_edge


def _time_scan(name, fn, ref, args, kw, nbytes, floor_bytes=None,
               floor="sector"):
    """Bit-exact check (its plain call timed), then the wrapper call's
    and the device ms beside the bound (and the sector or design
    floor)."""
    shape = ("x".join(map(str, args[1].shape)) if name == "gapscan_join"
             else f"{args[0].shape[0]} rows x {8 * args[1].shape[-1]}")
    what = f"{shape} positions, {args[-1].shape[-1]} windows"
    _, err, plain_ms = _scan_exact(name, fn, ref, args, kw, what,
                                   timed=True)
    row = {"max_abs_err": err, "what": what, "library_ms": None,
           **_kernel_times(lambda: fn(*args, **kw), nbytes),
           "plain_ms": plain_ms}
    if floor_bytes is not None:
        row[f"{floor}_floor_ms"] = floor_bytes / HBM_BYTES_PER_S * 1e3
        row[f"{floor}_floor_share"] = (row[f"{floor}_floor_ms"]
                                       / row["device_ms"])
    return row


def _log_scan(name, row, n_edge):
    extra = ""
    if "sector_floor_ms" in row:
        extra = (f"; sector floor {row['sector_floor_ms']} ms (share "
                 f"{row['sector_floor_share']}); main path's slabs "
                 f"{json.dumps(row['main_slabs'])}")
    if "design_floor_ms" in row:
        extra = (f"; design floor (decoded bitmaps written and read back) "
                 f"{row['design_floor_ms']} ms (share "
                 f"{row['design_floor_share']})")
    log(f"{name}: exact on {n_edge} edge cases and at {row['what']} "
        f"(max_abs_err {row['max_abs_err']}); call {row['ms']} ms, "
        f"device {row['device_ms']} ms, plain {row['plain_ms']} ms; "
        f"bound {row['bound_ms']} ms, share {row['bound_share']}{extra}")


def check_scan(dev, seed):
    """The scan kernel in its three modes bit-exact against its plain
    version on the edge cases and at the main shapes, then timed there:
    kernel, plain version and the bound (each input byte read once, each
    output written once, at HBM_BYTES_PER_S); the JOIN mode also beside
    its sector floor and at the main path's own slabs (MAIN_SLABS x
    MAIN_SLAB_POS positions, one launch), the RUNS mode beside its design
    floor. The ROWS and RUNS modes also at a full dprefix group
    (GROUP_ROWS x GROUP_N) in each of GROUP_LAYOUTS (the record's
    ``group``). No single PyTorch call computes the scan, so library_ms
    is null."""
    from kcftools_tpu_torch.ops import gapscan

    modes = {
        "gapscan_join": (gapscan.slabs_scan_join,
                         gapscan.slabs_scan_join_ref),
        "gapscan_rows": (gapscan.rows_scan, gapscan.rows_scan_ref),
        "gapscan_runs": (gapscan.runs_scan, gapscan.runs_scan_ref),
    }
    n_edge = _scan_edges(dev, seed, modes)
    jkw = {"k": K, "min_count": 3}
    rows = {}
    args, nbytes, floor = scan_join_operands(dev, seed, 3)
    row = _time_scan("gapscan_join", *modes["gapscan_join"], args, jkw,
                     nbytes, floor)
    del args
    args, m_bytes, m_floor = scan_join_operands(
        dev, seed + 1, 3, MAIN_SLABS, MAIN_SLAB_POS, MAIN_SLAB_SPAN)
    main = _time_scan("gapscan_join", *modes["gapscan_join"], args, jkw,
                      m_bytes, m_floor)
    row["main_slabs"] = {f: main[f] for f in ("what", "ms", "device_ms",
                                              "bound_ms", "sector_floor_ms")}
    rows["gapscan_join"] = row
    del args
    torch.cuda.empty_cache()
    rows_args = scan_rows_operands(dev, seed, 3)
    runs_args = scan_runs_operands(rows_args)
    rows["gapscan_rows"] = _time_scan("gapscan_rows", *modes["gapscan_rows"],
                                      rows_args, {"k": K},
                                      rows_bytes(rows_args))
    rows["gapscan_runs"] = _time_scan("gapscan_runs", *modes["gapscan_runs"],
                                      runs_args, {"k": K},
                                      *runs_bytes(runs_args), floor="design")
    del rows_args, runs_args
    torch.cuda.empty_cache()
    for name, row in rows.items():
        _log_scan(name, row, n_edge)
        del row["what"]
    # a full group, in each window layout
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    rows_args = scan_rows_operands(dev, seed + 2, GROUP_ROWS, GROUP_N)
    runs_args = scan_runs_operands(rows_args)
    for layout in GROUP_LAYOUTS:
        ws, wh = _windows(layout, GROUP_N, g, dev)
        for name, base in (("gapscan_rows", rows_args),
                           ("gapscan_runs", runs_args)):
            args = [*base[:2], ws, wh]
            if name == "gapscan_rows":
                row = _time_scan(name, *modes[name], args, {"k": K},
                                 rows_bytes(args))
            else:
                row = _time_scan(name, *modes[name], args, {"k": K},
                                 *runs_bytes(args), floor="design")
            _log_scan(f"{name} [{layout}]", row, n_edge)
            rows[name].setdefault("group", {})[layout] = row
            torch.cuda.empty_cache()
    return rows


# -- phase 3: the hash engine's probe and scan ---------------------------

def _hash_edges(dev):
    """Both kernels on the edge cases of tests/torch_hash_cases.py (k 11 /
    16 / 17 / 31 / 32 on both strands and one, hand-made tables of 1 and
    2 buckets, shards of 2 and 4, min_count 0 / 1 / 3); returns how
    many."""
    from kcftools_tpu_torch.engine.hashtable import (
        build_table,
        build_table_sharded,
    )
    from kcftools_tpu_torch.ops import hashscan as hs
    from tests.torch_hash_cases import (
        KS,
        MIN_COUNTS,
        counts_case,
        hand_table,
        rows_case,
        table_keys,
    )

    n = 0
    probe = ("hash_probe", hs.hash_probe, hs.hash_probe_ref)
    scan = ("hash_scan", hs.hash_scan, hs.hash_scan_ref)
    for k in KS:
        u8, wl = rows_case(k + 1, k)
        for both in (True, False):
            tbl = build_table(*table_keys(k, u8, wl, k, both), k,
                              both_strands=both).tbl
            _scan_exact(*probe, _on(dev, u8, wl, tbl.view(np.int32)),
                        {"k": k, "both_strands": both}, f"k={k}")
            n += 1
        u8, wl = rows_case(k, k)
        for mc in MIN_COUNTS:
            _scan_exact(*scan, _on(dev, u8, counts_case(k + mc, u8).view(
                np.int32), wl), {"k": k, "min_count": mc},
                f"k={k} min_count={mc}")
            n += 1
    for nb in (1, 2):
        u8, wl = rows_case(nb, 32)
        _scan_exact(*probe, _on(dev, u8, wl, hand_table(
            u8, wl, 32, True, nb).view(np.int32)),
            {"k": 32, "both_strands": True}, f"{nb}-bucket table")
        n += 1
    for t_axis in (2, 4):
        u8, wl = rows_case(40 + t_axis, K)
        keys, counts = table_keys(41, u8, wl, K, True)
        table = build_table_sharded(keys, counts, K, t_axis)
        nb = table.n_buckets // t_axis
        for s in range(t_axis):
            _scan_exact(*probe, _on(dev, u8, wl, table.tbl[
                s * nb : (s + 1) * nb].view(np.int32)),
                {"k": K, "both_strands": True, "nb_total": table.n_buckets,
                 "shard": s}, f"shard {s} of {t_axis}")
            n += 1
    return n


def hash_batch(rng, B, Lp, lo, hi, n_rate=0.01):
    """(u8, win_len) of a padded batch: win_len uniform in [lo, hi], random
    bases with ~n_rate N, the sentinel past each window."""
    wl = rng.integers(lo, hi + 1, B).astype(np.int64)
    u8 = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    u8[rng.random((B, Lp)) < n_rate] = 4
    u8[np.arange(Lp)[None, :] >= wl[:, None]] = 4
    return u8, wl


def _batch_kmers(u8, wl):
    """The canonical k-mers of a batch's valid starts (uint64)."""
    from kcftools_tpu_torch.engine.encode import canonicalize, pack_kmers

    out = []
    for row, n in zip(u8, wl):
        km, kv = pack_kmers(row[:n], row[:n] < 4, K)
        out.append(canonicalize(km[kv], K))
    return np.concatenate(out)


def hash_table(dev, rng, batches, frac=0.72):
    """A ~HASH_KEYS-key table (2^24 buckets): ``frac`` of the batches'
    distinct k-mers and random canonical k-mers, counts up to 2^32 - 1.
    Returns the table on ``dev`` and its bucket count."""
    from kcftools_tpu_torch.engine.encode import canonicalize
    from kcftools_tpu_torch.engine.hashtable import build_table
    from kcftools_tpu_torch.native import sort_pairs

    q = np.unique(np.concatenate([_batch_kmers(*b) for b in batches]))
    q = q[rng.random(q.shape[0]) < frac]
    more = canonicalize(rng.integers(0, 1 << (2 * K), HASH_KEYS - q.shape[0],
                                     dtype=np.uint64), K)
    keys, _ = sort_pairs(np.concatenate([q, more]),
                         np.zeros(HASH_KEYS, np.uint32))
    keys = keys[np.r_[True, keys[1:] != keys[:-1]]]
    counts = rng.integers(1, 1 << 32, keys.shape[0], dtype=np.uint64)
    table = build_table(keys, counts.astype(np.uint32), K)
    (tbl,) = _on(dev, table.tbl.view(np.int32))
    return tbl, table.n_buckets


def hash_bytes(u8, wl, nb):
    """The bytes each hash kernel must move on the card's batch, and its
    sector floor's, counted from this batch's data. Returns ((probe,
    probe floor), (scan, scan floor), valid k-mers, the probed bucket
    rows' indices: h1 of each valid k-mer, then h2 where it differs).

    probe: 1 B read a base of the valid k-mers' span (up to win_len, none
    in a row shorter than k), 4 B written a k-mer start, 48 B (floor:
    HASH_SECTOR) a probed bucket row: one a valid k-mer, two where its
    hashes differ. scan: the rows read once (eff_length reads every
    byte), 4 B read a valid k-mer's count (floor: the 32-byte sectors of
    the counts that hold one), win_len and the (8, B) int64 output."""
    from kcftools_tpu_torch.ops.hashscan import PAD_MARGIN, _kmer_valid
    from kcftools_tpu_torch.ops.kmerize import (
        assemble_kmers,
        canonical_select,
        rolling_pack_u32,
    )
    from kcftools_tpu_torch.ops.lookup import bucket_hashes

    B, Lp = u8.shape
    n_out = Lp - PAD_MARGIN
    valid = u8 < 4
    w32, rcw32 = rolling_pack_u32(torch.where(valid, u8, 0).long())
    hi, lo = canonical_select(*assemble_kmers(w32, rcw32, K, n_out))
    h1, h2 = bucket_hashes(hi, lo, nb)
    kv = _kmer_valid(valid, wl, K, n_out)
    n_valid = int(kv.sum())
    probed = torch.cat([h1[kv], h2[kv & (h1 != h2)]])
    rows = probed.numel()
    span = torch.where(wl >= K, torch.clamp(wl, max=n_out + K - 1), 0)
    rest = int(span.sum()) + 4 * B * n_out
    # the sectors of the contiguous (B, n_out) counts, 8 counts each
    flat = torch.nn.functional.pad(kv.reshape(-1), (0, -kv.numel() % 8))
    sectors = int(flat.view(-1, 8).any(dim=1).sum())
    srest = B * Lp + (8 + 64) * B
    return ((rest + 48 * rows, rest + HASH_SECTOR * rows),
            (srest + 4 * n_valid, srest + 32 * sectors), n_valid, probed)


def gather_yardstick(tbl, probed):
    """The card's rate for the probe's random 48-byte bucket rows, from two
    PyTorch calls that the port never makes, over the rows the batch's
    valid k-mers probe (``probed``), each read once (two 32-byte sectors)
    and written once (48 B): ``torch.index_select`` of the (nb, 12) int32
    table (gather_ms; gather_call_ms as a call's time) and ``torch.take``
    of each row's six int64 words (take_ms, the faster on an H100).
    Returns those with gather_rows and gather_bytes."""
    words = tbl.view(torch.int64).reshape(-1)
    idx = (probed[:, None] * 6
           + torch.arange(6, device=probed.device)).reshape(-1)
    out = {}
    for name, fn in (("gather", lambda: torch.index_select(tbl, 0, probed)),
                     ("take", lambda: torch.take(words, idx))):
        for _ in range(3):
            fn()
        out[f"{name}_ms"] = _device_ms(fn)
        if name == "gather":
            out["gather_call_ms"] = _event_ms(fn, 20)
    return {**out, "gather_rows": probed.numel(),
            "gather_bytes": probed.numel() * (HASH_SECTOR + 48)}


def check_hash(dev, seed):
    """Both hash kernels bit-exact against their plain versions on the
    edge cases and at the gene, mesh-window and long-feature batches
    (HASH_GENE, HASH_WINDOW, HASH_LONG) against a 2^24-bucket table, then
    timed there: the wrapper call's, device and plain ms, beside the
    bound and the sector floor (bytes over HBM_BYTES_PER_S, counted by
    hash_bytes from the batch's data), the probe also beside the gather
    yardstick. No single PyTorch call computes either, so library_ms is
    null."""
    from kcftools_tpu_torch.ops import hashscan as hs

    n_edge = _hash_edges(dev)
    rng = np.random.default_rng(seed + 7)
    batches = {"gene": hash_batch(rng, *HASH_GENE, 4096, HASH_GENE[1] - 32),
               "mesh_window": hash_batch(rng, *HASH_WINDOW, 5000, 5000),
               "long_feature": hash_batch(rng, *HASH_LONG, HASH_LONG[1] // 2,
                                          HASH_LONG[1] - 32)}
    t0 = time.perf_counter()
    tbl, nb = hash_table(dev, rng, batches.values())
    log(f"hash: table of {nb} buckets ({tbl.numel() * 4} bytes) built in "
        f"{time.perf_counter() - t0} s")
    rows = {"hash_probe": {}, "hash_scan": {}}
    for shape, (u8_h, wl_h) in batches.items():
        u8, wl = _on(dev, u8_h, wl_h)
        what = f"{shape} batch {tuple(u8.shape)}"
        pkw = {"k": K, "both_strands": True}
        skw = {"k": K, "min_count": 1}
        counts, perr = _scan_exact("hash_probe", hs.hash_probe,
                                   hs.hash_probe_ref, [u8, wl, tbl], pkw,
                                   what)
        _, serr = _scan_exact("hash_scan", hs.hash_scan, hs.hash_scan_ref,
                              [u8, counts, wl], skw, what)
        (pbytes, pfloor), (sbytes, sfloor), n_valid, probed = hash_bytes(
            u8, wl, nb)
        present = int((counts != 0).sum()) / max(1, n_valid)
        if not 0.6 < present < 0.85:
            fail(f"hash_probe {what}: {present} of the valid k-mers "
                 "present - bad operands")
        for name, fn, ref, args, kw, err, nbytes, floor in (
                ("hash_probe", hs.hash_probe, hs.hash_probe_ref,
                 [u8, wl, tbl], pkw, perr, pbytes, pfloor),
                ("hash_scan", hs.hash_scan, hs.hash_scan_ref,
                 [u8, counts, wl], skw, serr, sbytes, sfloor)):
            row = {"max_abs_err": err, "library_ms": None,
                   "bound_bytes": nbytes,
                   **_times(lambda: fn(*args, **kw), lambda: ref(*args, **kw),
                            nbytes)}
            row["sector_floor_ms"] = floor / HBM_BYTES_PER_S * 1e3
            row["sector_floor_share"] = (row["sector_floor_ms"]
                                         / row["device_ms"])
            if name == "hash_probe":
                row.update(gather_yardstick(tbl, probed))
                row["gather_share"] = row["gather_ms"] / row["device_ms"]
                row["take_share"] = row["take_ms"] / row["device_ms"]
            log(f"{name}: exact on {n_edge} edge cases and at {what} "
                f"(max_abs_err {err}; {present} of {n_valid} valid k-mers "
                f"present); {json.dumps(row)}")
            if shape == "gene":
                rows[name].update(row)
            else:
                rows[name][shape] = {f: row[f] for f in row
                                     if f.endswith(("ms", "bytes", "share",
                                                    "rows"))}
        del u8, wl, counts, probed
    del tbl
    torch.cuda.empty_cache()
    return rows


# -- phase 3: the device join's reference routing -------------------------

def _route_edges(dev):
    """Both routing kernels bit-exact against their plain versions (on the
    CPU) on the cases of tests/torch_route_cases.py; returns how many."""
    from kcftools_tpu_torch.ops import route as rt
    from tests.torch_route_cases import CASES, KS, route_case

    n = 0
    for k in KS:
        for case in CASES:
            keys, b, r_idx = route_case(case, k, seed=k)
            kt = torch.from_numpy(keys.view(np.int64))
            rt_idx = torch.from_numpy(r_idx)
            got = rt.route_reference(kt.to(dev), k, b)
            got += rt.route_slabs(rt_idx.to(dev), got[2])
            want = rt.route_reference_ref(kt, k, b)
            want += rt.route_slabs_ref(rt_idx, want[2])
            for g, w in zip(got, want):
                if g.shape != w.shape or not torch.equal(g.cpu(), w):
                    fail(f"route k={k} {case}: the kernels differ from the "
                         "plain version")
            n += 1
    return n


def route_operands(dev, seed):
    """Sorted unique int64 keys of about the canonical k-mer distribution
    (the smaller of two uniform 62-bit values) and (ROUTE_SLABS,
    DJOIN_SLAB) int32 reference ordinals, ROUTE_DEAD of them -1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    draws = [torch.randint(0, 1 << 62, (ROUTE_KEYS,), generator=g,
                           device=dev) for _ in range(2)]
    keys = torch.unique(torch.minimum(*draws))
    del draws
    shape = (ROUTE_SLABS, DJOIN_SLAB)
    r_idx = torch.randint(0, keys.shape[0], shape, generator=g, device=dev)
    dead = torch.rand(shape, generator=g, device=dev) < ROUTE_DEAD
    return keys, torch.where(dead, -1, r_idx).to(torch.int32)


def route_bytes(n, P, Tq, r_idx):
    """(route_reference's bytes, route_slabs' bytes, route_slabs' sector
    floor): each kernel reads its operands once and writes its outputs
    once. route_reference: the starts launch writes start (its binary
    searches read P log2 n keys, not counted, as in ``sample_bytes``), the
    maxima launch reads start, the tiles launch reads the keys and start
    and writes the (P, Tq) tiles whole and the slot of each key.
    route_slabs: r_idx read, a 4-byte slot gathered a live position (32
    bytes, a sector, in the floor), the slot maps and valid bitmaps
    written."""
    start = 8 * (P + 1)
    ref = 3 * start + 8 * n + 8 * P * Tq + 4 * n
    pos = r_idx.numel()
    live = int((r_idx >= 0).sum())
    base = 4 * pos + 4 * pos + pos // 8
    return ref, base + 4 * live, base + SECTOR_BYTES * live


def _host_routing_ms(keys, r_idx, k, b):
    """The host numpy the kernels replaced on the main path, ms:
    ``tile_sorted`` and the slot of each key; the slot maps and packed
    valid bitmaps of the slabs."""
    from kcftools_tpu_torch.ops.pjoin import tile_sorted
    from tests.torch_route_cases import host_slabs

    keys = keys.cpu().numpy().view(np.uint64)
    r_idx = r_idx.cpu().numpy()
    t0 = time.perf_counter()
    qh, _ql, _tc, rank, part = tile_sorted(keys, k, b)
    slot_of_ord = (part * qh.shape[1] + rank).astype(np.int64)
    t1 = time.perf_counter()
    host_slabs(r_idx, slot_of_ord)
    return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def check_route(dev, seed):
    """Both routing kernels bit-exact against their plain versions on the
    edge cases and at the lettuce cell's shapes (ROUTE_KEYS keys, 2^ROUTE_B
    partitions, ROUTE_SLABS slabs of DJOIN_SLAB positions), then timed
    there: the wrapper call's ms (route_reference's includes its one
    scalar read back), device_ms (route_reference's two entry points
    captured with the Tq found), the plain version on the card, and the
    host numpy they replaced (``host_ms``), beside the bound."""
    from kcftools_tpu_torch.ops import _kernels
    from kcftools_tpu_torch.ops import route as rt

    n_edge = _route_edges(dev)
    keys, r_idx = route_operands(dev, seed + 15)
    n, b, P = keys.shape[0], ROUTE_B, 1 << ROUTE_B
    qh, ql, slot = rt.route_reference(keys, K, b)
    sm, vb = rt.route_slabs(r_idx, slot)
    want = rt.route_reference_ref(keys, K, b)
    want += rt.route_slabs_ref(r_idx, want[2])
    torch.cuda.synchronize()
    for name, g, w in zip(("qh", "ql", "slot_of_ord", "slot_maps",
                           "valid_bits"), (qh, ql, slot, sm, vb), want):
        if g.shape != w.shape or not torch.equal(g, w):
            fail(f"route at the cell's shape: {name} differs from the "
                 "plain version")
    del want, sm, vb
    Tq = qh.shape[1]
    ref_bytes, slab_bytes, slab_floor = route_bytes(n, P, Tq, r_idx)
    start = torch.empty(P + 1, dtype=torch.int64, device=dev)
    maxima = torch.empty(2, dtype=torch.int64, device=dev)

    def entries():
        _kernels.launch("kcf_route_starts", keys, n, None, K, b, start,
                        maxima)
        _kernels.launch("kcf_route_tiles", keys, n, K, b, start, Tq, qh, ql,
                        slot)

    host_ref_ms, host_slab_ms = _host_routing_ms(keys, r_idx, K, b)
    shape = (f"{n} keys, P={P}, Tq={Tq}, {ROUTE_SLABS} slabs of "
             f"{DJOIN_SLAB}")
    rows = {}
    for name, fn, ref, nbytes, host_ms in (
            ("route_reference", lambda: rt.route_reference(keys, K, b),
             lambda: rt.route_reference_ref(keys, K, b), ref_bytes,
             host_ref_ms),
            ("route_slabs", lambda: rt.route_slabs(r_idx, slot),
             lambda: rt.route_slabs_ref(r_idx, slot), slab_bytes,
             host_slab_ms)):
        if name == "route_reference":
            # its scalar read back cannot be captured: the wrapper's ms
            # alone, and the entry points' device_ms
            for _ in range(3):
                fn()
                entries()
            row = {"ms": _event_ms(fn, 20), "device_ms": _device_ms(entries),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes", "plain_ms": _event_ms(ref, 1)}
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
        else:
            row = _times(fn, ref, nbytes)
            row["sector_floor_ms"] = slab_floor / HBM_BYTES_PER_S * 1e3
            row["sector_floor_share"] = (row["sector_floor_ms"]
                                         / row["device_ms"])
        row = {"max_abs_err": 0, "library_ms": None, "bound_bytes": nbytes,
               **row, "host_ms": host_ms}
        log(f"{name}: exact on {n_edge} edge cases and at {shape}; "
            f"{json.dumps(row)}")
        rows[name] = row
    del keys, r_idx, qh, ql, slot, start, maxima
    torch.cuda.empty_cache()
    return rows


def _sample_edges(dev):
    """The sample tiling kernels bit-exact against the plain version (on
    the CPU) on the cases of tests/torch_route_cases.py; returns how
    many."""
    from kcftools_tpu_torch.ops import route as rt
    from tests.torch_route_cases import CASES, COUNTS, KS, sample_case

    n = 0
    for k in KS:
        for case in CASES:
            for counts in COUNTS:
                keys, b, c = sample_case(case, k, counts, seed=k)
                kt = torch.from_numpy(keys.view(np.int64))
                ct = torch.from_numpy(c.view(np.int32))
                got = rt.tile_sample(kt.to(dev), ct.to(dev), k, b)
                want = rt.tile_sample_ref(kt, ct, k, b)
                if got[1:] != want[1:] or not torch.equal(got[0].cpu(),
                                                          want[0]):
                    fail(f"tile_sample k={k} {case} {counts}: the kernels "
                         "differ from the plain version")
                n += 1
    return n


def sample_operands(dev, seed, top):
    """A sample's sorted unique int64 keys of about the canonical k-mer
    distribution (SAMPLE_KEYS drawn) and int32 counts (uint32 bits) in
    1..top, ``top`` among them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    draws = [torch.randint(0, 1 << 62, (SAMPLE_KEYS,), generator=g,
                           device=dev) for _ in range(2)]
    keys = torch.unique(torch.minimum(*draws))
    del draws
    counts = torch.randint(1, top + 1, keys.shape, generator=g, device=dev)
    counts[keys.shape[0] // 2] = top
    return keys, _i32_bits(counts)


def sample_bytes(n, P, buf_bytes):
    """tile_sample's bytes: the keys and counts read once, the buffer
    written once, and the partition starts written by the search launch
    and read by the maxima and tiles launches."""
    return 12 * n + buf_bytes + 3 * 8 * (P + 1)


def _host_pack_ms(keys, counts, b, tile):
    """The host pack the kernels replaced on the main path, ms (the
    native histogram, the buffer's np.zeros and the native pack, from
    host memory: ``engine/device_join.py::pack_tiles_host``, the mesh's),
    and its (buf, Tt, packed)."""
    from kcftools_tpu_torch.engine.device_join import pack_tiles_host
    from kcftools_tpu_torch.native import get_lib

    if get_lib() is None:
        fail("the native host packer did not build")
    t0 = time.perf_counter()
    got = pack_tiles_host(keys, counts, K, b, tile)
    return (time.perf_counter() - t0) * 1e3, got


def check_sample_tiles(dev, seed):
    """The sample tiling kernels bit-exact against the plain version on
    the edge cases, and at the lettuce cell's two samples (SAMPLE_KEYS
    keys in 2^ROUTE_B partitions; byte counts, then counts up to
    2^32 - 1 at the first sample's width) against the plain version on
    the card and the native host packer, then timed there: the wrapper
    call's ms (its two numbers read back included), device_ms (the two
    entry points captured with the width found), the plain version on
    the card, and the host pack they replaced (``host_ms``), beside the
    bound. The first sample's row holds the second's as ``u32``."""
    from kcftools_tpu_torch.ops import _kernels
    from kcftools_tpu_torch.ops import route as rt

    n_edge = _sample_edges(dev)
    b, P = ROUTE_B, 1 << ROUTE_B
    rows, tile = [], None
    for i, top in enumerate(SAMPLE_TOPS):
        keys, counts = sample_operands(dev, seed + 21 + i, top)
        n = keys.shape[0]
        buf, Tt, packed = rt.tile_sample(keys, counts, K, b, tile)
        want = rt.tile_sample_ref(keys, counts, K, b, tile)
        torch.cuda.synchronize()
        if (Tt, packed) != want[1:] or not torch.equal(buf, want[0]):
            fail(f"tile_sample at the cell's shape (counts <= {top}): the "
                 "kernels differ from the plain version")
        del want
        host_ms, host = _host_pack_ms(
            keys.cpu().numpy().view(np.uint64),
            counts.cpu().numpy().view(np.uint32), b, tile)
        if host[1:] != (Tt, packed) or not np.array_equal(
                buf.cpu().numpy().view(np.uint32), host[0]):
            fail(f"tile_sample at the cell's shape (counts <= {top}): the "
                 "kernels differ from the native host packer")
        del host
        start = torch.empty(P + 1, dtype=torch.int64, device=dev)
        maxima = torch.empty(2, dtype=torch.int64, device=dev)

        def entries():
            _kernels.launch("kcf_route_starts", keys, n, counts, K, b,
                            start, maxima)
            _kernels.launch("kcf_sample_tiles", keys, counts, start, K, b,
                            Tt, int(packed), buf)

        def fn():
            return rt.tile_sample(keys, counts, K, b, tile)

        for _ in range(3):
            fn()
            entries()
        nbytes = sample_bytes(n, P, buf.nbytes)
        row = {"max_abs_err": 0, "library_ms": None, "bound_bytes": nbytes,
               "ms": _event_ms(fn, 20), "device_ms": _device_ms(entries),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes",
               "plain_ms": _event_ms(
                   lambda: rt.tile_sample_ref(keys, counts, K, b, tile), 1),
               "host_ms": host_ms, "keys": n, "Tt": Tt, "packed": packed,
               "buf_bytes": buf.nbytes}
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        log(f"tile_sample (counts <= {top}): exact on {n_edge} edge cases, "
            f"against the plain version and the native packer at {n} keys, "
            f"P={P}, Tt={Tt}; {json.dumps(row)}")
        rows.append(row)
        tile = Tt
        del keys, counts, buf, start, maxima
        torch.cuda.empty_cache()
    return {"tile_sample": {**rows[0], "u32": rows[1]}}


# -- phase 3: the device join's host-to-device copies ---------------------

def _gb_per_s(fn, nbytes, reps=XFER_REPS):
    """The rates of ``reps`` runs of ``fn`` (host clock, ending in a
    synchronisation), GB/s, after one untimed run."""
    fn()
    torch.cuda.synchronize()
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates.append(nbytes / (time.perf_counter() - t0) / 1e9)
    return rates


def check_transfers(dev, seed):
    """The transfer layer's rates for a source of XFER_BYTES random bytes,
    read from warm heap memory and from a fresh read-only map of a raw
    file (``io/rawfile.py``'s ``map_readonly``, as the sidecar and the
    index are read; the page cache warm, so minor faults only): a
    pageable ``.to(dev)``, ``h2d_staged`` at its constants and over the
    XFER_CHUNKS x XFER_DEPTHS sweep that chose them, and, as the link's
    ceiling, one copy of the whole source from pinned memory (its fill
    untimed). Every staged copy is checked bit-exact against the
    pageable one. GB/s, ``XFER_REPS`` runs each, median first."""
    from statistics import median

    from kcftools_tpu_torch.engine import device_join as tdj
    from kcftools_tpu_torch.io import rawfile

    n = XFER_BYTES
    heap = np.frombuffer(np.random.default_rng(seed).bytes(n), np.uint8)
    tmp = tempfile.mkdtemp(prefix="kcf_xfer_")
    path = os.path.join(tmp, "src.raw")
    heap.tofile(path)
    want = tdj._host_tensor(heap).to(dev)
    dst = torch.empty(n, dtype=torch.uint8, device=dev)
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    row = {"bytes": n, "chunk": tdj.H2D_CHUNK, "depth": tdj.H2D_DEPTH,
           "cores": os.cpu_count(), "page_cache": "warm"}

    def mapped(fn):
        """``fn`` of a fresh read-only map of the file."""
        def run():
            with open(path, "rb") as fh:
                mm = rawfile.map_readonly(fh)
                try:
                    fn(np.frombuffer(mm, np.uint8))
                finally:
                    mm.close()
        return run

    def staged(chunk, depth):
        return lambda src: tdj.h2d_staged([(dst, src)], chunk=chunk,
                                          depth=depth)

    def checked(chunk, depth):
        def run(src):
            dst.zero_()
            staged(chunk, depth)(src)
            torch.cuda.synchronize()
            if not torch.equal(dst, want):
                fail(f"h2d_staged (chunk {chunk}, depth {depth}) differs "
                     "from the pageable copy")
        return run

    def pageable(src):
        tdj._host_tensor(src).to(dev)

    sources = {"heap": lambda fn: (lambda: fn(heap)), "mapped": mapped}
    try:
        for name, source in sources.items():
            sweep = {}
            for chunk in XFER_CHUNKS:
                for depth in XFER_DEPTHS:
                    source(checked(chunk, depth))()
                    sweep[f"{chunk >> 20}MiB x{depth}"] = median(_gb_per_s(
                        source(staged(chunk, depth)), n))
            timed = {
                what: _gb_per_s(source(fn), n)
                for what, fn in (
                    ("pageable", pageable),
                    ("staged", staged(tdj.H2D_CHUNK, tdj.H2D_DEPTH)))
            }
            row[name] = {what: [median(r)] + r for what, r in timed.items()}
            row[name]["sweep"] = sweep
            log(f"transfers ({name}, {n} B): pageable "
                f"{row[name]['pageable'][0]} GB/s, h2d_staged "
                f"{row[name]['staged'][0]} GB/s; sweep (median GB/s) "
                f"{json.dumps(sweep)}; best "
                f"{max(sweep, key=sweep.get)}")
        pinned.copy_(tdj._host_tensor(heap))
        row["pinned"] = _gb_per_s(
            lambda: dst.copy_(pinned, non_blocking=True), n)
        row["pinned"].insert(0, median(row["pinned"]))
        log(f"transfers: one pinned copy of {n} B (the link's ceiling) "
            f"{row['pinned'][0]} GB/s; {json.dumps(row)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del want, dst, pinned
    torch.cuda.empty_cache()
    return row


# -- phase 4: synthetic data --------------------------------------------

def _write_fasta(path, chroms):
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as fh:
        for name, (codes, valid) in chroms.items():
            fh.write(f">{name}\n".encode())
            asc = lut[np.where(valid, codes, 4)]
            n_full = asc.shape[0] // 60
            body = np.empty((n_full, 61), np.uint8)
            body[:, :60] = asc[: n_full * 60].reshape(-1, 60)
            body[:, 60] = ord("\n")
            fh.write(body.tobytes())
            if asc.shape[0] > n_full * 60:
                fh.write(asc[n_full * 60:].tobytes() + b"\n")


def _sample_table(rng, chroms, snp_rate, n_err):
    """Sorted unique canonical k-mers of a 1%-SNP copy of the reference
    plus ``n_err`` random error k-mers, with multiplicities."""
    from kcftools_tpu_torch.engine.encode import canonicalize, pack_kmers
    from kcftools_tpu_torch.native import sort_pairs

    parts = []
    for codes, valid in chroms.values():
        s = codes.copy()
        m = rng.random(s.shape[0]) < snp_rate
        s[m] = (s[m] + rng.integers(1, 4, int(m.sum()), dtype=np.uint8)) % 4
        km, kv = pack_kmers(s, valid, K)
        parts.append(canonicalize(km[kv], K))
    err = rng.integers(0, 1 << (2 * K), n_err, dtype=np.uint64)
    parts.append(canonicalize(err, K))
    keys, _ = sort_pairs(np.concatenate(parts),
                         np.zeros(sum(p.shape[0] for p in parts), np.uint32))
    first = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    mult = np.diff(np.r_[first, keys.shape[0]]).astype(np.uint64)
    return keys[first], mult


def make_data(root, mbp, n_samples, seed):
    from kcftools_tpu_torch.io.kmc import write_kmc_db

    rng = np.random.default_rng(seed)
    L = mbp * 1_000_000 // N_CHROMS
    chroms = {}
    for c in range(N_CHROMS):
        codes = rng.integers(0, 4, L, dtype=np.uint8)
        valid = np.ones(L, bool)
        for at in rng.integers(0, L - 5000, 40):
            valid[at : at + int(rng.integers(1, 5000))] = False
        chroms[f"chr{c + 1}"] = (codes, valid)
    ref = os.path.join(root, "ref.fa")
    _write_fasta(ref, chroms)
    dbs = []
    for i in range(n_samples):
        keys, mult = _sample_table(rng, chroms, 0.01, L // 10)
        if i == 2:
            # u32 counts: > 255 everywhere, some at and near 2^32 - 1
            counts = mult * rng.integers(256, 5000, mult.shape[0],
                                         dtype=np.uint64)
            big = rng.integers(0, mult.shape[0], 1000)
            counts[big] = rng.integers(1 << 31, 1 << 32, 1000, dtype=np.uint64)
            counts[big[0]] = (1 << 32) - 1
        else:
            counts = np.minimum(
                mult * rng.integers(3, 60, mult.shape[0], dtype=np.uint64), 255
            )
        prefix = os.path.join(root, f"s{i + 1}")
        write_kmc_db(prefix, keys, counts, K, max_count=(1 << 31) - 1)
        dbs.append(prefix)
    return ref, dbs, {n: c[0].shape[0] for n, c in chroms.items()}


# -- phase 4: the slice through the CLI ---------------------------------

def _strip_volatile(path):
    with open(path, "rb") as f:
        return b"".join(
            line for line in f.readlines()
            if not line.startswith((b"##date=", b"##CMD="))
        )


@contextlib.contextmanager
def _environ(**kv):
    old = {key: os.environ.get(key) for key in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for key, v in old.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v


def run_cli(ref, dbs, out_dir, engine, stage_json, args=WINDOW_ARGS,
            env=None):
    """getVariations through the port's CLI, in process; returns (wall
    seconds, stage seconds, the KCF path of each sample)."""
    from kcftools_tpu_torch.cli import main

    samples = [os.path.basename(d) for d in dbs]
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"{s}.kcf") for s in samples]
    argv = ["getVariations", "-r", ref, "-k", ",".join(dbs),
            "-s", ",".join(samples), "-o", out_dir if len(dbs) > 1 else outs[0],
            *args, "--engine", engine,
            "-t", str(min(8, os.cpu_count() or 1))]
    with _environ(KCFTOOLS_STAGE_JSON=stage_json, **(env or {})):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the CLI logs to stdout
            rc = main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    if rc != 0:
        fail(f"getVariations --engine {engine} {' '.join(args)} exited {rc}")
    with open(stage_json) as f:
        stages = json.load(f)
    return dt, stages, outs


def check_same(got_paths, want_paths, n_rows, what):
    """KCF bytes equal apart from ##date / ##CMD, with n_rows windows."""
    for got, want in zip(got_paths, want_paths, strict=True):
        g, w = _strip_volatile(got), _strip_volatile(want)
        if g != w:
            fail(f"{what}: {got} differs from {want}")
        rows = [ln for ln in g.split(b"\n") if ln and not ln.startswith(b"#")]
        if len(rows) != n_rows:
            fail(f"{what}: {got} has {len(rows)} windows, expected {n_rows}")


def djoin_layout(chrom_len):
    """(slabs, positions, windows) of the device join's slab layout of
    the slice's tiling windows."""
    from kcftools_tpu_torch.engine.slabs import Layout
    from kcftools_tpu_torch.engine.windows import tiling_windows

    lay = Layout(K, DJOIN_SLAB)
    for name, L in chrom_len.items():
        lay.add_chrom(name, np.zeros(L - K + 1, np.int32),
                      *tiling_windows(L, WINDOW, K))
    lay.finalize()
    return len(lay.slabs), lay.pos_pad, lay.win_pad


def run_slice(root, ref, dbs, chrom_len):
    from kcftools_tpu_torch.engine.windows import tiling_windows

    n_win = sum(len(tiling_windows(L, WINDOW, K)[0]) for L in chrom_len.values())
    n_slabs, pos_pad, win_pad = djoin_layout(chrom_len)
    stage_json = os.path.join(root, "stages.json")

    def drive(out_dir):
        """One main-path run with the launch counts zeroed just before
        it; (wall s, stages, KCF paths, launches of each kernel)."""
        zero_launches(MAIN_PATH)
        res = run_cli(ref, dbs, os.path.join(root, out_dir), "device",
                      stage_json)
        return (*res, read_launches(MAIN_PATH))

    cold_s, cold_st, cold_kcf, cold_launches = drive("dev_cold")
    warm_s, warm_st, dev_kcf, launches = drive("dev")
    host_s, _, host_kcf = run_cli(ref, dbs, os.path.join(root, "host"),
                                  "hybrid", stage_json)
    for run_launches in (cold_launches, launches):
        for name, n in run_launches.items():
            if n == 0:
                fail(f"{name} was not launched by the main path")
        if run_launches["pjoin_packed"] + run_launches["pjoin_u32"] != len(dbs):
            fail(f"{run_launches} join launches for {len(dbs)} samples, "
                 "want one per sample")
        if run_launches["tile_sample"] != len(dbs):
            fail(f"{run_launches['tile_sample']} sample tiling launches for "
                 f"{len(dbs)} samples, want one per sample")
        if run_launches["gapscan_join"] != len(dbs):
            fail(f"{run_launches['gapscan_join']} scan launches for "
                 f"{len(dbs)} samples of {n_slabs} slabs, want one per "
                 "sample")
        for name in ROUTE:
            if run_launches[name] != 1:
                fail(f"{run_launches[name]} {name} launches in a call, "
                     "want one: the call routes its reference on the card")
    check_same(cold_kcf, host_kcf, n_win, "device engine, cold")
    check_same(dev_kcf, host_kcf, n_win, "device engine")
    if "jax" in sys.modules:
        fail("jax was imported")
    total_win = n_win * len(dbs)
    phases = {p: warm_st.get(f"djoin_{p}", 0.0)
              for p in ("pack", "upload", "join", "scan", "fetch")}
    log(f"slice: {sum(chrom_len.values())} bp in {len(chrom_len)} chromosomes,"
        f" {len(dbs)} samples, {total_win} windows; {n_slabs} slabs of "
        f"{pos_pad} positions and {win_pad} windows; KCF bytes equal the "
        f"host engine's; jax not loaded; launches cold {cold_launches}, "
        f"warm {launches}")
    log(f"slice: device cold {cold_s} s, warm {warm_s} s "
        f"({total_win / warm_s} windows/s); host engine {host_s} s")
    log(f"slice: warm phase seconds {json.dumps(phases)}; all stages "
        f"cold {json.dumps(cold_st)} warm {json.dumps(warm_st)}")
    return launches, host_kcf


# -- phase 5: the dprefix and on-chip hash engines ----------------------

def write_gtf(path, chrom_len, seed):
    """A synthetic annotation: GENES_PER_CHROM genes of 1-10 kb per
    chromosome on random strands, each with 1-3 transcripts of 2-6 exons
    inside the gene, plus SHORT_GENES_PER_CHROM single-exon genes shorter
    than k. Returns (genes, transcripts)."""
    rng = np.random.default_rng(seed + 1)
    rows = []
    n_genes = n_tr = 0

    def add(chrom, type_, start, end, strand, attrs):
        rows.append(f"{chrom}\tsmoke\t{type_}\t{start}\t{end}\t.\t{strand}"
                    f"\t.\t{attrs}\n")

    for chrom, L in chrom_len.items():
        genes = [(int(gs), int(rng.integers(1000, 10_001)))
                 for gs in np.sort(rng.integers(1, L - 10_000,
                                                GENES_PER_CHROM))]
        genes += [(int(gs), K - 5) for gs in
                  rng.integers(1, L - 100, SHORT_GENES_PER_CHROM)]
        for gs, glen in genes:
            ge = gs + glen - 1
            strand = "+-"[int(rng.integers(0, 2))]
            gid = f"g{n_genes}"
            n_genes += 1
            add(chrom, "gene", gs, ge, strand, f'gene_id "{gid}";')
            n_t = int(rng.integers(1, 4)) if glen >= 1000 else 1
            for t in range(n_t):
                if glen >= 1000:
                    n_ex = int(rng.integers(2, 7))
                    cuts = np.sort(rng.choice(glen, 2 * n_ex, replace=False))
                    exons = (cuts.reshape(-1, 2) + gs).tolist()
                else:
                    exons = [[gs, ge]]
                attrs = f'gene_id "{gid}"; transcript_id "{gid}.t{t}";'
                add(chrom, "mRNA", exons[0][0], exons[-1][1], strand, attrs)
                for a, b in exons:
                    add(chrom, "exon", a, b, strand, attrs)
                n_tr += 1
    with open(path, "w") as fh:
        fh.writelines(rows)
    return n_genes, n_tr


def _calls():
    from kcftools_tpu_torch.engine import device_prefix as tdp
    from kcftools_tpu_torch.ops.lookup import table_lookup

    return (tdp._score_runs, tdp._score_batch, table_lookup)


_COUNTED = ("gapscan_join", "gapscan_rows", "gapscan_runs", "hash_probe",
            "hash_scan")


def _zero_calls():
    for fn in _calls():
        fn.cuda_calls = 0
    zero_launches(_COUNTED)


def _read_calls():
    calls = dict(zip(("score_runs", "score_batch", "table_lookup"),
                     (fn.cuda_calls for fn in _calls())))
    calls.update(read_launches(_COUNTED))
    return calls


def _need(calls, name, what):
    if calls[name] == 0:
        fail(f"{what}: {name} did not run on the card ({calls})")


def _need_hash(calls, what, table_axis=1):
    """A hash-engine run: both kernels launched, a probe per table shard
    for every scan (one scan a batch and data row), and the plain lookup
    never on the card."""
    _need(calls, "hash_probe", what)
    _need(calls, "hash_scan", what)
    if calls["hash_probe"] != table_axis * calls["hash_scan"]:
        fail(f"{what}: {calls['hash_probe']} probe launches for "
             f"{calls['hash_scan']} scans, want {table_axis} a scan")
    if calls["table_lookup"] != 0:
        fail(f"{what}: the plain table_lookup ran on the card ({calls})")


def _need_scan(calls, what):
    """A dprefix run: every program call launched the scan kernel once,
    for all the rows of its group (the run program through ``runs_scan``,
    the bitmap program through ``rows_scan``)."""
    if (calls["score_runs"] + calls["score_batch"] == 0
            or calls["gapscan_runs"] != calls["score_runs"]
            or calls["gapscan_rows"] != calls["score_batch"]):
        fail(f"{what}: scan launches (runs_scan {calls['gapscan_runs']}, "
             f"rows_scan {calls['gapscan_rows']}) differ from the dprefix "
             f"program calls on the card ({calls})")


def run_engines(root, ref, dbs, chrom_len, host_kcf, seed):
    """Phase 5 (see the module docstring). Returns the per-program call
    counts of each run, and per feature kind the host engine's (KCF
    paths, feature count)."""
    from kcftools_tpu_torch.engine.windows import sliding_windows, tiling_windows

    n_win = sum(len(tiling_windows(L, WINDOW, K)[0])
                for L in chrom_len.values())
    stage_json = os.path.join(root, "stages5.json")
    out = {}

    def drive(name, dbs_, engine, args=WINDOW_ARGS, env=None):
        _zero_calls()
        res = run_cli(ref, dbs_, os.path.join(root, name), engine,
                      stage_json, args=args, env=env)
        out[name] = _read_calls()
        return res

    # window tiling, all samples: the run program
    cold_s, cold_st, cold_kcf = drive("dprefix_cold", dbs, "dprefix")
    _need(out["dprefix_cold"], "score_runs", "dprefix window")
    _need_scan(out["dprefix_cold"], "dprefix window, first run")
    check_same(cold_kcf, host_kcf, n_win, "dprefix window, first run")
    torch.cuda.reset_peak_memory_stats()
    warm_s, warm_st, dp_kcf = drive("dprefix", dbs, "dprefix")
    peak = torch.cuda.max_memory_allocated()
    _need(out["dprefix"], "score_runs", "dprefix window")
    _need_scan(out["dprefix"], "dprefix window")
    check_same(dp_kcf, host_kcf, n_win, "dprefix window")
    total = n_win * len(dbs)
    log(f"engines: dprefix window KCF bytes equal the host engine's; "
        f"cold {cold_s} s, warm {warm_s} s ({total / warm_s} windows/s); "
        f"calls {out['dprefix']}")
    log(f"engines: dprefix warm stage seconds {json.dumps(warm_st)}; "
        f"cold {json.dumps(cold_st)}")
    log(f"engines: dprefix peak device memory (warm run, slab "
        f"{os.environ.get('KCFTOOLS_DPREFIX_SLAB', 1 << 26)} positions) "
        f"{peak} bytes ({peak / 2**30} GiB)")

    # sliding windows on one sample: the bitmap program
    slide = ("-f", "window", "-w", str(WINDOW), "-p", "2500")
    hs_s, _, hs_kcf = drive("host_slide", dbs[:1], "hybrid", args=slide)
    sl_s, sl_st, sl_kcf = drive("dprefix_slide", dbs[:1], "dprefix",
                                args=slide,
                                env={"KCFTOOLS_DPREFIX_UPLINK": "bitmap"})
    _need(out["dprefix_slide"], "score_batch", "dprefix sliding")
    _need_scan(out["dprefix_slide"], "dprefix sliding")
    n_slide = sum(len(sliding_windows(L, WINDOW, 2500, K)[0])
                  for L in chrom_len.values())
    check_same(sl_kcf, hs_kcf, n_slide, "dprefix sliding")
    log(f"engines: dprefix sliding (bitmap program) {sl_s} s "
        f"({n_slide / sl_s} windows/s), host engine {hs_s} s; KCF bytes "
        f"equal; stages {json.dumps(sl_st)}; calls {out['dprefix_slide']}")

    # the streamed low-memory ingest: a copy of sample 1 without sidecar
    sdir = os.path.join(root, "streamed_db")
    os.makedirs(sdir)
    name1 = os.path.basename(dbs[0])
    for ext in (".kmc_pre", ".kmc_suf"):
        shutil.copyfile(dbs[0] + ext, os.path.join(sdir, name1 + ext))
    st_s, st_st, st_kcf = drive(
        "dprefix_streamed", [os.path.join(sdir, name1)], "dprefix",
        env={"KCFTOOLS_SORT_CACHE_BUDGET": "0"},
    )
    if "merge_streamed" not in st_st:
        fail(f"streamed ingest did not run (stages {st_st})")
    if sorted(os.listdir(sdir)) != sorted(name1 + e
                                          for e in (".kmc_pre", ".kmc_suf")):
        fail(f"the streamed run wrote beside its database: {os.listdir(sdir)}")
    _need(out["dprefix_streamed"], "score_runs", "dprefix streamed")
    _need_scan(out["dprefix_streamed"], "dprefix streamed")
    check_same(st_kcf, host_kcf[:1], n_win, "dprefix streamed")
    log(f"engines: dprefix streamed ingest {st_s} s; KCF bytes equal; "
        f"stages {json.dumps(st_st)}")

    # gene / transcript features
    gtf = os.path.join(root, "smoke.gtf")
    n_feat = dict(zip(("gene", "transcript"), write_gtf(gtf, chrom_len, seed)))
    host_feature_kcf = {}
    for feature in ("gene", "transcript"):
        args = ("-f", feature, "-g", gtf)
        times = {}
        h_s, _, h_kcf = drive(f"host_{feature}", dbs, "hybrid", args=args)
        host_feature_kcf[feature] = (h_kcf, n_feat[feature])
        times["hybrid"] = h_s
        for engine in ("device", "dprefix"):
            e_s, e_st, e_kcf = drive(f"{engine}_{feature}", dbs, engine,
                                     args=args)
            calls = out[f"{engine}_{feature}"]
            if engine == "device":
                _need_hash(calls, f"device {feature}")
            else:
                _need_scan(calls, f"dprefix {feature}")
            check_same(e_kcf, h_kcf, n_feat[feature], f"{engine} {feature}")
            times[engine] = e_s
            log(f"engines: -f {feature} --engine {engine}: KCF bytes equal "
                f"the host engine's; stages {json.dumps(e_st)}; "
                f"calls {calls}")
        nw = n_feat[feature] * len(dbs)
        log(f"engines: -f {feature}, {n_feat[feature]} features x "
            f"{len(dbs)} samples: " + ", ".join(
                f"{e} {t} s ({nw / t} windows/s)" for e, t in times.items()))
    if "jax" in sys.modules:
        fail("jax was imported")
    log(f"engines: all phase-5 runs equal the host engine; jax not loaded; "
        f"calls per run {json.dumps(out)}")
    return out, host_feature_kcf


# -- phase 6: the multi-device tier ---------------------------------------

MESH_SLOTS = 4  # virtual slots on cuda:0 when only one card is visible
MESH_TABLE_AXIS = 2


def _mesh_env():
    """The environment of the phase-6 runs, and the label of their times."""
    n_gpu = torch.cuda.device_count()
    if n_gpu > 1:
        return {}, f"{n_gpu} GPUs"
    return ({"KCFTOOLS_TORCH_DEVICE": "cuda:0",
             "KCFTOOLS_TORCH_VIRTUAL_DEVICES": str(MESH_SLOTS)},
            f"virtual mesh: {MESH_SLOTS} slots on one card (no multi-GPU "
            "speed)")


def _mesh_join(ref, dbs, env):
    """MeshJoinScorer on a (data, 2) mesh against DeviceJoinScorer for
    every sample; returns (single s, mesh s, launches per sample)."""
    from kcftools_tpu_torch.engine.refindex import RefKmerIndex
    from kcftools_tpu_torch.engine.windows import tiling_windows
    from kcftools_tpu_torch.io.fasta import FastaIndex
    from kcftools_tpu_torch.io.kmc import load_sorted_cache
    from kcftools_tpu_torch.engine.device_join import (
        DeviceJoinScorer,
        MeshJoinScorer,
    )
    from kcftools_tpu_torch.ops.gapscan import slabs_scan_join
    from kcftools_tpu_torch.ops.pjoin import pjoin_join
    from kcftools_tpu_torch.parallel.mesh import make_mesh
    from kcftools_tpu_torch.torchinit import resolve_devices

    index = FastaIndex(ref)
    refidx = RefKmerIndex.load_or_build(ref, index, K, canonical=True)
    tables = []
    for prefix in dbs:
        cached = load_sorted_cache(prefix, K)
        if cached is None:
            fail(f"mesh join: no sorted sidecar for {prefix}")
        tables.append(cached)
    with _environ(**env):
        slots = resolve_devices()
    mesh = make_mesh(data=len(slots) // MESH_TABLE_AXIS,
                     table=MESH_TABLE_AXIS, devices=slots)
    res, secs, launches = {}, {}, 0
    for name in ("single", "mesh"):
        if name == "single":
            sc = DeviceJoinScorer(refidx, K, slots[0].device)
        else:
            sc = MeshJoinScorer(refidx, K, mesh)
        for chrom in index.get_sequence_names():
            starts, ends = tiling_windows(index.get_sequence_length(chrom),
                                          WINDOW, K)
            sc.add_chrom(chrom, refidx.chrom_r_idx[chrom], starts, ends)
        before = pjoin_join.launches_packed + pjoin_join.launches_u32
        scans = slabs_scan_join.launches
        t0 = time.perf_counter()
        for key, (keys, counts) in enumerate(tables):
            sc.submit(key, refidx.kmers, keys, counts)
        res[name] = [sc.collect(key) for key in range(len(tables))]
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        scans = slabs_scan_join.launches - scans
        # one launch per sample on one device, per data row with slabs on
        # the mesh
        rows = (1 if name == "single"
                else sum(len(st) > 0 for _dev, st in sc._statics))
        if scans != rows * len(tables):
            fail(f"{name} join: {scans} scan launches for {len(tables)} "
                 f"samples over {rows} device row(s), want one each")
        if name == "mesh":
            launches = (pjoin_join.launches_packed + pjoin_join.launches_u32
                        - before)
            if launches != MESH_TABLE_AXIS * len(tables):
                fail(f"mesh join: {launches} pjoin launches for "
                     f"{len(tables)} samples, want {MESH_TABLE_AXIS} each")
            if sorted(sc._q) != list(range(MESH_TABLE_AXIS)):
                fail(f"mesh join: query tiles on columns {sorted(sc._q)}")
        sc.close()
    for key, (got, want) in enumerate(zip(res["mesh"], res["single"])):
        for chrom, fields in want.items():
            for f, w in fields.items():
                if not np.array_equal(got[chrom][f], w):
                    fail(f"mesh join: sample {key} {chrom} {f} differs "
                         "from the single-device join")
    return secs["single"], secs["mesh"], launches // len(tables)


def run_mesh(root, ref, dbs, chrom_len, host_kcf, host_gene, smi):
    """Phase 6 (see the module docstring). ``host_gene`` is phase 5's
    (hybrid -f gene KCF paths, gene count) over root/smoke.gtf. Returns
    the call counts of each run."""
    from kcftools_tpu_torch.engine.windows import tiling_windows
    from kcftools_tpu_torch.dryrun import dryrun_multichip
    from kcftools_tpu_torch.engine import device_prefix as tdp

    env, label = _mesh_env()
    n_win = sum(len(tiling_windows(L, WINDOW, K)[0])
                for L in chrom_len.values())
    total = n_win * len(dbs)
    stage_json = os.path.join(root, "stages6.json")
    out = {}
    spread = []  # slots holding dprefix slabs, per scorer built
    build = tdp.DevicePrefixScorer._build_statics

    def _recording_build(self):
        build(self)
        spread.append(len({s for st in self._statics for s in st["pool"]}))

    def drive(name, engine, args=WINDOW_ARGS, dbs_=dbs, **extra):
        _zero_calls()
        res = run_cli(ref, dbs_, os.path.join(root, name), engine,
                      stage_json, args=args, env={**env, **extra})
        out[name] = _read_calls()
        return res

    tdp.DevicePrefixScorer._build_statics = _recording_build
    try:
        a_s, a_st, a_kcf = drive("mesh_auto", "auto",
                                 KCFTOOLS_NO_DEVICE_PROBE="")
    finally:
        tdp.DevicePrefixScorer._build_statics = build
    _need(out["mesh_auto"], "score_runs", "auto on the mesh")
    _need_scan(out["mesh_auto"], "auto on the mesh")
    if not spread or min(spread) < 2:
        fail(f"auto: dprefix slabs on {spread} slot(s), want > 1")
    check_same(a_kcf, host_kcf, n_win, "auto on the mesh")
    times = {"mesh_auto": (a_s, total, a_st)}

    for name, args in (("mesh_device", WINDOW_ARGS),
                       ("mesh_device_memory", WINDOW_ARGS + ("--memory",))):
        d_s, d_st, d_kcf = drive(name, "device", args=args,
                                 KCFTOOLS_TABLE_AXIS=str(MESH_TABLE_AXIS))
        _need_hash(out[name], name, MESH_TABLE_AXIS)
        check_same(d_kcf, host_kcf, n_win, name)
        times[name] = (d_s, total, d_st)

    host_gene_kcf, n_genes = host_gene
    gtf = os.path.join(root, "smoke.gtf")
    g_s, g_st, g_kcf = drive("mesh_gene", "device", args=("-f", "gene",
                                                          "-g", gtf),
                             KCFTOOLS_TABLE_AXIS=str(MESH_TABLE_AXIS))
    _need_hash(out["mesh_gene"], "gene on the mesh", MESH_TABLE_AXIS)
    check_same(g_kcf, host_gene_kcf, n_genes, "gene on the mesh")
    times["mesh_gene"] = (g_s, n_genes * len(dbs), g_st)
    if "jax" in sys.modules:
        fail("jax was imported")

    single_s, mesh_s, per_sample = _mesh_join(ref, dbs, env)
    t0 = time.perf_counter()
    with _environ(**env):
        dryrun_multichip(MESH_SLOTS if env else torch.cuda.device_count())
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0

    log(f"mesh: {smi} - {label}")
    for name, (secs, windows, stages) in times.items():
        log(f"mesh: {name}: KCF bytes equal the host engine's; {secs} s "
            f"({windows / secs} windows/s); stages {json.dumps(stages)}; "
            f"calls {out[name]}")
    log(f"mesh: auto took dprefix with slabs on {spread} slot(s)")
    log(f"mesh: MeshJoinScorer (data x table = "
        f"{(MESH_SLOTS if env else torch.cuda.device_count()) // MESH_TABLE_AXIS}"
        f" x {MESH_TABLE_AXIS}) equals DeviceJoinScorer on {len(dbs)} "
        f"samples; {per_sample} pjoin launches per sample; submit+collect "
        f"{mesh_s} s against {single_s} s on one device")
    log(f"mesh: dryrun_multichip passed in {dry_s} s; jax not loaded")
    return out


def run_paths(args, smi):
    """Phases 4-6 on synthetic data; returns each kernel's launches on
    its path."""
    root = tempfile.mkdtemp(prefix="kcf_smoke_")
    try:
        t0 = time.perf_counter()
        ref, dbs, chrom_len = make_data(root, args.mbp, args.samples, args.seed)
        log(f"data: {args.mbp} Mbp reference, {len(dbs)} samples in "
            f"{time.perf_counter() - t0} s")
        launches, host_kcf = run_slice(root, ref, dbs, chrom_len)
        calls5, feature_kcf = run_engines(root, ref, dbs, chrom_len,
                                          host_kcf, args.seed)
        # the RUNS mode's path is the dprefix engine's warm window run,
        # the ROWS mode's its -p 2500 bitmap run
        launches["gapscan_runs"] = calls5["dprefix"]["gapscan_runs"]
        launches["gapscan_rows"] = calls5["dprefix_slide"]["gapscan_rows"]
        # the hash kernels' path is the -f gene --engine device run
        for name in ("hash_probe", "hash_scan"):
            launches[name] = calls5["device_gene"][name]
        run_mesh(root, ref, dbs, chrom_len, host_kcf, feature_kcf["gene"],
                 smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mbp", type=int, default=40)
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3 only: build, check and time the "
                         "kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke runs on a GPU")
    from kcftools_tpu_torch.ops import _kernels
    from kcftools_tpu_torch.native import get_lib

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__} CUDA {torch.version.cuda}")
    print(smi, flush=True)

    t0 = time.perf_counter()
    sources = sorted({os.path.basename(v[2])[:-3] for v in KERNELS.values()}
                     | {"h2d"})  # the staged host-to-device copy
    _kernels.load_all(sources)  # one nvcc a source, all at once
    for src in sources:
        info = _kernels.build_info[src]
        log(f"build: csrc/{src}.cu in {info['seconds']} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")
    t1 = time.perf_counter()
    native = get_lib() is not None
    log(f"build: native host library {'loaded' if native else 'MISSING'} "
        f"in {time.perf_counter() - t1} s; kernels {t1 - t0} s")
    if not native:
        fail("the native host library did not build")

    rows = check_kernels(dev, args.seed, MAIN_P, MAIN_TQ, MAIN_TT)
    rows.update(check_scan(dev, args.seed))
    rows.update(check_hash(dev, args.seed))
    rows.update(check_route(dev, args.seed))
    rows.update(check_sample_tiles(dev, args.seed))
    transfers = check_transfers(dev, args.seed)

    launches = (dict.fromkeys(KERNELS) if args.kernels_only
                else run_paths(args, smi))
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"kcftools_tpu_torch/{source}", "replaces": where,
         "launches": launches[name], **rows[name]}
        for name, (_fn, _attr, source, where) in KERNELS.items()
    ], "transfers": transfers}
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
