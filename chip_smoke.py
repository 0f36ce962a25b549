#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (kcftools_tpu_torch) on one GPU.

    python3 chip_smoke.py [--mbp 40] [--samples 3] [--seed 0]

Phases (any failure exits non-zero):
  1. device   - the card's name, and its name and power limit as
                nvidia-smi reports them;
  2. build    - nvcc builds the port's kernels from csrc/ (and g++ the
                shared native host library) - timed;
  3. kernels  - each kernel against its plain torch version on the
                card, at the main path's shapes (P = 2^16 partitions,
                Tq = Tt = 1024): outputs must be bit-identical; kernel
                and plain times from CUDA events;
  4. slice    - synthesises a 40 Mbp reference in 4 chromosomes (N runs
                sprinkled) and 3 KMC samples at 1% SNPs (the third with
                counts > 255 up to 2^32 - 1, so both kernel variants
                run), then runs ``getVariations -f window -w 5000
                --engine device`` (k = 31) through the port's CLI, cold
                and warm, with the kernel launch counters zeroed just
                before; checks the KCF bytes against the port's
                ``--engine hybrid`` (host) output, the window count and
                that jax never loaded; prints windows/s and the
                per-phase seconds (pack, upload, join, scan, fetch).

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
MAIN_P, MAIN_TQ, MAIN_TT = 1 << 16, 1024, 1024
KERNELS = {
    "pjoin_packed": ("launches_packed", "kcftools_tpu/ops/pjoin.py:179"),
    "pjoin_u32": ("launches_u32", "kcftools_tpu/ops/pjoin.py:198"),
}


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
    """Main-path-shaped join operands: random 64-bit keys (half of the
    hi words have bit 31 set, as k = 32 keys do), a fifth of each
    table tile left as padding (key 0, count 0), the all-A key 0 as a
    real key in every seventh partition and as a query in every
    partition, half the queries hits and half misses. Counts are bytes
    when packed, else full-range uint32 (>255 and >= 2^31)."""
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
    idx = torch.randint(0, pad, (P, Tq), generator=g, device=dev)
    qh, ql = th.gather(1, idx), tl.gather(1, idx)
    miss = torch.rand((P, Tq), generator=g, device=dev) < 0.5
    qh = torch.where(miss, _rand_i32((P, Tq), g, dev), qh)
    ql = torch.where(miss, _rand_i32((P, Tq), g, dev), ql)
    qh[:, 0] = 0
    ql[:, 0] = 0
    if packed:
        W = Tt // 4
        tc = _i32_bits(cnt[:, :W] | (cnt[:, W:2 * W] << 8)
                       | (cnt[:, 2 * W:3 * W] << 16) | (cnt[:, 3 * W:] << 24))
    else:
        tc = _i32_bits(cnt)
    return [t.contiguous() for t in (qh, ql, th, tl, tc)]


def _event_ms(fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernels(dev, seed, P, Tq, Tt):
    from kcftools_tpu_torch.ops.pjoin import pjoin_join, pjoin_join_ref

    rows = {}
    for name, packed in (("pjoin_packed", True), ("pjoin_u32", False)):
        ops = join_operands(dev, seed, P, Tq, Tt, packed)
        got = pjoin_join(*ops, packed=packed)
        want = pjoin_join_ref(*ops, packed=packed)
        torch.cuda.synchronize()
        err = int(((got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF))
                  .abs().max())
        hits = int((want != 0).sum())
        if not torch.equal(got, want):
            fail(f"{name}: kernel differs from the plain version "
                 f"(max abs err {err})")
        if hits < P * Tq // 4:
            fail(f"{name}: only {hits} nonzero join results - bad operands")
        for _ in range(3):
            pjoin_join(*ops, packed=packed)
        ms = _event_ms(lambda: pjoin_join(*ops, packed=packed), 20)
        plain_ms = _event_ms(lambda: pjoin_join_ref(*ops, packed=packed), 1)
        log(f"{name}: P={P} Tq={Tq} Tt={Tt} exact (max_abs_err {err}, "
            f"{hits} nonzero); kernel {ms} ms, plain {plain_ms} ms")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del ops, got, want
    return rows


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
    from kcftools_tpu_torch._host import canonicalize, pack_kmers, sort_pairs

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
    from kcftools_tpu_torch._host import write_kmc_db

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


def run_cli(ref, dbs, out_dir, engine, stage_json):
    from kcftools_tpu_torch.cli import main

    samples = [os.path.basename(d) for d in dbs]
    argv = ["getVariations", "-r", ref, "-k", ",".join(dbs),
            "-s", ",".join(samples), "-o", out_dir, "-f", "window",
            "-w", str(WINDOW), "--engine", engine,
            "-t", str(min(8, os.cpu_count() or 1))]
    os.environ["KCFTOOLS_STAGE_JSON"] = stage_json
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # the CLI logs to stdout
        rc = main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if rc != 0:
        fail(f"getVariations --engine {engine} exited {rc}")
    with open(stage_json) as f:
        stages = json.load(f)
    return dt, stages, [os.path.join(out_dir, f"{s}.kcf") for s in samples]


def run_slice(root, ref, dbs, chrom_len):
    from kcftools_tpu_torch._host import tiling_windows
    from kcftools_tpu_torch.ops.pjoin import pjoin_join

    n_win = sum(len(tiling_windows(L, WINDOW, K)[0]) for L in chrom_len.values())
    stage_json = os.path.join(root, "stages.json")
    pjoin_join.launches_packed = 0
    pjoin_join.launches_u32 = 0
    cold_s, cold_st, _ = run_cli(ref, dbs, os.path.join(root, "dev_cold"),
                                 "device", stage_json)
    warm_s, warm_st, dev_kcf = run_cli(ref, dbs, os.path.join(root, "dev"),
                                       "device", stage_json)
    launches = {n: getattr(pjoin_join, attr) for n, (attr, _) in KERNELS.items()}
    host_s, _, host_kcf = run_cli(ref, dbs, os.path.join(root, "host"),
                                  "hybrid", stage_json)
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} was not launched by the main path")
    for d, h in zip(dev_kcf, host_kcf):
        got, want = _strip_volatile(d), _strip_volatile(h)
        if got != want:
            fail(f"{d}: KCF differs from the host engine's")
        rows = [ln for ln in got.split(b"\n") if ln and not ln.startswith(b"#")]
        if len(rows) != n_win:
            fail(f"{d}: {len(rows)} windows, expected {n_win}")
    if "jax" in sys.modules:
        fail("jax was imported")
    total_win = n_win * len(dbs)
    phases = {p: warm_st.get(f"djoin_{p}", 0.0)
              for p in ("pack", "upload", "join", "scan", "fetch")}
    log(f"slice: {sum(chrom_len.values())} bp in {len(chrom_len)} chromosomes,"
        f" {len(dbs)} samples, {total_win} windows; KCF bytes equal the "
        f"host engine's; jax not loaded; launches {launches}")
    log(f"slice: device cold {cold_s} s, warm {warm_s} s "
        f"({total_win / warm_s} windows/s); host engine {host_s} s")
    log(f"slice: warm phase seconds {json.dumps(phases)}; all stages "
        f"cold {json.dumps(cold_st)} warm {json.dumps(warm_st)}")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mbp", type=int, default=40)
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke runs on a GPU")
    from kcftools_tpu_torch.ops import _kernels
    from kcftools_tpu_torch._host import get_lib

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
    _kernels.load("pjoin")
    info = _kernels.build_info["pjoin"]
    log(f"build: csrc/pjoin.cu in {info['seconds']} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    t1 = time.perf_counter()
    native = get_lib() is not None
    log(f"build: native host library {'loaded' if native else 'MISSING'} "
        f"in {time.perf_counter() - t1} s; kernels {t1 - t0} s")
    if not native:
        fail("the native host library did not build")

    rows = check_kernels(dev, args.seed, MAIN_P, MAIN_TQ, MAIN_TT)

    root = tempfile.mkdtemp(prefix="kcf_smoke_")
    try:
        t0 = time.perf_counter()
        ref, dbs, chrom_len = make_data(root, args.mbp, args.samples, args.seed)
        log(f"data: {args.mbp} Mbp reference, {len(dbs)} samples in "
            f"{time.perf_counter() - t0} s")
        launches = run_slice(root, ref, dbs, chrom_len)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "kcftools_tpu_torch/csrc/pjoin.cu", "replaces": where,
         "launches": launches[name], **rows[name]}
        for name, (_attr, where) in KERNELS.items()
    ]}
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
