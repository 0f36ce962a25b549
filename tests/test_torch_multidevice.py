"""The port's multi-device tier on CPU slots against the JAX package on
its 8-device CPU mesh: dprefix's sample-axis device pool, and
getVariations through the port's CLI on 8 slots.

Mirrors tests/test_multichip_default.py and tests/test_device_prefix.py
:302-347. The CLI runs in jax-free subprocesses with
``KCFTOOLS_TORCH_DEVICE=cpu KCFTOOLS_TORCH_VIRTUAL_DEVICES=8``; every
KCF must equal the JAX CLI's (same engine, in process) and the port's
``--engine hybrid`` bytes, apart from ``##date`` / ``##CMD``. Also: no
fallback hides the device (virtual slots need the device they name; a
gloo process group does not serve CUDA tensors).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kcftools_tpu.cli import main as jax_main
from kcftools_tpu.engine.device_prefix import DevicePrefixScorer as JaxDP
from kcftools_tpu.engine.encode import canonicalize, pack_kmers
from kcftools_tpu.engine.prefix_scan import (
    chromosome_stats_indirect,
    window_stats,
)
from kcftools_tpu.engine.windows import tiling_windows
from kcftools_tpu.native import merge_counts_u8, window_scan_u8
from kcftools_tpu_torch.engine.device_prefix import DevicePrefixScorer
from kcftools_tpu_torch.torchinit import resolve_devices

from .gen import db_from_seqs, mutate, random_seq, write_fasta
from .test_torch_cli import _REPO, _env, _strip_volatile
from .test_torch_cli_engines import _feature_fixture, _port_many

K = 21
_FIELDS = ("observed", "variations", "inner", "left", "right", "count_sum")
_SLOTS = {"KCFTOOLS_TORCH_VIRTUAL_DEVICES": "8"}


@pytest.fixture
def cpu_slots(monkeypatch):
    monkeypatch.setenv("KCFTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("KCFTOOLS_TORCH_VIRTUAL_DEVICES", "8")
    return resolve_devices()


def test_dprefix_shards_slabs_across_slots(rng, cpu_slots, monkeypatch):
    """Slabs land on more than one slot; the results equal the native
    merge + scan and the JAX scorer on its 8 devices, on every window."""
    n = 300_000
    genome = rng.integers(0, 4, n).astype(np.uint8)
    kmers, kv = pack_kmers(genome, np.ones(n, bool), K)
    canon = canonicalize(kmers, K)
    refk = np.unique(canon[kv])
    r_idx = np.searchsorted(refk, canon).astype(np.int32)
    r_idx[~kv] = -1
    starts, ends = tiling_windows(n, 2000, K)
    sample = genome.copy()
    snp = rng.random(n) < 0.01
    sample[snp] = (sample[snp] + rng.integers(1, 4, snp.sum())) % 4
    sk, skv = pack_kmers(sample, np.ones(n, bool), K)
    db, dbc = np.unique(canonicalize(sk[skv], K), return_counts=True)
    dbc = dbc.astype(np.uint32)

    monkeypatch.setenv("KCFTOOLS_DPREFIX_SLAB", str(1 << 20))
    out = {}
    for name, sc in (
        ("port", DevicePrefixScorer(None, K, batch=1, devices=cpu_slots)),
        ("jax", JaxDP(None, K, min_count=1, batch=1)),
    ):
        sc.add_chrom("c", r_idx, starts, ends)
        sc.merge_and_upload(refk, db, dbc)
        out[name] = sc.score_chrom("c")
        used = sc.devices_used()
        assert len(used) > 1, f"{name}: slabs on {used}"
        sc.close()
    u8, ei, ev = merge_counts_u8(refk, db, dbc)
    want = window_scan_u8(u8, ei, ev, r_idx, 1, K, starts,
                          (ends - K).astype(np.int32))
    for f in _FIELDS:
        np.testing.assert_array_equal(out["port"][f], out["jax"][f],
                                      err_msg=f)
        if want is not None:
            np.testing.assert_array_equal(out["port"][f], want[f],
                                          err_msg=f)


@pytest.mark.parametrize("seq_len,uplink,pooled", [
    (4096, "auto", False), (1024, "auto", True), (1024, "bitmap", True),
])
def test_dprefix_sample_axis_spread(rng, cpu_slots, monkeypatch, seq_len,
                                    uplink, pooled):
    """A group of 7 samples on 8 slots: with at least as many slabs as
    slots each slab runs the group on its slot; with fewer slabs (the
    2 windows of a 1 kb genome) each slab gets a pool of slots and the
    group's rows split over it. Every sample stays exact (against the
    host prefix oracle and the JAX scorer)."""
    monkeypatch.setenv("KCFTOOLS_DPREFIX_UPLINK", uplink)
    k = 31
    n_ref = 3000
    starts, ends = tiling_windows(seq_len, 512, k)
    n_pos = seq_len - k + 1
    r_idx = rng.integers(0, n_ref, n_pos).astype(np.int32)
    r_idx[rng.random(n_pos) < 0.04] = -1
    port = DevicePrefixScorer(None, k, batch=8, devices=cpu_slots)
    jax_ = JaxDP(None, k, min_count=1, batch=8)
    samples = [rng.integers(0, 9, n_ref).astype(np.uint8) for _ in range(7)]
    for sc in (port, jax_):
        sc.add_chrom("c", r_idx, starts, ends)
        for i, counts_u8 in enumerate(samples):
            sc.submit_counts(i, counts_u8, np.empty(0, np.int32),
                             np.empty(0, np.uint32))
    assert (port._spread > 1) == pooled
    n_slots = min(8, len(port._layout.slabs) * port._spread)
    assert len(port.sample_rows_devices()) == n_slots > 1
    assert port.devices_used() == port.sample_rows_devices()
    assert port.programs_run == set() and port._pending  # 7 < batch
    for i, counts_u8 in enumerate(samples):
        got = port.collect(i)["c"]
        st = chromosome_stats_indirect(
            counts_u8.astype(np.uint32), r_idx, np.ones(seq_len, bool), 1, k
        )
        want = window_stats(st, starts, ends)
        jw = jax_.collect(i)["c"]
        for f in _FIELDS:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"s{i} {f}")
            np.testing.assert_array_equal(got[f], jw[f], err_msg=f"s{i} {f}")
    assert port.programs_run == {"runs" if uplink == "auto" else "bits"}
    port.close()


def _window_fixture(tmp_path, rng, n_samples=1):
    chr1 = random_seq(rng, 6000, n_prob=0.004)
    chr2 = random_seq(rng, 4000, n_prob=0.004)
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, [("chr1", chr1), ("chr2", chr2)])
    dbs, names = [], []
    for i in range(n_samples):
        p = str(tmp_path / f"db{i}")
        db_from_seqs(p, [mutate(rng, chr1, 0.01 * (i + 1)),
                         mutate(rng, chr2, 0.01)], K)
        dbs.append(p)
        names.append(f"s{i}")
    return fa, dbs, names


def _argv(fa, dbs, names, out, engine, *extra):
    return ["getVariations", "-r", fa, "-k", ",".join(dbs), "-o", out,
            "-s", ",".join(names), "-f", "window", "-w", "400",
            "--engine", engine, *extra]


def _outs(out, names):
    return ([os.path.join(out, f"{n}.kcf") for n in names]
            if len(names) > 1 else [out])


@pytest.mark.parametrize("case", [
    "auto", "device", "device_memory", "device_table4",
    "device_table4_memory",
])
def test_port_cli_mesh_window(tmp_path, rng, monkeypatch, case):
    """auto (-> dprefix over 8 slots) and --engine device window mode
    (-> the mesh-sharded hash engine, streamed or with --memory, table
    axis 1 or 4) equal the JAX CLI's run and --engine hybrid."""
    fa, dbs, names = _window_fixture(tmp_path, rng)
    engine = "auto" if case == "auto" else "device"
    extra = ("--memory",) if case.endswith("memory") else ()
    env = dict(_SLOTS, KCFTOOLS_NO_DEVICE_PROBE="",
               KCFTOOLS_DPREFIX_SLAB=str(1 << 20))
    if "table4" in case:
        env["KCFTOOLS_TABLE_AXIS"] = "4"
    for key, v in env.items():
        if key != "KCFTOOLS_TORCH_VIRTUAL_DEVICES":
            monkeypatch.setenv(key, v)
    jax_out = str(tmp_path / "jax.kcf")
    assert jax_main(_argv(fa, dbs, names, jax_out, engine, *extra)) == 0
    h_out, p_out = str(tmp_path / "h.kcf"), str(tmp_path / "p.kcf")
    proc = _port_many([_argv(fa, dbs, names, h_out, "hybrid"),
                       _argv(fa, dbs, names, p_out, engine, *extra)], **env)
    if case == "auto":
        assert "8 devices visible -> dprefix" in proc.stdout
    else:
        axis = 4 if "table4" in case else 1
        assert f"data={8 // axis} table={axis}" in proc.stdout
        assert ("Streaming" in proc.stdout) == (not extra)
    got = _strip_volatile(p_out)
    assert got == _strip_volatile(jax_out)
    assert got == _strip_volatile(h_out)


def test_port_cli_mesh_multi_sample_dprefix(tmp_path, rng, monkeypatch):
    """Three samples in groups of two through dprefix over 8 slots: each
    KCF equals the JAX CLI's and its hybrid twin."""
    fa, dbs, names = _window_fixture(tmp_path, rng, n_samples=3)
    monkeypatch.setenv("KCFTOOLS_DEVICE_BATCH", "2")
    jax_out = str(tmp_path / "jax")
    assert jax_main(_argv(fa, dbs, names, jax_out, "dprefix")) == 0
    h_out, p_out = str(tmp_path / "h"), str(tmp_path / "p")
    _port_many([_argv(fa, dbs, names, h_out, "hybrid"),
                _argv(fa, dbs, names, p_out, "dprefix")],
               KCFTOOLS_DEVICE_BATCH="2", **_SLOTS)
    for got, want, hyb in zip(_outs(p_out, names), _outs(jax_out, names),
                              _outs(h_out, names)):
        assert _strip_volatile(got) == _strip_volatile(want), got
        assert _strip_volatile(got) == _strip_volatile(hyb), got


@pytest.mark.parametrize("memory", [False, True], ids=["streamed", "memory"])
@pytest.mark.parametrize("feature", ["gene", "transcript"])
def test_port_cli_mesh_features(tmp_path, rng, monkeypatch, feature, memory):
    """-f gene|transcript --engine device on the mesh (the sharded hash
    engine with table axis 2) equals the JAX CLI's run and hybrid."""
    fa, gtf_path, db = _feature_fixture(tmp_path, rng, 15)
    monkeypatch.setenv("KCFTOOLS_TABLE_AXIS", "2")
    extra = ["--memory"] if memory else []

    def argv(out, engine):
        return ["getVariations", "-r", fa, "-k", db, "-o", out, "-s", "sx",
                "-f", feature, "-g", gtf_path, "--engine", engine, *extra]

    jax_out = str(tmp_path / "jax.kcf")
    assert jax_main(argv(jax_out, "device")) == 0
    h_out, p_out = str(tmp_path / "h.kcf"), str(tmp_path / "p.kcf")
    proc = _port_many([argv(h_out, "hybrid"), argv(p_out, "device")],
                      KCFTOOLS_TABLE_AXIS="2", **_SLOTS)
    assert "data=4 table=2" in proc.stdout
    got = _strip_volatile(p_out)
    assert got == _strip_volatile(jax_out)
    assert got == _strip_volatile(h_out)


def _run_port_code(code, **env):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, env=_env(**env),
        capture_output=True, text=True, timeout=120,
    )


def test_virtual_slots_need_their_device(tmp_path, rng):
    """Virtual slots on the default device (cuda:0) of a host without
    CUDA: the run exits non-zero; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    fa, dbs, names = _window_fixture(tmp_path, rng)
    out = str(tmp_path / "o.kcf")
    for engine in ("auto", "dprefix", "device"):
        proc = subprocess.run(
            [sys.executable, "-m", "kcftools_tpu_torch.cli",
             *_argv(fa, dbs, names, out, engine)],
            cwd=_REPO, env=_env(KCFTOOLS_NO_DEVICE_PROBE="", **_SLOTS),
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0, engine
        assert "CUDA is not available" in proc.stderr, engine
        assert not os.path.exists(out)


def test_gloo_group_refuses_cuda_tensors():
    """A collective of a CUDA tensor through a gloo process group
    raises (a CUDA run needs NCCL), as does a group asked for on a host
    without CUDA when the device is CUDA."""
    code = (
        "import socket, torch, torch.distributed as dist\n"
        "from kcftools_tpu_torch.parallel import mesh\n"
        "s = socket.socket(); s.bind(('127.0.0.1', 0))\n"
        "port = s.getsockname()[1]; s.close()\n"
        "mesh.init_distributed(f'127.0.0.1:{port}', 1, 0)\n"
        "assert not dist.is_initialized()  # one process: no group\n"
        "dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:"
        "{port}', world_size=1, rank=0)\n"
        "mesh.check_backend(torch.device('cpu'))\n"
        "try:\n"
        "    mesh.check_backend(torch.device('cuda', 0))\n"
        "except RuntimeError as e:\n"
        "    print('REFUSED', e)\n"
        "dist.destroy_process_group()\n"
    )
    proc = _run_port_code(code, KCFTOOLS_TORCH_DEVICE="cpu")
    assert proc.returncode == 0, proc.stderr
    assert "REFUSED process group backend gloo cannot serve cuda" in (
        proc.stdout
    )
    code = (
        "from kcftools_tpu_torch.parallel import mesh\n"
        "mesh.init_distributed('127.0.0.1:1', 2, 0)\n"
    )
    proc = _run_port_code(code, KCFTOOLS_TORCH_DEVICE="cuda:0")
    if not torch.cuda.is_available():
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr
