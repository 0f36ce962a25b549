"""Whole runs of tiny cells on the CPU: a sound run is correct, and a run
whose timed path is broken underneath is not (CPU; one test on the
card)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench_tiny import GENE, ROOT, WINDOW, run

REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("workload", [WINDOW, GENE])
def test_sound_run_is_correct(tmp_path, workload):
    res = run(tmp_path, workload)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] >= 1
    keys = list(res)
    assert keys[: len(REQUIRED)] == list(REQUIRED)
    assert keys[-1] == "checks" and "breakdown" not in res
    assert set(res["metrics"]) == {"mbp_per_s", "first_run_s", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0
    assert res["checks"]["bad_windows"] == {"value": 0, "limit": 0}
    json.dumps(res)


def _patch_collect(monkeypatch, workload, fault):
    """Break the engine's result underneath the timed path."""
    from kcftools_tpu_torch.engine.device_join import DeviceJoinScorer
    from kcftools_tpu_torch.engine.pipeline import WindowScorer

    first = {}

    def broken(res, slot):
        if fault == "unchanged":
            kept = first.setdefault(slot, {f: v.copy()
                                           for f, v in res.items()})
            return {f: v.copy() for f, v in kept.items()}
        out = {f: v.copy() for f, v in res.items()}
        if fault == "half":
            for v in out.values():
                v[len(v) // 2:] = 0
        elif fault == "altered":
            out["observed"][0] += 1
        return out

    if workload == WINDOW:
        orig = DeviceJoinScorer.collect

        def collect(self, key=None):
            return {name: broken(r, name)
                    for name, r in orig(self, key).items()}

        monkeypatch.setattr(DeviceJoinScorer, "collect", collect)
    else:
        orig = WindowScorer.collect

        def collect(handle):
            res = orig(handle)
            return broken(res, len(res["observed"]))

        monkeypatch.setattr(WindowScorer, "collect", staticmethod(collect))


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", [WINDOW, GENE])
def test_broken_path_is_not_correct(tmp_path, monkeypatch, workload, fault):
    """A step that returns its state unchanged (every result the first
    one made for its chromosome or batch shape), half of the windows left out (their statistics
    zero), an answer altered where it is produced."""
    _patch_collect(monkeypatch, workload, fault)
    res = run(tmp_path, workload)
    assert res["correct"] is False
    assert res["checks"]["bad_windows"]["value"] > 0


def test_failed_call_is_counted(tmp_path, monkeypatch):
    """A window call that raises is failed, and its output missing."""
    from kcftools_tpu_torch.engine import device_join

    seen = []
    orig = device_join.DeviceJoinScorer.submit

    def submit(self, *a, **kw):
        seen.append(1)
        if len(seen) > 4:  # two small calls, the first, one warm-up
            raise RuntimeError("planted")
        return orig(self, *a, **kw)

    monkeypatch.setattr(device_join.DeviceJoinScorer, "submit", submit)
    res = run(tmp_path, WINDOW)
    assert res["failed"] == res["attempted"] >= 2
    assert res["correct"] is False
    assert res["checks"]["failed_calls"]["value"] == res["failed"]


def test_forbidden_modules_compared_whole(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kcftools_tpu_torch_x", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]
    monkeypatch.setitem(sys.modules, "kcftools_tpu.engine", object())
    assert harness.forbidden_modules() == ["jax", "kcftools_tpu"]


def test_no_cuda_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        WINDOW, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        WINDOW, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [WINDOW])
def test_cell_on_card(workload):
    """A short run of the cell itself (card only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        workload, "--seed", str(2**31 + 77), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
