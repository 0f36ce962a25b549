"""The port's CLI (``python -m kcftools_tpu_torch.cli``) against the JAX
package's, end to end.

The port runs in a subprocess (this test process has jax loaded by
conftest.py) with ``KCFTOOLS_TORCH_DEVICE=cpu``; the JAX package runs in
process, as tests/test_engines_agree.py runs it. Outputs must be the
same bytes apart from the ``##date`` / ``##CMD`` header lines, and the
port's process must never load jax.
"""

import os
import subprocess
import sys

import pytest

from kcftools_tpu.cli import main as jax_main

from .gen import db_from_seqs, mutate, random_seq, write_fasta

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RUN = (
    "import sys\n"
    "from kcftools_tpu_torch.cli import main\n"
    "rc = main(sys.argv[1:])\n"
    "print('JAX_LOADED=%s' % ('jax' in sys.modules))\n"
    "sys.exit(rc)\n"
)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p
    )
    env.pop("KCFTOOLS_TORCH_DEVICE", None)
    env.update(extra)
    return env


def _port(args, **env):
    return subprocess.run(
        [sys.executable, "-c", _RUN, *args], cwd=_REPO,
        env=_env(**env), capture_output=True, text=True, timeout=300,
    )


def _strip_volatile(path):
    with open(path) as f:
        return "\n".join(
            line for line in f.read().split("\n")
            if not line.startswith(("##date=", "##CMD="))
        )


def _fixture(tmp_path, rng, case):
    """(reference, db list, samples, extra flags) as in
    tests/test_engines_agree.py, plus a two-sample run."""
    if case == "sliding":
        k = 17
        chrom = random_seq(rng, 3000, n_prob=0.01)
        fa = str(tmp_path / "ref2.fa")
        write_fasta(fa, [("c1", chrom)])
        db_from_seqs(str(tmp_path / "db2"), [mutate(rng, chrom, 0.02)], k)
        return fa, [str(tmp_path / "db2")], ["sY"], [
            "-w", "400", "-p", "150", "-c", "2"]
    k = 21
    chr1 = random_seq(rng, 4000, n_prob=0.004)
    chr2 = random_seq(rng, 2500)
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, [("c1", chr1), ("c2", chr2)])
    dbs = [str(tmp_path / "db")]
    db_from_seqs(dbs[0], [mutate(rng, chr1, 0.01, 0.002),
                          mutate(rng, chr2, 0.03)], k)
    if case == "tiling":
        return fa, dbs, ["s1"], ["-w", "500"]
    dbs.append(str(tmp_path / "dbb"))
    db_from_seqs(dbs[1], [mutate(rng, chr1, 0.02), chr2], k)
    return fa, dbs, ["x", "y"], ["-w", "500"]


def _gv(fa, dbs, samples, out, extra, engine):
    return ["getVariations", "-r", fa, "-k", ",".join(dbs), "-o", out,
            "-s", ",".join(samples), "-f", "window", *extra,
            "--engine", engine]


@pytest.mark.parametrize("engine", ["device", "hybrid"])
@pytest.mark.parametrize("case", ["tiling", "sliding", "two_sample"])
def test_port_cli_matches_jax_device_engine(tmp_path, rng, case, engine):
    fa, dbs, samples, extra = _fixture(tmp_path, rng, case)
    multi = len(dbs) > 1
    jax_out = str(tmp_path / ("jax" if multi else "jax.kcf"))
    port_out = str(tmp_path / ("port" if multi else "port.kcf"))
    assert jax_main(_gv(fa, dbs, samples, jax_out, extra, "device")) == 0
    proc = _port(_gv(fa, dbs, samples, port_out, extra, engine),
                 KCFTOOLS_TORCH_DEVICE="cpu")
    assert proc.returncode == 0, proc.stderr
    assert "JAX_LOADED=False" in proc.stdout
    pairs = (
        [(os.path.join(jax_out, f"{s}.kcf"), os.path.join(port_out, f"{s}.kcf"))
         for s in samples]
        if multi else [(jax_out, port_out)]
    )
    for want, got in pairs:
        assert _strip_volatile(got) == _strip_volatile(want)


def test_port_cli_default_device_needs_cuda(tmp_path, rng):
    """Without KCFTOOLS_TORCH_DEVICE the device is cuda:0; on a host
    without CUDA the run fails rather than falling back to the CPU."""
    fa, dbs, samples, extra = _fixture(tmp_path, rng, "tiling")
    out = str(tmp_path / "o.kcf")
    proc = _port(_gv(fa, dbs, samples, out, extra, "device"))
    if proc.returncode == 0:
        pytest.skip("this host has CUDA")
    assert "CUDA is not available" in proc.stderr
    assert not os.path.exists(out)


@pytest.mark.parametrize("args,what", [
    (["--engine", "dprefix"], "--engine dprefix"),
    (["--engine", "auto"], "auto engine"),
])
def test_port_cli_refuses_unported_engines(tmp_path, rng, args, what):
    fa, dbs, samples, extra = _fixture(tmp_path, rng, "tiling")
    argv = _gv(fa, dbs, samples, str(tmp_path / "o.kcf"), extra, "hybrid")
    argv[-2:] = args
    # auto on more than one GPU is the multi-GPU path: the subprocess
    # makes torch report two
    env = {"KCFTOOLS_NO_DEVICE_PROBE": ""}
    if args[1] == "auto":
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys, torch\n"
             "torch.cuda.device_count = lambda: 2\n" + _RUN, *argv],
            cwd=_REPO, env=_env(**env), capture_output=True, text=True,
            timeout=300,
        )
    else:
        proc = _port(argv, **env)
    assert proc.returncode == 1
    assert what in proc.stderr and "not yet ported" in proc.stderr


def test_port_cli_host_plugin_without_jax(tmp_path, rng):
    """The host subcommands run through the port's CLI, jax-free."""
    fa, dbs, samples, extra = _fixture(tmp_path, rng, "tiling")
    kcf = str(tmp_path / "h.kcf")
    proc = _port(_gv(fa, dbs, samples, kcf, extra, "hybrid"))
    assert proc.returncode == 0, proc.stderr
    proc = _port(["kcf2tsv", "-i", kcf, "-o", str(tmp_path / "t")])
    assert proc.returncode == 0, proc.stderr
    assert "JAX_LOADED=False" in proc.stdout
    assert os.path.getsize(str(tmp_path / "t.s1.tsv")) > 0


def test_port_import_keeps_jax_engine_importable():
    """A process that imports the port first (jax-free) can still import
    the JAX engine package's re-exports afterwards."""
    code = (
        "import sys\n"
        "import kcftools_tpu_torch.cli\n"
        "from kcftools_tpu_torch.engine import device_join\n"
        "assert 'jax' not in sys.modules\n"
        "from kcftools_tpu.engine import WindowScorer, pack_kmers\n"
        "from kcftools_tpu.engine.device_join import DeviceJoinScorer\n"
        "assert 'jax' in sys.modules\n"
        "print('OK')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"
