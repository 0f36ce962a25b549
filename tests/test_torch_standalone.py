"""The port stands alone: nothing under kcftools_tpu_torch/ and nothing in
chip_smoke.py imports the JAX package ``kcftools_tpu`` (it carries its
own copy of the host tier), every module of the port imports and every
subcommand runs with ``kcftools_tpu`` and jax unimportable, with outputs
byte-equal to the JAX package's CLI, and its native library builds in
its own directory.

The port's side runs in subprocesses that set ``sys.modules["kcftools_tpu"]``
and ``sys.modules["jax"]`` to None, so that any import of either raises;
this test process has jax loaded by conftest.py and runs the JAX
package's CLI in process as the reference.
"""

import argparse
import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from kcftools_tpu.cli import build_parser as jax_parser
from kcftools_tpu.cli import main as jax_main

from .gen import mutate, random_seq, write_fasta
from .test_torch_cli import _REPO, _env

_PORT = os.path.join(_REPO, "kcftools_tpu_torch")
_BLOCKED = (
    "import sys\n"
    "sys.modules['kcftools_tpu'] = None\n"
    "sys.modules['jax'] = None\n"
)
_IMPORTERS = {"import_module", "__import__", "find_spec", "run_module",
              "spec_from_file_location"}
_IMPORT_LINE = re.compile(r"^\s*(import|from)\s+kcftools_tpu(?!_torch)\b")


def _jax_pkg(name):
    return name == "kcftools_tpu" or name.startswith("kcftools_tpu.")


def _offences(path):
    """Imports of the JAX package in one source file: import statements
    (anywhere, lazy ones too), module-name strings handed to the import
    machinery, and import lines inside strings (code run by exec)."""
    with open(path) as f:
        text = f.read()
    found = []
    for node in ast.walk(ast.parse(text, path)):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _jax_pkg(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _jax_pkg(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name in _IMPORTERS:
                found += [
                    a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _jax_pkg(a.value)
                ]
    found += [ln.strip() for ln in text.splitlines() if _IMPORT_LINE.match(ln)]
    return [f"{os.path.relpath(path, _REPO)}: {x}" for x in found]


def _port_sources():
    paths = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(_PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _run_blocked(code, *args, cwd=_REPO, **env):
    return subprocess.run(
        [sys.executable, "-c", _BLOCKED + code, *args], cwd=cwd,
        env=_env(COLUMNS="80", **env), capture_output=True, text=True,
        timeout=600,
    )


def test_port_sources_never_import_the_jax_package():
    paths = _port_sources()
    assert len(paths) > 40
    offences = [x for p in paths for x in _offences(p)]
    assert offences == []


def test_scan_finds_planted_imports(tmp_path):
    planted = tmp_path / "planted.py"
    planted.write_text(
        "import importlib\n"
        "def f():\n"
        "    from kcftools_tpu.engine import encode\n"
        "    import kcftools_tpu\n"
        "    return importlib.import_module('kcftools_tpu.io.kmc')\n"
        "CODE = '''\nfrom kcftools_tpu import cli\n'''\n"
        "import kcftools_tpu_torch\n"
        "CACHE = ('.cache', 'kcftools_tpu')\n"
    )
    found = "\n".join(_offences(str(planted)))
    for planted_import in ("kcftools_tpu.engine", "import kcftools_tpu",
                           "kcftools_tpu.io.kmc",
                           "from kcftools_tpu import cli"):
        assert planted_import in found
    assert "_torch" not in found and ".cache" not in found


_HELP = r'''
import importlib, json, pkgutil
import kcftools_tpu_torch
from kcftools_tpu_torch.cli import build_parser, main
names = sorted(m.name for m in pkgutil.walk_packages(
    kcftools_tpu_torch.__path__, "kcftools_tpu_torch."))
for name in names:
    importlib.import_module(name)
import argparse, contextlib, io
sub = next(a for a in build_parser()._actions
           if isinstance(a, argparse._SubParsersAction))
helps = {}
for cmd in sub.choices:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            main([cmd, "--help"])
        except SystemExit as e:
            assert e.code == 0, (cmd, e.code)
    helps[cmd] = buf.getvalue()
print(json.dumps({"modules": names, "help": helps,
                  "blocked": [sys.modules[m] is None
                              for m in ("kcftools_tpu", "jax")]}))
'''


def test_port_imports_and_helps_without_the_jax_package(capsys,
                                                         monkeypatch):
    proc = _run_blocked(_HELP)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["blocked"] == [True, True]
    assert len(got["modules"]) > 40
    assert "kcftools_tpu_torch.native" in got["modules"]
    sub = next(a for a in jax_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    assert list(got["help"]) == list(sub.choices)
    assert len(got["help"]) == 13
    # the same options and help; the usage lines differ by the program
    # name (kcftools-torch) and so wrap differently
    monkeypatch.setenv("COLUMNS", "80")
    for cmd, text in got["help"].items():
        with pytest.raises(SystemExit):
            jax_main([cmd, "--help"])
        want = capsys.readouterr().out
        assert text.startswith(f"usage: kcftools-torch {cmd} ")
        assert text.split("\n\n", 1)[1] == want.split("\n\n", 1)[1], cmd


_CHAIN = r'''
from kcftools_tpu_torch.cli import main
def run(*argv):
    assert main(list(argv)) == 0, argv
for i in (1, 2):
    run("count", "-i", f"s{i}.fa", "-o", f"db{i}", "-k", "21")
for engine in ("hybrid", "device", "dprefix"):
    run("getVariations", "-r", "ref.fa", "-k", "db1,db2", "-s", "s1,s2",
        "-o", engine, "-f", "window", "-w", "500", "--engine", engine)
run("cohort", "-i", "hybrid/s1.kcf,hybrid/s2.kcf", "-o", "cohort.kcf")
run("kcf2tsv", "-i", "cohort.kcf", "-o", "tsv")
run("kcf2gt", "-i", "cohort.kcf", "-o", "gt.tsv")
print("BLOCKED=%s" % all(sys.modules[m] is None
                         for m in ("kcftools_tpu", "jax")))
'''


def _read(path):
    """File bytes without the ``##date=`` / ``##CMD=`` header lines."""
    with open(path, "rb") as f:
        return b"".join(
            ln for ln in f.readlines()
            if not ln.startswith((b"##date=", b"##CMD="))
        )


def test_port_chain_matches_the_jax_package(tmp_path, rng, monkeypatch):
    """count -> getVariations (hybrid, device, dprefix on the CPU) ->
    cohort -> kcf2tsv / kcf2gt through the port with the JAX package
    unimportable, and through the JAX package's CLI, each in its own
    directory with the same relative paths: the same bytes."""
    chr1 = random_seq(rng, 4000, n_prob=0.004)
    chr2 = random_seq(rng, 2500)
    dirs = {side: tmp_path / side for side in ("port", "jax")}
    for d in dirs.values():
        d.mkdir()
        write_fasta(str(d / "ref.fa"), [("c1", chr1), ("c2", chr2)])
    samples = [
        [("c1", mutate(rng, chr1, 0.01, 0.002)), ("c2", mutate(rng, chr2, 0.03))],
        [("c1", mutate(rng, chr1, 0.02)), ("c2", chr2)],
    ]
    for i, recs in enumerate(samples, 1):
        for d in dirs.values():
            write_fasta(str(d / f"s{i}.fa"), recs)

    proc = _run_blocked(_CHAIN, cwd=str(dirs["port"]),
                        KCFTOOLS_TORCH_DEVICE="cpu")
    assert proc.returncode == 0, proc.stderr
    assert "BLOCKED=True" in proc.stdout

    monkeypatch.chdir(dirs["jax"])
    for argv in (
        ["count", "-i", "s1.fa", "-o", "db1", "-k", "21"],
        ["count", "-i", "s2.fa", "-o", "db2", "-k", "21"],
        ["getVariations", "-r", "ref.fa", "-k", "db1,db2", "-s", "s1,s2",
         "-o", "hybrid", "-f", "window", "-w", "500", "--engine", "hybrid"],
        ["cohort", "-i", "hybrid/s1.kcf,hybrid/s2.kcf", "-o", "cohort.kcf"],
        ["kcf2tsv", "-i", "cohort.kcf", "-o", "tsv"],
        ["kcf2gt", "-i", "cohort.kcf", "-o", "gt.tsv"],
    ):
        assert jax_main(argv) == 0, argv

    port, jax = dirs["port"], dirs["jax"]
    pairs = [(f"db{i}{ext}", f"db{i}{ext}") for i in (1, 2)
             for ext in (".kmc_pre", ".kmc_suf")]
    pairs += [(f"{engine}/s{i}.kcf", f"hybrid/s{i}.kcf")
              for engine in ("hybrid", "device", "dprefix") for i in (1, 2)]
    tsvs = sorted(p.name for p in jax.glob("tsv.*"))
    assert tsvs and sorted(p.name for p in port.glob("tsv.*")) == tsvs
    pairs += [(n, n) for n in ["cohort.kcf", "gt.tsv", *tsvs]]
    for got, want in pairs:
        assert _read(port / got) == _read(jax / want), got


_NATIVE = r'''
import json, os
from kcftools_tpu_torch import native
lib = native.get_lib()
print(json.dumps({"lib": native._LIB, "loaded": lib is not None and
                  os.path.samefile(lib._name, native._LIB)}))
'''


def _tree_state(path):
    return {
        os.path.join(root, f): os.stat(os.path.join(root, f)).st_mtime_ns
        for root, _dirs, files in os.walk(path) for f in files
    }


def test_port_native_library_builds_in_its_own_directory(tmp_path):
    jax_native = os.path.join(_REPO, "kcftools_tpu", "native")
    before = _tree_state(jax_native)
    proc = _run_blocked(_NATIVE)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"lib": os.path.join(_PORT, "_build", "libkcfnative.so"),
                   "loaded": True}

    lib_dir = tmp_path / "native"
    proc = _run_blocked(_NATIVE, KCFTOOLS_NATIVE_DIR=str(lib_dir))
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"lib": str(lib_dir / "libkcfnative.so"), "loaded": True}
    assert (lib_dir / "libkcfnative.so.srchash").exists()
    assert not [p for p in os.listdir(lib_dir) if p.endswith(".tmp")]
    assert _tree_state(jax_native) == before
    shutil.rmtree(lib_dir)
