"""The port's dprefix engine and on-chip hash engine through its CLI
(``python -m kcftools_tpu_torch.cli``) against the JAX package's, end to
end.

Each test runs its port commands in one jax-free subprocess with
``KCFTOOLS_TORCH_DEVICE=cpu``; the JAX package runs in process. Outputs
must be the same bytes apart from the ``##date`` / ``##CMD`` header
lines, and the port's process must never load jax.
"""

import json
import os
import subprocess
import sys

import pytest

from kcftools_tpu.cli import main as jax_main

from .gen import mutate, random_seq, write_fasta
from .test_torch_cli import _REPO, _env, _fixture, _gv, _strip_volatile

_RUN_MANY = (
    "import json, sys\n"
    "from kcftools_tpu_torch.cli import main\n"
    "rcs = [main(a) for a in json.loads(sys.argv[1])]\n"
    "print('RCS=%s' % json.dumps(rcs))\n"
    "print('JAX_LOADED=%s' % ('jax' in sys.modules))\n"
)


def _port_many(argvs, **env):
    """Run several port commands in one jax-free process; asserts that
    each exited 0 and that jax never loaded."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_MANY, json.dumps(argvs)], cwd=_REPO,
        env=_env(KCFTOOLS_TORCH_DEVICE="cpu", **env), capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert f"RCS={json.dumps([0] * len(argvs))}" in proc.stdout, proc.stderr
    assert "JAX_LOADED=False" in proc.stdout
    return proc


def _outputs(out, samples):
    if len(samples) > 1:
        return [os.path.join(out, f"{s}.kcf") for s in samples]
    return [out]


def _assert_same_bytes(got_paths, want_paths):
    for got, want in zip(got_paths, want_paths):
        assert _strip_volatile(got) == _strip_volatile(want), got


@pytest.mark.parametrize("case", ["tiling", "sliding", "two_sample",
                                  "three_sample_batch2"])
def test_port_dprefix_matches_jax(tmp_path, rng, monkeypatch, case):
    env = {}
    if case == "three_sample_batch2":
        # three samples in groups of two: one full group, one partial
        fa, dbs, samples, extra = _fixture(tmp_path, rng, "two_sample")
        from .gen import db_from_seqs

        db3 = str(tmp_path / "dbc")
        db_from_seqs(db3, [random_seq(rng, 3000)], 21)
        dbs, samples = dbs + [db3], samples + ["z"]
        env["KCFTOOLS_DEVICE_BATCH"] = "2"
        monkeypatch.setenv("KCFTOOLS_DEVICE_BATCH", "2")
    else:
        fa, dbs, samples, extra = _fixture(tmp_path, rng, case)
    multi = len(dbs) > 1
    jax_out = str(tmp_path / ("jax" if multi else "jax.kcf"))
    port_out = str(tmp_path / ("port" if multi else "port.kcf"))
    assert jax_main(_gv(fa, dbs, samples, jax_out, extra, "dprefix")) == 0
    _port_many([_gv(fa, dbs, samples, port_out, extra, "dprefix")], **env)
    _assert_same_bytes(_outputs(port_out, samples),
                       _outputs(jax_out, samples))


def test_port_dprefix_streamed_ingest(tmp_path, rng, monkeypatch):
    """KCFTOOLS_SORT_CACHE_BUDGET=0 on a database without a sorted
    sidecar: the port streams the merge (stage merge_streamed) and
    writes no sidecar; bytes equal the JAX package's streamed run."""
    fa, dbs, samples, extra = _fixture(tmp_path, rng, "two_sample")
    monkeypatch.setenv("KCFTOOLS_SORT_CACHE_BUDGET", "0")
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_main(_gv(fa, dbs, samples, jax_out, extra, "dprefix")) == 0
    stages = str(tmp_path / "stages.json")
    _port_many([_gv(fa, dbs, samples, port_out, extra, "dprefix")],
               KCFTOOLS_SORT_CACHE_BUDGET="0", KCFTOOLS_STAGE_JSON=stages)
    with open(stages) as f:
        assert json.load(f).get("merge_streamed", -1) >= 0
    assert not [n for n in os.listdir(tmp_path) if "kcfsorted" in n]
    _assert_same_bytes(_outputs(port_out, samples),
                       _outputs(jax_out, samples))


def _write_gtf(path, rows):
    with open(path, "w") as fh:
        fh.write("# test gtf\n")
        for chrom, type_, start, end, strand, attrs in rows:
            fh.write(f"{chrom}\ttest\t{type_}\t{start}\t{end}\t.\t{strand}"
                     f"\t.\t{attrs}\n")


def _feature_fixture(tmp_path, rng, k):
    """As tests/test_gtf_mode.py::test_feature_dprefix_matches_hybrid: a
    spliced two-exon gene, a minus-strand gene and a gene shorter than
    k, plus a two-transcript gene on a second chromosome."""
    chrom = random_seq(rng, 3000, n_prob=0.005)
    chrom2 = random_seq(rng, 1500)
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, [("chr1", chrom), ("chr2", chrom2)])
    gtf_path = str(tmp_path / "f.gtf")
    rows = []
    for gid, c, s, e, strand, exons in (
        ("g1", "chr1", 101, 900, "+", [(101, 500), (701, 900)]),
        ("g2", "chr1", 1001, 1000 + k - 2, "+", [(1001, 1000 + k - 2)]),
        ("g3", "chr1", 1501, 2800, "-", [(1501, 2800)]),
    ):
        rows.append((c, "gene", s, e, strand, f'gene_id "{gid}";'))
        tid = "t" + gid[1:]
        attrs = f'gene_id "{gid}"; transcript_id "{tid}";'
        rows.append((c, "mRNA", s, e, strand, attrs))
        rows += [(c, "exon", a, b, strand, attrs) for a, b in exons]
    rows.append(("chr2", "gene", 51, 1400, "+", 'gene_id "g4";'))
    for tid, exons in (("t4a", [(51, 400), (601, 1400)]),
                       ("t4b", [(51, 300), (501, 900), (1001, 1200)])):
        attrs = f'gene_id "g4"; transcript_id "{tid}";'
        rows.append(("chr2", "mRNA", exons[0][0], exons[-1][1], "+", attrs))
        rows += [("chr2", "exon", a, b, "+", attrs) for a, b in exons]
    _write_gtf(gtf_path, rows)
    sfa = str(tmp_path / "s.fa")
    write_fasta(sfa, [("chr1", mutate(rng, chrom, snp_rate=0.02)),
                      ("chr2", mutate(rng, chrom2, snp_rate=0.01))])
    db = str(tmp_path / "db")
    assert jax_main(["count", "-i", sfa, "-o", db, "-k", str(k)]) == 0
    return fa, gtf_path, db


@pytest.mark.parametrize("feature", ["gene", "transcript"])
@pytest.mark.parametrize("k", [15, 51])
def test_port_feature_engines_match_jax(tmp_path, rng, k, feature):
    """Gene/transcript windows through every engine that takes them:
    the on-chip hash engine (--engine device, k <= 32), dprefix and
    hybrid, each against the JAX package's same engine."""
    fa, gtf_path, db = _feature_fixture(tmp_path, rng, k)
    engines = ["dprefix", "hybrid"] + (["device"] if k <= 32 else [])

    def argv(out, engine):
        return ["getVariations", "-r", fa, "-k", db, "-o", out, "-s", "sx",
                "-f", feature, "-g", gtf_path, "--engine", engine]

    for eng in engines:
        assert jax_main(argv(str(tmp_path / f"jax_{eng}.kcf"), eng)) == 0
    _port_many([argv(str(tmp_path / f"port_{eng}.kcf"), eng)
                for eng in engines])
    for eng in engines:
        got = _strip_volatile(str(tmp_path / f"port_{eng}.kcf"))
        assert got == _strip_volatile(str(tmp_path / f"jax_{eng}.kcf")), eng
        assert got == _strip_volatile(str(tmp_path / "port_hybrid.kcf")), eng
    rows = [ln for ln in got.split("\n") if ln and not ln.startswith("#")]
    assert len(rows) == (4 if feature == "gene" else 5)
