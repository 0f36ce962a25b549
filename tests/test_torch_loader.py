"""The port's streaming sharded-table loader (kcftools_tpu_torch/
parallel/loader.py) against the JAX package, on CPU slots.

Mirrors tests/test_loader.py: the streamed table on three meshes, the
multi-pass plan under a tiny host budget, and shard-overflow growth from
an undersized bucket count. The reference is the JAX single-device
WindowScorer over the fully built table (and, for the meshes, the JAX
loader's scorer); every comparison is exact.
"""

import numpy as np
import pytest

from kcftools_tpu.engine.encode import str_to_kmer
from kcftools_tpu.engine.hashtable import build_table
from kcftools_tpu.engine.pipeline import PAD_MARGIN, WindowScorer
from kcftools_tpu.engine.windows import pad_batch_varlen
from kcftools_tpu.io.fasta import codes_from_str
from kcftools_tpu.parallel.loader import ShardedTableLoader as JaxLoader
from kcftools_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kcftools_tpu_torch.parallel.loader import ShardedTableLoader
from kcftools_tpu_torch.parallel.mesh import make_mesh
from kcftools_tpu_torch.parallel.sharded import (
    ShardedTable,
    ShardedWindowScorer,
)

from .gen import db_from_seqs, mutate, random_seq

K = 31


@pytest.fixture(autouse=True)
def cpu_slots(monkeypatch):
    monkeypatch.setenv("KCFTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("KCFTOOLS_TORCH_VIRTUAL_DEVICES", "8")


@pytest.fixture(scope="module")
def dbws(tmp_path_factory):
    rng = np.random.default_rng(12)
    tmp = tmp_path_factory.mktemp("torch_loader")
    genome = random_seq(rng, 6000)
    sample = mutate(rng, genome, snp_rate=0.01, del_rate=0.001)
    prefix = str(tmp / "db")
    db = db_from_seqs(prefix, [sample], K)
    windows = [genome[i : i + 500] for i in range(0, 5400, 470)]
    pad = max(len(w) for w in windows) + PAD_MARGIN
    codes, valids = zip(*[codes_from_str(w) for w in windows])
    batch = pad_batch_varlen(list(codes), list(valids), pad)
    kmers = np.array([str_to_kmer(s) for s in db], dtype=np.uint64)
    counts = np.array(list(db.values()), dtype=np.uint32)
    ref = WindowScorer(build_table(kmers, counts, K)).score_batch(*batch)
    return {"prefix": prefix, "batch": batch, "ref": ref}


def _assert_ref(got, ref):
    for key in ref:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]),
                                      err_msg=key)


@pytest.mark.parametrize("data,table", [(4, 2), (2, 4), (1, 8)])
def test_streamed_loader_matches_jax(dbws, data, table):
    loader = ShardedTableLoader(dbws["prefix"], make_mesh(data, table),
                                slab_records=777)
    scorer = loader.load_scorer(min_count=1)
    got = scorer.score_batch(*dbws["batch"])
    _assert_ref(got, dbws["ref"])
    jax_scorer = JaxLoader(dbws["prefix"], jax_make_mesh(data, table),
                           slab_records=777).load_scorer(min_count=1)
    _assert_ref(got, jax_scorer.score_batch(*dbws["batch"]))
    assert scorer.nb_total == jax_scorer.nb_total
    # one shard tensor per table column (the slots share one device)
    assert sorted(ti for _dev, ti in scorer.tbl.parts) == list(range(table))
    assert loader.last_stats["n_passes"] == 1


def test_loader_multi_pass_under_ram_budget(dbws):
    """A budget that holds one shard at a time forces one pass per local
    shard; the result must not change."""
    mesh = make_mesh(data=1, table=8)
    loader = ShardedTableLoader(
        dbws["prefix"], mesh, ram_budget_bytes=1, slab_records=500
    )
    t_axis, _nb_local, per_pass = loader._plan(16)
    assert (t_axis, per_pass) == (8, 1)
    scorer = loader.load_scorer(min_count=1)
    assert loader.last_stats["n_passes"] == 8
    _assert_ref(scorer.score_batch(*dbws["batch"]), dbws["ref"])


def test_shard_overflow_grows(dbws):
    """From a deliberately undersized bucket count (2 buckets a shard),
    per-shard overflow grows the global table and the result stays
    exact."""
    mesh = make_mesh(data=1, table=8)
    loader = ShardedTableLoader(dbws["prefix"], mesh, slab_records=911)
    tbl, nb_total = loader.load(nb_total=16)
    assert nb_total > 16 and isinstance(tbl, ShardedTable)
    scorer = ShardedWindowScorer.from_device_table(
        tbl, nb_total, mesh, k=K, both_strands=True, min_count=1
    )
    _assert_ref(scorer.score_batch(*dbws["batch"]), dbws["ref"])
    with pytest.raises(ValueError):
        ShardedWindowScorer.from_device_table(
            tbl, nb_total * 2, mesh, k=K, both_strands=True
        )
