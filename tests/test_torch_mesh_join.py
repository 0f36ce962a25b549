"""The port's MeshJoinScorer (kcftools_tpu_torch/engine/device_join.py)
against the JAX package's MeshJoinScorer and the port's single-device
DeviceJoinScorer, on CPU slots (the join's plain torch version).

Mirrors tests/test_device_join.py:113-158: the meshes (2, 4), (4, 2)
and (1, 8). Plus the k = 32 palindrome T^16A^16 in the top partition
on a mesh, and a table axis that is not a power of two. Every statistic
is an integer; every comparison is exact.
"""

import numpy as np
import pytest
import torch

from kcftools_tpu.engine.device_join import MeshJoinScorer as JaxMesh
from kcftools_tpu.engine.windows import tiling_windows
from kcftools_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kcftools_tpu_torch.engine.device_join import (
    DeviceJoinScorer,
    MeshJoinScorer,
)
from kcftools_tpu_torch.parallel.mesh import make_mesh
from kcftools_tpu_torch.torchinit import resolve_devices

from .test_torch_device_join import (
    _FIELDS,
    _Ref,
    _assert_oracle,
    _genome,
    _ref_index,
    _sample_db,
)

_CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def cpu_slots(monkeypatch):
    monkeypatch.setenv("KCFTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("KCFTOOLS_TORCH_VIRTUAL_DEVICES", "8")


def _score(scorer, chrom, refk, db, dbc):
    scorer.add_chrom("c", *chrom)
    scorer.submit(0, refk, db, dbc)
    return scorer.collect(0)["c"]


@pytest.mark.parametrize("data,table", [(2, 4), (4, 2), (1, 8)])
def test_mesh_join_matches_jax_and_single(data, table):
    rng = np.random.default_rng(11)
    k, length = 31, 60_000
    genome, valid = _genome(rng, length)
    refk, r_idx = _ref_index(genome, valid, k)
    chrom = (r_idx, *tiling_windows(length, 4000, k))
    db, dbc = _sample_db(rng, genome, valid, k)
    want = _score(DeviceJoinScorer(_Ref(refk), k, _CPU), chrom, refk, db,
                  dbc)
    jax_got = _score(JaxMesh(_Ref(refk), k, jax_make_mesh(data, table)),
                     chrom, refk, db, dbc)
    msc = MeshJoinScorer(_Ref(refk), k, make_mesh(data, table))
    got = _score(msc, chrom, refk, db, dbc)
    for f in _FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        np.testing.assert_array_equal(got[f], jax_got[f], err_msg=f)
    assert got["observed"].sum() > 0
    # the reference is really sharded: each table column holds P/table
    # partitions of the query tiles, and the slabs spread over the rows
    assert sorted(msc._q) == list(range(table))
    assert all(q[0].shape[0] == msc.P // table for q in msc._q.values())
    n_slabs = len(msc._layout.slabs)
    rows = [len(statics) for _dev, statics in msc._statics]
    assert sum(rows) == n_slabs and len(rows) == data
    assert data == 1 or sum(r > 0 for r in rows) > 1


def test_mesh_join_top_partition_key():
    """The k = 32 palindrome T^16A^16 (all top-32 bits set), the last key
    of the reference and of the sample, lands in the last partition -
    the last table column's - and is counted (checked against the
    oracle; the JAX package raises on this key)."""
    rng = np.random.default_rng(32)
    k = 32
    genome, valid = _genome(rng, 20_000, n_rate=0.0)
    pal = np.array([3] * 16 + [0] * 16, np.uint8)
    keep = np.zeros(genome.shape[0], bool)
    for at in (1000, 9000, 15_000):
        genome[at : at + 32] = pal
        keep[at : at + 32] = True
    refk, r_idx = _ref_index(genome, valid, k)
    assert refk[-1] == np.uint64(0xFFFFFFFF00000000)
    starts, ends = tiling_windows(genome.shape[0], 2500, k)
    db, dbc = _sample_db(rng, genome, valid, k, keep=keep)
    assert db[-1] == refk[-1]
    msc = MeshJoinScorer(_Ref(refk), k, make_mesh(2, 4))
    res = _score(msc, (r_idx, starts, ends), refk, db, dbc)
    _assert_oracle(res, genome, valid, starts, ends, k, db, dbc)


def test_mesh_join_rejects_non_power_of_two_table_axis():
    """A table axis of 3 cannot split the 2^b quantile partitions: a
    clear ValueError at construction."""
    mesh = make_mesh(data=2, table=3, devices=resolve_devices()[:6])
    with pytest.raises(ValueError, match="power of two"):
        MeshJoinScorer(_Ref(np.arange(10, dtype=np.uint64)), 31, mesh)
