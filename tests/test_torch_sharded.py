"""The port's mesh-sharded hash engine (kcftools_tpu_torch/parallel/
sharded.py) against the JAX package's, on CPU slots.

Mirrors tests/test_sharded.py: every (data, table) factorisation of 8
slots, partial meshes (a table axis of 3 raises), batch sizes that force
the data-axis padding, a table built at load factor ~1, a written-then-
read KMC database, wide-k rejection and a randomised fuzz loop. The
reference is the JAX single-device WindowScorer (and, on the full
meshes, the JAX ShardedWindowScorer on its 8-device CPU mesh); every
statistic is an integer, so every comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch

from kcftools_tpu.engine.encode import str_to_kmer
from kcftools_tpu.engine.hashtable import build_table
from kcftools_tpu.engine.pipeline import PAD_MARGIN, WindowScorer
from kcftools_tpu.engine.windows import pad_batch_varlen
from kcftools_tpu.io.fasta import codes_from_str
from kcftools_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kcftools_tpu.parallel.sharded import ShardedWindowScorer as JaxSharded
from kcftools_tpu_torch.ops import lookup as tlk
from kcftools_tpu_torch.parallel.mesh import make_mesh
from kcftools_tpu_torch.parallel.sharded import ShardedWindowScorer
from kcftools_tpu_torch.torchinit import Slot, resolve_devices

from .gen import mutate, random_seq
from .oracle import count_db


@pytest.fixture(autouse=True)
def cpu_slots(monkeypatch):
    """Eight CPU mesh slots for the port."""
    monkeypatch.setenv("KCFTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("KCFTOOLS_TORCH_VIRTUAL_DEVICES", "8")


def _batch(genome, windows_spec):
    windows = [genome[a:b] for a, b in windows_spec]
    pad = max(len(w) for w in windows) + PAD_MARGIN
    codes, valids = zip(*[codes_from_str(w) for w in windows])
    return pad_batch_varlen(list(codes), list(valids), pad)


def _table_from_seq(sample, k, load_factor=0.8):
    db = count_db([sample], k)
    kmers = np.array([str_to_kmer(s) for s in db], dtype=np.uint64)
    counts = np.array(list(db.values()), dtype=np.uint32)
    return build_table(kmers, counts, k, load_factor=load_factor)


def _port(tbl, batch, data, table):
    mesh = make_mesh(data=data, table=table,
                     devices=resolve_devices()[: data * table])
    return ShardedWindowScorer(tbl, mesh).score_batch(*batch)


def _assert_same(tbl, batch, data, table, with_jax_mesh=False):
    ref = WindowScorer(tbl).score_batch(*batch)
    got = _port(tbl, batch, data, table)
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]),
                                      err_msg=key)
    if with_jax_mesh:
        mesh = jax_make_mesh(data=data, table=table,
                             devices=jax.devices()[: data * table])
        want = JaxSharded(tbl, mesh).score_batch(*batch)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    return got


@pytest.mark.parametrize("data,table", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_matches_jax(rng, data, table):
    k = 31
    genome = random_seq(rng, 6000)
    sample = mutate(rng, genome, snp_rate=0.01, del_rate=0.001)
    tbl = _table_from_seq(sample, k)
    batch = _batch(genome, [(i, i + 500) for i in range(0, 5400, 470)])
    got = _assert_same(tbl, batch, data, table, with_jax_mesh=True)
    assert got["observed"].sum() > 0


@pytest.mark.parametrize("data,table", [
    (1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4), (2, 3),
])
def test_partial_meshes(rng, data, table):
    """Meshes that use only some of the 8 slots. A table axis of 3
    cannot split a power-of-two bucket count: the port raises a clear
    ValueError up front (the JAX scorer fails later, test_sharded.py)."""
    k = 21
    genome = random_seq(rng, 3000)
    tbl = _table_from_seq(mutate(rng, genome, 0.02, 0.0), k)
    batch = _batch(genome, [(i, i + 300) for i in range(0, 2700, 290)])
    if table == 3:
        with pytest.raises(ValueError, match="power of two"):
            _port(tbl, batch, data, table)
        return
    _assert_same(tbl, batch, data, table)


@pytest.mark.parametrize("n_windows", [1, 3, 5, 7, 9, 13])
def test_non_divisible_batches(rng, n_windows):
    """Batch sizes not divisible by the data axis force the padding
    path; padded rows must not leak into real rows' results."""
    k = 31
    genome = random_seq(rng, 4000)
    tbl = _table_from_seq(mutate(rng, genome, 0.01, 0.001), k)
    spec = [(i * 250, i * 250 + 240 + (i % 3) * 7)
            for i in range(n_windows)]
    got = _assert_same(tbl, _batch(genome, spec), 4, 2)
    assert got["total"].shape == (n_windows,)


def test_table_near_grow_threshold(rng):
    """A table built at load factor ~1.0 (bucket overflow, cuckoo
    evictions); sharded lookups must stay exact."""
    k = 31
    genome = random_seq(rng, 5000)
    tbl = _table_from_seq(mutate(rng, genome, 0.01, 0.0), k,
                          load_factor=0.99)
    batch = _batch(genome, [(i, i + 400) for i in range(0, 4500, 380)])
    _assert_same(tbl, batch, 2, 4, with_jax_mesh=True)


def test_written_then_read_db(rng, tmp_path):
    """Through the real KMC binary format: write the DB, re-read it,
    shard the re-read table 8 ways."""
    from kcftools_tpu.io.kmc import KMCReader, write_kmc_db

    k = 31
    genome = random_seq(rng, 4000)
    sample = mutate(rng, genome, snp_rate=0.02, del_rate=0.001)
    db = count_db([sample], k)
    kmers = np.sort(np.array([str_to_kmer(s) for s in db], dtype=np.uint64))
    cmap = {str_to_kmer(s): c for s, c in db.items()}
    counts = np.array([cmap[int(x)] for x in kmers], np.uint32)
    write_kmc_db(str(tmp_path / "d"), kmers, counts, k, counter_size=2)
    r = KMCReader(str(tmp_path / "d"))
    tbl = build_table(r.kmers, r.counts, k, both_strands=r.both_strands)
    batch = _batch(genome, [(i, i + 350) for i in range(0, 3500, 333)])
    _assert_same(tbl, batch, 1, 8)


def test_wide_k_rejected():
    """k > 32 keys cannot enter the (hi, lo)-uint32 sharded table."""
    with pytest.raises(ValueError):
        tbl = build_table(np.arange(100, dtype=np.uint64),
                          np.ones(100, np.uint32), k=40)
        ShardedWindowScorer(tbl, make_mesh(data=1, table=8))


def test_fuzz_differential(rng):
    """Randomised shapes: window lengths, batch sizes, mesh splits."""
    k = 25
    for trial in range(4):
        glen = int(rng.integers(1500, 4000))
        genome = random_seq(rng, glen)
        tbl = _table_from_seq(mutate(rng, genome, 0.015, 0.002), k)
        spec = []
        for _ in range(int(rng.integers(1, 12))):
            a = int(rng.integers(0, glen - k - 50))
            b = a + int(rng.integers(k + 5, min(600, glen - a)))
            spec.append((a, b))
        data, table = [(2, 4), (4, 2), (8, 1), (1, 8)][trial]
        _assert_same(tbl, _batch(genome, spec), data, table)


def test_shard_local_lookup_partials(rng):
    """Each shard's partial counts: a present key is counted by exactly
    one shard (its owner), absent keys by none, and the partials sum to
    each key's count. The slot list names 8 distinct positions."""
    from kcftools_tpu.engine.encode import split_hi_lo
    from kcftools_tpu.engine.hashtable import build_table_sharded

    k = 31
    keys = np.unique(rng.integers(0, 1 << 62, 3000, dtype=np.uint64))
    counts = rng.integers(1, 1 << 32, keys.shape[0],
                          dtype=np.uint64).astype(np.uint32)
    t_axis = 4
    tbl = build_table_sharded(keys, counts, k, t_axis)
    absent = rng.integers(0, 1 << 62, 500, dtype=np.uint64)
    q = np.concatenate([keys, absent])
    hi, lo = (torch.from_numpy(a.astype(np.int64)) for a in split_hi_lo(q, k))
    full = torch.from_numpy(tbl.tbl.view(np.int32))
    nb_local = tbl.n_buckets // t_axis
    parts = torch.stack([
        tlk.table_lookup(hi, lo, full[s * nb_local : (s + 1) * nb_local],
                         nb_total=tbl.n_buckets, shard=s)
        for s in range(t_axis)
    ])
    hits = (parts != 0).sum(dim=0).numpy()
    assert (hits[: keys.shape[0]] == 1).all()
    assert (hits[keys.shape[0]:] == 0).all()
    total = parts.sum(dim=0).numpy()
    np.testing.assert_array_equal(total[: keys.shape[0]],
                                  counts.astype(np.int64))
    # the slot list: positions 0..7 on one CPU device, all distinct
    slots = resolve_devices()
    assert slots == [Slot(i, torch.device("cpu"), 0) for i in range(8)]
    assert len(set(slots)) == 8
