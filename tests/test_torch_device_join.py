"""The port's DeviceJoinScorer (kcftools_tpu_torch/engine/device_join.py,
on the CPU device: the join's plain torch version) against the JAX
package's DeviceJoinScorer and tests/oracle.py.

The per-window statistics must be identical: observed, variations,
inner, left, right and count_sum are integers, so every comparison is
exact.
"""

import ctypes

import numpy as np
import pytest
import torch

from kcftools_tpu.engine.device_join import DeviceJoinScorer as JaxScorer
from kcftools_tpu.engine.encode import canonicalize, pack_kmers
from kcftools_tpu.engine.windows import tiling_windows
from kcftools_tpu_torch.engine.device_join import DeviceJoinScorer

from .oracle import process_window

_FIELDS = ("observed", "variations", "inner", "left", "right", "count_sum")
_CPU = torch.device("cpu")


class _Ref:
    def __init__(self, kmers):
        self.kmers = kmers


def _kmer_str(v, k):
    return "".join(
        "ACGT"[(int(v) >> (2 * (k - 1 - i))) & 3] for i in range(k)
    )


def _genome(rng, length, n_rate=0.002):
    genome = rng.integers(0, 4, length).astype(np.uint8)
    return genome, rng.random(length) >= n_rate


def _ref_index(genome, valid, k):
    kmers, kv = pack_kmers(genome, valid, k)
    canon = canonicalize(kmers, k)
    refk = np.unique(canon[kv])
    r_idx = np.full(canon.shape[0], -1, np.int32)
    r_idx[kv] = np.searchsorted(refk, canon[kv]).astype(np.int32)
    return refk, r_idx


def _sample_db(rng, genome, valid, k, snp=0.01, keep=None):
    s = genome.copy()
    m = rng.random(s.shape[0]) < snp
    if keep is not None:
        m &= ~keep
    s[m] = (s[m] + rng.integers(1, 4, int(m.sum()))) % 4
    km, kv = pack_kmers(s, valid, k)
    db, dbc = np.unique(canonicalize(km[kv], k), return_counts=True)
    return db, dbc.astype(np.uint32)


def _scorers(refk, k, chroms, **kw):
    port = DeviceJoinScorer(_Ref(refk), k, _CPU, **kw)
    jax_ = JaxScorer(_Ref(refk), k, **kw)
    for sc in (port, jax_):
        for name, (r_idx, starts, ends) in chroms.items():
            sc.add_chrom(name, r_idx, starts, ends)
    return port, jax_


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for name in want:
        for f in _FIELDS:
            np.testing.assert_array_equal(
                got[name][f], want[name][f], err_msg=f"{name}.{f}"
            )


def _assert_oracle(res, genome, valid, starts, ends, k, db, dbc,
                   min_count=1):
    seq = "".join("ACGTN"[c if v else 4] for c, v in zip(genome, valid))
    db_map = {
        _kmer_str(key, k): int(c) for key, c in zip(db.tolist(), dbc.tolist())
    }
    for w in range(len(starts)):
        exp = process_window(
            seq[starts[w]:ends[w]], k, db_map, min_count=min_count,
            both_strands=True,
        )
        for f in _FIELDS:
            assert res[f][w] == exp[f], (w, f, res[f][w], exp[f])


@pytest.mark.parametrize("seed,length,counts_hi", [
    (1, 30_000, False),
    (2, 50_000, True),   # counts > 255: the unpacked count operand
])
def test_device_join_matches_jax_and_oracle(seed, length, counts_hi):
    rng = np.random.default_rng(seed)
    k, window = 31, 5000
    genome, valid = _genome(rng, length)
    refk, r_idx = _ref_index(genome, valid, k)
    starts, ends = tiling_windows(length, window, k)
    db, dbc = _sample_db(rng, genome, valid, k)
    if counts_hi:
        dbc = dbc * np.uint32(300)
    port, jax_ = _scorers(refk, k, {"c": (r_idx, starts, ends)}, batch=4)
    port.submit(0, refk, db, dbc)
    jax_.submit(0, refk, db, dbc)
    got = port.collect(0)
    _assert_same(got, jax_.collect(0))
    _assert_oracle(got["c"], genome, valid, starts, ends, k, db, dbc)


def test_device_join_multi_chrom_and_empty():
    rng = np.random.default_rng(7)
    k = 21
    chroms, canon_all = {}, []
    for name, L in (("a", 9000), ("b", 4000), ("tiny", 15)):
        g = rng.integers(0, 4, L).astype(np.uint8)
        km, kv = pack_kmers(g, np.ones(L, bool), k)
        cn = canonicalize(km, k)
        chroms[name] = (g, cn, kv)
        canon_all.append(cn[kv])
    refk = np.unique(np.concatenate(canon_all))
    geom = {}
    for name, (g, cn, kv) in chroms.items():
        r_idx = np.full(cn.shape[0], -1, np.int32)
        r_idx[kv] = np.searchsorted(refk, cn[kv]).astype(np.int32)
        starts, ends = tiling_windows(g.shape[0], 2000, k)
        if len(starts):
            geom[name] = (r_idx, starts, ends)
    port, jax_ = _scorers(refk, k, geom)
    db = refk[::2]  # every other reference k-mer present
    ones = np.ones(db.shape[0], np.uint32)
    port.submit("x", refk, db, ones)
    jax_.submit("x", refk, db, ones)
    got = port.collect("x")
    _assert_same(got, jax_.collect("x"))
    assert all(got[n]["observed"].sum() > 0 for n in geom)
    # the single-sample flow reads the same result under key None
    port.submit(None, refk, db, ones)
    np.testing.assert_array_equal(
        port.score_chrom("a")["variations"], got["a"]["variations"]
    )
    with pytest.raises(NotImplementedError):
        port.submit_counts("y", np.zeros(refk.shape[0], np.uint8),
                           np.empty(0, np.int32), np.empty(0, np.uint32))


def test_device_join_batch_grows_sticky_tile():
    """Three samples through one scorer: the second is larger and has
    counts > 255, so it grows the sticky table tile and takes the
    unpacked count operand; the third returns to packed counts."""
    rng = np.random.default_rng(21)
    k = 25
    genome, valid = _genome(rng, 40_000)
    refk, r_idx = _ref_index(genome, valid, k)
    starts, ends = tiling_windows(genome.shape[0], 3000, k)
    port, jax_ = _scorers(refk, k, {"c": (r_idx, starts, ends)}, batch=3)
    db0, c0 = _sample_db(rng, genome[:20_000], valid[:20_000], k)
    db1, c1 = _sample_db(rng, genome, valid, k, snp=0.005)
    # extra k-mers absent from the reference fill the table further
    extra = rng.integers(0, 1 << (2 * k), 30_000, dtype=np.uint64)
    db1, idx = np.unique(np.concatenate([db1, extra]), return_index=True)
    c1 = np.concatenate([c1 * np.uint32(700), np.full(30_000, 3, np.uint32)])
    c1 = c1[idx]
    db2, c2 = _sample_db(rng, genome, valid, k, snp=0.02)
    tiles = []
    for key, (db, c) in enumerate(((db0, c0), (db1, c1), (db2, c2))):
        port.submit(key, refk, db, c)
        jax_.submit(key, refk, db, c)
        tiles.append(port._sample_tile)
    assert tiles[0] < tiles[1] == tiles[2]
    for key, (db, c) in enumerate(((db0, c0), (db1, c1), (db2, c2))):
        got = port.collect(key)
        _assert_same(got, jax_.collect(key))
        _assert_oracle(got["c"], genome, valid, starts, ends, k, db, c)


def test_device_join_many_slabs(monkeypatch):
    """KCFTOOLS_DJOIN_SLAB forces the genome into several slabs; the
    result equals the JAX scorer's single-slab run."""
    rng = np.random.default_rng(4)
    k = 21
    genome, valid = _genome(rng, 30_000, n_rate=0.01)
    refk, r_idx = _ref_index(genome, valid, k)
    starts, ends = tiling_windows(genome.shape[0], 1000, k)
    db, dbc = _sample_db(rng, genome, valid, k, snp=0.03)
    jax_ = JaxScorer(_Ref(refk), k, min_count=2)
    jax_.add_chrom("c", r_idx, starts, ends)
    jax_.submit(0, refk, db, dbc)
    monkeypatch.setenv("KCFTOOLS_DJOIN_SLAB", "4096")
    port = DeviceJoinScorer(_Ref(refk), k, _CPU, min_count=2)
    port.add_chrom("c", r_idx, starts, ends)
    port.submit(0, refk, db, dbc)
    assert len(port._layout.slabs) > 4
    _assert_same(port.collect(0), jax_.collect(0))


def test_device_join_wide_window_count_sum():
    """A window over more than 65537 k-mer positions with large counts:
    the count sum is one exact int64 prefix (checked against the
    oracle)."""
    rng = np.random.default_rng(8)
    k, window = 31, 70_000
    genome, valid = _genome(rng, 150_000, n_rate=0.0005)
    refk, r_idx = _ref_index(genome, valid, k)
    starts, ends = tiling_windows(genome.shape[0], window, k)
    db, dbc = _sample_db(rng, genome, valid, k)
    dbc = rng.integers(1 << 30, 1 << 32, dbc.shape[0],
                       dtype=np.uint64).astype(np.uint32)
    port, jax_ = _scorers(refk, k, {"c": (r_idx, starts, ends)})
    port.submit(0, refk, db, dbc)
    jax_.submit(0, refk, db, dbc)
    got = port.collect(0)
    assert (ends - starts - k + 1).max() > 65537
    assert got["c"]["count_sum"].max() > 1 << 32
    _assert_same(got, jax_.collect(0))
    _assert_oracle(got["c"], genome, valid, starts, ends, k, db, dbc)


def test_device_join_top_partition_key():
    """The k=32 palindrome T^16A^16 (all top-32 bits set) in both the
    reference and the sample: the last key of the sorted table. The
    port clamps it into the last partition, in the native packer too
    (checked against the oracle; the JAX package raises on this key)."""
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
    port = DeviceJoinScorer(_Ref(refk), k, _CPU)
    port.add_chrom("c", r_idx, starts, ends)
    port.submit(0, refk, db, dbc)
    res = port.collect(0)["c"]
    _assert_oracle(res, genome, valid, starts, ends, k, db, dbc)


@pytest.mark.parametrize("k", [31, 32])
@pytest.mark.parametrize("packed", [False, True], ids=["u32", "packed"])
def test_native_pjoin_pack_clamps_top_keys(monkeypatch, k, packed):
    """The native kcf_pjoin_hist / kcf_pjoin_pack (the mesh's host pack)
    put keys whose top 32 bits are all set (at k = 32 the palindrome
    T^16A^16 among them) into the last partition, as
    ``quantile_partition_ids`` does: histogram and upload buffer equal the
    numpy path's."""
    from kcftools_tpu_torch.engine import device_join as tdj
    from kcftools_tpu_torch.native import get_lib
    from kcftools_tpu_torch.ops.pjoin import (
        quantile_partition_ids,
        raw_quantile_ids,
    )

    lib = get_lib()
    assert lib is not None
    rng = np.random.default_rng(k)
    top = ((1 << 32) - 1) << (2 * k - 32)  # the key's top 32 bits set
    keys = np.unique(np.concatenate([
        rng.integers(0, 1 << (2 * k), 5000, dtype=np.uint64),
        np.array([top, top + 1, top + 77, (1 << (2 * k)) - 1], np.uint64),
    ]))
    counts = rng.integers(1, 256 if packed else 1 << 32, keys.shape[0],
                          dtype=np.uint64).astype(np.uint32)
    b = 4
    assert (raw_quantile_ids(keys, b, k) == 1 << b).sum() == 4
    per = np.zeros(1 << b, np.int64)
    lib.kcf_pjoin_hist(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(keys.shape[0]), ctypes.c_int(k), ctypes.c_int(b),
        per.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    np.testing.assert_array_equal(
        per, np.bincount(quantile_partition_ids(keys, b, k), minlength=1 << b))
    bufs = []
    for use_lib in (True, False):
        monkeypatch.setattr(tdj, "get_lib",
                            (lambda: lib) if use_lib else (lambda: None))
        bufs.append(tdj.pack_tiles_host(keys, counts, k, b))
    (got, tt, pk), (want, tt2, pk2) = bufs
    assert (tt, pk) == (tt2, pk2) and pk == packed
    np.testing.assert_array_equal(got, want)
