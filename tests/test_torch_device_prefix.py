"""The port's dprefix engine (kcftools_tpu_torch/engine/device_prefix.py,
on the CPU device) against the JAX package's and the host prefix engine.

The device programs (``ops/gapscan.py::_cs_tot``, ``_score_batch``,
``_score_runs``) are held against the JAX jitted programs on the same numpy inputs, and the
port's DevicePrefixScorer against the JAX scorer and
``prefix_scan.chromosome_stats_indirect`` / ``window_stats`` on the
cases of tests/test_device_prefix.py and tests/test_runs_uplink.py.
Every statistic is an integer, so every comparison is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcftools_tpu.engine import device_prefix as jdp
from kcftools_tpu.engine.encode import canonicalize, pack_kmers
from kcftools_tpu.engine.prefix_scan import (
    chromosome_stats_indirect,
    window_stats,
)
from kcftools_tpu.engine.windows import tiling_windows
from kcftools_tpu.native import bits_to_runs, merge_counts, merge_counts_u8
from kcftools_tpu_torch.engine import device_prefix as tdp
from kcftools_tpu_torch.ops import gapscan as tgs

_FIELDS = ("observed", "variations", "inner", "left", "right", "count_sum")
_CPU = torch.device("cpu")


# -- the device programs ---------------------------------------------------


def _jax_cs_tot_fn():
    """The JAX scorer builds its ``_cs_tot`` program in ``_finalize``."""
    sc = jdp.DevicePrefixScorer(None, 21, batch=1)
    sc.add_chrom("c", np.zeros(100, np.int32), np.array([0]),
                 np.array([100]))
    sc._finalize()
    return sc._cs_tot_fn


def _slab(rng, n, k):
    """A valid bitmap with N runs, and tiling plus overlapping windows
    (and a few shorter than k) over n positions."""
    valid = rng.random(n) > 0.03
    valid[n // 4 : n // 4 + 300] = False
    ws, wh = [], []
    for s in range(0, n - 400, 333):
        ws.append(s)
        wh.append(s + 332)
    for s in range(50, n - 900, 410):
        ws.append(s)
        wh.append(s + 800)
    for s in rng.integers(0, n - 1, 4):
        ws.append(int(s))
        wh.append(int(s) - 1)
    cs_tot = np.zeros(n + 1, np.int32)
    np.cumsum(valid, out=cs_tot[1:])
    return (valid, cs_tot, np.array(ws, np.int32), np.array(wh, np.int32))


def _presence(rng, valid, density):
    pr = rng.random(valid.shape[0]) < density
    for a in rng.integers(0, valid.shape[0], valid.shape[0] // 50):
        pr[a : a + int(rng.integers(1, 30))] = False
    pr[1000:1700] = False  # a run longer than 255: (0, 255) continuations
    pr[-37:] = False  # a trailing run that ends at n
    return pr & valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_cs_tot_matches_jax(rng):
    n = 8192
    valid = rng.random(n) > 0.1
    valid[4000:4600] = False
    vb = np.packbits(valid, bitorder="little")
    want = np.asarray(_jax_cs_tot_fn()(jnp.asarray(vb)))
    got = tgs._cs_tot(_t(vb))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("k", [21, 31])
def test_score_batch_matches_jax(rng, k):
    n = 8192
    valid, cs_tot, ws, wh = _slab(rng, n, k)
    mat = np.stack([
        np.packbits(_presence(rng, valid, d), bitorder="little")
        for d in (0.98, 0.7, 0.0)
    ])
    fn = jax.jit(functools.partial(jdp._score_batch, k=k))
    want = np.asarray(fn(jnp.asarray(mat), jnp.asarray(cs_tot),
                         jnp.asarray(ws), jnp.asarray(wh)))
    vb = np.packbits(valid, bitorder="little")
    got = tdp._score_batch(_t(mat), _t(vb), _t(ws).long(), _t(wh).long(),
                           k=k)
    assert got.shape == (5, 3, ws.shape[0])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("k", [21, 31])
def test_score_runs_matches_jax(rng, k):
    """Run streams from the native encoder with (255, 0) fillers after
    a long present stretch, (0, 255) continuations of a long run,
    (0, 0) padding and a trailing run that ends at n - and the same
    presence through the bitmap program."""
    n = 8192
    valid, cs_tot, ws, wh = _slab(rng, n, k)
    vb = np.packbits(valid, bitorder="little")
    cap = 2048
    rows, bits = [], []
    for d in (0.995, 0.9, 0.5):
        pr = _presence(rng, valid, d)
        pr[2500:3200] = valid[2500:3200]  # > 255 present: (255, 0) fillers
        pb = np.packbits(pr, bitorder="little")
        dd, ll, nr = bits_to_runs(pb, vb, n, cap)
        assert 0 < nr < cap
        rows.append(np.stack([dd, ll]))
        bits.append(pb)
    dl = np.stack(rows)
    used = dl[:, :, : max(r.shape[1] for r in rows)]
    assert ((used[:, 0] == 255) & (used[:, 1] == 0)).any()
    assert ((used[:, 0] == 0) & (used[:, 1] == 255)).any()
    fn = jax.jit(functools.partial(jdp._score_runs, k=k))
    want = np.asarray(fn(jnp.asarray(dl), jnp.asarray(cs_tot),
                         jnp.asarray(ws), jnp.asarray(wh)))
    args = (_t(vb), _t(ws).long(), _t(wh).long())
    got = tdp._score_runs(_t(dl), *args, k=k)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    via_bits = tdp._score_batch(_t(np.stack(bits)), *args, k=k)
    np.testing.assert_array_equal(got.numpy(), via_bits.numpy())


def test_runs_presence_trailing_run_and_padding():
    """A (255, 0) filler, a (0, 255) continuation, (0, 0) padding at
    the last run's end, and a run that ends exactly at n decode
    exactly."""
    n = 600
    valid = torch.ones(n, dtype=torch.bool)
    # runs [10, 30), [285, 540) (filler, then a continuation), [580, 585)
    dl = torch.tensor([[10, 255, 0, 40, 0, 0, 0],
                       [20, 0, 255, 5, 0, 0, 0]], dtype=torch.uint8)
    want = torch.ones(n, dtype=torch.bool)
    for a, b in ((10, 30), (285, 540), (580, 585)):
        want[a:b] = False
    assert torch.equal(tgs._runs_presence(dl, valid), want)
    # a final run through the end of the slab (its end is n: dropped)
    dl2 = torch.tensor([[5, 0], [200, 0]], dtype=torch.uint8)
    got = tgs._runs_presence(dl2, torch.ones(205, dtype=torch.bool))
    assert not got[5:].any() and got[:5].all()


# -- the scorer --------------------------------------------------------------


def _setup(rng, n, k, n_prob=0.01, window=400):
    genome = rng.integers(0, 4, size=n).astype(np.uint8)
    valid = rng.random(n) >= n_prob
    kmers, kv = pack_kmers(genome, valid, k)
    canon = canonicalize(kmers, k)
    refk = np.unique(canon[kv])
    r_idx = np.full(canon.shape[0], -1, np.int32)
    r_idx[kv] = np.searchsorted(refk, canon[kv]).astype(np.int32)
    starts, ends = tiling_windows(n, window, k)
    return genome, valid, refk, r_idx, starts, ends


def _sample(rng, genome, valid, k, snp):
    s = genome.copy()
    flip = rng.random(genome.shape[0]) < snp
    s[flip] = (s[flip] + rng.integers(1, 4, flip.sum())) % 4
    sk, skv = pack_kmers(s, valid, k)
    db, dbc = np.unique(canonicalize(sk[skv], k), return_counts=True)
    return db, dbc.astype(np.uint32)


def _host(refk, db, dbc, r_idx, valid, min_count, k, starts, ends):
    counts_r = merge_counts(refk, db, dbc)
    st = chromosome_stats_indirect(counts_r, r_idx, valid, min_count, k)
    return window_stats(st, starts, ends)


def _assert_fields(got, want, n, what=""):
    for f in _FIELDS:
        np.testing.assert_array_equal(
            np.asarray(got[f], np.int64), np.asarray(want[f], np.int64)[:n],
            err_msg=f"{what} {f}",
        )


def _run_both(chroms, k, packs, min_count=1, batch=None):
    """Submit ``packs`` (u8, exc_idx, exc_val) under keys 0.. through the
    port's scorer and the JAX scorer; returns ([port results],
    port programs, [JAX results], JAX programs)."""
    res = []
    for sc in (tdp.DevicePrefixScorer(None, k, _CPU, min_count=min_count,
                                      batch=batch),
               jdp.DevicePrefixScorer(None, k, min_count=min_count,
                                      batch=batch)):
        for name, (r_idx, starts, ends) in chroms.items():
            sc.add_chrom(name, r_idx, starts, ends)
        try:
            for i, pk in enumerate(packs):
                sc.submit_counts(i, *pk)
            res.append([sc.collect(i) for i in range(len(packs))])
            res.append(sc.programs_run if isinstance(sc, tdp.DevicePrefixScorer)
                       else set(sc._score_fns))
        finally:
            sc.close()
    return res


@pytest.mark.parametrize("uplink,kind", [("runs", "runs"),
                                         ("bitmap", "bits")])
@pytest.mark.parametrize("k", [21, 31])
def test_scorer_runs_and_bitmap_match_jax_and_host(rng, monkeypatch, k,
                                                   uplink, kind):
    genome, valid, refk, r_idx, starts, ends = _setup(rng, 30000, k)
    dbs = [_sample(rng, genome, valid, k, 0.02) for _ in range(3)]
    monkeypatch.setenv("KCFTOOLS_DPREFIX_UPLINK", uplink)
    packs = [merge_counts_u8(refk, *db) for db in dbs]
    got, got_kinds, want, want_kinds = _run_both(
        {"c1": (r_idx, starts, ends)}, k, packs)
    assert got_kinds == want_kinds == {kind}
    for i, db in enumerate(dbs):
        _assert_fields(got[i]["c1"], want[i]["c1"], len(starts), "jax")
        host = _host(refk, *db, r_idx, valid, 1, k, starts, ends)
        _assert_fields(got[i]["c1"], host, len(starts), "host")


def test_scorer_cap_overflow_falls_back(rng, monkeypatch):
    k = 21
    genome, valid, refk, r_idx, starts, ends = _setup(rng, 20000, k)
    dbs = [_sample(rng, genome, valid, k, 0.05) for _ in range(2)]
    monkeypatch.setenv("KCFTOOLS_RUNS_CAP", "8")
    packs = [merge_counts_u8(refk, *db) for db in dbs]
    got, kinds, want, _ = _run_both({"c1": (r_idx, starts, ends)}, k, packs)
    assert kinds == {"bits"}
    for i, db in enumerate(dbs):
        _assert_fields(got[i]["c1"], want[i]["c1"], len(starts), "jax")
        host = _host(refk, *db, r_idx, valid, 1, k, starts, ends)
        _assert_fields(got[i]["c1"], host, len(starts), "host")


def test_scorer_run_cap_grows(rng):
    """A bootstrapped budget shrunk below the dense samples' run counts
    grows (no bitmap fallback), and every sample stays exact."""
    k = 21
    genome, valid, refk, r_idx, starts, ends = _setup(rng, 20000, k)
    dbs = [_sample(rng, genome, valid, k, s) for s in (0.001, 0.05, 0.05)]
    sc = tdp.DevicePrefixScorer(None, k, _CPU)
    sc.add_chrom("c1", r_idx, starts, ends)
    for i, db in enumerate(dbs):
        sc.submit_counts(i, *merge_counts_u8(refk, *db))
        if i == 0:
            assert sc._run_cap is not None
            sc._run_cap = 16
    out = [sc.collect(i)["c1"] for i in range(len(dbs))]
    assert sc._run_cap > 16
    assert sc.programs_run == {"runs"}
    sc.close()
    for i, db in enumerate(dbs):
        host = _host(refk, *db, r_idx, valid, 1, k, starts, ends)
        _assert_fields(out[i], host, len(starts), f"sample {i}")


def test_scorer_mixed_group_falls_back(rng, monkeypatch):
    """A sparse sample fits the pinned budget, a dense one overflows it:
    the whole group drops to the bitmap program."""
    k = 21
    genome, valid, refk, r_idx, starts, ends = _setup(rng, 20000, k)
    dbs = [_sample(rng, genome, valid, k, s) for s in (0.0005, 0.05, 0.0005)]
    monkeypatch.setenv("KCFTOOLS_RUNS_CAP", "16")
    packs = [merge_counts_u8(refk, *db) for db in dbs]
    got, kinds, want, want_kinds = _run_both(
        {"c1": (r_idx, starts, ends)}, k, packs)
    assert "bits" in kinds and kinds == want_kinds
    for i, db in enumerate(dbs):
        _assert_fields(got[i]["c1"], want[i]["c1"], len(starts), "jax")
        host = _host(refk, *db, r_idx, valid, 1, k, starts, ends)
        _assert_fields(got[i]["c1"], host, len(starts), f"sample {i}")


def test_scorer_mixed_keyed_and_single_sample_flows(rng):
    """A keyed sample grouped with a key=None sample stays collectable
    after a later key=None submit invalidates the old single-sample
    slot; the single-sample flow reads the newest sample."""
    k = 21
    genome, valid, refk, r_idx, starts, ends = _setup(rng, 15000, k)
    dbs = [_sample(rng, genome, valid, k, 0.02) for _ in range(3)]
    sc = tdp.DevicePrefixScorer(None, k, _CPU)
    sc.add_chrom("c1", r_idx, starts, ends)
    sc.submit_counts("a", *merge_counts_u8(refk, *dbs[0]))
    sc.submit_counts(None, *merge_counts_u8(refk, *dbs[1]))  # flushes
    sc.submit_counts(None, *merge_counts_u8(refk, *dbs[2]))
    got = sc.collect("a")["c1"]
    newest = sc.score_chrom("c1")
    sc.close()
    _assert_fields(got, _host(refk, *dbs[0], r_idx, valid, 1, k, starts,
                              ends), len(starts), "keyed")
    _assert_fields(newest, _host(refk, *dbs[2], r_idx, valid, 1, k, starts,
                                 ends), len(starts), "single")


@pytest.mark.parametrize("min_count", [1, 2, 300])
def test_scorer_high_counts_and_min_count(rng, min_count):
    """Counts >= 255 take the exception lists; min_count = 300 is met
    only through exact exception values."""
    k = 15
    genome, valid, refk, r_idx, starts, ends = _setup(rng, 8000, k,
                                                      window=500)
    db, dbc = _sample(rng, genome, valid, k, 0.02)
    big = rng.random(dbc.shape[0]) < 0.3
    dbc[big] = rng.integers(255, 100000, big.sum()).astype(np.uint32)
    pack = merge_counts_u8(refk, db, dbc)
    assert pack[1].size > 0
    got, _, want, _ = _run_both({"c1": (r_idx, starts, ends)}, k, [pack],
                                min_count=min_count)
    _assert_fields(got[0]["c1"], want[0]["c1"], len(starts), "jax")
    host = _host(refk, db, dbc, r_idx, valid, min_count, k, starts, ends)
    _assert_fields(got[0]["c1"], host, len(starts), "host")


@pytest.mark.parametrize("slab", [None, "2048"])
def test_scorer_multi_chrom_multi_slab(rng, monkeypatch, slab):
    """Two chromosomes, two samples through the single-sample flow
    (merge_and_upload), in one slab or in several."""
    if slab:
        monkeypatch.setenv("KCFTOOLS_DPREFIX_SLAB", slab)
    k = 19
    per_chrom, all_kmers = {}, []
    for name, L in (("a", 9000), ("b", 5000)):
        genome = rng.integers(0, 4, size=L).astype(np.uint8)
        valid = rng.random(L) >= 0.02
        kmers, kv = pack_kmers(genome, valid, k)
        canon = canonicalize(kmers, k)
        per_chrom[name] = (genome, valid, canon, kv)
        all_kmers.append(np.unique(canon[kv]))
    refk = np.unique(np.concatenate(all_kmers))
    chroms = {}
    for name, (genome, valid, canon, kv) in per_chrom.items():
        r_idx = np.full(canon.shape[0], -1, np.int32)
        r_idx[kv] = np.searchsorted(refk, canon[kv]).astype(np.int32)
        chroms[name] = (r_idx, valid) + tiling_windows(len(genome), 600, k)
    port = tdp.DevicePrefixScorer(None, k, _CPU)
    theirs = jdp.DevicePrefixScorer(None, k)
    for sc in (port, theirs):
        for name, (r_idx, _v, starts, ends) in chroms.items():
            sc.add_chrom(name, r_idx, starts, ends)
    for seed in (1, 2):
        srng = np.random.default_rng(seed)
        sk = []
        for genome, valid, _c, _kv in per_chrom.values():
            s = genome.copy()
            flip = srng.random(len(genome)) < 0.03
            s[flip] = (s[flip] + srng.integers(1, 4, flip.sum())) % 4
            km, kmv = pack_kmers(s, valid, k)
            sk.append(canonicalize(km, k)[kmv])
        db, dbc = np.unique(np.concatenate(sk), return_counts=True)
        dbc = dbc.astype(np.uint32)
        port.merge_and_upload(refk, db, dbc)
        theirs.merge_and_upload(refk, db, dbc)
        for name, (r_idx, valid, starts, ends) in chroms.items():
            got = port.score_chrom(name)
            _assert_fields(got, theirs.score_chrom(name), len(starts), "jax")
            host = _host(refk, db, dbc, r_idx, valid, 1, k, starts, ends)
            _assert_fields(got, host, len(starts), "host")
    if slab:
        assert len(port._layout.slabs) > 3
    port.close()
    theirs.close()


def test_scorer_nothing_present(rng):
    k = 13
    n = 5000
    genome = rng.integers(0, 4, size=n).astype(np.uint8)
    valid = np.ones(n, bool)
    kmers, kv = pack_kmers(genome, valid, k)
    canon = canonicalize(kmers, k)
    refk = np.unique(canon[kv])
    r_idx = np.searchsorted(refk, canon).astype(np.int32)
    r_idx[~kv] = -1
    other = rng.integers(0, 4, size=n).astype(np.uint8)
    ok, okv = pack_kmers(other, valid, k)
    db, dbc = np.unique(canonicalize(ok, k)[okv], return_counts=True)
    keep = ~np.isin(db, refk)
    db, dbc = db[keep], dbc[keep].astype(np.uint32)
    starts, ends = tiling_windows(n, 800, k)
    sc = tdp.DevicePrefixScorer(None, k, _CPU)
    sc.add_chrom("c1", r_idx, starts, ends)
    sc.merge_and_upload(refk, db, dbc)
    got = sc.score_chrom("c1")
    sc.close()
    _assert_fields(got, _host(refk, db, dbc, r_idx, valid, 1, k, starts,
                              ends), len(starts))
    assert (got["observed"] == 0).all() and (got["variations"] > 0).all()


def test_scorer_feature_windows_kcoords(rng):
    """Feature-mode windows in k-mer coordinates, overlapping (not
    fusable: pack_posbits) and shorter than k, through both scorers."""
    k = 17
    genome, valid, refk, r_idx, _s, _e = _setup(rng, 12000, k)
    w_start = np.array([0, 500, 900, 3000, 3000, 7000, 11000], np.int32)
    w_hi = np.array([700, 1600, 899, 5000, 2990, 9000, 11500], np.int32)
    db, dbc = _sample(rng, genome, valid, k, 0.02)
    pack = merge_counts_u8(refk, db, dbc)
    res = []
    for sc in (tdp.DevicePrefixScorer(None, k, _CPU),
               jdp.DevicePrefixScorer(None, k)):
        sc.add_chrom_kcoords("c1", r_idx, w_start, w_hi)
        sc.submit_counts(0, *pack)
        res.append(sc.collect(0)["c1"])
        sc.close()
    _assert_fields(res[0], res[1], len(w_start))
    assert res[0]["observed"][2] == 0 and res[0]["observed"][0] > 0
