"""The port's on-chip hash engine (kcftools_tpu_torch/ops/kmerize.py,
ops/lookup.py, engine/pipeline.py, on the CPU device) against the JAX
package's, on the same numpy inputs, and against tests/oracle.py.
Everything compared is an integer, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcftools_tpu.engine import pipeline as jpl
from kcftools_tpu.engine.encode import str_to_kmer
from kcftools_tpu.engine.hashtable import build_table
from kcftools_tpu.engine.windows import pad_batch_varlen
from kcftools_tpu.io.fasta import codes_from_str
from kcftools_tpu.ops import kmerize as jkm
from kcftools_tpu.ops import lookup as jlk
from kcftools_tpu_torch.engine import pipeline as tpl
from kcftools_tpu_torch.ops import kmerize as tkm
from kcftools_tpu_torch.ops import lookup as tlk

from .gen import mutate, random_seq
from .oracle import count_db, process_window

_CPU = torch.device("cpu")


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("k", [15, 16, 17, 31, 32])
def test_kmerize_matches_jax(rng, k):
    B, Lp = 3, 200
    codes = rng.integers(0, 4, (B, Lp)).astype(np.uint32)
    codes[:, -40:] = 0
    n_out = Lp - 32
    jw, jrc = jkm.rolling_pack_u32(jnp.asarray(codes))
    tw, trc = tkm.rolling_pack_u32(torch.from_numpy(codes.astype(np.int64)))
    np.testing.assert_array_equal(tw.numpy(), _np(jw))
    np.testing.assert_array_equal(trc.numpy(), _np(jrc))
    want = jkm.assemble_kmers(jw, jrc, k, n_out)
    got = tkm.assemble_kmers(tw, trc, k, n_out)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    for g, w in zip(tkm.canonical_select(*got), jkm.canonical_select(*want)):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    # the top bit of a 16-base half is set for k = 16 / 32 T-rich k-mers
    assert k not in (16, 32) or int(got[0].max()) >= 1 << 31


def _lookup_case(rng, k=32, n_keys=40):
    """A small table (few buckets, so h1 == h2 happens), counts >= 2^31
    and up to 2^32 - 1, and queries: every key plus absent keys."""
    keys = np.unique(rng.integers(0, 1 << 63, n_keys, dtype=np.uint64)
                     << np.uint64(1))
    keys[:2] = [0, np.uint64(0xFFFFFFFFFFFFFFFF)]  # all-A and all-T
    keys = np.unique(keys)
    counts = rng.integers(1, 300, keys.shape[0]).astype(np.uint32)
    counts[::3] = rng.integers(1 << 31, 1 << 32, counts[::3].shape[0],
                               dtype=np.uint64).astype(np.uint32)
    counts[1] = 0xFFFFFFFF
    table = build_table(keys, counts, k)
    absent = rng.integers(0, 1 << 63, 30, dtype=np.uint64) | np.uint64(1)
    q = np.concatenate([keys, absent])
    hi = (q >> np.uint64(32)).astype(np.uint32)
    lo = (q & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return table, q, hi, lo


def test_bucket_hashes_match_host(rng):
    hi = rng.integers(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)
    hi[:4] = 0xFFFFFFFF
    lo[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    from kcftools_tpu.engine.hashtable import bucket_hashes_np

    for nb in (1, 8, 1 << 20, 1 << 31):
        want = bucket_hashes_np(hi, lo, nb)
        got = tlk.bucket_hashes(torch.from_numpy(hi.astype(np.int64)),
                                torch.from_numpy(lo.astype(np.int64)), nb)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_table_lookup_matches_jax(seed):
    table, q, hi, lo = _lookup_case(np.random.default_rng(seed))
    thi = torch.from_numpy(hi.astype(np.int64))
    tlo = torch.from_numpy(lo.astype(np.int64))
    h1, h2 = tlk.bucket_hashes(thi, tlo, table.n_buckets)
    assert bool((h1 == h2).any())
    want = np.asarray(jlk.table_lookup(jnp.asarray(hi), jnp.asarray(lo),
                                       jnp.asarray(table.tbl)))
    got = tlk.table_lookup(thi, tlo, tpl._table_tensor(table, _CPU))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(),
                                  table.lookup_np(q).astype(np.int64))
    assert got.max() >= 1 << 31 and (got[-30:] == 0).all()


def _batch(rng, k, n_win=6):
    genome = random_seq(rng, 3000, n_prob=0.01)
    sample = mutate(rng, genome, snp_rate=0.02)
    windows = [genome[i : i + int(rng.integers(k - 3, 400))]
               for i in range(0, 2700, 2700 // n_win)]
    windows.append("N" * 40)
    pad = max(len(w) for w in windows) + 32
    codes, valids = zip(*[codes_from_str(w) for w in windows])
    bc, bv, wl = pad_batch_varlen(list(codes), list(valids), pad)
    return genome, sample, windows, bc, bv, wl


@pytest.mark.parametrize("both_strands", [True, False])
def test_gap_scan_core_matches_jax(rng, both_strands):
    k = 21
    _g, _s, _w, bc, bv, wl = _batch(rng, k)
    present = rng.random(bv.shape) < (0.9 if both_strands else 0.5)
    want = jpl.gap_scan_core(jnp.asarray(bv), jnp.asarray(present),
                             jnp.asarray(wl), k=k)
    got = tpl.gap_scan_core(torch.from_numpy(bv), torch.from_numpy(present),
                            torch.from_numpy(wl.astype(np.int64)), k=k)
    for f in tpl.FIELDS:
        np.testing.assert_array_equal(got[f].numpy(), _np(want[f]),
                                      err_msg=f)


@pytest.mark.parametrize("both_strands", [True, False])
@pytest.mark.parametrize("k", [17, 31])
def test_score_windows_core_matches_jax(rng, k, both_strands):
    _g, sample, _w, bc, bv, wl = _batch(rng, k)
    db = count_db([sample], k, both_strands=both_strands)
    keys = np.array([str_to_kmer(s) for s in db], np.uint64)
    cnt = np.array(list(db.values()), np.uint32) * np.uint32(3)
    table = build_table(keys, cnt, k, both_strands=both_strands)
    jt = jnp.asarray(table.tbl)
    want = jpl.score_windows_core(
        jnp.asarray(bc), jnp.asarray(bv), jnp.asarray(wl),
        lambda h, l: jlk.table_lookup(h, l, jt),
        k=k, min_count=2, both_strands=both_strands,
    )
    tt = tpl._table_tensor(table, _CPU)
    got = tpl.score_windows_core(
        torch.from_numpy(bc.astype(np.int64)), torch.from_numpy(bv),
        torch.from_numpy(wl.astype(np.int64)),
        lambda h, l: tlk.table_lookup(h, l, tt),
        k=k, min_count=2, both_strands=both_strands,
    )
    for f in tpl.FIELDS:
        np.testing.assert_array_equal(got[f].numpy(), _np(want[f]),
                                      err_msg=f)
    assert got["observed"].sum() > 0


@pytest.mark.parametrize("both_strands", [True, False])
def test_window_scorer_matches_jax_and_oracle(rng, both_strands):
    k = 15
    genome, sample, windows, bc, bv, wl = _batch(rng, k)
    db = count_db([sample, sample], k, both_strands=both_strands)
    keys = np.array([str_to_kmer(s) for s in db], np.uint64)
    cnt = np.array(list(db.values()), np.uint32)
    table = build_table(keys, cnt, k, both_strands=both_strands)
    port = tpl.WindowScorer(table, _CPU, min_count=2)
    got = port.score_batch(bc, bv, wl)
    want = jpl.WindowScorer(table, min_count=2).score_batch(bc, bv, wl)
    for f in tpl.FIELDS:
        np.testing.assert_array_equal(got[f], _np(want[f]), err_msg=f)
    for i, w in enumerate(windows):
        exp = process_window(w, k, db, 2, both_strands)
        for f in ("total", "observed", "variations", "inner", "left",
                  "right", "eff_length", "count_sum"):
            assert got[f][i] == exp[f], (f, i)
    # set_table: the same scorer serves another sample's table
    other = build_table(keys[::2], cnt[::2], k, both_strands=both_strands)
    port.set_table(other)
    want2 = jpl.WindowScorer(other, min_count=2).score_batch(bc, bv, wl)
    got2 = port.score_batch(bc, bv, wl)
    for f in tpl.FIELDS:
        np.testing.assert_array_equal(got2[f], _np(want2[f]), err_msg=f)
    with pytest.raises(ValueError):
        port.set_table(build_table(keys, cnt, k,
                                   both_strands=not both_strands))


@pytest.mark.parametrize("both_strands", [True, False])
def test_score_chunk_matches_jax(rng, both_strands):
    """The chunked interface: windows gathered on the device from one
    uploaded chunk (padded rows have length 0), against the JAX
    ``_score_chunk``."""
    k, Lp = 21, 300 + 32
    genome = random_seq(rng, 5000, n_prob=0.01)
    codes, valid = codes_from_str(genome)
    db = count_db([mutate(rng, genome, snp_rate=0.02)], k,
                  both_strands=both_strands)
    keys = np.array([str_to_kmer(s) for s in db], np.uint64)
    table = build_table(keys, np.array(list(db.values()), np.uint32), k,
                        both_strands=both_strands)
    chunk = jpl.combine_u8(codes, valid)
    starts = np.zeros(16, np.int64)
    win_len = np.zeros(16, np.int64)
    starts[:12] = rng.integers(0, 5000 - 300, 12)
    win_len[:12] = rng.integers(k - 2, 301, 12)
    starts[11] = 5000 - 40  # a window that runs past the chunk's end
    want = jpl._score_chunk(
        jnp.asarray(chunk), jnp.asarray(starts, jnp.int32),
        jnp.asarray(win_len, jnp.int32), jnp.asarray(table.tbl), Lp=Lp,
        k=k, min_count=1, both_strands=both_strands,
    )
    port = tpl.WindowScorer(table, _CPU)
    got = port.score_chunk_async(chunk, starts, win_len, Lp)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    res = port.collect(got)
    assert res["observed"][:12].sum() > 0 and not res["total"][12:].any()


def test_fixed_windows_chunked_and_batched(rng, tmp_path, monkeypatch):
    """The plugin's fixed-window hash scoring: the chunked path (one
    WindowScorer) and the padded-batch path (a ShardedWindowScorer on a
    (2, 2) mesh of CPU slots) give the JAX package's chunked result."""
    from argparse import Namespace

    from kcftools_tpu.io.fasta import FastaIndex
    from kcftools_tpu.plugins import get_variations as jgv
    from kcftools_tpu_torch.parallel.mesh import make_mesh
    from kcftools_tpu_torch.parallel.sharded import ShardedWindowScorer
    from kcftools_tpu_torch.plugins import get_variations as tgv

    from .gen import write_fasta

    monkeypatch.setenv("KCFTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("KCFTOOLS_TORCH_VIRTUAL_DEVICES", "4")
    k = 21
    genome = random_seq(rng, 7000, n_prob=0.005)
    fa = str(tmp_path / "r.fa")
    write_fasta(fa, [("c1", genome)])
    index = FastaIndex(fa)
    db = count_db([mutate(rng, genome, snp_rate=0.02)], k)
    keys = np.array([str_to_kmer(s) for s in db], np.uint64)
    table = build_table(keys, np.array(list(db.values()), np.uint32), k)
    for step in (0, 150):
        args = Namespace(window=500, step=step)
        want = jgv._score_fixed_windows(
            args, index, "c1", k, jpl.WindowScorer(table), "s")
        for scorer in (tpl.WindowScorer(table, _CPU),
                       ShardedWindowScorer(table, make_mesh(2, 2))):
            got = tgv._score_fixed_windows(args, index, "c1", k, scorer, "s")
            np.testing.assert_array_equal(got.start, want.start)
            for f in ("total_kmers", "eff_length", "ob", "va", "inner",
                      "left", "right", "kmer_count"):
                np.testing.assert_array_equal(
                    getattr(got, f), getattr(want, f), err_msg=f)
            assert got.window_id == want.window_id
