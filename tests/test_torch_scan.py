"""The port's gap-run prefix scan (kcftools_tpu_torch/ops/gapscan.py:
the plain ``_scan_core`` and ``slabs_scan_join`` on CPU tensors) and slab
layout against the JAX package's, on the same numpy inputs. Exact: the
statistics are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcftools_tpu.engine import device_join as jdj
from kcftools_tpu.engine import device_prefix as jdp
from kcftools_tpu_torch.engine.slabs import Layout
from kcftools_tpu_torch.ops import gapscan as tgs


def _windows(rng, n, k):
    """Tiling windows, overlapping sliding windows and a few empty
    (shorter than k) windows over n k-mer positions."""
    ws, wh = [], []
    for s in range(0, n - 300, 250):
        ws.append(s)
        wh.append(s + 250 - 1)
    for s in range(10, n - 500, 170):
        ws.append(s)
        wh.append(s + 400)
    for s in rng.integers(0, n - 1, 5):
        ws.append(int(s))
        wh.append(int(s) - 1)
    return np.array(ws, np.int32), np.array(wh, np.int32)


def _presence(rng, n, density):
    """Presence with absent runs (SNP-like gaps), N-run invalid
    stretches and a fully absent stretch."""
    valid = rng.random(n) > 0.02
    valid[n // 3 : n // 3 + 90] = False
    pr = rng.random(n) < density
    absent = rng.integers(0, n, n // 40)
    for a in absent:
        pr[a : a + int(rng.integers(1, 40))] = False
    pr[n // 2 : n // 2 + 700] = False
    return pr & valid, valid


@pytest.mark.parametrize("density", [0.97, 0.6])
@pytest.mark.parametrize("k", [17, 21, 31])
def test_scan_core_matches_jax(k, density):
    rng = np.random.default_rng(k * 100 + int(density * 10))
    n = 6144
    pr, valid = _presence(rng, n, density)
    cs_tot = np.zeros(n + 1, np.int32)
    np.cumsum(valid, out=cs_tot[1:])
    ws, wh = _windows(rng, n, k)
    want = np.asarray(
        jdp._scan_core(jnp.asarray(pr), jnp.asarray(cs_tot),
                       jnp.asarray(ws), jnp.asarray(wh), k=k)
    )
    got = tgs._scan_core(
        torch.from_numpy(pr), torch.from_numpy(cs_tot).long(),
        torch.from_numpy(ws).long(), torch.from_numpy(wh).long(), k=k,
    )
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("min_count", [1, 3])
def test_slab_scan_matches_jax(min_count):
    """Gather through the slot map, unsigned presence test (counts up to
    2^32 - 1) and the count sums."""
    rng = np.random.default_rng(min_count)
    k = 31
    n = 4096
    n_routed = 3000
    routed = rng.integers(0, 6, n_routed).astype(np.uint32)
    routed[::7] = rng.integers(1 << 31, 1 << 32, routed[::7].shape[0],
                               dtype=np.uint64).astype(np.uint32)
    valid = rng.random(n) > 0.05
    slot_map = np.where(valid, rng.integers(0, n_routed, n), 0).astype(np.int32)
    vbits = np.packbits(valid, bitorder="little")
    ws, wh = _windows(rng, n, k)
    want = np.asarray(jdj._slab_scan(
        jnp.asarray(routed), jnp.asarray(slot_map), jnp.asarray(vbits),
        jnp.asarray(ws), jnp.asarray(wh), k=k, min_count=min_count,
        wide_windows=True,
    ))
    got = tgs.slabs_scan_join(
        torch.from_numpy(routed.view(np.int32)),
        torch.from_numpy(slot_map[None]), torch.from_numpy(vbits[None]),
        torch.from_numpy(ws[None]).long(), torch.from_numpy(wh[None]).long(),
        k=k, min_count=min_count,
    )
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("slab_pos", [1 << 24, 3000, 700])
def test_layout_matches_jax(slab_pos):
    rng = np.random.default_rng(slab_pos)
    k = 21
    ours, theirs = Layout(k, slab_pos), jdp._Layout(k, slab_pos)
    for name, L in (("a", 5000), ("b", 1200), ("c", 40)):
        r_idx = rng.integers(-1, 10_000, L - k + 1).astype(np.int32)
        starts = np.arange(0, L - k, 300)
        ends = np.minimum(starts + 300, L)
        ours.add_chrom(name, r_idx, starts, ends)
        theirs.add_chrom(name, r_idx, starts, ends)
    ours.finalize()
    theirs.finalize()
    assert (ours.pos_pad, ours.win_pad) == (theirs.pos_pad, theirs.win_pad)
    assert ours.chrom_n_win == theirs.chrom_n_win
    assert len(ours.slabs) == len(theirs.slabs)
    for a, b in zip(ours.slabs, theirs.slabs):
        assert a["wins"] == b["wins"] and a["n_win"] == b["n_win"]
        for f in ("r_idx", "w_start", "w_hi"):
            np.testing.assert_array_equal(a[f], b[f])
        # the JAX layout's int32 valid prefix counts follow from r_idx,
        # the field the port keeps
        np.testing.assert_array_equal(
            b["cs_tot"], np.concatenate([[0], np.cumsum(a["r_idx"] >= 0)]))
