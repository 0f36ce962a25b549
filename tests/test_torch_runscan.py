"""The run-stream scan of the port (kcftools_tpu_torch/ops/gapscan.py::
runs_scan) against the JAX package's run program (kcftools_tpu/engine/
device_prefix.py::_score_runs), on the CPU.

A numpy model of the kernel's run front end (csrc/gapscan.cu) is written
to its design: per row, segment totals of delta + length, an exclusive
scan of the totals, then each segment rescanned from its offset and its
runs cleared from a copy of the valid words, word by word. It runs at
segment sizes 1, 3, 64 and 1,024 (the kernel's), so that segment edges
split continuations, and its bitmaps, scanned by the model of the scan,
must equal the JAX package exactly. ``runs_scan`` on CPU tensors (its
plain version) must equal the JAX package too. Every statistic is an
integer, so every comparison is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcftools_tpu.engine import device_prefix as jdp
from kcftools_tpu_torch.native import bits_to_runs
from kcftools_tpu_torch.ops import gapscan as tgs

from .test_torch_gapscan import FULL, Model, word_mask
from .torch_gapscan_cases import N, bits, rows_case, runs_case, runs_presence

SEGMENTS = [1, 3, 64, 1024]


def clear_run(words, s, e, n):
    """Clear [s, e), clamped to n, from one row's words."""
    if s >= n:
        return
    e = min(e, n)
    for w in range(s >> 5, ((e - 1) >> 5) + 1):
        words[w] &= ~word_mask(w, s, e - 1) & FULL


def front_end(dl, valid, seg):
    """The kernel's run front end at segment size ``seg``: (S, n/32)
    presence words."""
    S, _, R = dl.shape
    n = valid.shape[0]
    words = np.tile(bits(valid).view("<u4").astype(np.int64), (S, 1))
    starts = range(0, R, seg)
    for r in range(S):
        dl_r = dl[r].astype(np.int64)
        totals = [int(dl_r[:, a : a + seg].sum()) for a in starts]
        offsets = np.cumsum([0] + totals[:-1])
        for a, end in zip(starts, offsets.tolist()):
            for j in range(a, min(R, a + seg)):
                end += int(dl_r[0, j] + dl_r[1, j])
                if dl_r[1, j]:
                    clear_run(words[r], end - int(dl_r[1, j]), end, n)
    return words


def _cs_tot(valid):
    cs = np.zeros(valid.shape[0] + 1, np.int32)
    np.cumsum(valid, out=cs[1:])
    return cs


@functools.lru_cache(maxsize=None)
def _jax_runs(seed, k):
    dl, valid, ws, wh = runs_case(seed, k)
    fn = jax.jit(functools.partial(jdp._score_runs, k=k))
    want = fn(jnp.asarray(dl), jnp.asarray(_cs_tot(valid)),
              jnp.asarray(ws.astype(np.int32)),
              jnp.asarray(wh.astype(np.int32)))
    return np.asarray(want).astype(np.int64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_runs_case_reaches_every_edge():
    """The streams hold fillers, continuations, zero padding, a run that
    ends exactly at n, runs past n, absent runs over invalid positions,
    an all-absent row and an empty stream."""
    dl, valid, _ws, _wh = runs_case(1, 31)
    d, ln = dl[:, 0].astype(np.int64), dl[:, 1].astype(np.int64)
    assert ((d == 255) & (ln == 0)).any()
    assert ((d == 0) & (ln == 255)).any()
    assert (dl[:, :, -1] == 0).all()
    ends = np.cumsum(d + ln, 1)
    assert ((ends == N) & (ln > 0)).any()
    assert ((ends - ln >= N) & (ln > 0)).any()
    pr = runs_presence(dl, valid)
    assert not pr[2].any() and (pr[3] == valid).all()
    run_mask = ~runs_presence(dl, np.ones(N, bool))
    assert (run_mask[:2] & ~valid).any()


@pytest.mark.parametrize("k", [17, 31])
@pytest.mark.parametrize("seg", SEGMENTS)
def test_front_end_model_matches_jax_score_runs(seg, k):
    seed = 50 + k
    dl, valid, ws, wh = runs_case(seed, k)
    if seg == 3:  # a segment edge splits a continuation from its run
        split = [(r, j) for r in range(dl.shape[0])
                 for j in range(0, dl.shape[2], seg)
                 if dl[r, 0, j] == 0 and dl[r, 1, j] == 255]
        assert split
    words = front_end(dl, valid, seg)
    pr = runs_presence(dl, valid)
    np.testing.assert_array_equal(words,
                                  bits(pr).view("<u4").astype(np.int64))
    got = np.stack([Model(row, valid, k, 1024).scan(ws, wh, 5)
                    for row in pr], axis=1)
    np.testing.assert_array_equal(got, _jax_runs(seed, k))


@pytest.mark.parametrize("k", [17, 31, 45])
def test_runs_scan_cpu_matches_jax(k):
    seed = 50 + k
    dl, valid, ws, wh = runs_case(seed, k)
    before = tgs.runs_scan.launches
    got = tgs.runs_scan(_t(dl), _t(bits(valid)), _t(ws), _t(wh), k=k)
    assert got.shape == (5, dl.shape[0], ws.shape[0])
    assert tgs.runs_scan.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(got.numpy(), _jax_runs(seed, k))
    via_bits = tgs.rows_scan(_t(bits(runs_presence(dl, valid))),
                             _t(bits(valid)), _t(ws), _t(wh), k=k)
    assert torch.equal(got, via_bits)


def test_runs_scan_cpu_on_encoder_streams():
    """Streams from the native kcf_bits_to_runs of every presence kind
    (zero-padded to one width) scan as their bitmaps do."""
    pr, valid, ws, wh = rows_case(61, 31)
    streams = []
    for row in pr:
        d, ln, n_runs = bits_to_runs(bits(row), bits(valid), N, 4096)
        assert n_runs >= 0
        streams.append(np.stack([d, ln]))
    dl = np.zeros((len(streams), 2, max(s.shape[1] for s in streams) + 5),
                  np.uint8)
    for r, st in enumerate(streams):
        dl[r, :, : st.shape[1]] = st
    got = tgs.runs_scan(_t(dl), _t(bits(valid)), _t(ws), _t(wh), k=31)
    want = tgs.rows_scan(_t(bits(pr)), _t(bits(valid)), _t(ws), _t(wh),
                         k=31)
    assert torch.equal(got, want)


BAD = [
    (0, lambda t: t.int(), TypeError),  # dl not uint8
    (0, lambda t: t[:, :1].contiguous(), TypeError),  # not (S, 2, R)
    (0, lambda t: t[0], TypeError),  # not 3-D
    (1, lambda t: t[:-1], ValueError),  # n not a multiple of 32
    (2, lambda t: t.int(), TypeError),  # int32 window bounds
    (3, lambda t: t[:-1], ValueError),  # bounds differ in shape
]


@pytest.mark.parametrize("arg,bad,exc", BAD,
                         ids=[f"{a}-{e.__name__}-{i}"
                              for i, (a, _b, e) in enumerate(BAD)])
def test_runs_scan_checks_raise(arg, bad, exc):
    dl, valid, ws, wh = runs_case(7, 31)
    args = [_t(dl), _t(bits(valid)), _t(ws), _t(wh)]
    args[arg] = bad(args[arg])
    with pytest.raises(exc):
        tgs.runs_scan(*args, k=31)
