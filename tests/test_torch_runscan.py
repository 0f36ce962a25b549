"""The run-stream scan of the port (kcftools_tpu_torch/ops/gapscan.py::
runs_scan) against the JAX package's run program (kcftools_tpu/engine/
device_prefix.py::_score_runs), on the CPU.

A numpy model of the kernel's run decode (csrc/gapscan.cu: runs_totals,
runs_offsets, runs_paint) is written to its design: per row, segments of
``seg`` entries whose offsets are the sums of the segments before them;
the words where a span starts, or the stream ends, inside a word are
zeroed; each segment paints its span [P, E) (clamped to n) and writes
every word of it once, or-ing the words it shares with another span and
storing the rest; the words past the stream are zeroed. The model checks
that every word is either stored once and touched by nothing else, or
zeroed and then or-ed by the spans that share it. It runs at segments of
1, 3, 64, 1,024 (the kernel's) and 4,096 entries, so that segment edges
split continuations and fall inside words, and its presence
(valid & ~absent), scanned by the models of the scan, must equal the JAX
package exactly. ``runs_scan`` on CPU tensors
(its plain version) must equal the JAX package too. Every statistic is an
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

from .test_torch_gapscan import FULL, Model, WindowModel, word_mask
from .torch_gapscan_cases import (
    N,
    RUN_SEG,
    bits,
    long_runs_case,
    rows_case,
    runs_case,
    runs_presence,
)

SEGMENTS = [1, 3, 64, RUN_SEG, 4096]  # entries a segment


def decode(dl, valid, seg):
    """The kernel's run decode at ``seg`` entries a segment: (S, n/32)
    absent words."""
    S, _, R = dl.shape
    n = valid.shape[0]
    nw = n // 32
    words = np.full((S, nw), -1, np.int64)  # not yet written
    for r in range(S):
        d, ln = dl[r, 0].astype(np.int64), dl[r, 1].astype(np.int64)
        ends = np.concatenate([[0], np.cumsum(d + ln)])
        n_seg = max(1, -(-R // seg))
        offsets = [int(ends[min(b * seg, R)]) for b in range(n_seg)]
        end = int(ends[-1])
        zeroed = {p >> 5 for p in offsets + [end] if p < n and p & 31}
        words[r, list(zeroed)] = 0
        stores, ors = np.zeros(nw, np.int64), np.zeros(nw, np.int64)
        for b in range(n_seg):
            a, z = b * seg, min((b + 1) * seg, R)
            P, E = min(offsets[b], n), min(int(ends[z]), n)
            window = {}
            for j in range(a, z):
                s, e = int(ends[j + 1] - ln[j]), int(ends[j + 1])
                if ln[j] == 0 or s >= n:
                    continue
                for w in range(s >> 5, ((min(e, n) - 1) >> 5) + 1):
                    window[w] = window.get(w, 0) | word_mask(w, s,
                                                             min(e, n) - 1)
            nwords = ((E - 1) >> 5) - (P >> 5) + 1 if E > P else 0
            for i in range(nwords):
                w = (P >> 5) + i
                if (i == 0 and P & 31) or (i == nwords - 1 and E & 31):
                    assert w in zeroed
                    words[r, w] |= window.get(w, 0)
                    ors[w] += 1
                else:
                    words[r, w] = window.get(w, 0)
                    stores[w] += 1
        for w in range((min(end, n) + 31) >> 5, nw):
            words[r, w] = 0
            stores[w] += 1
        shared = np.zeros(nw, bool)
        shared[list(zeroed)] = True
        assert ((stores == 1) & (ors == 0) & ~shared
                | (stores == 0) & (ors >= 1) & shared).all()
    return words


def presence_words(dl, valid, seg):
    """The presence the scan reads: valid & ~absent."""
    vw = bits(valid).view("<u4").astype(np.int64)
    return vw & ~decode(dl, valid, seg) & FULL


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
    """The decode model at ``seg`` entries a segment on the edge streams,
    scanned by the chunk model."""
    seed = 50 + k
    dl, valid, ws, wh = runs_case(seed, k)
    if seg == 3:  # a segment edge splits a continuation
        split = [(r, j) for r in range(dl.shape[0])
                 for j in range(0, dl.shape[2], seg)
                 if dl[r, 0, j] == 0 and dl[r, 1, j] == 255]
        assert split
    words = presence_words(dl, valid, seg)
    pr = runs_presence(dl, valid)
    np.testing.assert_array_equal(words,
                                  bits(pr).view("<u4").astype(np.int64))
    got = np.stack([Model(row, valid, k, 1024).scan(ws, wh, 5)
                    for row in pr], axis=1)
    np.testing.assert_array_equal(got, _jax_runs(seed, k))


@functools.lru_cache(maxsize=None)
def _jax_long_runs(seed, k):
    dl, valid, ws, wh = long_runs_case(seed, k, 7)
    fn = jax.jit(functools.partial(jdp._score_runs, k=k))
    want = fn(jnp.asarray(dl), jnp.asarray(_cs_tot(valid)),
              jnp.asarray(ws.astype(np.int32)),
              jnp.asarray(wh.astype(np.int32)))
    return np.asarray(want).astype(np.int64)


@pytest.mark.parametrize("k", [11, 16, 17, 31, 32])
def test_decode_model_matches_jax_long(k):
    """The kernel's decode (segments of 1,024 entries) on streams of many
    segments (one-position runs sharing words, a dense and a sparse row,
    zeros in the middle of a stream), its presence scanned by the window
    model on the long windows: the rows' presence equals the streams',
    and the sparse row's statistics the JAX run program's."""
    seed = 120 + k
    dl, valid, ws, wh = long_runs_case(seed, k, 7)
    assert (dl.shape[2] > 2 * RUN_SEG
            and (dl[:, 1] > 0).sum(1).max() > 2 * RUN_SEG)
    words = presence_words(dl, valid, RUN_SEG)
    pr = runs_presence(dl, valid)
    np.testing.assert_array_equal(words,
                                  bits(pr).view("<u4").astype(np.int64))
    got = WindowModel(pr[2], valid, k).scan(ws, wh)
    np.testing.assert_array_equal(got, _jax_long_runs(seed, k)[:, 2])


@pytest.mark.parametrize("rows", [1, 8, 9])
def test_runs_scan_cpu_matches_jax_long(rows):
    """Groups of 1, 8 and 9 rows of multi-segment streams over a long
    slab and its long windows."""
    dl, valid, ws, wh = long_runs_case(130 + rows, 31, rows)
    got = tgs.runs_scan(_t(dl), _t(bits(valid)), _t(ws), _t(wh), k=31)
    assert got.shape == (5, rows, ws.shape[0])
    fn = jax.jit(functools.partial(jdp._score_runs, k=31))
    want = fn(jnp.asarray(dl), jnp.asarray(_cs_tot(valid)),
              jnp.asarray(ws.astype(np.int32)),
              jnp.asarray(wh.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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
