"""The window gap-run scan of the port (kcftools_tpu_torch/ops/gapscan.py)
against the JAX package's (kcftools_tpu/engine/device_prefix.py::
_scan_core, device_join.py::_slab_scan), on the CPU.

Two numpy models of the kernel (csrc/gapscan.cu) are written to its
design and must equal the JAX package exactly:
- ``Model`` / ``JoinModel``, the JOIN mode: one summary per chunk of
  positions, then per window the partial head chunk, the whole chunks'
  summaries and the partial tail chunk; a range inside a chunk is
  summarised one 32-position word at a time by the kernel's bit
  arithmetic and the words combined in the order of its shuffle tree.
  Pass 1 gathers each valid position's count once into presence words
  and one count sum a word, and everything after reads those, going back
  to the counts only for a range's partial edge words. It runs at chunk
  sizes 1, 7, 64 and 4,096 (the kernel's is 1,024), so that chunk edges
  fall everywhere.
- ``WindowModel``, the ROWS and RUNS modes (rows_short, rows_long): a
  window of at most 64 128-position quads folded word by word by one
  lane; a longer one split into contiguous lane stretches of a warp (for
  fewer than 8 rows, first into 8 // S pieces, a warp each), each
  stretch folded word by word, the lanes combined in lane order, the
  pieces in piece order. It runs at k 11, 16, 17, 31 and 32 on the long
  cases, as for groups of 1, 3 and 8 rows.
The wrappers on CPU tensors (their plain versions; the multi-slab one
against its slabs one at a time too) must equal the JAX package, and
their argument checks must raise. Every statistic is an integer, so every
comparison is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcftools_tpu.engine import device_join as jdj
from kcftools_tpu.engine import device_prefix as jdp
from kcftools_tpu_torch.native import build_ordmap, ordpack, pack_posbits
from kcftools_tpu_torch.ops import gapscan as tgs

from .torch_gapscan_cases import (
    LONG_N,
    LONG_WINDOW,
    N,
    SHORT_QUADS,
    ODD_N,
    PRESENCE_KINDS,
    bits,
    join_case,
    long_rows_case,
    rows_case,
    slabs_case,
)

CHUNKS = [1, 7, 64, 4096]
FULL = 0xFFFFFFFF


# -- the model of the kernel ------------------------------------------------

# (nval, obs, lead, trail, var, dist, csum); lead = trail = nval when
# nothing is present
EMPTY = (0, 0, 0, 0, 0, 0, 0)


def gap_dist(g, k):
    d = g - (k - 1)
    return d if d > 0 else abs(d + 1)


def combine(a, b, k):
    nval, obs = a[0] + b[0], a[1] + b[1]
    lead = a[2] if a[1] else a[0] + b[2]
    trail = b[3] if b[1] else a[3] + b[0]
    var, dist, csum = a[4] + b[4], a[5] + b[5], a[6] + b[6]
    if a[1] and b[1]:
        g = a[3] + b[2]
        if g > 0:
            var += 1
            dist += gap_dist(g, k)
    return (nval, obs, lead, trail, var, dist, csum)


def popc(x):
    return bin(x & FULL).count("1")


def ffs(x):  # 1 + index of the lowest set bit, 0 for none (CUDA __ffs)
    return (x & -x).bit_length()


def clz(x):  # leading zeros of a 32-bit word (CUDA __clz)
    return 32 - (x & FULL).bit_length()


def word_sum(pw, vw, k):
    """The kernel's ``word_sum``: pw inside vw, both masked."""
    nval, obs = popc(vw), popc(pw)
    if pw == 0:
        return (nval, 0, nval, nval, 0, 0, 0)
    f, l = ffs(pw) - 1, 31 - clz(pw)
    lead = popc(vw & ((1 << f) - 1))
    trail = popc(vw & ~(((2 << l) & FULL) - 1))
    var = dist = 0
    m = vw & ~pw & ((1 << l) - 1) & ~(((2 << f) & FULL) - 1) & FULL
    while m:
        q = ffs(m) - 1
        a = 31 - clz(pw & ((1 << q) - 1))
        b = ffs(pw & ~(((2 << q) & FULL) - 1) & FULL) - 1
        g = popc(vw & ((1 << b) - 1) & ~(((2 << a) & FULL) - 1))
        var += 1
        dist += gap_dist(g, k)
        m &= ~((1 << b) - 1)
    return (nval, obs, lead, trail, var, dist, 0)


def tree(sums, k):
    """Combine in the order of the kernel's shuffle tree (lane i takes
    lane i + o at o = 1, 2, 4, ...; lanes past the end read their own)."""
    if not sums:
        return EMPTY
    width = 1 << (len(sums) - 1).bit_length()
    lanes = list(sums) + [EMPTY] * (width - len(sums))
    o = 1
    while o < width:
        lanes = [combine(x, lanes[i + o] if i + o < width else x, k)
                 for i, x in enumerate(lanes)]
        o <<= 1
    return lanes[0]


def word_mask(w, lo, hi):
    """The bits of word w inside positions [lo, hi]."""
    mask = FULL
    if w == lo >> 5:
        mask &= (FULL << (lo & 31)) & FULL
    if w == hi >> 5:
        mask &= FULL >> (31 - (hi & 31))
    return mask


class Model:
    """The kernel's two passes at chunk size ``chunk`` over one row.
    pwords / vwords: presence (inside valid) and valid as 32-bit
    words."""

    def __init__(self, pr, valid, k, chunk):
        self.n = valid.shape[0]
        self.k = k
        self.chunk = chunk
        self.pwords = bits(pr & valid).view("<u4").astype(np.int64)
        self.vwords = bits(valid).view("<u4").astype(np.int64)
        n_chunks = -(-self.n // chunk)
        self.chunks = [  # pass 1
            self.range_sum(c * chunk, min(self.n, (c + 1) * chunk) - 1)
            for c in range(n_chunks)
        ]

    def range_sum(self, lo, hi):
        """Positions [lo, hi] of one chunk: one word a lane, masked."""
        lanes = []
        for w in range(lo >> 5, (hi >> 5) + 1):
            vw = int(self.vwords[w]) & word_mask(w, lo, hi)
            lanes.append(word_sum(int(self.pwords[w]) & vw, vw, self.k))
        return tree(lanes, self.k)

    def window(self, s, h):
        n, c, k = self.n, self.chunk, self.k
        s, h = min(max(s, 0), n), min(max(h, -1), n - 1)
        neg = h < s - 1
        lo, hi = (h + 1, s - 1) if neg else (s, h)
        t = EMPTY
        if lo <= hi:
            c0, c1 = lo // c, hi // c
            if c0 == c1:
                t = self.range_sum(lo, hi)
            else:
                t = self.range_sum(lo, c0 * c + c - 1)
                for b in range(c0 + 1, c1, 32):
                    t = combine(t, tree(self.chunks[b : min(b + 32, c1)], k),
                                k)
                t = combine(t, self.range_sum(c1 * c, hi), k)
        nval, obs, lead, trail, var, dist, csum = t
        if neg:
            return [-obs, 0, 0, 0, -nval, -csum]
        has = obs > 0
        return [obs,
                var + (lead > 0) + (trail > 0) if has else int(nval > 0),
                dist, lead if has else 0, trail if has else nval, csum]

    def scan(self, ws, wh, fields):
        out = np.array([self.window(int(s), int(h)) for s, h in zip(ws, wh)],
                       np.int64)
        return out.T[:fields] if len(ws) else np.zeros((fields, 0), np.int64)


class JoinModel(Model):
    """The JOIN mode. Pass 1 gathers each valid position's count once
    (through the slot map, compared unsigned) into the presence words
    and one count sum a word; the chunk summaries and the windows read
    those and gather again only the present positions of a range's
    partial edge words. ``pass1_gathers`` counts pass 1's gathers,
    ``chunk_gathers`` those of the chunk summaries after it (none with
    chunks of whole words), ``window_gathers`` the most of one
    window."""

    def __init__(self, routed, slot_map, valid, k, chunk, min_count):
        self.routed = routed.astype(np.int64)
        self.slot_map = slot_map
        live = np.flatnonzero(valid)
        cnt = np.zeros(valid.shape[0], np.int64)
        cnt[live] = self.routed[slot_map[live]]  # pass 1: once a position
        self.gathers = self.pass1_gathers = live.shape[0]
        pr = valid & (cnt >= min_count)
        self.wsum = np.where(pr, cnt, 0).reshape(-1, 32).sum(1)
        self.window_gathers = 0
        super().__init__(pr, valid, k, chunk)
        self.chunk_gathers = self.gathers - self.pass1_gathers

    def count(self, pos):
        self.gathers += 1
        return int(self.routed[self.slot_map[pos]])

    def range_sum(self, lo, hi):
        csum = 0
        for w in range(lo >> 5, (hi >> 5) + 1):
            mask = word_mask(w, lo, hi)
            if mask == FULL:
                csum += int(self.wsum[w])
                continue
            pw = int(self.pwords[w]) & mask
            csum += sum(self.count(32 * w + b) for b in range(32)
                        if pw >> b & 1)
        return super().range_sum(lo, hi)[:6] + (csum,)

    def window(self, s, h):
        before = self.gathers
        out = super().window(s, h)
        self.window_gathers = max(self.window_gathers, self.gathers - before)
        return out


class WindowModel:
    """The ROWS / RUNS kernel (rows_short, rows_long) over one row of a
    group of ``rows``: pr (inside valid) and valid as 32-bit words, four
    to a 128-position quad."""

    def __init__(self, pr, valid, k, rows=1):
        self.n = valid.shape[0]
        self.k = k
        self.pieces = 1 if rows >= 8 else 8 // rows
        self.pwords = bits(pr & valid).view("<u4").astype(np.int64)
        self.vwords = bits(valid).view("<u4").astype(np.int64)
        self.word_sum = functools.lru_cache(maxsize=None)(
            functools.partial(word_sum, k=k))

    def stretch(self, qb, qe, lo, hi):
        """Quads [qb, qe) folded word by word in order, each word masked
        to [lo, hi] (words outside it are empty)."""
        acc = EMPTY
        for w in range(4 * qb, min(4 * qe, self.vwords.shape[0])):
            if w < lo >> 5 or w > hi >> 5:
                continue
            vw = int(self.vwords[w]) & word_mask(w, lo, hi)
            acc = combine(acc, self.word_sum(int(self.pwords[w]) & vw, vw),
                          self.k)
        return acc

    def warp(self, qb, qe, lo, hi):
        """Quads [qb, qe) by one warp: a contiguous stretch a lane, the
        lanes combined by the shuffle tree."""
        per = -(-(qe - qb) // 32)
        return tree([self.stretch(qb + j * per, min(qb + (j + 1) * per, qe),
                                  lo, hi) for j in range(32)], self.k)

    def split(self, lo, hi):
        """A short window by one lane; a long one by the row's pieces, a
        warp each, combined in order."""
        q0, q1 = lo >> 7, (hi >> 7) + 1
        if q1 - q0 <= SHORT_QUADS:
            return self.stretch(q0, q1, lo, hi)
        pq = -(-(q1 - q0) // self.pieces)
        t = EMPTY
        for j in range(self.pieces):
            b = q0 + j * pq
            t = combine(t, self.warp(b, min(b + pq, q1), lo, hi), self.k)
        return t

    def window(self, s, h):
        n = self.n
        s, h = min(max(s, 0), n), min(max(h, -1), n - 1)
        neg = h < s - 1
        lo, hi = (h + 1, s - 1) if neg else (s, h)
        t = self.split(lo, hi) if lo <= hi else EMPTY
        nval, obs, lead, trail, var, dist, _csum = t
        if neg:
            return [-obs, 0, 0, 0, -nval]
        has = obs > 0
        return [obs,
                var + (lead > 0) + (trail > 0) if has else int(nval > 0),
                dist, lead if has else 0, trail if has else nval]

    def scan(self, ws, wh):
        return np.array([self.window(int(s), int(h))
                         for s, h in zip(ws, wh)], np.int64).T


def _cs_tot(valid):
    cs = np.zeros(valid.shape[0] + 1, np.int32)
    np.cumsum(valid, out=cs[1:])
    return cs


@functools.lru_cache(maxsize=None)
def _jax_rows(seed, k):
    pr, valid, ws, wh = rows_case(seed, k)
    fn = jax.jit(functools.partial(jdp._score_batch, k=k))
    want = np.asarray(fn(jnp.asarray(bits(pr)), jnp.asarray(_cs_tot(valid)),
                         jnp.asarray(ws.astype(np.int32)),
                         jnp.asarray(wh.astype(np.int32))))
    return want.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _jax_join(seed, min_count):
    routed, slot_map, valid, ws, wh = join_case(seed, min_count)
    want = np.asarray(jdj._slab_scan(
        jnp.asarray(routed), jnp.asarray(slot_map),
        jnp.asarray(bits(valid)), jnp.asarray(ws.astype(np.int32)),
        jnp.asarray(wh.astype(np.int32)), k=31, min_count=min_count,
        wide_windows=True,
    ))
    return want


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the model -------------------------------------------------------------


def test_word_sum_matches_positions():
    """The kernel's bit arithmetic on one word equals folding the word's
    32 positions one at a time, on edge and random words."""
    rng = np.random.default_rng(1)
    words = [(0, 0), (FULL, FULL), (1, 1), (1 << 31, 1 << 31),
             (1 | 1 << 31, FULL), (1 | 1 << 31, 1 | 1 << 31 | 0xF0),
             (0x00F000F0, 0x0FFFFFF0), (0, FULL)]
    for _ in range(400):
        vw = int(rng.integers(0, 1 << 32))
        words.append((vw & int(rng.integers(0, 1 << 32)), vw))
    for k in (17, 45):
        for pw, vw in words:
            want = EMPTY
            for j in range(32):
                v, p = vw >> j & 1, pw >> j & 1
                want = combine(want, (v, p, 0 if p else v, 0 if p else v,
                                      0, 0, 0), k)
            assert word_sum(pw, vw, k) == want, (hex(pw), hex(vw), k)


ROW_CASES = [(17, ("dense", "sparse")), (31, PRESENCE_KINDS),
             (45, ("dense", "sparse"))]


@pytest.mark.parametrize("k,kinds", ROW_CASES, ids=["k17", "k31", "k45"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_model_matches_jax_scan_core(chunk, k, kinds):
    """Rows of every presence kind, windows of every kind."""
    seed = 10 + k
    pr, valid, ws, wh = rows_case(seed, k)
    want = _jax_rows(seed, k)
    for r, kind in enumerate(PRESENCE_KINDS):
        if kind not in kinds:
            continue
        got = Model(pr[r], valid, k, chunk).scan(ws, wh, 5)
        np.testing.assert_array_equal(got, want[:, r], err_msg=kind)


@pytest.mark.parametrize("min_count", [1, 3])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_model_matches_jax_slab_scan(chunk, min_count):
    """The JOIN mode: counts through the slot map, compared unsigned,
    summed in int64."""
    seed = 20 + min_count
    routed, slot_map, valid, ws, wh = join_case(seed, min_count)
    model = JoinModel(routed, slot_map, valid, 31, chunk, min_count)
    assert model.pass1_gathers == valid.sum()  # each count once
    got = model.scan(ws, wh, 6)
    np.testing.assert_array_equal(got, _jax_join(seed, min_count))
    if chunk % 32 == 0:
        # chunks of whole words: the chunk summaries gather nothing, and a
        # window gathers again only in its two partial edge words
        assert model.chunk_gathers == 0
        assert 0 < model.window_gathers <= 2 * 31


@pytest.mark.parametrize("chunk", CHUNKS)
def test_model_matches_plain_on_inverted_windows(chunk):
    """Windows with w_hi < w_start - 1 get what the plain version's
    prefix differences give (negated sums, the rest 0)."""
    routed, slot_map, valid, ws, wh = join_case(5, 2, inverted=True)
    assert (wh < ws - 1).sum() >= 3
    got = JoinModel(routed, slot_map, valid, 31, chunk, 2).scan(ws, wh, 6)
    want = tgs.slab_scan_join_ref(
        _t(routed.view(np.int32)), _t(slot_map), _t(bits(valid)), _t(ws),
        _t(wh), k=31, min_count=2)
    np.testing.assert_array_equal(got, want.numpy())


@functools.lru_cache(maxsize=None)
def _jax_long_rows(seed, k, rows, n):
    pr, valid, ws, wh = long_rows_case(seed, k, rows, n)
    fn = jax.jit(functools.partial(jdp._score_batch, k=k))
    want = np.asarray(fn(jnp.asarray(bits(pr)), jnp.asarray(_cs_tot(valid)),
                         jnp.asarray(ws.astype(np.int32)),
                         jnp.asarray(wh.astype(np.int32))))
    return want.astype(np.int64)


@pytest.mark.parametrize("k", [11, 16, 17, 31, 32])
def test_window_model_matches_jax_scan_core(k):
    """The ROWS / RUNS split over the long case's windows (longer than
    LONG_WINDOW, the whole slab, stretch, batch and piece edges, tiling,
    sliding, features) on its dense row, as in groups of 1, 3 and 8
    rows."""
    pr, valid, ws, wh = long_rows_case(100 + k, k, 1)
    assert ((wh - ws + 1) > LONG_WINDOW).sum() > 10
    want = _jax_long_rows(100 + k, k, 1, LONG_N)[:, 0]
    for rows in (1, 3, 8):  # 8, 2 and 1 pieces a long window
        got = WindowModel(pr[0], valid, k, rows).scan(ws, wh)
        np.testing.assert_array_equal(got, want, err_msg=f"{rows} rows")


# -- the wrappers on CPU tensors ------------------------------------------


@pytest.mark.parametrize("min_count", [1, 3])
def test_slab_scan_join_cpu_matches_jax(min_count):
    seed = 20 + min_count
    routed, slot_map, valid, ws, wh = join_case(seed, min_count)
    before = tgs.slabs_scan_join.launches
    got = tgs.slabs_scan_join(
        _t(routed.view(np.int32)), _t(slot_map[None]), _t(bits(valid)[None]),
        _t(ws[None]), _t(wh[None]), k=31, min_count=min_count)
    assert got.shape == (1, 6, ws.shape[0]) and got.dtype == torch.int64
    np.testing.assert_array_equal(got[0].numpy(), _jax_join(seed, min_count))
    assert tgs.slabs_scan_join.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("k", [17, 31, 45])
def test_rows_scan_cpu_matches_jax(k):
    """S = 4 rows (one per presence kind) in one call."""
    seed = 10 + k
    pr, valid, ws, wh = rows_case(seed, k)
    before = tgs.rows_scan.launches
    got = tgs.rows_scan(_t(bits(pr)), _t(bits(valid)), _t(ws), _t(wh), k=k)
    assert got.shape == (5, pr.shape[0], ws.shape[0])
    np.testing.assert_array_equal(got.numpy(), _jax_rows(seed, k))
    assert tgs.rows_scan.launches == before


@pytest.mark.parametrize("rows,n", [(1, LONG_N), (8, LONG_N), (9, ODD_N),
                                    (40, LONG_N)],
                         ids=["S1", "S8", "S9-odd", "S40"])
def test_rows_scan_cpu_matches_jax_long(rows, n):
    """Groups of 1, 8, 9 and 40 rows over a long slab (windows longer than
    LONG_WINDOW, the whole slab, stretch edges, tiling, sliding,
    features)."""
    pr, valid, ws, wh = long_rows_case(110 + rows, 31, rows, n)
    got = tgs.rows_scan(_t(bits(pr)), _t(bits(valid)), _t(ws), _t(wh), k=31)
    assert got.shape == (5, rows, ws.shape[0])
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_long_rows(110 + rows, 31, rows, n))


@functools.lru_cache(maxsize=None)
def _jax_slabs(seed, min_count):
    """JAX ``_slab_scan`` over each slab of ``slabs_case``."""
    routed, slot_maps, valid, ws, wh = slabs_case(seed, min_count,
                                                  inverted=True)
    return np.stack([np.asarray(jdj._slab_scan(
        jnp.asarray(routed), jnp.asarray(slot_maps[si]),
        jnp.asarray(bits(valid[si])), jnp.asarray(ws[si].astype(np.int32)),
        jnp.asarray(wh[si].astype(np.int32)), k=31, min_count=min_count,
        wide_windows=True,
    )) for si in range(slot_maps.shape[0])])


@pytest.mark.parametrize("min_count", [1, 3])
def test_slabs_scan_join_cpu_matches_slabs_and_jax(min_count):
    """Three slabs of one sample (each its own slot map, valid bitmap and
    windows, inverted ones too) in one call: equal to one call a slab
    and to the JAX ``_slab_scan`` of each."""
    routed, slot_maps, valid, ws, wh = slabs_case(40 + min_count, min_count,
                                                  inverted=True)
    args = [_t(routed.view(np.int32)), _t(slot_maps), _t(bits(valid)),
            _t(ws), _t(wh)]
    before = tgs.slabs_scan_join.launches
    got = tgs.slabs_scan_join(*args, k=31, min_count=min_count)
    assert got.shape == (3, 6, ws.shape[1]) and got.dtype == torch.int64
    assert tgs.slabs_scan_join.launches == before
    for si in range(3):
        one = tgs.slabs_scan_join(args[0],
                                  *(a[si : si + 1] for a in args[1:]), k=31,
                                  min_count=min_count)
        assert torch.equal(got[si], one[0])
    np.testing.assert_array_equal(got.numpy(), _jax_slabs(40 + min_count,
                                                          min_count))


@pytest.mark.parametrize("chunk", [64, 4096])
def test_join_model_matches_jax_over_slabs(chunk):
    """The JOIN model slab by slab equals the JAX ``_slab_scan`` of each
    slab (the kernel takes the slab as its row)."""
    routed, slot_maps, valid, ws, wh = slabs_case(41, 1, inverted=True)
    want = _jax_slabs(41, 1)
    for si in range(slot_maps.shape[0]):
        got = JoinModel(routed, slot_maps[si], valid[si], 31, chunk,
                        1).scan(ws[si], wh[si], 6)
        np.testing.assert_array_equal(got, want[si])


def _join_args():
    routed, slot_map, valid, ws, wh = join_case(7, 1)
    return [_t(routed.view(np.int32)), _t(slot_map), _t(bits(valid)),
            _t(ws), _t(wh)]


def _rows_args():
    pr, valid, ws, wh = rows_case(7, 31)
    return [_t(bits(pr)), _t(bits(valid)), _t(ws), _t(wh)]


def _slabs_args():
    routed, slot_maps, valid, ws, wh = slabs_case(7, 1)
    return [_t(routed.view(np.int32)), _t(slot_maps), _t(bits(valid)),
            _t(ws), _t(wh)]


BAD = [
    ("join", 0, lambda t: t.long(), TypeError),  # routed not int32
    ("join", 1, lambda t: t[:-32], ValueError),  # slot map too short
    ("join", 2, lambda t: t.int(), TypeError),  # valid bits not uint8
    ("join", 2, lambda t: t[:-1], ValueError),  # n not a multiple of 32
    ("join", 3, lambda t: t.int(), TypeError),  # int32 window bounds
    ("join", 4, lambda t: t[:-1], ValueError),  # bounds differ in shape
    ("rows", 0, lambda t: t[:, :-4].contiguous(), ValueError),  # row width
    ("rows", 0, lambda t: t[0], TypeError),  # presence not 2-D
    ("rows", 0, lambda t: t.t(), ValueError),  # not contiguous
    ("rows", 2, lambda t: t[:, None], ValueError),  # bounds not 1-D
    ("slabs", 1, lambda t: t[0], TypeError),  # one slot map, not (S, n)
    ("slabs", 1, lambda t: t[:2], ValueError),  # slab counts differ
    ("slabs", 2, lambda t: t[:, :-1].contiguous(), ValueError),  # n % 32
    ("slabs", 3, lambda t: t[0], ValueError),  # bounds not (S, W)
]


@pytest.mark.parametrize("mode,arg,bad,exc", BAD,
                         ids=[f"{m}-{a}-{e.__name__}-{i}"
                              for i, (m, a, _b, e) in enumerate(BAD)])
def test_wrapper_checks_raise(mode, arg, bad, exc):
    args = {"join": _join_args, "rows": _rows_args,
            "slabs": _slabs_args}[mode]()
    args[arg] = bad(args[arg])
    if mode == "join":  # one slab, as a leading axis of 1
        args[1:] = [a[None] for a in args[1:]]
    fn = tgs.rows_scan if mode == "rows" else tgs.slabs_scan_join
    kw = {"k": 31} if mode == "rows" else {"k": 31, "min_count": 1}
    with pytest.raises(exc):
        fn(*args, **kw)


# -- what feeds the scan ---------------------------------------------------


def test_native_packers_stay_inside_valid():
    """No present bit at an invalid position reaches the bitmap program:
    kcf_pack_posbits and kcf_ordpack set presence only where r_idx >= 0
    (the valid bitmap), for any min_count and counts >= 255."""
    rng = np.random.default_rng(3)
    n, n_ref = 8192, 3000
    r_idx = rng.integers(0, n_ref, n).astype(np.int32)
    r_idx[rng.random(n) < 0.1] = -1
    r_idx[2000:2300] = -1
    valid_bits = bits(r_idx >= 0)
    nbb = valid_bits.shape[0]
    ws = np.arange(0, n - 500, 500, dtype=np.int32)
    wh = (ws + 499).astype(np.int32)
    counts = rng.integers(0, 256, n_ref).astype(np.uint8)
    exc_idx = np.flatnonzero(counts == 255).astype(np.int32)
    exc_val = rng.integers(255, 5000, exc_idx.shape[0]).astype(np.uint32)
    occ = build_ordmap(r_idx)
    for min_count in (0, 1, 3, 300):
        b1, _ = pack_posbits(counts, exc_idx, exc_val, r_idx, min_count,
                             ws, wh, n_bits_bytes=nbb)
        b2, _ = ordpack(counts, exc_idx, exc_val, occ[0], occ[1], min_count,
                        ws, wh, valid_bits, nbb)
        b3, _ = ordpack(counts, exc_idx, exc_val, occ[0], occ[1], min_count,
                        ws, wh, valid_bits, nbb, seg_off=occ[2],
                        seg_ord=occ[3])
        for b in (b1, b2, b3):
            assert not (b & ~valid_bits).any(), min_count
        assert b1.any() or min_count == 300


def test_runs_presence_batched_equals_rows():
    """The run program decodes all rows of a group at once; each row
    equals its decode alone, and packs to the bitmap the scan reads."""
    from kcftools_tpu_torch.native import bits_to_runs

    rng = np.random.default_rng(4)
    pr, valid, _ws, _wh = rows_case(4, 31)
    rows = []
    for row in pr:
        d, l, n_runs = bits_to_runs(bits(row), bits(valid), N, 4096)
        assert n_runs >= 0
        rows.append(np.stack([d, l]))
    cap = max(r.shape[1] for r in rows) + int(rng.integers(1, 9))
    dl = np.zeros((len(rows), 2, cap), np.uint8)
    for i, r in enumerate(rows):
        dl[i, :, : r.shape[1]] = r
    got = tgs._runs_presence(_t(dl), _t(valid))
    assert got.shape == pr.shape
    for i in range(len(rows)):
        assert torch.equal(got[i], tgs._runs_presence(_t(dl[i]), _t(valid)))
    np.testing.assert_array_equal(got.numpy(), pr)
    np.testing.assert_array_equal(tgs._pack_bits(got).numpy(), bits(pr))
