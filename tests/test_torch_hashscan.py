"""The hash engine's scoring in the port (kcftools_tpu_torch/ops/
hashscan.py) against the JAX package's (kcftools_tpu/ops/kmerize.py,
ops/lookup.py::table_lookup, parallel/sharded.py::_sharded_lookup,
engine/pipeline.py::gap_scan_core / score_windows_core), on the CPU.

The plain ``hash_probe`` must equal the JAX k-mers and lookups masked to
the valid k-mers, on tables built by the JAX package and on hand-made
ones (a key in both of its buckets, counts that wrap past 2^32, 1 and 2
buckets), shard by shard on the mesh's shard-local placement; the plain
``hash_scan`` must equal ``score_windows_core`` fed the same counts. Two
numpy models are written to the kernels' design (csrc/hashscan.cu): the
probe's 64-bit k-mer and bucket arithmetic, and the scan's decomposition
into chunk summaries of 32-bit words (invalid bytes as words, a word's
valid starts from it and the next word, run starts from the byte before
it; chunk sizes 1, 7, 64 and 1,024, combined 32 at a time). Every value
is an integer, so every comparison is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from kcftools_tpu.engine import pipeline as jpl
from kcftools_tpu.engine.hashtable import build_table, build_table_sharded
from kcftools_tpu.ops import kmerize as jkm
from kcftools_tpu.ops import lookup as jlk
from kcftools_tpu.parallel import sharded as jsh
from kcftools_tpu_torch.engine import pipeline as tpl
from kcftools_tpu_torch.engine.hashtable import bucket_hashes_np
from kcftools_tpu_torch.ops import hashscan as ths

from .test_torch_gapscan import (
    EMPTY,
    FULL,
    combine,
    popc,
    tree,
    word_mask,
    word_sum,
)
from .torch_hash_cases import (
    CHUNK,
    KS,
    LP,
    PAD,
    STRETCHES,
    counts_case,
    hand_table,
    kernel_kmers,
    kmer_valid,
    rolling_kmers,
    rows_case,
    stretch_edges_case,
    table_keys,
)

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

CHUNKS = [1, 7, 64, 1024]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_kmers(u8, k, both_strands):
    """(hi, lo) of every start, by the JAX package's kmerize."""
    valid = u8 < 4
    codes = jnp.asarray(np.where(valid, u8, 0).astype(np.uint32))
    w32, rcw32 = jkm.rolling_pack_u32(codes)
    parts = jkm.assemble_kmers(w32, rcw32, k, u8.shape[1] - PAD)
    return jkm.canonical_select(*parts) if both_strands else parts[:2]


def _probe_model(hi, lo, ok, tbl, nb_total, shard):
    """The probe kernel's bucket arithmetic in numpy: the two hashes of
    an nb_total-bucket table, b2 = (h1 & ~lm) | (h2 & lm), the uint32
    range test of ownership, the second row dropped where b2 == h1, both
    rows' matching slots summed in uint32; 0 where ``ok`` is false."""
    nb = tbl.shape[0]
    lm = np.uint32(nb - 1)
    h1, h2 = bucket_hashes_np(hi, lo, nb_total)
    h1, h2 = h1.reshape(hi.shape), h2.reshape(hi.shape)
    b2 = (h1 & ~lm) | (h2 & lm)
    base = np.uint32(shard * nb)
    out = np.zeros(hi.shape, np.uint32)
    with np.errstate(over="ignore"):
        for b, use in ((h1, True), (b2, b2 != h1)):
            local = b - base
            own = ok & use & (local < np.uint32(nb))
            rows = tbl[np.where(own, local, 0)]
            match = (rows[..., 0:4] == hi[..., None]) & (
                rows[..., 4:8] == lo[..., None])
            out += np.where(own, np.where(match, rows[..., 8:], 0).sum(
                -1, dtype=np.uint32), 0).astype(np.uint32)
    return out


# -- the probe --------------------------------------------------------------


@pytest.mark.parametrize("both_strands", [True, False], ids=["both", "fwd"])
@pytest.mark.parametrize("k", KS)
def test_probe_model_kmers_match_jax(k, both_strands):
    """The kernel's 64-bit k-mers (min of forward and reverse complement,
    split by 64-bit shifts) equal JAX kmerize's at every start whose k
    bytes are bases; k = 16 and 32 reach the shift and mask edges."""
    u8, _wl = rows_case(k, k)
    hi, lo, ok = kernel_kmers(u8, k, both_strands)
    jhi, jlo = (np.asarray(x) for x in _jax_kmers(u8, k, both_strands))
    np.testing.assert_array_equal(hi[ok], jhi[ok])
    np.testing.assert_array_equal(lo[ok], jlo[ok])
    if k in (16, 32):
        assert hi[ok].max() >= 1 << 31  # the top bit of a full half


# (Lp, the rows' alignment): whole stretches, and a row of 3,141 starts
# (ending mid-stretch) at an odd alignment, so tiles start off granules
ROLL_LAYOUTS = [(LP, 0), (LP + 5, 7)]


@functools.lru_cache(maxsize=None)
def _roll_case(k, both_strands, Lp):
    """The edge rows and the stretch-edge rows, their valid k-mers and
    the JAX kmerize keys (hi << 2 (k - 16) | lo) there."""
    u8, wl = rows_case(k + 2, k, Lp)
    eu8, ewl = stretch_edges_case(k + 3, k, Lp)
    u8, wl = np.concatenate([u8, eu8]), np.concatenate([wl, ewl])
    valid = kmer_valid(u8, wl, k)
    jhi, jlo = (np.asarray(x).astype(np.uint64)
                for x in _jax_kmers(u8, k, both_strands))
    jkey = (jhi << np.uint64(2 * max(k - 16, 0))) | jlo
    return u8, wl, valid, jkey


@pytest.mark.parametrize("stretch", STRETCHES)
@pytest.mark.parametrize("layout", ROLL_LAYOUTS,
                         ids=[f"Lp{lp}-align{a}" for lp, a in ROLL_LAYOUTS])
@pytest.mark.parametrize("both_strands", [True, False], ids=["both", "fwd"])
@pytest.mark.parametrize("k", KS)
def test_rolling_build_matches_jax(k, both_strands, layout, stretch):
    """The probe's rolling build (warp tiles staged as aligned granules,
    a lane's stretch of starts built from k - 1 bytes of prologue and
    one byte a start, a run count for validity) gives JAX kmerize's
    canonical (or forward) k-mer at exactly the valid starts: k-mers
    across stretch and tile edges, N runs shorter and longer than k,
    rows ending mid-stretch, the last valid start beside every stretch
    and tile edge, random bytes around the rows."""
    Lp, align = layout
    u8, wl, valid, jkey = _roll_case(k, both_strands, Lp)
    keys, live = rolling_kmers(u8, wl, k, both_strands, stretch, align)
    np.testing.assert_array_equal(live, valid)
    np.testing.assert_array_equal(keys[valid], jkey[valid])
    assert valid.sum() > 10_000


@pytest.mark.parametrize("both_strands", [True, False], ids=["both", "fwd"])
@pytest.mark.parametrize("k", KS)
def test_hash_probe_matches_jax(k, both_strands):
    """Plain ``hash_probe`` = JAX kmerize + table_lookup masked to the
    valid k-mers = the kernel's model, on a JAX-built table holding 70%
    of the rows' k-mers with counts >= 2^31."""
    u8, wl = rows_case(k + 1, k)
    keys, counts = table_keys(k, u8, wl, k, both_strands)
    table = build_table(keys, counts, k, both_strands=both_strands)
    valid = kmer_valid(u8, wl, k)
    hi, lo = _jax_kmers(u8, k, both_strands)
    want = np.where(valid, np.asarray(jlk.table_lookup(
        hi, lo, jnp.asarray(table.tbl))), 0).astype(np.uint32)
    before = ths.hash_probe.launches
    got = ths.hash_probe(_t(u8), _t(wl), tpl._table_tensor(table, "cpu"),
                         k=k, both_strands=both_strands)
    assert ths.hash_probe.launches == before  # no kernel on the CPU
    assert got.dtype == torch.int32 and got.shape == valid.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    model = _probe_model(*kernel_kmers(u8, k, both_strands),
                         table.tbl, table.n_buckets, 0)
    np.testing.assert_array_equal(np.where(valid, model, 0), want)
    assert (want != 0).sum() > valid.sum() // 2
    assert want.max() >= 1 << 31


@pytest.mark.parametrize("k", [16, 31])
@pytest.mark.parametrize("nb", [1, 2])
def test_hash_probe_hand_tables(nb, k):
    """Tables of 1 and 2 buckets (h1 == h2 all the time): a key in both
    of its buckets or twice in one, counts that wrap to 0x10, counts
    >= 2^31."""
    u8, wl = rows_case(nb, k)
    tbl = hand_table(u8, wl, k, True, nb)
    valid = kmer_valid(u8, wl, k)
    hi, lo = _jax_kmers(u8, k, True)
    want = np.where(valid, np.asarray(jlk.table_lookup(
        hi, lo, jnp.asarray(tbl))), 0).astype(np.uint32)
    got = ths.hash_probe(_t(u8), _t(wl), _t(tbl.view(np.int32)), k=k,
                         both_strands=True)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    model = _probe_model(*kernel_kmers(u8, k, True), tbl, nb, 0)
    np.testing.assert_array_equal(np.where(valid, model, 0), want)
    assert (want == 0x10).any() and (want >= 1 << 31).any()


@functools.lru_cache(maxsize=None)
def _sharded_case(t_axis):
    k = 31
    u8, wl = rows_case(40 + t_axis, k)
    keys, counts = table_keys(41, u8, wl, k, True)
    table = build_table_sharded(keys, counts, k, t_axis)
    return k, u8, wl, table, dict(zip(keys.tolist(), counts.tolist()))


@pytest.mark.parametrize("t_axis", [1, 2, 4])
def test_hash_probe_shards_match_jax_sharded_lookup(t_axis):
    """Each table shard's partial counts (``nb_total``, ``shard``) equal
    the JAX ``_sharded_lookup`` of that shard under ``shard_map`` (masked
    to the valid k-mers), and the kernel's model; their sum is every
    key's count."""
    k, u8, wl, table, cmap = _sharded_case(t_axis)
    nb_total = table.n_buckets
    nb = nb_total // t_axis
    valid = kmer_valid(u8, wl, k)
    hi, lo = _jax_kmers(u8, k, True)
    mesh = Mesh(np.array(jax.devices()[:t_axis]), ("table",))
    fn = shard_map(
        lambda h, l, tb: jsh._sharded_lookup(h, l, tb, nb_total)[None],
        mesh=mesh, in_specs=(PartitionSpec(), PartitionSpec(),
                             PartitionSpec("table", None)),
        out_specs=PartitionSpec("table"), check_vma=False)
    want = np.where(valid[None], np.asarray(jax.jit(fn)(
        hi, lo, jnp.asarray(table.tbl))), 0).astype(np.uint32)
    full = _t(table.tbl.view(np.int32))
    mhi, mlo, ok = kernel_kmers(u8, k, True)
    got = []
    for s in range(t_axis):
        part = ths.hash_probe(_t(u8), _t(wl), full[s * nb : (s + 1) * nb],
                              k=k, both_strands=True, nb_total=nb_total,
                              shard=s)
        got.append(part.numpy().view(np.uint32))
        model = _probe_model(mhi, mlo, ok, table.tbl[s * nb : (s + 1) * nb],
                             nb_total, s)
        np.testing.assert_array_equal(np.where(valid, model, 0), want[s])
    np.testing.assert_array_equal(np.stack(got), want)
    # every present key counted by exactly its owner
    n_lo = np.uint64(2 * (k - 16))
    key = (mhi.astype(np.uint64) << n_lo) | mlo.astype(np.uint64)
    exp = np.array([cmap.get(int(x), 0) for x in key[valid]], np.uint32)
    np.testing.assert_array_equal(np.stack(got).sum(0, dtype=np.uint32)[valid],
                                  exp)
    assert ((np.stack(got) != 0).sum(0) <= 1).all()


# -- the scan ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_scan(k, min_count, Lp=LP):
    """JAX ``score_windows_core`` over rows_case(k, k, Lp) fed
    counts_case's counts through its ``lookup_fn``: (8, B) int64."""
    u8, wl = rows_case(k, k, Lp)
    counts = counts_case(k + min_count, u8)
    valid = u8 < 4
    res = jpl.score_windows_core(
        jnp.asarray(np.where(valid, u8, 0).astype(np.uint32)),
        jnp.asarray(valid), jnp.asarray(wl.astype(np.int32)),
        lambda h, l: jnp.asarray(counts), k=k, min_count=min_count,
        both_strands=True)
    return np.stack([np.asarray(res[f]).astype(np.int64)
                     for f in jpl.FIELDS])


SCAN_CASES = [(k, mc) for k in KS for mc in (0, 1, 3)]


@pytest.mark.parametrize("k,min_count", SCAN_CASES,
                         ids=[f"k{k}-mc{mc}" for k, mc in SCAN_CASES])
def test_hash_scan_matches_jax(k, min_count):
    """Plain ``hash_scan`` = JAX ``score_windows_core`` with the same
    counts on every edge row (win_len 0, < k, = Lp - 32, all N, N at
    both ends, runs of k and k - 1, bases past win_len), min_count 0 /
    1 / 3, rows with no and with every k-mer present."""
    u8, wl = rows_case(k, k)
    counts = counts_case(k + min_count, u8)
    before = ths.hash_scan.launches
    got = ths.hash_scan(_t(u8), _t(counts.view(np.int32)), _t(wl), k=k,
                        min_count=min_count)
    assert ths.hash_scan.launches == before
    assert got.shape == (8, u8.shape[0]) and got.dtype == torch.int64
    want = _jax_scan(k, min_count)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[:, 1].any()  # the padding row: eight zeros
    total, observed = want[0], want[1]
    if min_count:
        assert ((observed == 0) & (total > 0)).any()
    assert ((observed == total) & (total > 0)).any()


class ScanModel:
    """The scan kernel's two passes over one row at chunk size ``chunk``:
    invalid bytes as 32-bit words (past the row: invalid); a word's
    valid starts = the zero bits of the OR of k shifts of it and the next
    word (the halo); run starts where the byte before is invalid (before
    position 0: yes); presence from the counts of the valid k-mers below
    n_out and win_len - k + 1; chunk summaries of word summaries in shuffle-
    tree order, with eff = starts + (k - 1) x run starts; pass 2 combines
    them 32 at a time."""

    def __init__(self, row, counts, win_len, k, min_count, chunk):
        self.Lp = row.shape[0]
        self.k = k
        n_words = -(-self.Lp // 32) + -(-chunk // 32) + 2
        bad = np.ones(32 * n_words, bool)
        bad[: self.Lp] = row >= 4
        self.inv = [int(w) for w in
                    np.packbits(bad, bitorder="little").view("<u4")]
        self.counts = counts.astype(np.int64)
        self.lim = min(self.Lp - PAD - 1, int(win_len) - k)
        self.min_count = min_count
        self.chunk = chunk

    def word(self, w, mask):
        """(summary, eff) of word w's starts inside ``mask``."""
        k = self.k
        w64 = self.inv[w] | self.inv[w + 1] << 32
        any_ = 0
        for t in range(k):
            any_ |= w64 >> t
        av = ~any_ & FULL
        before = 1 if w == 0 else self.inv[w - 1] >> 31
        starts = av & (((self.inv[w] << 1) & FULL) | before)
        av &= mask
        starts &= mask
        eff = popc(av) + (k - 1) * popc(starts)
        d = self.lim - 32 * w
        kv = av & (FULL if d >= 31 else ((2 << d) - 1 if d >= 0 else 0))
        pw, csum = 0, 0
        for b in range(32):
            if kv >> b & 1:
                c = int(self.counts[32 * w + b])
                if c >= self.min_count:
                    pw |= 1 << b
                    csum += c
        s = word_sum(pw, kv, k)
        return s[:6] + (csum,), eff

    def chunk_sum(self, c):
        lo = c * self.chunk
        hi = lo + self.chunk - 1
        lanes, eff = [], 0
        for w in range(lo >> 5, (hi >> 5) + 1):
            s, e = self.word(w, word_mask(w, lo, hi))
            lanes.append(s)
            eff += e
        return tree(lanes, self.k), eff

    def fields(self):
        chunks = [self.chunk_sum(c) for c in range(-(-self.Lp // self.chunk))]
        t, eff = EMPTY, 0
        for b in range(0, len(chunks), 32):
            grp = chunks[b : b + 32]
            t = combine(t, tree([g[0] for g in grp], self.k), self.k)
            eff += sum(g[1] for g in grp)
        nval, obs, lead, trail, var, dist, csum = t
        has = obs > 0
        return [nval, obs,
                var + (lead > 0) + (trail > 0) if has else int(nval > 0),
                dist, lead if has else 0, trail if has else nval, csum, eff]


MODEL_CASES = [(11, 0), (31, 1), (32, 3)]


@pytest.mark.parametrize("k,min_count", MODEL_CASES,
                         ids=[f"k{k}-mc{mc}" for k, mc in MODEL_CASES])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_scan_model_matches_jax(chunk, k, min_count):
    """The kernel's decomposition equals JAX ``gap_scan_core`` and the
    count sum, over rows several chunks long."""
    u8, wl = rows_case(k, k)
    counts = counts_case(k + min_count, u8)
    got = np.array([ScanModel(u8[r], counts[r], wl[r], k, min_count,
                              chunk).fields()
                    for r in range(u8.shape[0])], np.int64).T
    np.testing.assert_array_equal(got, _jax_scan(k, min_count))


M64 = (1 << 64) - 1


def inv4(x):
    """The kernel's inv4: __vcmpgeu4 against 4 (0xff a byte >= 4), the
    bytes' top bits gathered by one multiply into bits 0-3."""
    m = 0
    for b in range(4):
        if (x >> 8 * b) & 0xFF >= 4:
            m |= 0xFF << 8 * b
    return (((m & 0x80808080) * 0x00204081) & FULL) >> 28


class OneLaunchModel:
    """The one-launch scan kernel over a batch, as it reads memory: the
    rows lie in one buffer from byte ``align`` (mod 16) with random bytes
    around them. A lane's 32 bytes arrive as the aligned 16-byte granules
    that hold them (one that starts past the row reads as invalid; the
    bytes past the row are masked), each turned into 16 invalid bits by
    ``inv4``; a lane's valid starts are the AND of k shifts of its valid
    bits and the next lane's, by doubling; in step j a lane reads the four
    counts at 128 j + 4 lane where one of them is a valid k-mer (all four
    with 16-byte loads: checked to lie in the row), and its nibble of
    presence reaches the word's owner lane by the kernel's shuffles. A
    block spans min(chunks, ``warps``) chunks, a warp a chunk, combined
    in warp order; a row of several blocks stores each block's summary,
    and the block that draws the last ticket combines them in position
    order, 32 a step."""

    def __init__(self, u8, counts, win_len, k, min_count, warps, align,
                 seed=0):
        B, self.Lp = u8.shape
        self.n_out = self.Lp - PAD
        self.k, self.min_count = k, min_count
        self.counts, self.win_len = counts.astype(np.int64), win_len
        rng = np.random.default_rng(seed)
        self.mem = rng.integers(0, 256, 16 + align + B * self.Lp + 64,
                                dtype=np.int64).astype(np.uint8)
        self.base = 16 + align
        self.mem[self.base : self.base + B * self.Lp] = u8.ravel()
        self.vec = self.n_out % 4 == 0
        self.n_chunks = -(-self.Lp // CHUNK)
        self.wpb = min(self.n_chunks, warps)
        self.bpr = -(-self.n_chunks // self.wpb)

    def inv16(self, g):
        w = self.mem[g : g + 16].view("<u4")
        return sum(inv4(int(x)) << 4 * i for i, x in enumerate(w))

    def inv_word(self, row, pos):
        if pos >= self.Lp:
            return FULL
        row0 = self.base + row * self.Lp
        off = (row0 + pos) & 15
        g = row0 + pos - off
        end = row0 + self.Lp
        m = self.inv16(g)
        m |= (self.inv16(g + 16) if g + 16 < end else 0xFFFF) << 16
        if off:
            m |= (self.inv16(g + 32) if g + 32 < end else 0xFFFF) << 32
        inv = (m >> off) & FULL
        left = self.Lp - pos
        if left < 32:
            inv |= (FULL << left) & FULL
        return inv

    def chunk_sum(self, row, lo):
        """(summary, eff) of the warp's chunk from position lo."""
        k = self.k
        inv = [self.inv_word(row, lo + 32 * ln) for ln in range(32)]
        nxt = inv[1:] + [self.inv_word(row, lo + CHUNK)]
        first = 1 if lo == 0 else int(self.mem[self.base + row * self.Lp
                                               + lo - 1] >= 4)
        before = [first] + [w >> 31 for w in inv[:-1]]
        lim = min(self.n_out - 1, int(self.win_len[row]) - k)
        kv, eff = [], 0
        for ln in range(32):
            v = ~((nxt[ln] << 32) | inv[ln]) & M64
            acc, at, b = M64, 0, 1
            while b <= k:
                if k & b:
                    acc &= v >> at
                    at += b
                v &= v >> b
                b <<= 1
            av = acc & FULL
            starts = av & (((inv[ln] << 1) & FULL) | before[ln])
            eff += popc(av) + (k - 1) * popc(starts)
            d = lim - (lo + 32 * ln)
            kv.append(av & (FULL if d >= 31 else
                            ((2 << d) - 1 if d >= 0 else 0)))
        pw, csum = [0] * 32, [0] * 32
        for j in range(8):
            g = []
            for ln in range(32):
                nk = (kv[4 * j + ln // 8] >> 4 * (ln & 7)) & 15
                q = lo + 128 * j + 4 * ln
                nib = 0
                if nk and self.vec:
                    assert q + 3 < self.n_out  # a 16-byte load in the row
                for b in range(4):
                    if nk >> b & 1:
                        c = int(self.counts[row, q + b])
                        if c >= self.min_count:
                            nib |= 1 << b
                            csum[ln] += c
                g.append(nib << 4 * (ln & 7))
            words = [functools.reduce(int.__or__, g[8 * m : 8 * m + 8])
                     for m in range(4)]
            for ln in range(4 * j, 4 * j + 4):
                pw[ln] = words[ln & 3]
        lanes = [word_sum(pw[ln], kv[ln], k)[:6] + (csum[ln],)
                 for ln in range(32)]
        return tree(lanes, k), eff

    def block_sum(self, row, span):
        parts, eff = [EMPTY] * 32, 0
        for w in range(self.wpb):
            c = span * self.wpb + w
            if c < self.n_chunks:
                parts[w], e = self.chunk_sum(row, c * CHUNK)
                eff += e
        return tree(parts, self.k), eff

    def row_fields(self, row):
        """The row's eight fields: its blocks' summaries (stored by each
        block in any order) combined in position order, 32 a step."""
        blocks = [self.block_sum(row, s) for s in range(self.bpr)]
        t, eff = EMPTY, 0
        for c in range(0, self.bpr, 32):
            grp = [b[0] for b in blocks[c : c + 32]]
            t = combine(t, tree(grp + [EMPTY] * (32 - len(grp)), self.k),
                        self.k)
            eff += sum(b[1] for b in blocks[c : c + 32])
        nval, obs, lead, trail, var, dist, csum = t
        has = obs > 0
        return [nval, obs,
                var + (lead > 0) + (trail > 0) if has else int(nval > 0),
                dist, lead if has else 0, trail if has else nval, csum, eff]


# (Lp, the rows' alignment): 4 chunks; 4 chunks with n_out % 4 != 0 (the
# counts' one-at-a-time loads) at an odd alignment; 18 chunks
SCAN_LAYOUTS = [(LP, 0), (LP + 5, 3), (17 * CHUNK + 64, 0)]


@pytest.mark.parametrize("k,min_count", MODEL_CASES,
                         ids=[f"k{k}-mc{mc}" for k, mc in MODEL_CASES])
@pytest.mark.parametrize("layout", SCAN_LAYOUTS,
                         ids=[f"Lp{lp}-align{a}" for lp, a in SCAN_LAYOUTS])
@pytest.mark.parametrize("warps", [1, 2, 16])
def test_one_launch_scan_model_matches_jax(warps, layout, k, min_count):
    """The one-launch kernel's decomposition (16-byte granules, inv4
    byte compares, AND by doubling, counts in aligned fours, presence by
    shuffles, block spans of 1, 2 and up to 16 chunks, the last block's
    combine in position order) equals JAX ``gap_scan_core`` and the count
    sum."""
    Lp, align = layout
    u8, wl = rows_case(k, k, Lp)
    counts = counts_case(k + min_count, u8)
    model = OneLaunchModel(u8, counts, wl, k, min_count, warps, align)
    got = np.array([model.row_fields(r) for r in range(u8.shape[0])],
                   np.int64).T
    np.testing.assert_array_equal(got, _jax_scan(k, min_count, Lp))


# -- the batch, and the argument checks -------------------------------------


@pytest.mark.parametrize("both_strands", [True, False], ids=["both", "fwd"])
def test_score_u8_batch_matches_jax(both_strands):
    """The port's batch (``hash_probe`` then ``hash_scan``) equals the JAX
    ``_score_u8_batch`` on the edge rows."""
    k = 31
    u8, wl = rows_case(7, k)
    keys, counts = table_keys(8, u8, wl, k, both_strands)
    table = build_table(keys, counts, k, both_strands=both_strands)
    want = np.asarray(jpl._score_u8_batch(
        jnp.asarray(u8), jnp.asarray(wl.astype(np.int32)),
        jnp.asarray(table.tbl), k=k, min_count=2,
        both_strands=both_strands))
    got = tpl._score_u8_batch(_t(u8), _t(wl), tpl._table_tensor(table, "cpu"),
                              k=k, min_count=2, both_strands=both_strands)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[1].sum() > 0


def _probe_args():
    u8, wl = rows_case(3, 31)
    keys, counts = table_keys(3, u8, wl, 31, True)
    table = build_table(keys, counts, 31)
    return [_t(u8), _t(wl), _t(table.tbl.view(np.int32))]


def _scan_args():
    u8, wl = rows_case(3, 31)
    return [_t(u8), _t(counts_case(3, u8).view(np.int32)), _t(wl)]


BAD = [
    ("probe", 0, lambda t: t.int(), {}, TypeError),  # rows not uint8
    ("probe", 0, lambda t: t[0], {}, TypeError),  # rows not 2-D
    ("probe", 0, lambda t: t[:, :20].contiguous(), {}, ValueError),  # < PAD
    ("probe", 0, lambda t: t.t().contiguous().t(), {}, ValueError),
    ("probe", 1, lambda t: t.int(), {}, TypeError),  # int32 lengths
    ("probe", 1, lambda t: t[:-1], {}, TypeError),  # lengths of B - 1 rows
    ("probe", 2, lambda t: t[:, :8].contiguous(), {}, TypeError),  # width
    ("probe", 2, lambda t: t.long(), {}, TypeError),  # table not int32
    ("probe", 2, lambda t: t[:-1], {}, ValueError),  # nb not a power of 2
    ("probe", None, None, {"k": 33}, ValueError),
    ("probe", None, None, {"nb_total": 3}, ValueError),
    ("probe", None, None, {"shard": 1}, ValueError),  # one shard only
    ("scan", 1, lambda t: t[:, :-1].contiguous(), {}, TypeError),  # width
    ("scan", 1, lambda t: t.long(), {}, TypeError),  # counts not int32
    ("scan", 2, lambda t: t[:-1], {}, TypeError),
    ("scan", None, None, {"k": 0}, ValueError),
]


@pytest.mark.parametrize("mode,arg,bad,kw,exc", BAD,
                         ids=[f"{m}-{i}-{e.__name__}"
                              for i, (m, _a, _b, _k, e) in enumerate(BAD)])
def test_wrapper_checks_raise(mode, arg, bad, kw, exc):
    args = _probe_args() if mode == "probe" else _scan_args()
    if arg is not None:
        args[arg] = bad(args[arg])
    base = ({"k": 31, "both_strands": True} if mode == "probe"
            else {"k": 31, "min_count": 1})
    fn = ths.hash_probe if mode == "probe" else ths.hash_scan
    with pytest.raises(exc):
        fn(*args, **{**base, **kw})
