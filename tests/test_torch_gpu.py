"""The port's CUDA kernel and device engines on the card.

Every test here needs an NVIDIA GPU and skips without one. This file
imports no jax, so that it runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py sets up jax for the other tests).
The CPU tests hold the plain versions used here against the JAX
package; these hold the kernel against the plain versions.
"""

import numpy as np
import pytest
import torch

from kcftools_tpu_torch.engine.encode import canonicalize, pack_kmers
from kcftools_tpu_torch.engine.hashtable import build_table
from kcftools_tpu_torch.engine.windows import pad_batch_varlen, tiling_windows
from kcftools_tpu_torch.engine import device_prefix as tdp
from kcftools_tpu_torch.engine import pipeline as tpl
from kcftools_tpu_torch.engine.device_join import (
    DeviceJoinScorer,
    pack_tiles_host,
)
from kcftools_tpu_torch.engine.hashtable import build_table_sharded
from kcftools_tpu_torch.ops import gapscan as tgs
from kcftools_tpu_torch.ops import hashscan as ths
from kcftools_tpu_torch.ops import lookup as tlk
from kcftools_tpu_torch.ops import pjoin as tpj
from kcftools_tpu_torch.ops import route as trt

from .torch_gapscan_cases import (
    LONG_N,
    LONG_WINDOW,
    N,
    ODD_N,
    QUAD,
    SHORT_QUADS,
    bits,
    join_case,
    long_rows_case,
    long_runs_case,
    rows_case,
    runs_case,
    slabs_case,
)
from . import torch_hash_cases as thc
from . import torch_route_cases as trc
from .torch_join_cases import EDGE_SHAPES, hard_join_operands, layout_width

_TOP32 = np.uint64(0xFFFFFFFF00000000)  # k=32 T^16A^16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["u32", "packed"])
def test_pjoin_kernel_matches_ref(cuda_device, packed):
    rng = np.random.default_rng(11)
    k = 32
    keys = np.unique(np.concatenate([
        rng.integers(0, 1 << 63, 300_000, dtype=np.uint64) << np.uint64(1),
        np.array([0, _TOP32], np.uint64),
    ]))
    if packed:
        counts = rng.integers(1, 256, keys.shape[0]).astype(np.uint32)
    else:
        counts = rng.integers(1, 1 << 32, keys.shape[0],
                              dtype=np.uint64).astype(np.uint32)
    th, tl, tc, _, _ = tpj.tile_sorted(keys, k, 9, counts=counts)
    qh, ql, _, rank, part = tpj.tile_sorted(keys[::2], k, 9)
    tcw = tpj.pack_planar(tc) if packed else tc
    ops = [tpj.as_i32(a).to(cuda_device) for a in (qh, ql, th, tl, tcw)]
    name = "launches_packed" if packed else "launches_u32"
    before = getattr(tpj.pjoin_join, name)
    got = tpj.pjoin_join(*ops, packed=packed)
    torch.cuda.synchronize()
    assert getattr(tpj.pjoin_join, name) == before + 1
    assert torch.equal(got, tpj.pjoin_join_ref(*ops, packed=packed))
    assert np.array_equal(
        got.cpu().numpy().view(np.uint32)[part, rank], counts[::2]
    )


@pytest.mark.cuda
def test_pjoin_kernel_wide_table_chunks(cuda_device):
    """Tt = 2560: the rows and their hash table do not fit the staged
    variant's shared memory, so the chunked variant builds each
    partition's table twice (2,048 keys, then 512)."""
    rng = np.random.default_rng(3)
    P, Tq, Tt = 8, 640, 2560
    th = rng.integers(0, 1 << 32, (P, Tt), dtype=np.uint64).astype(np.uint32)
    tl = rng.integers(0, 1 << 32, (P, Tt), dtype=np.uint64).astype(np.uint32)
    tc = rng.integers(1, 1 << 32, (P, Tt), dtype=np.uint64).astype(np.uint32)
    cols = rng.integers(0, Tt, (P, Tq))
    qh = np.take_along_axis(th, cols, 1)
    ql = np.take_along_axis(tl, cols, 1)
    for packed, cnt in ((False, tc), (True, tpj.pack_planar(tc & 0xFF))):
        ops = [tpj.as_i32(a).to(cuda_device) for a in (qh, ql, th, tl, cnt)]
        got = tpj.pjoin_join(*ops, packed=packed)
        assert torch.equal(got, tpj.pjoin_join_ref(*ops, packed=packed))


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["u32", "packed"])
@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=["x".join(map(str, s)) for s in EDGE_SHAPES])
def test_pjoin_kernel_holds_the_contract(cuda_device, shape, packed):
    """Duplicate keys that sum, uint32 sums that wrap, the all-ones key
    (the kernel's EMPTY marker) as a table key and as a query, unsorted
    rows, every variant and width: bit-exact against the plain join."""
    P, Tq, Tt = shape
    Tt = layout_width(Tt, packed)
    arrs = hard_join_operands(P + Tt, P, Tq, Tt, packed)
    ops = [tpj.as_i32(a).to(cuda_device) for a in arrs]
    got = tpj.pjoin_join(*ops, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(got, tpj.pjoin_join_ref(*ops, packed=packed))


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["u32", "packed"])
def test_pjoin_kernel_unaligned_operands(cuda_device, packed):
    """Contiguous operands that start 4 bytes past an aligned address take
    the kernel's 4-byte copies."""
    P, Tq, Tt = 37, 256, 512
    arrs = hard_join_operands(7, P, Tq, Tt, packed)
    ops = []
    for a in arrs:
        buf = torch.empty(a.size + 1, dtype=torch.int32, device=cuda_device)
        view = buf[1:].view(a.shape)
        view.copy_(tpj.as_i32(a))
        assert view.data_ptr() % 16 != 0
        ops.append(view)
    got = tpj.pjoin_join(*ops, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(got, tpj.pjoin_join_ref(*ops, packed=packed))


class _Ref:
    def __init__(self, kmers):
        self.kmers = kmers


@pytest.mark.cuda
@pytest.mark.parametrize("counts_hi", [False, True])
def test_device_join_scorer_gpu_matches_cpu(cuda_device, counts_hi):
    rng = np.random.default_rng(5)
    k = 31
    L = 200_000
    genome = rng.integers(0, 4, L).astype(np.uint8)
    valid = rng.random(L) > 0.002
    km, kv = pack_kmers(genome, valid, k)
    canon = canonicalize(km, k)
    refk = np.unique(canon[kv])
    r_idx = np.full(canon.shape[0], -1, np.int32)
    r_idx[kv] = np.searchsorted(refk, canon[kv]).astype(np.int32)
    starts, ends = tiling_windows(L, 5000, k)
    s = genome.copy()
    m = rng.random(L) < 0.01
    s[m] = (s[m] + 1) % 4
    km2, kv2 = pack_kmers(s, valid, k)
    db, dbc = np.unique(canonicalize(km2[kv2], k), return_counts=True)
    dbc = dbc.astype(np.uint32) * np.uint32(1000 if counts_hi else 7)
    out = {}
    before = tgs.slabs_scan_join.launches
    for dev in (torch.device("cpu"), cuda_device):
        sc = DeviceJoinScorer(_Ref(refk), k, dev, min_count=2)
        sc.add_chrom("c", r_idx, starts, ends)
        sc.submit(0, refk, db, dbc)
        out[dev.type] = sc.collect(0)["c"]
    assert tgs.slabs_scan_join.launches == before + 1  # every slab at once
    for f, want in out["cpu"].items():
        np.testing.assert_array_equal(out["cuda"][f], want, err_msg=f)
    assert out["cuda"]["observed"].sum() > 0


def _genome_case(rng, L, k, snp=0.01):
    """A genome's reference index and one sample's sorted table."""
    genome = rng.integers(0, 4, L).astype(np.uint8)
    valid = rng.random(L) > 0.002
    km, kv = pack_kmers(genome, valid, k)
    canon = canonicalize(km, k)
    refk = np.unique(canon[kv])
    r_idx = np.full(canon.shape[0], -1, np.int32)
    r_idx[kv] = np.searchsorted(refk, canon[kv]).astype(np.int32)
    s = genome.copy()
    m = rng.random(L) < snp
    s[m] = (s[m] + 1) % 4
    km2, kv2 = pack_kmers(s, valid, k)
    db, dbc = np.unique(canonicalize(km2[kv2], k), return_counts=True)
    return genome, valid, refk, r_idx, db, dbc.astype(np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("uplink,kind", [("runs", "runs"),
                                         ("bitmap", "bits")])
def test_device_prefix_scorer_gpu_matches_cpu(cuda_device, monkeypatch,
                                              uplink, kind):
    """Three samples in one group (counts > 255 in one of them), two
    slabs, min_count 2: the scorer on the card equals it on the CPU."""
    monkeypatch.setenv("KCFTOOLS_DPREFIX_UPLINK", uplink)
    monkeypatch.setenv("KCFTOOLS_DPREFIX_SLAB", str(1 << 17))
    rng = np.random.default_rng(9)
    k = 31
    _g, _v, refk, r_idx, db, dbc = _genome_case(rng, 200_000, k)
    starts, ends = tiling_windows(r_idx.shape[0] + k - 1, 5000, k)
    keep = rng.random(db.shape[0]) > 0.005
    tables = [(db, dbc * np.uint32(3)), (db, dbc * np.uint32(500)),
              (db[keep], dbc[keep])]
    fn = tdp._score_runs if kind == "runs" else tdp._score_batch
    scan = tgs.runs_scan if kind == "runs" else tgs.rows_scan
    before = fn.cuda_calls
    scans = scan.launches
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        sc = tdp.DevicePrefixScorer(None, k, dev, min_count=2, batch=3)
        sc.add_chrom("c", r_idx, starts, ends)
        for key, (d, c) in enumerate(tables):
            sc.submit(key, refk, d, c)
        out[dev.type] = [sc.collect(key)["c"] for key in range(3)]
        assert sc.programs_run == {kind}
        assert len(sc._layout.slabs) == 2
        sc.close()
    assert fn.cuda_calls == before + 2  # one call per slab
    assert scan.launches == scans + 2  # all 3 rows in one launch
    for got, want in zip(out["cuda"], out["cpu"]):
        for f, w in want.items():
            np.testing.assert_array_equal(got[f], w, err_msg=f)
    assert out["cuda"][0]["observed"].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("both_strands", [True, False])
def test_window_scorer_gpu_matches_cpu(cuda_device, both_strands):
    """Spliced-feature-like windows of 20..6000 bases, counts up to
    2^32 - 1, through the hash engine on the card and on the CPU."""
    rng = np.random.default_rng(13)
    k = 25
    genome, valid, _r, _i, db, dbc = _genome_case(rng, 100_000, k)
    if not both_strands:
        km, kv = pack_kmers(genome, valid, k)
        db, dbc = np.unique(km[kv], return_counts=True)
        dbc = dbc.astype(np.uint32)
    dbc[::5] = rng.integers(1 << 31, 1 << 32, dbc[::5].shape[0],
                            dtype=np.uint64).astype(np.uint32)
    table = build_table(db, dbc, k, both_strands=both_strands)
    lens = rng.integers(20, 6000, 40)
    at = rng.integers(0, 100_000 - 6000, 40)
    pad = 8192
    bc, bv, wl = pad_batch_varlen(
        [genome[a : a + n] for a, n in zip(at, lens)],
        [valid[a : a + n] for a, n in zip(at, lens)], pad,
    )
    before = (tlk.table_lookup.cuda_calls, ths.hash_probe.launches,
              ths.hash_scan.launches)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        out[dev.type] = tpl.WindowScorer(table, dev, min_count=2).score_batch(
            bc, bv, wl)
    # one launch of each kernel; the plain lookup never ran on the card
    assert (tlk.table_lookup.cuda_calls, ths.hash_probe.launches,
            ths.hash_scan.launches) == (before[0], before[1] + 1,
                                        before[2] + 1)
    for f, want in out["cpu"].items():
        np.testing.assert_array_equal(out["cuda"][f], want, err_msg=f)
    assert out["cuda"]["count_sum"].max() >= 1 << 31


def _cuda_slots(dev, n=4):
    """n mesh slots on one card (a virtual mesh)."""
    from kcftools_tpu_torch.torchinit import Slot

    return [Slot(i, dev, 0) for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("data,table", [(4, 1), (2, 2), (1, 4)])
def test_sharded_scorer_gpu_matches_cpu(cuda_device, data, table):
    """The mesh-sharded hash engine on 4 slots of the card against the
    single-device scorer on the CPU."""
    from kcftools_tpu_torch.parallel.mesh import make_mesh
    from kcftools_tpu_torch.parallel.sharded import ShardedWindowScorer

    rng = np.random.default_rng(17)
    k = 31
    genome, valid, _r, _i, db, dbc = _genome_case(rng, 100_000, k)
    table_ = build_table(db, dbc, k)
    at = rng.integers(0, 100_000 - 5000, 37)
    bc, bv, wl = pad_batch_varlen([genome[a : a + 5000] for a in at],
                                  [valid[a : a + 5000] for a in at], 5032)
    want = tpl.WindowScorer(table_, torch.device("cpu")).score_batch(
        bc, bv, wl)
    before = (tlk.table_lookup.cuda_calls, ths.hash_probe.launches,
              ths.hash_scan.launches)
    mesh = make_mesh(data, table, devices=_cuda_slots(cuda_device))
    got = ShardedWindowScorer(table_, mesh).score_batch(bc, bv, wl)
    # a probe per table shard and data row, a scan per data row
    assert (tlk.table_lookup.cuda_calls, ths.hash_probe.launches,
            ths.hash_scan.launches) == (before[0], before[1] + data * table,
                                        before[2] + data)
    for f, w in want.items():
        np.testing.assert_array_equal(got[f], w, err_msg=f)


@pytest.mark.cuda
def test_mesh_join_gpu_matches_single(cuda_device):
    """MeshJoinScorer on a (2, 2) mesh of the card: one join launch per
    table shard and per sample, results equal to DeviceJoinScorer."""
    from kcftools_tpu_torch.engine.device_join import MeshJoinScorer
    from kcftools_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(23)
    k = 31
    _g, _v, refk, r_idx, db, dbc = _genome_case(rng, 300_000, k)
    starts, ends = tiling_windows(r_idx.shape[0] + k - 1, 5000, k)
    mesh = make_mesh(2, 2, devices=_cuda_slots(cuda_device))
    out = {}
    for name, sc in (
        ("single", DeviceJoinScorer(_Ref(refk), k, cuda_device)),
        ("mesh", MeshJoinScorer(_Ref(refk), k, mesh)),
    ):
        sc.add_chrom("c", r_idx, starts, ends)
        before = tpj.pjoin_join.launches_packed + tpj.pjoin_join.launches_u32
        for key, counts in enumerate((dbc, dbc * np.uint32(300))):
            sc.submit(key, refk, db, counts)
        launches = (tpj.pjoin_join.launches_packed
                    + tpj.pjoin_join.launches_u32 - before)
        out[name] = [sc.collect(key)["c"] for key in range(2)]
        assert launches == (2 if name == "single" else 4)
    for got, want in zip(out["mesh"], out["single"]):
        for f, w in want.items():
            np.testing.assert_array_equal(got[f], w, err_msg=f)


@pytest.mark.cuda
def test_device_prefix_pool_gpu_matches_cpu(cuda_device, monkeypatch):
    """dprefix over 4 slots of the card (slabs spread, then a pool of
    slots per slab) against one CPU device."""
    monkeypatch.setenv("KCFTOOLS_DPREFIX_SLAB", str(1 << 16))
    rng = np.random.default_rng(29)
    k = 31
    _g, _v, refk, r_idx, db, dbc = _genome_case(rng, 100_000, k)
    starts, ends = tiling_windows(r_idx.shape[0] + k - 1, 5000, k)
    tables = [(db, dbc * np.uint32(m)) for m in (1, 3, 700)]
    before = tdp._score_runs.cuda_calls
    out = {}
    for name, kw in (("cpu", {"device": torch.device("cpu")}),
                     ("cuda", {"devices": _cuda_slots(cuda_device)})):
        sc = tdp.DevicePrefixScorer(None, k, batch=3, **kw)
        sc.add_chrom("c", r_idx, starts, ends)
        for key, (d, c) in enumerate(tables):
            sc.submit(key, refk, d, c)
        out[name] = [sc.collect(key)["c"] for key in range(3)]
        if name == "cuda":
            assert len(sc.devices_used()) == 4
        sc.close()
    assert tdp._score_runs.cuda_calls > before
    for got, want in zip(out["cuda"], out["cpu"]):
        for f, w in want.items():
            np.testing.assert_array_equal(got[f], w, err_msg=f)


@pytest.mark.cuda
def test_dryrun_multichip_gpu(cuda_device, monkeypatch):
    from kcftools_tpu_torch.dryrun import dryrun_multichip

    monkeypatch.setenv("KCFTOOLS_TORCH_DEVICE", "cuda:0")
    monkeypatch.setenv("KCFTOOLS_TORCH_VIRTUAL_DEVICES", "4")
    dryrun_multichip(4)


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.fixture
def no_plain_scan(monkeypatch):
    """A CUDA tensor must never reach the plain scan: the wrappers find
    every plain version raising. Returns the plain versions by mode, each
    run with the real plain versions in place (they call each other)."""
    names = {"join": "slab_scan_join_ref", "rows": "rows_scan_ref",
             "slabs": "slabs_scan_join_ref", "runs": "runs_scan_ref"}
    real = {name: getattr(tgs, name) for name in names.values()}

    def boom(*_a, **_k):
        raise AssertionError("a CUDA tensor reached the plain scan")

    def place(fns):
        for name in names.values():
            setattr(tgs, name, fns.get(name, boom))

    def plain(name):
        def run(*args, **kw):
            place(real)
            try:
                return real[name](*args, **kw)
            finally:
                place({})
        return run

    for name in names.values():
        monkeypatch.setattr(tgs, name, boom)
    return {mode: plain(name) for mode, name in names.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("min_count", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_gapscan_join_kernel_matches_plain(cuda_device, no_plain_scan, seed,
                                           min_count):
    """The JOIN mode on every window kind (inverted ones too), counts at
    and above 2^31, bit-exact against the plain version; one launch."""
    routed, slot_map, valid, ws, wh = join_case(seed, min_count,
                                                inverted=True)
    args = _on(cuda_device, routed.view(np.int32), slot_map[None],
               bits(valid)[None], ws[None], wh[None])
    before = tgs.slabs_scan_join.launches
    got = tgs.slabs_scan_join(*args, k=31, min_count=min_count)
    torch.cuda.synchronize()
    assert tgs.slabs_scan_join.launches == before + 1
    want = no_plain_scan["slabs"](*args, k=31, min_count=min_count)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [17, 31, 45])
def test_gapscan_rows_kernel_matches_plain(cuda_device, no_plain_scan, k):
    """The ROWS mode: four rows (dense, sparse, all absent, all present)
    in one launch, bit-exact against the plain version."""
    pr, valid, ws, wh = rows_case(30 + k, k, inverted=True)
    args = _on(cuda_device, bits(pr), bits(valid), ws, wh)
    before = tgs.rows_scan.launches
    got = tgs.rows_scan(*args, k=k)
    torch.cuda.synchronize()
    assert tgs.rows_scan.launches == before + 1
    assert torch.equal(got, no_plain_scan["rows"](*args, k=k))


@pytest.mark.cuda
@pytest.mark.parametrize("min_count", [1, 3])
def test_gapscan_slabs_kernel_matches_plain(cuda_device, no_plain_scan,
                                            min_count):
    """The JOIN mode over three slabs of one sample (each its own slot
    map, valid bitmap and windows) in one launch: bit-exact against the
    plain version slab by slab."""
    routed, slot_maps, valid, ws, wh = slabs_case(min_count, min_count,
                                                  inverted=True)
    args = _on(cuda_device, routed.view(np.int32), slot_maps, bits(valid),
               ws, wh)
    before = tgs.slabs_scan_join.launches
    got = tgs.slabs_scan_join(*args, k=31, min_count=min_count)
    torch.cuda.synchronize()
    assert tgs.slabs_scan_join.launches == before + 1
    want = no_plain_scan["slabs"](*args, k=31, min_count=min_count)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [17, 31, 45])
def test_gapscan_runs_kernel_matches_plain(cuda_device, no_plain_scan, k):
    """The RUNS mode: fillers, continuations, zero padding, runs that end
    at and start past n, an all-absent row and an empty stream, all rows
    in one launch, bit-exact against the plain decode and scan."""
    dl, valid, ws, wh = runs_case(70 + k, k)
    args = _on(cuda_device, dl, bits(valid), ws, wh)
    before = tgs.runs_scan.launches
    got = tgs.runs_scan(*args, k=k)
    torch.cuda.synchronize()
    assert tgs.runs_scan.launches == before + 1
    assert torch.equal(got, no_plain_scan["runs"](*args, k=k))


@pytest.mark.cuda
def test_gapscan_runs_kernel_on_encoder_streams(cuda_device, no_plain_scan):
    """Streams of the native kcf_bits_to_runs, one run segment of the
    kernel split many times (a row of ~1,200 short runs), equal
    the plain version and the bitmap scan of the same presence."""
    from kcftools_tpu_torch.native import bits_to_runs

    pr, valid, ws, wh = rows_case(81, 31)
    pr[0, 64 : 64 + 2 * 1300] = True
    pr[0, 64 : 64 + 2 * 1300 : 2] = False  # ~1,200 short runs
    pr[0] &= valid
    streams, longest = [], 0
    for row in pr:
        d, ln, n_runs = bits_to_runs(bits(row), bits(valid), N, 8192)
        assert n_runs >= 0
        streams.append(np.stack([d, ln]))
        longest = max(longest, n_runs)
    assert longest > 1024
    dl = np.zeros((len(streams), 2, max(s.shape[1] for s in streams) + 3),
                  np.uint8)
    for r, st in enumerate(streams):
        dl[r, :, : st.shape[1]] = st
    args = _on(cuda_device, dl, bits(valid), ws, wh)
    got = tgs.runs_scan(*args, k=31)
    assert torch.equal(got, no_plain_scan["runs"](*args, k=31))
    rows = tgs.rows_scan(*_on(cuda_device, bits(pr), bits(valid), ws, wh),
                         k=31)
    assert torch.equal(got, rows)


@pytest.mark.cuda
def test_gapscan_main_width(cuda_device):
    """One slab at the main path's width (2^24 positions, 4,970-position
    tiling windows padded to 4,096 entries) in both modes, bit-exact."""
    n, width = 1 << 24, 5000 - 31 + 1
    g = torch.Generator(device=cuda_device).manual_seed(0)
    valid = torch.rand(n, generator=g, device=cuda_device) > 0.02
    valid[n // 3 : n // 3 + 5000] = False
    routed = torch.randint(0, 50, (1 << 22,), generator=g,
                           device=cuda_device, dtype=torch.int32)
    routed[::9] = torch.randint(-(1 << 31), 0, routed[::9].shape,
                                generator=g, device=cuda_device,
                                dtype=torch.int32)  # counts >= 2^31
    slot_map = torch.randint(0, routed.numel(), (n,), generator=g,
                             device=cuda_device, dtype=torch.int32)
    vb = tgs._pack_bits(valid[None])[0]
    ws = torch.arange(0, n - width, width, device=cuda_device)
    pad = 4096 - ws.numel()
    ws = torch.cat([ws, torch.zeros(pad, dtype=torch.int64,
                                    device=cuda_device)])
    wh = torch.where(ws > 0, ws + width - 1, 0)
    wh[0] = width - 1
    got = tgs.slabs_scan_join(routed, slot_map[None], vb[None], ws[None],
                              wh[None], k=31, min_count=3)[0]
    want = tgs.slab_scan_join_ref(routed, slot_map, vb, ws, wh, k=31,
                                  min_count=3)
    assert torch.equal(got, want)
    assert int(got[0].sum()) > n // 2
    pres = (torch.rand((2, n), generator=g, device=cuda_device) < 0.9) & valid
    pb = tgs._pack_bits(pres)
    got = tgs.rows_scan(pb, vb, ws, wh, k=31)
    assert torch.equal(got, tgs.rows_scan_ref(pb, vb, ws, wh, k=31))
    # two slabs of the same width in one JOIN launch
    sms = torch.stack([slot_map, slot_map.flip(0)])
    vbs = torch.stack([vb, vb.flip(0)])
    got = tgs.slabs_scan_join(routed, sms, vbs, torch.stack([ws, ws]),
                              torch.stack([wh, wh]), k=31, min_count=3)
    assert torch.equal(got, tgs.slabs_scan_join_ref(
        routed, sms, vbs, torch.stack([ws, ws]), torch.stack([wh, wh]),
        k=31, min_count=3))


LONG = [(1, LONG_N), (8, LONG_N), (9, ODD_N)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", LONG + [(40, LONG_N)],
                         ids=["S1", "S8", "S9-odd", "S40"])
def test_gapscan_rows_long_windows(cuda_device, no_plain_scan, rows, n):
    """The ROWS mode on short windows (a lane a window and row) and long
    ones (split over warps and pieces), one over the whole slab, windows
    starting and ending on and beside quad, short/long, lane-stretch and
    piece edges, unsorted, overlapping and inverted ones; groups of 1, 8,
    9 and 40 rows (32, 4, 3 and 1 windows a warp; past 32 rows a lane
    takes two); 16-byte loads (LONG_N) and word loads (ODD_N)."""
    pr, valid, ws, wh = long_rows_case(90 + rows, 31, rows, n, inverted=True)
    assert ((wh - ws + 1) > LONG_WINDOW).sum() > 10
    args = _on(cuda_device, bits(pr), bits(valid), ws, wh)
    got = tgs.rows_scan(*args, k=31)
    assert torch.equal(got, no_plain_scan["rows"](*args, k=31))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", LONG, ids=["S1", "S8", "S9-odd"])
def test_gapscan_runs_long_streams(cuda_device, no_plain_scan, rows, n):
    """The RUNS mode on streams of several decode segments (one-position
    runs that share words and cross thread stretches and segments, a run
    over a segment's continuations, all-absent and empty rows, runs past
    n), over the long windows; R a multiple of 16 (16-byte stream loads)
    on LONG_N, not on ODD_N."""
    pad = 16 if n == LONG_N else 9
    dl, valid, ws, wh = long_runs_case(95 + rows, 31, rows, n, pad)
    args = _on(cuda_device, dl, bits(valid), ws, wh)
    before = tgs.runs_scan.launches
    got = tgs.runs_scan(*args, k=31)
    torch.cuda.synchronize()
    assert tgs.runs_scan.launches == before + 1
    assert torch.equal(got, no_plain_scan["runs"](*args, k=31))


@pytest.mark.cuda
def test_gapscan_whole_slab_windows(cuda_device, no_plain_scan):
    """Eight rows of a 2^22-position slab: one window over the whole
    slab, ones at and beside the short/long edge and LONG_WINDOW, ones
    ending on lane-stretch edges, and tiling windows, in both modes."""
    from kcftools_tpu_torch.native import bits_to_runs

    rng = np.random.default_rng(5)
    n = 1 << 22
    valid = rng.random(n) > 0.01
    pr = (rng.random((8, n)) > 0.02) & valid
    pr[3] = False
    pr[5] = valid
    nq = n // QUAD
    short = SHORT_QUADS * QUAD
    pairs = [(0, n - 1), (1, n - 2), (0, short - 1), (0, short),
             (QUAD - 1, short), (0, LONG_WINDOW - 1), (0, LONG_WINDOW),
             (QUAD, QUAD + LONG_WINDOW), (n - LONG_WINDOW - 1, n - 1),
             (0, (nq // 32) * 3 * QUAD - 1), (17, n // 2 + 3)]
    pairs += [(s, s + 4969) for s in range(0, n - 4970, 4970 * 37)]
    ws, wh = (np.asarray(p, np.int64) for p in zip(*pairs))
    args = _on(cuda_device, bits(pr), bits(valid), ws, wh)
    got = tgs.rows_scan(*args, k=31)
    assert torch.equal(got, no_plain_scan["rows"](*args, k=31))
    streams = [bits_to_runs(bits(row), bits(valid), n, n // 2)
               for row in pr]
    R = -(-max(s[2] for s in streams) // 4096) * 4096
    dl = np.zeros((8, 2, R), np.uint8)
    for r, (d, ln, _n) in enumerate(streams):
        dl[r, 0], dl[r, 1] = d[:R], ln[:R]
    rargs = _on(cuda_device, dl, bits(valid), ws, wh)
    got_runs = tgs.runs_scan(*rargs, k=31)
    assert torch.equal(got_runs, got)


def _runs_inputs(dev, seed):
    dl, valid, ws, wh = long_runs_case(seed, 31, 8, LONG_N)
    return _on(dev, dl, bits(valid), ws, wh)


@pytest.mark.cuda
def test_gapscan_runs_back_to_back(cuda_device, no_plain_scan):
    """Three run scans on different inputs with no synchronisation
    between them: each call decodes into its own bitmaps and starts its
    long-window list empty."""
    ins = [_runs_inputs(cuda_device, s) for s in (1, 2, 3)]
    outs = [tgs.runs_scan(*a, k=31) for a in ins]
    torch.cuda.synchronize()
    for a, got in zip(ins, outs):
        assert torch.equal(got, no_plain_scan["runs"](*a, k=31))


@pytest.mark.cuda
def test_gapscan_runs_two_streams(cuda_device, no_plain_scan):
    """Run scans on two streams at once, each on its own inputs."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    ins = [_runs_inputs(cuda_device, s) for s in (4, 5)]
    outs = []
    for st, a in zip(streams, ins):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append([tgs.runs_scan(*a, k=31) for _ in range(3)])
    torch.cuda.synchronize()
    for a, got in zip(ins, outs):
        want = no_plain_scan["runs"](*a, k=31)
        assert all(torch.equal(g, want) for g in got)


@pytest.fixture
def no_plain_hash(monkeypatch):
    """A CUDA tensor must never reach the plain hash scoring: the wrappers
    find both plain versions raising. Returns the real ones by name."""
    names = ("hash_probe_ref", "hash_scan_ref")
    real = {name: getattr(ths, name) for name in names}

    def boom(*_a, **_k):
        raise AssertionError("a CUDA tensor reached the plain hash scoring")

    for name in names:
        monkeypatch.setattr(ths, name, boom)
    return real


def _probe_exact(dev, plain, u8, wl, tbl, **kw):
    """One hash_probe launch on the card, bit-exact against the plain
    version; returns the counts."""
    args = _on(dev, u8, wl) + [torch.from_numpy(
        np.ascontiguousarray(tbl).view(np.int32)).to(dev)]
    before = ths.hash_probe.launches
    got = ths.hash_probe(*args, **kw)
    torch.cuda.synchronize()
    assert ths.hash_probe.launches == before + 1
    assert torch.equal(got, plain["hash_probe_ref"](*args, **kw))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("both_strands", [True, False], ids=["both", "fwd"])
@pytest.mark.parametrize("k", thc.KS)
def test_hash_probe_kernel_matches_plain(cuda_device, no_plain_hash, k,
                                         both_strands):
    """Every edge row at k 11 / 16 / 17 / 31 / 32 (the k = 16 and 32 shift
    and mask edges), both strands and one, against a table holding 70% of
    the rows' k-mers with counts >= 2^31: bit-exact, one launch."""
    u8, wl = thc.rows_case(k + 1, k)
    keys, counts = thc.table_keys(k, u8, wl, k, both_strands)
    table = build_table(keys, counts, k, both_strands=both_strands)
    got = _probe_exact(cuda_device, no_plain_hash, u8, wl, table.tbl, k=k,
                       both_strands=both_strands)
    assert int((got != 0).sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 32])
@pytest.mark.parametrize("nb", [1, 2])
def test_hash_probe_kernel_hand_tables(cuda_device, no_plain_hash, nb, k):
    """Tables of 1 and 2 buckets: dedup where h1 == h2, a key in both of
    its buckets and in two slots of one, counts that wrap to 0x10."""
    u8, wl = thc.rows_case(nb, k)
    got = _probe_exact(cuda_device, no_plain_hash, u8, wl,
                       thc.hand_table(u8, wl, k, True, nb), k=k,
                       both_strands=True)
    assert bool((got == 0x10).any())


@pytest.mark.cuda
@pytest.mark.parametrize("t_axis", [2, 4])
def test_hash_probe_kernel_shards(cuda_device, no_plain_hash, t_axis):
    """Shard-local placement: each shard's partial counts (ownership by
    range, b2 within the owner, dedup on the global b2 == h1) bit-exact,
    and their sum equals the unsharded counts of the same keys."""
    k = 31
    u8, wl = thc.rows_case(40 + t_axis, k)
    keys, counts = thc.table_keys(41, u8, wl, k, True)
    table = build_table_sharded(keys, counts, k, t_axis)
    nb = table.n_buckets // t_axis
    total = 0
    for s in range(t_axis):
        part = _probe_exact(cuda_device, no_plain_hash, u8, wl,
                            table.tbl[s * nb : (s + 1) * nb], k=k,
                            both_strands=True, nb_total=table.n_buckets,
                            shard=s)
        total = total + (part.long() & 0xFFFFFFFF)
    whole = _probe_exact(cuda_device, no_plain_hash, u8, wl,
                         build_table(keys, counts, k).tbl, k=k,
                         both_strands=True)
    assert torch.equal(total, whole.long() & 0xFFFFFFFF)


@pytest.mark.cuda
@pytest.mark.parametrize("min_count", [0, 1, 3])
@pytest.mark.parametrize("k", thc.KS)
def test_hash_scan_kernel_matches_plain(cuda_device, no_plain_hash, k,
                                        min_count):
    """Every edge row (win_len 0, < k, = Lp - 32, all N, N at both ends,
    runs of k and k - 1, bases past win_len, bytes > 4) with counts around
    min_count, all 0, >= 2^31 and full-range: bit-exact, one launch."""
    u8, wl = thc.rows_case(k, k)
    counts = thc.counts_case(k + min_count, u8).view(np.int32)
    args = _on(cuda_device, u8, counts, wl)
    before = ths.hash_scan.launches
    got = ths.hash_scan(*args, k=k, min_count=min_count)
    torch.cuda.synchronize()
    assert ths.hash_scan.launches == before + 1
    want = no_plain_hash["hash_scan_ref"](*args, k=k, min_count=min_count)
    assert torch.equal(got, want)
    assert not bool(got[:, 1].any())  # the padding row


@pytest.mark.cuda
def test_hash_scan_kernel_long_rows(cuda_device, no_plain_hash):
    """A batch of 3 features of ~2^20 bases (1,025 chunks a row, pass 2
    over 33 steps of 32), N runs and ~1% N: bit-exact."""
    rng = np.random.default_rng(3)
    B, Lp, k = 3, (1 << 20) + 64, 31
    u8 = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    u8[rng.random((B, Lp)) < 0.01] = 4
    u8[:, 300_000:304_000] = 4
    wl = np.array([Lp - 32, Lp - 5000, 70_000], np.int64)
    for r, n in enumerate(wl):
        u8[r, n:] = 4
    counts = rng.integers(0, 6, (B, Lp - 32)).astype(np.int32)
    args = _on(cuda_device, u8, counts, wl)
    got = ths.hash_scan(*args, k=k, min_count=2)
    assert torch.equal(got, no_plain_hash["hash_scan_ref"](*args, k=k,
                                                           min_count=2))


def _feature_rows(seed, B, Lp, k, lo=None):
    """(u8, win_len) of a padded feature batch: win_len uniform in [lo,
    Lp - 32], or, without ``lo``, in [0, Lp - 32] with k - 1, k and Lp -
    32 among them; random bases with ~1% N and an N run, the sentinel
    past each window."""
    rng = np.random.default_rng(seed)
    wl = rng.integers(lo or 0, Lp - 31, B).astype(np.int64)
    if lo is None:
        wl[:3] = [k - 1, k, Lp - 32]
    u8 = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    u8[rng.random((B, Lp)) < 0.01] = 4
    u8[:, Lp // 3 : Lp // 3 + 40] = 4
    u8[np.arange(Lp)[None, :] >= wl[:, None]] = 4
    return u8, wl


def _both_exact(dev, plain, u8, wl, k, min_count=2):
    """hash_probe against a table of 70% of the rows' k-mers, then
    hash_scan on its counts, each one launch and bit-exact against its
    plain version; returns the counts."""
    keys, counts = thc.table_keys(k, u8, wl, k, True)
    counts = _probe_exact(dev, plain, u8, wl,
                          build_table(keys, counts, k).tbl, k=k,
                          both_strands=True)
    u8_d, wl_d = _on(dev, u8, wl)
    before = ths.hash_scan.launches
    got = ths.hash_scan(u8_d, counts, wl_d, k=k, min_count=min_count)
    assert ths.hash_scan.launches == before + 1
    assert torch.equal(got, plain["hash_scan_ref"](u8_d, counts, wl_d, k=k,
                                                   min_count=min_count))
    return counts


@pytest.mark.cuda
def test_hash_kernels_long_feature_batch(cuda_device, no_plain_hash):
    """The batch of the longest features: 4 rows of 2^20 bytes (1,024
    chunks a row, 64 scan blocks a row), win_len up to 2^20 - 32."""
    u8, wl = _feature_rows(5, 4, 1 << 20, 31, lo=1 << 19)
    counts = _both_exact(cuda_device, no_plain_hash, u8, wl, 31)
    assert int((counts != 0).sum()) > 500_000


# row lengths: one chunk (64 and 1,024 bytes), 16 chunks (one block), 17
# chunks (two blocks, the second of one chunk), 33 chunks (three blocks)
ROW_LENGTHS = [64, 1024, 16 * 1024, 16 * 1024 + 64, 33 * 1024 - 32]


@pytest.mark.cuda
@pytest.mark.parametrize("Lp", ROW_LENGTHS)
def test_hash_kernels_row_lengths(cuda_device, no_plain_hash, Lp):
    """Rows of one chunk up to rows spanning three scan blocks."""
    u8, wl = _feature_rows(Lp, 24, Lp, 31)
    _both_exact(cuda_device, no_plain_hash, u8, wl, 31)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 31, 32])
def test_hash_kernels_stretch_edges(cuda_device, no_plain_hash, k):
    """The last valid start (win_len - k) one before, at and one after
    the probe's stretch and warp-tile edges, and at n_out - 1."""
    u8, wl = thc.stretch_edges_case(k, k)
    _both_exact(cuda_device, no_plain_hash, u8, wl, k)


@pytest.mark.cuda
def test_hash_kernels_unaligned_operands(cuda_device, no_plain_hash):
    """Rows that start off a 16-byte granule (a view at byte 3) with
    n_out % 4 != 0, and counts off 16 bytes: the probe's four-byte
    stores and the scan's one-count loads."""
    k = 31
    u8, wl = thc.rows_case(9, k, thc.LP + 5)
    keys, counts = thc.table_keys(9, u8, wl, k, True)
    tbl = torch.from_numpy(build_table(keys, counts, k).tbl.view(
        np.int32)).to(cuda_device)
    flat = torch.zeros(u8.size + 3, dtype=torch.uint8, device=cuda_device)
    flat[3:] = torch.from_numpy(u8.ravel()).to(cuda_device)
    rows = flat[3:].view(u8.shape)
    (wl_d,) = _on(cuda_device, wl)
    got = ths.hash_probe(rows, wl_d, tbl, k=k, both_strands=True)
    assert torch.equal(got, no_plain_hash["hash_probe_ref"](
        rows, wl_d, tbl, k=k, both_strands=True))
    cbuf = torch.zeros(got.numel() + 1, dtype=torch.int32,
                       device=cuda_device)
    cbuf[1:] = got.view(-1)
    cnt = cbuf[1:].view(got.shape)
    out = ths.hash_scan(rows, cnt, wl_d, k=k, min_count=2)
    assert torch.equal(out, no_plain_hash["hash_scan_ref"](
        rows, cnt, wl_d, k=k, min_count=2))


def _scan_inputs(dev, seed, Lp=17 * 1024 + 32, B=16):
    rng = np.random.default_rng(seed)
    u8, wl = _feature_rows(seed, B, Lp, 31)
    counts = rng.integers(0, 5, (B, Lp - 32)).astype(np.int32)
    return _on(dev, u8, counts, wl)


@pytest.mark.cuda
def test_hash_scan_back_to_back(cuda_device, no_plain_hash):
    """Three scans of rows spanning two blocks on different inputs, with
    no synchronisation between them: each call's row tickets start at
    zero."""
    ins = [_scan_inputs(cuda_device, s) for s in (1, 2, 3)]
    outs = [ths.hash_scan(*a, k=31, min_count=2) for a in ins]
    torch.cuda.synchronize()
    for a, got in zip(ins, outs):
        assert torch.equal(got, no_plain_hash["hash_scan_ref"](
            *a, k=31, min_count=2))


@pytest.mark.cuda
def test_hash_scan_two_streams(cuda_device, no_plain_hash):
    """Scans on two streams at once, each on its own inputs."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    ins = [_scan_inputs(cuda_device, s) for s in (4, 5)]
    outs = []
    for st, a in zip(streams, ins):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append([ths.hash_scan(*a, k=31, min_count=2)
                         for _ in range(3)])
    torch.cuda.synchronize()
    for a, got in zip(ins, outs):
        want = no_plain_hash["hash_scan_ref"](*a, k=31, min_count=2)
        assert all(torch.equal(g, want) for g in got)


@pytest.fixture
def no_plain_route(monkeypatch):
    """A CUDA tensor must never reach the plain routing or tiling: the
    wrappers find the plain versions raising. Returns the real ones by
    name."""
    names = ("route_reference_ref", "route_slabs_ref", "tile_sample_ref")
    real = {name: getattr(trt, name) for name in names}

    def boom(*_a, **_k):
        raise AssertionError("a CUDA tensor reached the plain routing")

    for name in names:
        monkeypatch.setattr(trt, name, boom)
    return real


def _route_exact(plain, keys, k, b, r_idx, plain_dev):
    """``route_reference`` and ``route_slabs`` on the card, one launch
    each, bit-exact against the plain versions run on ``plain_dev``;
    returns the query tiles."""
    dev = torch.device("cuda:0")
    before = (trt.route_reference.launches, trt.route_slabs.launches)
    got = trt.route_reference(keys.to(dev), k, b)
    got += trt.route_slabs(r_idx.to(dev), got[2])
    torch.cuda.synchronize()
    assert (trt.route_reference.launches, trt.route_slabs.launches) == (
        before[0] + 1, before[1] + 1)
    keys, r_idx = keys.to(plain_dev), r_idx.to(plain_dev)
    want = plain["route_reference_ref"](keys, k, b)
    want += plain["route_slabs_ref"](r_idx, want[2])
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.to(plain_dev), w)
    return got[0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", trc.CASES)
@pytest.mark.parametrize("k", trc.KS)
def test_route_kernels_match_plain(cuda_device, no_plain_route, k, case):
    """The routing kernels on the edge cases: the top-bit and top-32
    keys, empty partitions, one partition, one key and none, an all-dead
    slab; the plain version runs on the CPU."""
    keys, b, r_idx = trc.route_case(case, k, seed=k)
    _route_exact(no_plain_route, torch.from_numpy(keys.view(np.int64)), k,
                 b, torch.from_numpy(r_idx), torch.device("cpu"))


@pytest.mark.cuda
def test_route_kernels_cell_shape(cuda_device, no_plain_route):
    """The lettuce cell's shape: ~39.9 M canonical-like k = 31 keys in
    2^16 partitions (Tq 768 there), three slabs of 2^24 positions; the
    plain version runs on the card too."""
    g = torch.Generator(device=cuda_device).manual_seed(15)
    n = 40_000_000
    draws = [torch.randint(0, 1 << 62, (n,), generator=g, device=cuda_device)
             for _ in range(2)]
    keys = torch.unique(torch.minimum(*draws))  # sorted
    del draws
    S, N = 3, 1 << 24
    r_idx = torch.randint(0, keys.shape[0], (S, N), generator=g,
                          device=cuda_device, dtype=torch.int64)
    dead = torch.rand((S, N), generator=g, device=cuda_device) < 0.05
    r_idx = torch.where(dead, -1, r_idx).to(torch.int32)
    r_idx[2, N - 4096 :] = -1  # a slab's padding tail
    qh = _route_exact(no_plain_route, keys, 31, 16, r_idx, cuda_device)
    assert qh.shape[0] == 1 << 16 and qh.shape[1] >= keys.shape[0] >> 16


def _native_equal(buf, keys, counts, k, b, tile):
    """The card's (buf, Tt, packed) equals the native host packer's,
    which picks Tt and the count layout itself after a sample that took
    the width ``tile``."""
    from kcftools_tpu_torch.native import get_lib

    assert get_lib() is not None
    host = pack_tiles_host(keys, counts, k, b, tile)
    assert host[1:] == buf[1:]
    np.testing.assert_array_equal(buf[0].cpu().numpy().view(np.uint32),
                                  host[0])


def _tile_exact(plain, keys, counts, k, b, tile, plain_dev):
    """``tile_sample`` on the card, one launch, bit-exact against the
    plain version run on ``plain_dev``; returns (buf, Tt, packed)."""
    dev = torch.device("cuda:0")
    before = trt.tile_sample.launches
    got = trt.tile_sample(keys.to(dev), counts.to(dev), k, b, tile)
    torch.cuda.synchronize()
    assert trt.tile_sample.launches == before + 1
    want = plain["tile_sample_ref"](keys.to(plain_dev), counts.to(plain_dev),
                                    k, b, tile)
    assert got[1:] == want[1:]
    assert got[0].shape == want[0].shape
    assert torch.equal(got[0].to(plain_dev), want[0])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("counts", trc.COUNTS)
@pytest.mark.parametrize("case", trc.CASES)
@pytest.mark.parametrize("k", trc.KS)
def test_sample_tile_kernels_match_plain(cuda_device, no_plain_route, k,
                                         case, counts):
    """The sample tiling kernels on the edge cases (bit 63 at k = 32, the
    top-32 keys clamped to P - 1, empty partitions, one partition, one
    key and none; byte counts, one 256, counts up to 2^32 - 1): equal to
    the plain version on the CPU and to the native packer; then a
    smaller sample of the same case keeps the width."""
    keys, b, c = trc.sample_case(case, k, counts, seed=k)
    got = _tile_exact(
        no_plain_route, torch.from_numpy(keys.view(np.int64)),
        tpj.as_i32(c), k, b, None, torch.device("cpu"))
    _native_equal(got, keys, c, k, b, None)
    fewer = np.ascontiguousarray(keys[::3])
    _tile_exact(no_plain_route, torch.from_numpy(fewer.view(np.int64)),
                tpj.as_i32(c[::3]), k, b, got[1], torch.device("cpu"))


@pytest.mark.cuda
def test_sample_tile_kernels_cell_shape(cuda_device, no_plain_route):
    """The lettuce cell's samples: ~43.9 M canonical-like k = 31 keys in
    2^16 partitions, byte counts, then a second sample with counts up to
    2^32 - 1 at the first one's width; equal to the plain version on the
    card and to the native packer on the host."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    n = 44_000_000
    tile = None
    for top in (255, (1 << 32) - 1):
        draws = [torch.randint(0, 1 << 62, (n,), generator=g,
                               device=cuda_device) for _ in range(2)]
        keys = torch.unique(torch.minimum(*draws))  # sorted
        del draws
        counts = torch.randint(1, top + 1, keys.shape, generator=g,
                               device=cuda_device, dtype=torch.int64)
        counts[7] = top
        counts = (counts - ((counts >> 31) << 32)).to(torch.int32)
        got = _tile_exact(no_plain_route, keys, counts, 31, 16, tile,
                          cuda_device)
        assert got[2] == (top == 255) and (tile is None or got[1] == tile)
        _native_equal(got, keys.cpu().numpy().view(np.uint64),
                      counts.cpu().numpy().view(np.uint32), 31, 16, tile)
        tile = got[1]
        del keys, counts, got
        torch.cuda.empty_cache()


def _join_cpu_and_card(cuda_device, monkeypatch, tmp_path):
    """One reference and sample through a CPU and a CUDA
    DeviceJoinScorer (slabs of 2^17): device type -> (scorer, its
    windows' statistics, the stage snapshot of the call, the launches of
    route_reference, route_slabs and tile_sample)."""
    from kcftools_tpu_torch.utils import stagetimer as st

    monkeypatch.setenv("KCFTOOLS_STAGE_JSON", str(tmp_path / "st.json"))
    monkeypatch.setenv("KCFTOOLS_DJOIN_SLAB", str(1 << 17))
    rng = np.random.default_rng(41)
    k = 31
    _g, _v, refk, r_idx, db, dbc = _genome_case(rng, 400_000, k)
    starts, ends = tiling_windows(r_idx.shape[0] + k - 1, 5000, k)
    runs = {}
    for dev in (torch.device("cpu"), cuda_device):
        sc = DeviceJoinScorer(_Ref(refk), k, dev)
        sc.add_chrom("c", r_idx, starts, ends)
        before = (trt.route_reference.launches, trt.route_slabs.launches,
                  trt.tile_sample.launches)
        st.reset()
        sc.submit(0, refk, db, dbc)
        snap = st.snapshot()
        launched = (trt.route_reference.launches - before[0],
                    trt.route_slabs.launches - before[1],
                    trt.tile_sample.launches - before[2])
        runs[dev.type] = (sc, sc.collect(0)["c"], snap, launched)
    st.reset()
    return runs


def _same_join(runs):
    """The CUDA scorer's query tiles, slab statics and windows' statistics
    equal to the CPU scorer's."""
    (cpu, want, _s, _l), (gpu, got, _s2, _l2) = runs["cpu"], runs["cuda"]
    assert len(gpu._statics) == len(cpu._statics) > 1
    for a, b in ((cpu._q_hi, gpu._q_hi), (cpu._q_lo, gpu._q_lo),
                 (cpu._statics.slot_maps, gpu._statics.slot_maps),
                 (cpu._statics.valid_bits, gpu._statics.valid_bits),
                 (cpu._statics.w_start, gpu._statics.w_start),
                 (cpu._statics.w_hi, gpu._statics.w_hi)):
        assert torch.equal(a, b.cpu())
    for f, w in want.items():
        np.testing.assert_array_equal(got[f], w, err_msg=f)
    assert got["observed"].sum() > 0


@pytest.mark.cuda
def test_device_join_routes_on_card(cuda_device, monkeypatch, tmp_path):
    """DeviceJoinScorer on cuda routes and tiles its sample with the
    kernels: one launch of each, djoin_route_on_card and
    djoin_pack_on_card 1, the same bytes uploaded, all of them through
    the pinned staging (djoin_h2d_staged_bytes; 0 on the CPU), query
    tiles and slab statics equal to the CPU scorer's (the plain
    version), and the same per-window statistics."""
    runs = _join_cpu_and_card(cuda_device, monkeypatch, tmp_path)
    snaps = {dev: run[2] for dev, run in runs.items()}
    assert runs["cpu"][3] == (0, 0, 0)
    assert runs["cuda"][3] == (1, 1, 1)
    assert snaps["cpu"]["djoin_route_on_card"] == 0
    assert snaps["cuda"]["djoin_route_on_card"] == 1
    assert snaps["cpu"]["djoin_pack_on_card"] == 0
    assert snaps["cuda"]["djoin_pack_on_card"] == 1
    assert snaps["cuda"]["djoin_h2d_bytes"] == snaps["cpu"]["djoin_h2d_bytes"]
    assert snaps["cpu"]["djoin_h2d_staged_bytes"] == 0
    assert (snaps["cuda"]["djoin_h2d_staged_bytes"]
            == snaps["cuda"]["djoin_h2d_bytes"])
    _same_join(runs)


@pytest.mark.cuda
def test_device_join_staged_small_chunks(cuda_device, monkeypatch,
                                         tmp_path):
    """The whole device join with its uploads staged through 4,093-byte
    chunks two deep (hundreds of chunks a copy, their edges inside the
    keys): statics and statistics equal to the CPU scorer's, and
    djoin_h2d_staged_bytes equal to djoin_h2d_bytes."""
    from kcftools_tpu_torch.engine import device_join as tdj

    staged, real = [], tdj.h2d_staged

    def small(copies):
        staged.extend(dst.nbytes for dst, _src in copies)
        real(copies, chunk=4093, depth=2)

    monkeypatch.setattr(tdj, "h2d_staged", small)
    runs = _join_cpu_and_card(cuda_device, monkeypatch, tmp_path)
    snap = runs["cuda"][2]
    assert sum(staged) == snap["djoin_h2d_staged_bytes"]
    assert snap["djoin_h2d_staged_bytes"] == snap["djoin_h2d_bytes"]
    assert snap["djoin_h2d_bytes"] == runs["cpu"][2]["djoin_h2d_bytes"]
    assert max(staged) > 100 * 4093
    _same_join(runs)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["heap", "mapped"])
def test_h2d_staged_matches_to(cuda_device, tmp_path, source):
    """h2d_staged into the middle row of a (3, n) int64 tensor, in chunks
    of 65,537 bytes two deep (40 chunks and an odd tail, their edges
    inside the elements), behind a device sleep that holds every DMA
    back: a buffer refilled before its copy ran would show. The source
    (a heap array, or a read-only map of a file) is overwritten as soon
    as the call returns. The row equals the source's ``.to(dev)`` as it
    was, bit for bit, and the rows beside it are untouched."""
    from kcftools_tpu_torch.engine.device_join import h2d_staged

    chunk = 65_537
    n = 40 * chunk // 8 + 3
    want = np.random.default_rng(5).integers(-(1 << 63), (1 << 63) - 1, n,
                                             dtype=np.int64)
    if source == "heap":
        src = writer = want.copy()
    else:
        path = str(tmp_path / "src.raw")
        want.tofile(path)
        src = np.memmap(path, dtype=np.int64, mode="r")
        writer = np.memmap(path, dtype=np.int64, mode="r+")
    dst = torch.full((3, n), -1, dtype=torch.int64, device=cuda_device)
    expect = torch.from_numpy(want).to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the stream's time
    h2d_staged([(dst[1], src)], chunk=chunk, depth=2)
    writer[:] = 0
    torch.cuda.synchronize()
    assert torch.equal(dst[1], expect)
    assert bool((dst[0] == -1).all()) and bool((dst[2] == -1).all())
    del src, writer
