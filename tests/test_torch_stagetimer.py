"""The port's stage timer (``utils/stagetimer.py``): spans with parents
and self time, counters, the off path, profiler ranges, and the stages
and counters a ``getVariations`` call writes (CPU)."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from kcftools_tpu_torch.engine import device_join as tdj
from kcftools_tpu_torch import torchinit
from kcftools_tpu_torch.utils import stagetimer as st

from .gen import mutate, random_seq, write_fasta
from .test_torch_cli import _strip_volatile


@pytest.fixture
def timer(monkeypatch, tmp_path):
    """The timer on, a clock that advances 1 s a read, a fresh state."""
    path = tmp_path / "stages.json"
    monkeypatch.setenv("KCFTOOLS_STAGE_JSON", str(path))
    ticks = iter(range(10**6))
    monkeypatch.setattr(st.time, "perf_counter", lambda: float(next(ticks)))
    st.reset()
    yield path
    st.reset()


def test_nesting_and_self_time(timer):
    with st.stage("root"):          # clock 0 .. 7
        with st.stage("a"):         # 1 .. 4
            with st.stage("b"):     # 2 .. 3
                pass
        with st.stage("a"):         # 5 .. 6
            pass
    snap = st.snapshot()
    assert snap == {"root": 7.0, "root.self": 3.0, "a": 4.0, "a.self": 3.0,
                    "b": 1.0}


def test_parent(timer):
    seen = {}
    with st.stage("outer") as outer:
        with st.stage("inner") as inner:
            seen["parent"] = inner.parent
    assert seen["parent"] is outer and outer.parent is None


def test_threads_keep_their_own_stacks(timer):
    """A stage on another thread has no parent, and the stage open on
    the first thread keeps its whole time as self time."""
    got = {}

    def worker():
        with st.stage("ingest") as s:
            got["parent"] = s.parent

    with st.stage("root"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    snap = st.snapshot()
    assert got["parent"] is None
    assert "root.self" not in snap and snap["ingest"] == 1.0
    assert snap["root"] == 3.0


def test_counters_reset_and_dump(timer):
    st.count("djoin_h2d_bytes", 100)
    st.count("djoin_h2d_bytes", 28)
    st.count("plan_built", 0)
    with st.stage("s"):
        pass
    st.dump()
    with open(timer) as fh:
        assert json.load(fh) == {"djoin_h2d_bytes": 128, "plan_built": 0,
                                 "s": 1.0}
    st.reset()
    assert st.snapshot() == {}


def test_off_path_does_nothing(monkeypatch):
    """Neither the variable nor a profiler: no clock read, no lock, no
    profiler range, no device sync, no count."""
    monkeypatch.delenv("KCFTOOLS_STAGE_JSON", raising=False)
    st.reset()

    def boom(*a, **k):
        raise AssertionError("called on the off path")

    class NoLock:
        __enter__ = __exit__ = boom

    monkeypatch.setattr(st.time, "perf_counter", boom)
    monkeypatch.setattr(st, "_lock", NoLock())
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torchinit, "sync_devices", boom)
    with st.stage("a"), torchinit.phase("b", torch.device("cpu")):
        st.count("c", 5)
    assert st._acc == {} and st._counts == {}


def test_profiler_ranges(monkeypatch, tmp_path):
    """Under torch.profiler the stages are user_annotation ranges on the
    trace, nested as they ran; the timer itself stays off."""
    monkeypatch.delenv("KCFTOOLS_STAGE_JSON", raising=False)
    st.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with st.stage("outer_span"):
            with torchinit.phase("inner_span", torch.device("cpu")):
                torch.ones(8).sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    assert {"outer_span", "inner_span"} <= set(spans)
    o, i = spans["outer_span"], spans["inner_span"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert st._acc == {}
    # and no range once the profiler has stopped
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: (_ for _ in ()).throw(AssertionError))
    with st.stage("after"):
        pass


# -- a getVariations call ----------------------------------------------


def _reference(tmp_path, rng):
    from .gen import db_from_seqs

    k = 21
    chr1 = random_seq(rng, 4000, n_prob=0.004)
    chr2 = random_seq(rng, 2500)
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, [("c1", chr1), ("c2", chr2)])
    db = str(tmp_path / "db")
    db_from_seqs(db, [mutate(rng, chr1, 0.01, 0.002),
                      mutate(rng, chr2, 0.03)], k)
    return fa, db


class _Shapes:
    """The device join's shapes of a call, recorded by wrapping the
    scorer and its sample tiling."""

    def __init__(self, monkeypatch):
        self.scorer = None
        self.samples = []
        fin, tile = tdj.DeviceJoinScorer._finalize, tdj.tile_sample

        def finalize(scorer):
            fin(scorer)
            self.scorer = scorer

        def tile_sample(keys, counts, *a):
            buf, Tt, packed = tile(keys, counts, *a)
            self.samples.append((keys.shape[0], buf.nbytes, Tt, packed))
            return buf, Tt, packed

        monkeypatch.setattr(tdj.DeviceJoinScorer, "_finalize", finalize)
        monkeypatch.setattr(tdj, "tile_sample", tile_sample)

    def h2d_bytes(self):
        sc = self.scorer
        S, pos_pad = sc._statics.slot_maps.shape
        win_pad = sc._statics.w_start.shape[1]
        # the keys, each slab's r_idx and window bounds; the tiles, slot
        # maps and valid bitmaps are built on the device
        statics = (sc._refk.shape[0] * 8 + S * pos_pad * 4
                   + 2 * S * win_pad * 8)
        sample = 0
        for n, nbytes, Tt, packed in self.samples:
            # the sorted keys and counts; the tiles are built on the device
            sample += 12 * n
            words = sc.P * Tt // 4 if packed else sc.P * Tt
            assert nbytes == (2 * sc.P * Tt + words) * 4
        return statics, sample


MAIN_THREAD = ("fasta_index", "ingest", "refindex_load", "plan_load",
               "djoin_setup", "djoin_pack", "djoin_upload", "djoin_join",
               "djoin_scan", "scan", "write")


def test_get_variations_spans_and_counters(tmp_path, rng, monkeypatch):
    """A cold and a warm ``--engine device`` call on the CPU: the new
    spans, the built counters 1 then 0, the join's bytes to the byte,
    and the same KCF bytes as a call with the timer off."""
    from kcftools_tpu_torch.cli import main

    fa, db = _reference(tmp_path, rng)
    runs = {}
    for tag in ("cold", "warm", "off"):
        out = str(tmp_path / f"{tag}.kcf")
        path = tmp_path / f"{tag}.json"
        with monkeypatch.context() as mp:
            mp.setenv("KCFTOOLS_TORCH_DEVICE", "cpu")
            if tag == "off":
                mp.delenv("KCFTOOLS_STAGE_JSON", raising=False)
            else:
                mp.setenv("KCFTOOLS_STAGE_JSON", str(path))
            shapes = _Shapes(mp)
            assert main(["getVariations", "-r", fa, "-k", db, "-o", out,
                         "-s", "s1", "-f", "window", "-w", "500",
                         "--engine", "device"]) == 0
        stages = json.loads(path.read_text()) if tag != "off" else None
        runs[tag] = (stages, shapes, _strip_volatile(out))
    assert not (tmp_path / "off.json").exists()
    assert runs["cold"][2] == runs["warm"][2] == runs["off"][2]
    cold, warm = runs["cold"][0], runs["warm"][0]
    for key in ("refindex_built", "plan_built", "sidecar_built"):
        assert (cold[key], warm[key]) == (1, 0), key
    assert cold["sidecar_bytes"] == 0 < warm["sidecar_bytes"]
    assert cold["refindex_bytes"] == 0 < warm["refindex_bytes"]
    assert "refindex_build" in cold and "refindex_build" not in warm
    for stages, shapes, _ in (runs["cold"], runs["warm"]):
        for name in MAIN_THREAD + ("getVariations", "getVariations.self",
                                   "djoin_route", "djoin_statics",
                                   "djoin_static_upload", "djoin_setup.self",
                                   "djoin_fetch"):
            assert name in stages, name
        statics, sample = shapes.h2d_bytes()
        assert stages["djoin_h2d_bytes"] == statics + sample
        assert stages["djoin_route_on_card"] == 0  # a CPU device
        assert stages["djoin_pack_on_card"] == 0  # the plain version
        kids = sum(stages[n] for n in MAIN_THREAD)
        assert stages["getVariations.self"] == pytest.approx(
            stages["getVariations"] - kids, abs=2e-3)
        parts = sum(stages[n] for n in ("djoin_route", "djoin_statics",
                                        "djoin_static_upload",
                                        "djoin_setup.self"))
        assert parts == pytest.approx(stages["djoin_setup"], abs=2e-3)


def test_hash_engine_spans(tmp_path, rng, monkeypatch):
    """A ``-f gene --engine device`` call on the CPU (the hash engine):
    the GTF parse, the table upload and the scan's parts."""
    from kcftools_tpu_torch.cli import main

    from .test_torch_cli_engines import _feature_fixture

    fa, gtf_path, db = _feature_fixture(tmp_path, rng, 15)
    path = tmp_path / "stages.json"
    monkeypatch.setenv("KCFTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("KCFTOOLS_STAGE_JSON", str(path))
    assert main(["getVariations", "-r", fa, "-k", db, "-o",
                 str(tmp_path / "g.kcf"), "-s", "sx", "-f", "gene", "-g",
                 gtf_path, "--engine", "device"]) == 0
    stages = json.loads(path.read_text())
    for name in ("getVariations", "fasta_index", "gtf_parse", "ingest",
                 "hash_table_upload", "scan", "scan.self", "hash_splice",
                 "hash_pad", "hash_fetch", "write"):
        assert name in stages, name
    assert stages["scan"] >= stages["hash_splice"] + stages["hash_fetch"]
    assert not any(k.startswith("djoin_") for k in stages)


def test_slabs_upload_counts_bytes(monkeypatch):
    """``_Slabs`` uploads each slab's r_idx and window bounds, counting
    their bytes, and ``route`` builds the slot maps and valid bitmaps on
    the device, which copies nothing more."""
    monkeypatch.setenv("KCFTOOLS_STAGE_JSON", os.devnull)
    st.reset()
    r_idx = np.full(32, -1, np.int32)
    r_idx[:4] = [0, -1, 2, 1]
    slab = {"r_idx": r_idx,
            "w_start": np.zeros(8, np.int32), "w_hi": np.ones(8, np.int32)}
    s = tdj._Slabs([slab], 32, 8, torch.device("cpu"))
    assert len(s) == 1 and s.slot_maps is None
    assert s.w_hi.dtype == torch.int64 and s.w_hi.tolist() == [[1] * 8]
    assert st.snapshot() == {"djoin_h2d_bytes": 32 * 4 + 2 * 8 * 8,
                             "djoin_h2d_staged_bytes": 0}
    s.route(torch.tensor([5, 6, 7], dtype=torch.int32))
    assert s.r_idx is None
    assert s.slot_maps[0, :4].tolist() == [5, 0, 7, 6]
    assert not s.slot_maps[0, 4:].any()
    assert s.valid_bits.tolist() == [[0b1101, 0, 0, 0]]
    assert st.snapshot() == {"djoin_h2d_bytes": 32 * 4 + 2 * 8 * 8,
                             "djoin_h2d_staged_bytes": 0}
    st.reset()


# -- the staged upload's host code ---------------------------------------


@pytest.fixture(scope="module")
def h2d_stub(tmp_path_factory):
    """``csrc/h2d.cu``'s ``kcf_h2d_staged``, built by g++ against
    ``tests/cuda_stub/cuda_runtime.h`` (no GPU: one in-order stream of
    delayed memcpy copies, so a buffer refilled before its copy ran shows
    in the destination), bound with the program's own argument types."""
    import ctypes
    import subprocess

    from kcftools_tpu_torch.ops import _kernels

    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "kcftools_tpu_torch", "csrc",
                       "h2d.cu")
    lib = str(tmp_path_factory.mktemp("h2d_stub") / "libh2dstub.so")
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-pthread", "-I", os.path.join(here, "cuda_stub"),
                    "-x", "c++", src, "-o", lib], check=True)
    dll = ctypes.CDLL(lib)
    fn = dll.kcf_h2d_staged
    fn.restype = ctypes.c_int
    fn.argtypes = _kernels._ENTRIES["kcf_h2d_staged"][1]
    dll.kcf_stub_set_delay_us(50)
    return fn


def _stub_staged(fn, copies, chunk, depth):
    """``kcf_h2d_staged`` of the stub build over (dst, src) byte arrays
    through ``depth`` buffers of ``chunk`` bytes, laid out as
    ``h2d_staged`` lays them; the buffers are overwritten as soon as it
    returns, as the caching host allocator may hand them on."""
    dsts = np.array([d.ctypes.data for d, _s in copies], np.uint64)
    srcs = np.array([s.ctypes.data for _d, s in copies], np.uint64)
    sizes = np.array([s.size for _d, s in copies], np.int64)
    bufs = np.full(chunk * depth, 0xAB, np.uint8)
    rc = fn(dsts.ctypes.data, srcs.ctypes.data, sizes.ctypes.data,
            len(copies), bufs.ctypes.data, chunk, depth, None)
    bufs[:] = 0xCD
    return rc


# kcf_h2d_staged's chunk loop: (elements, chunk bytes, depth) of each
# case; 25 elements over 7-byte chunks is several chunks and an odd tail,
# the chunk edges falling inside the int32 and int64 elements
_STAGED = {"empty": (0, 7, 2), "one": (1, 7, 2), "chunk-1": (25, None, 2),
           "chunk": (25, 0, 2), "several": (25, 7, 2),
           "several-deep": (25, 7, 3)}


@pytest.mark.parametrize("readonly", [False, True], ids=["heap", "mapped"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int64])
@pytest.mark.parametrize("case", list(_STAGED))
def test_h2d_staged_chunk_loop(monkeypatch, h2d_stub, case, dtype,
                               readonly):
    """``kcf_h2d_staged``'s host code (the stub build) writes every byte
    of the source and no other, at 0 and 1 bytes, one chunk less 1,
    exactly one chunk and several chunks with an odd tail, from a heap
    array or a read-only (mapped-style) view, its copies done when it
    returns; ``_h2d`` and ``_h2d_rows`` on a CPU device take the same
    source without a warning and count the same ``djoin_h2d_bytes`` as
    ever and 0 ``djoin_h2d_staged_bytes``."""
    import warnings

    n, chunk, depth = _STAGED[case]
    rng = np.random.default_rng(n + depth)
    src = rng.integers(0, 1 << 62, n).astype(dtype)
    nbytes = src.nbytes
    chunk = {None: nbytes + 1, 0: nbytes}.get(chunk, chunk)
    if case == "chunk-1":
        assert nbytes == chunk - 1
    src.flags.writeable = not readonly
    dst = np.full(nbytes + 8, 0xEE, np.uint8)
    assert _stub_staged(h2d_stub, [(dst[4 : 4 + nbytes],
                                    src.view(np.uint8))], chunk, depth) == 0
    assert dst[4 : 4 + nbytes].tobytes() == src.tobytes()
    assert (dst[:4] == 0xEE).all() and (dst[4 + nbytes :] == 0xEE).all()
    tdtype = {np.uint8: torch.uint8, np.int32: torch.int32,
              np.int64: torch.int64}[dtype]
    monkeypatch.setenv("KCFTOOLS_STAGE_JSON", os.devnull)
    st.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        on, = tdj._h2d(torch.device("cpu"), src)
        rows = tdj._h2d_rows([src], n, tdtype, torch.device("cpu"))
    assert on.numpy().tobytes() == rows.numpy().tobytes() == src.tobytes()
    assert st.snapshot() == {"djoin_h2d_bytes": 2 * nbytes,
                             "djoin_h2d_staged_bytes": 0}
    st.reset()


def test_h2d_staged_pairs(h2d_stub):
    """One ``kcf_h2d_staged`` call (the stub build) fills several
    destinations, empty ones among them, their chunks taken in turn
    through more buffers than one and many more chunks than buffers,
    every copy done when it returns; ``h2d_staged`` refuses a destination
    of another size, and one that is not on a CUDA device."""
    rng = np.random.default_rng(9)
    srcs = [rng.integers(0, 255, n, dtype=np.uint8)
            for n in (0, 1, 40, 97, 0, 5000)]
    srcs.append(rng.integers(0, 1 << 40, 33, dtype=np.int64).view(np.uint8))
    dsts = [np.zeros(a.size, np.uint8) for a in srcs]
    assert _stub_staged(h2d_stub, list(zip(dsts, srcs)), 8, 3) == 0
    for d, a in zip(dsts, srcs):
        assert d.tobytes() == a.tobytes()
    with pytest.raises(ValueError, match="source bytes"):
        tdj.h2d_staged([(torch.empty(3, dtype=torch.uint8), srcs[2])])
    with pytest.raises(ValueError, match="CUDA device"):
        tdj.h2d_staged([(torch.empty(40, dtype=torch.uint8), srcs[2])])


@pytest.mark.parametrize("writable", [True, False])
def test_sidecar_built_counts_written_sidecars(tmp_path, monkeypatch,
                                               writable):
    """``sidecar_built`` adds 1 where ``save_sorted_cache`` wrote the
    ``.raw`` sidecar, nothing where the write failed, and 0 for a load;
    ``sidecar_bytes`` adds the 12 bytes a record that a hit served, and
    0 on a miss."""
    from kcftools_tpu_torch.io import kmc

    prefix = str(tmp_path / "db")
    for ext in (".kmc_pre", ".kmc_suf"):
        with open(prefix + ext, "wb") as fh:
            fh.write(b"\0" * 8)
        os.utime(prefix + ext, (1e9, 1e9))  # older than the sidecar
    monkeypatch.setenv("KCFTOOLS_STAGE_JSON", os.devnull)
    st.reset()
    keys = np.arange(5, dtype=np.uint64)
    counts = np.ones(5, np.uint32)
    if not writable:
        def refuse(*a, **k):
            raise OSError("read-only")

        monkeypatch.setattr(kmc.os, "replace", refuse)
    kmc.save_sorted_cache(prefix, 21, keys, counts)
    assert st.snapshot() == ({"sidecar_built": 1} if writable else {})
    assert os.path.exists(prefix + ".kcfsorted.k21.raw") == writable
    assert not (tmp_path / "db.kcfsorted.k21.npz").exists()
    got = kmc.load_sorted_cache(prefix, 21)
    if writable:
        np.testing.assert_array_equal(got[0], keys)
        assert st.snapshot() == {"sidecar_built": 1,
                                 "sidecar_bytes": 12 * 5}
    else:
        assert got is None
        assert st.snapshot() == {"sidecar_bytes": 0}
    st.reset()
    if writable:
        kmc.load_sorted_cache(prefix, 21)
        assert st.snapshot() == {"sidecar_built": 0,
                                 "sidecar_bytes": 12 * 5}
    st.reset()


def test_mesh_statics_row_by_row(monkeypatch):
    """``MeshJoinScorer`` builds and uploads each data row's statics in
    turn, inside ``djoin_setup``, and counts every byte it uploads."""
    from kcftools_tpu_torch.engine.encode import canonicalize, pack_kmers
    from kcftools_tpu_torch.engine.windows import tiling_windows
    from kcftools_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setenv("KCFTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("KCFTOOLS_TORCH_VIRTUAL_DEVICES", "8")
    monkeypatch.setenv("KCFTOOLS_STAGE_JSON", os.devnull)
    rng = np.random.default_rng(5)
    k, length = 21, 40_000
    genome = rng.integers(0, 4, length).astype(np.uint8)
    valid = np.ones(length, bool)
    kmers, kv = pack_kmers(genome, valid, k)
    canon = canonicalize(kmers, k)
    refk = np.unique(canon[kv])
    r_idx = np.full(canon.shape[0], -1, np.int32)
    r_idx[kv] = np.searchsorted(refk, canon[kv]).astype(np.int32)

    class Ref:
        pass

    ref = Ref()
    ref.kmers = refk
    order = []
    init, route = tdj._Slabs.__init__, tdj._Slabs.route

    def rec_init(self, *a):
        order.append("upload")
        init(self, *a)

    def rec_route(self, slot_of_ord):
        order.append("route")
        return route(self, slot_of_ord)

    monkeypatch.setattr(tdj._Slabs, "__init__", rec_init)
    monkeypatch.setattr(tdj._Slabs, "route", rec_route)
    st.reset()
    msc = tdj.MeshJoinScorer(ref, k, make_mesh(2, 4))
    msc.add_chrom("c", r_idx, *tiling_windows(length, 2000, k))
    msc._finalize()
    assert order == ["upload", "route"] * 2
    snap = st.snapshot()
    for name in ("djoin_setup", "djoin_route", "djoin_statics",
                 "djoin_static_upload"):
        assert name in snap, name
    assert snap["djoin_route_on_card"] == 0  # routed once, on the CPU
    # the keys once, then each row's r_idx and window bounds
    want = refk.nbytes
    want += sum(t.nbytes for _dev, row in msc._statics
                for t in (row.slot_maps, row.w_start, row.w_hi))
    assert snap["djoin_h2d_bytes"] == want
    st.reset()


def test_sample_pack_counter_and_upload(monkeypatch):
    """Each sample of a CPU ``DeviceJoinScorer`` adds 0 to
    ``djoin_pack_on_card`` (tiled by the plain version) and its sorted
    keys and counts, 12 bytes a key, to ``djoin_h2d_bytes``, in the
    stages ``djoin_upload`` then ``djoin_pack``; read-only arrays (a
    mapped sidecar's) pass without a warning."""
    import warnings

    from kcftools_tpu_torch.engine.windows import tiling_windows

    from .torch_route_cases import sample_case

    monkeypatch.setenv("KCFTOOLS_STAGE_JSON", os.devnull)
    k = 21
    refk, _b, _c = sample_case("canonical", k, "u8", seed=2, n=5000)
    rng = np.random.default_rng(3)
    r = rng.integers(0, refk.shape[0], 8000).astype(np.int32)

    class Ref:
        kmers = refk

    sc = tdj.DeviceJoinScorer(Ref(), k, "cpu", tile_target=64)
    sc.add_chrom("c", r, *tiling_windows(8000 + k - 1, 1000, k))
    sc._finalize()
    order = []
    phase = tdj.phase
    monkeypatch.setattr(tdj, "phase",
                        lambda n, *d: (order.append(n), phase(n, *d))[1])
    for key, top in enumerate((255, (1 << 32) - 1)):
        # half the reference's k-mers and as many others
        other, _b, _c = sample_case("canonical", k, "u8", seed=key + 5,
                                    n=2500)
        keys = np.unique(np.concatenate([refk[key::2], other]))
        c = rng.integers(1, top, keys.shape[0], endpoint=True,
                         dtype=np.uint64).astype(np.uint32)
        keys.flags.writeable = c.flags.writeable = False
        st.reset()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            sc.submit(key, refk, keys, c)
        snap = st.snapshot()
        assert snap["djoin_pack_on_card"] == 0
        assert snap["djoin_h2d_bytes"] == 12 * keys.shape[0]
        assert snap["djoin_h2d_staged_bytes"] == 0  # nothing pinned
        assert "djoin_upload" in snap and "djoin_pack" in snap
        assert sc.collect(key)["c"]["observed"].sum() > 0
    st.reset()
    assert [n for n in order if n in ("djoin_upload", "djoin_pack")] == [
        "djoin_upload", "djoin_pack"] * 2


def test_refindex_counters(tmp_path, rng, monkeypatch):
    """``refindex_built`` is 1 for the call that builds the reference
    index and 0 for the one that maps its cache; ``refindex_bytes`` is 0
    in the first and the index's key and r_idx bytes in the second."""
    from kcftools_tpu_torch.cli import main
    from kcftools_tpu_torch.engine.refindex import RefKmerIndex
    from kcftools_tpu_torch.io.fasta import FastaIndex

    fa, db = _reference(tmp_path, rng)
    got = []
    for tag in ("cold", "warm"):
        path = tmp_path / f"{tag}.json"
        with monkeypatch.context() as mp:
            mp.setenv("KCFTOOLS_TORCH_DEVICE", "cpu")
            mp.setenv("KCFTOOLS_STAGE_JSON", str(path))
            assert main(["getVariations", "-r", fa, "-k", db, "-o",
                         str(tmp_path / f"{tag}.kcf"), "-s", "s1", "-f",
                         "window", "-w", "500", "--engine", "device"]) == 0
        stages = json.loads(path.read_text())
        got.append((stages["refindex_built"], stages["refindex_bytes"]))
    st.reset()
    ridx = RefKmerIndex.load_or_build(fa, FastaIndex(fa), 21)
    st.reset()
    served = ridx.kmers.nbytes + sum(
        ridx.chrom_r_idx[n].nbytes for n in ("c1", "c2"))
    assert served == 8 * ridx.n_kmers + 4 * (4000 + 2500 - 2 * 20)
    assert got == [(1, 0), (0, served)]
