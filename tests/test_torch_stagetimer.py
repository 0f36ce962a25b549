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
from kcftools_tpu_torch.engine import device_prefix as tdp
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
    monkeypatch.setattr(tdp, "sync_devices", boom)
    with st.stage("a"), tdp._phase("b", torch.device("cpu")):
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
            with tdp._phase("inner_span", torch.device("cpu")):
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
    scorer."""

    def __init__(self, monkeypatch):
        self.scorer = None
        self.tiles = []
        fin, pack = tdj.DeviceJoinScorer._finalize, \
            tdj.DeviceJoinScorer._pack_tiles

        def finalize(scorer):
            fin(scorer)
            self.scorer = scorer

        def pack_tiles(scorer, *a):
            buf, Tt, packed = pack(scorer, *a)
            self.tiles.append((buf.nbytes, Tt, packed))
            return buf, Tt, packed

        monkeypatch.setattr(tdj.DeviceJoinScorer, "_finalize", finalize)
        monkeypatch.setattr(tdj.DeviceJoinScorer, "_pack_tiles", pack_tiles)

    def h2d_bytes(self):
        sc = self.scorer
        S, pos_pad = sc._statics.slot_maps.shape
        win_pad = sc._statics.w_start.shape[1]
        statics = (2 * sc.P * sc.Tq * 4 + S * pos_pad * 4 + S * pos_pad // 8
                   + 2 * S * win_pad * 8)
        sample = 0
        for nbytes, Tt, packed in self.tiles:
            words = sc.P * Tt // 4 if packed else sc.P * Tt
            sample += (2 * sc.P * Tt + words) * 4
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
    assert "refindex_build" in cold and "refindex_build" not in warm
    for stages, shapes, _ in (runs["cold"], runs["warm"]):
        for name in MAIN_THREAD + ("getVariations", "getVariations.self",
                                   "djoin_route", "djoin_statics",
                                   "djoin_static_upload", "djoin_setup.self",
                                   "djoin_fetch"):
            assert name in stages, name
        statics, sample = shapes.h2d_bytes()
        assert stages["djoin_h2d_bytes"] == statics + sample
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
    """``_Slabs`` builds on the host and ``upload`` counts its bytes."""
    monkeypatch.setenv("KCFTOOLS_STAGE_JSON", os.devnull)
    st.reset()
    r_idx = np.full(16, -1, np.int64)
    r_idx[:4] = [0, -1, 2, 1]
    slab = {"r_idx": r_idx,
            "w_start": np.zeros(8, np.int64), "w_hi": np.ones(8, np.int64)}
    s = tdj._Slabs([slab], np.array([5, 6, 7], np.int64), 16, 8)
    assert isinstance(s.slot_maps, np.ndarray) and len(s) == 1
    assert s.slot_maps[0, :4].tolist() == [5, 0, 7, 6]
    s.upload(torch.device("cpu"))
    assert isinstance(s.w_hi, torch.Tensor)
    assert st.snapshot() == {"djoin_h2d_bytes": 16 * 4 + 2 + 2 * 8 * 8}
    st.reset()


@pytest.mark.parametrize("writable", [True, False])
def test_sidecar_built_counts_written_sidecars(tmp_path, monkeypatch,
                                               writable):
    """``sidecar_built`` adds 1 where ``save_sorted_cache`` wrote the
    sidecar, nothing where the write failed, and 0 for a load."""
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
    got = kmc.load_sorted_cache(prefix, 21)
    if writable:
        np.testing.assert_array_equal(got[0], keys)
        assert st.snapshot() == {"sidecar_built": 1}
    else:
        assert got is None
        assert st.snapshot() == {}
    st.reset()
    if writable:
        kmc.load_sorted_cache(prefix, 21)
        assert st.snapshot() == {"sidecar_built": 0}
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
    init, upload = tdj._Slabs.__init__, tdj._Slabs.upload

    def rec_init(self, *a):
        order.append("build")
        init(self, *a)

    def rec_upload(self, dev):
        order.append("upload")
        return upload(self, dev)

    monkeypatch.setattr(tdj._Slabs, "__init__", rec_init)
    monkeypatch.setattr(tdj._Slabs, "upload", rec_upload)
    st.reset()
    msc = tdj.MeshJoinScorer(ref, k, make_mesh(2, 4))
    msc.add_chrom("c", r_idx, *tiling_windows(length, 2000, k))
    msc._finalize()
    assert order == ["build", "upload"] * 2
    snap = st.snapshot()
    for name in ("djoin_setup", "djoin_route", "djoin_statics",
                 "djoin_static_upload"):
        assert name in snap, name
    want = sum(q.nbytes for pair in msc._q.values() for q in pair)
    want += sum(t.nbytes for _dev, row in msc._statics
                for t in (row.slot_maps, row.valid_bits, row.w_start,
                          row.w_hi))
    assert snap["djoin_h2d_bytes"] == want
    st.reset()
