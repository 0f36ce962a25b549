"""The port's sorted-key sidecar (``io/kmc.py``: ``<db>.kcfsorted.k<k>.raw``,
a header and the raw, aligned key and count arrays, loaded as read-only
views of a memory map): the round trip, staleness, damaged files, and
``getVariations`` off a loaded sidecar against a run without one (CPU)."""

import json
import os

import numpy as np
import pytest

from kcftools_tpu_torch.io import kmc
from kcftools_tpu_torch.utils import stagetimer as st

from .gen import mutate, random_seq, write_fasta
from .test_torch_cli import _strip_volatile


@pytest.fixture
def counted(monkeypatch):
    """The stage timer's counters on, from a fresh state."""
    monkeypatch.setenv("KCFTOOLS_STAGE_JSON", os.devnull)
    st.reset()
    yield
    st.reset()


def _fake_db(tmp_path):
    """A database prefix whose .kmc_pre / .kmc_suf predate any sidecar."""
    prefix = str(tmp_path / "db")
    for ext, size in ((".kmc_pre", 8), (".kmc_suf", 16)):
        with open(prefix + ext, "wb") as fh:
            fh.write(b"\0" * size)
        os.utime(prefix + ext, (1e9, 1e9))
    return prefix


def _table(rng, k, n):
    """Sorted unique keys (uint64, or an (hi, lo) pair for k > 32) and
    counts over the whole uint32 range."""
    counts = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if k <= 32:
        keys = np.unique(rng.integers(0, 4**k, 2 * n, dtype=np.uint64))[:n]
        assert keys.shape == (n,)
        return keys, counts
    hi = np.sort(rng.integers(0, 4 ** (k - 32), n, dtype=np.uint64))
    lo = rng.integers(0, 2**64, n, dtype=np.uint64)
    return (hi, lo), counts


@pytest.mark.parametrize("k,n", [(21, 1000), (45, 777), (21, 0), (45, 0)])
def test_round_trip_is_bit_exact(tmp_path, rng, counted, k, n):
    """What ``save_sorted_cache`` wrote, ``load_sorted_cache`` returns to
    the bit: read-only arrays at 64-byte-aligned offsets of a file whose
    length the header gives, with no zip container around them."""
    prefix = _fake_db(tmp_path)
    keys, counts = _table(rng, k, n)
    kmc.save_sorted_cache(prefix, k, keys, counts)
    path = kmc.sorted_cache_path(prefix, k)
    assert path == f"{prefix}.kcfsorted.k{k}.raw"
    assert not os.path.exists(f"{prefix}.kcfsorted.k{k}.npz")
    with open(path, "rb") as fh:
        head = fh.read(8)
    assert head == b"KCFSORT\0"
    got_keys, got_counts = kmc.load_sorted_cache(prefix, k)
    want = list(keys) if k > 32 else [keys]
    got = list(got_keys) if k > 32 else [got_keys]
    assert len(got) == len(want)
    for g, w in zip(got + [got_counts], want + [counts]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        assert not g.flags.writeable
        assert g.ctypes.data % 64 == 0 or g.size == 0
    limbs = 2 if k > 32 else 1
    assert os.path.getsize(path) == kmc._sorted_layout(n, limbs)[1]
    assert st.snapshot() == {"sidecar_built": 1,
                             "sidecar_bytes": (8 * limbs + 4) * n}


@pytest.mark.parametrize("what", ["newer", "size"])
@pytest.mark.parametrize("ext", ["pre", "suf"])
def test_stale_sidecar_is_a_miss(tmp_path, rng, counted, what, ext):
    """A regenerated database (a newer .kmc_pre or .kmc_suf) or one of
    another size returns None, and counts no bytes served."""
    prefix = _fake_db(tmp_path)
    keys, counts = _table(rng, 21, 50)
    kmc.save_sorted_cache(prefix, 21, keys, counts)
    assert kmc.load_sorted_cache(prefix, 21) is not None
    target = prefix + ".kmc_" + ext
    if what == "newer":
        side = os.path.getmtime(kmc.sorted_cache_path(prefix, 21))
        os.utime(target, (side + 5, side + 5))
    else:
        with open(target, "ab") as fh:
            fh.write(b"\0")
        os.utime(target, (1e9, 1e9))
    st.reset()
    assert kmc.load_sorted_cache(prefix, 21) is None
    assert st.snapshot() == {"sidecar_bytes": 0}


def _damage(path, how):
    """Truncate or extend the sidecar, leave it empty, or overwrite its
    magic, version, k or record count."""
    size = os.path.getsize(path)
    if how == "truncated":
        os.truncate(path, size - 4)
        return
    if how == "empty":
        os.truncate(path, 0)
        return
    if how == "extended":
        with open(path, "ab") as fh:
            fh.write(b"\0" * 64)
        return
    at, data = {"magic": (0, b"PK\x03\x04"), "version": (8, b"\x02"),
                "k": (12, b"\x17"), "n": (24, b"\xff" * 8)}[how]
    with open(path, "r+b") as fh:
        fh.seek(at)
        fh.write(data)


_DAMAGE = ["truncated", "empty", "extended", "magic", "version", "k", "n"]


@pytest.mark.parametrize("how", _DAMAGE)
def test_damaged_sidecar_is_a_miss(tmp_path, rng, counted, how):
    """A truncated, extended, empty or foreign file returns None, never
    raises."""
    prefix = _fake_db(tmp_path)
    keys, counts = _table(rng, 21, 50)
    kmc.save_sorted_cache(prefix, 21, keys, counts)
    path = kmc.sorted_cache_path(prefix, 21)
    mtime = os.path.getmtime(path)
    _damage(path, how)
    os.utime(path, (mtime, mtime))
    st.reset()
    assert kmc.load_sorted_cache(prefix, 21) is None
    assert st.snapshot() == {"sidecar_bytes": 0}


def _sample(tmp_path, rng, k):
    """A two-chromosome reference and one sample's database of it,
    counted by the port's ``count``."""
    from kcftools_tpu_torch.cli import main

    chr1 = random_seq(rng, 4000, n_prob=0.004)
    chr2 = random_seq(rng, 2500)
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, [("c1", chr1), ("c2", chr2)])
    sfa = str(tmp_path / "s.fa")
    write_fasta(sfa, [("c1", mutate(rng, chr1, 0.01, 0.002)),
                      ("c2", mutate(rng, chr2, 0.03))])
    db = str(tmp_path / "db")
    assert main(["count", "-i", sfa, "-o", db, "-k", str(k)]) == 0
    return fa, db


def _call(monkeypatch, tmp_path, fa, db, tag, engine):
    """One in-process ``getVariations`` call of the port on a CPU device;
    returns (KCF bytes less the volatile lines, stage JSON)."""
    from kcftools_tpu_torch.cli import main

    out = str(tmp_path / f"{tag}.kcf")
    path = tmp_path / f"{tag}.json"
    with monkeypatch.context() as mp:
        mp.setenv("KCFTOOLS_TORCH_DEVICE", "cpu")
        mp.setenv("KCFTOOLS_STAGE_JSON", str(path))
        assert main(["getVariations", "-r", fa, "-k", db, "-o", out,
                     "-s", "s1", "-f", "window", "-w", "500",
                     "--engine", engine]) == 0
    st.reset()
    return _strip_volatile(out), json.loads(path.read_text())


@pytest.mark.parametrize("engine,k", [("device", 21), ("dprefix", 21),
                                      ("hybrid", 21), ("dprefix", 45),
                                      ("hybrid", 45)])
def test_get_variations_off_loaded_sidecar(tmp_path, rng, monkeypatch,
                                           engine, k):
    """A call off the mapped sidecar writes the bytes of the call that
    decoded and sorted the database (so no consumer writes into the
    read-only arrays), and of a call after the sidecar was deleted."""
    fa, db = _sample(tmp_path, rng, k)
    cold, cold_st = _call(monkeypatch, tmp_path, fa, db, "cold", engine)
    warm, warm_st = _call(monkeypatch, tmp_path, fa, db, "warm", engine)
    assert (cold_st["sidecar_built"], cold_st["sidecar_bytes"]) == (1, 0)
    n = kmc.KMCReader(db, materialize=False).total_kmers
    limbs = 2 if k > 32 else 1
    assert (warm_st["sidecar_built"], warm_st["sidecar_bytes"]) == (
        0, (8 * limbs + 4) * n)
    os.unlink(kmc.sorted_cache_path(db, k))
    again, _ = _call(monkeypatch, tmp_path, fa, db, "again", engine)
    assert cold == warm == again


@pytest.mark.parametrize("how", ["truncated", "magic", "version"])
def test_damaged_sidecar_is_rebuilt(tmp_path, rng, monkeypatch, how):
    """A call that finds a damaged sidecar decodes the database again,
    writes a sound sidecar and the same bytes."""
    fa, db = _sample(tmp_path, rng, 21)
    cold, _ = _call(monkeypatch, tmp_path, fa, db, "cold", "device")
    path = kmc.sorted_cache_path(db, 21)
    mtime = os.path.getmtime(path)
    _damage(path, how)
    os.utime(path, (mtime, mtime))
    got, stages = _call(monkeypatch, tmp_path, fa, db, "damaged", "device")
    assert (stages["sidecar_built"], stages["sidecar_bytes"]) == (1, 0)
    assert got == cold
    assert kmc.load_sorted_cache(db, 21) is not None


def test_sorted_cache_staleness(tmp_path, rng, monkeypatch):
    """The port's counterpart of the JAX package's test of the same name,
    through the port's CLI: a regenerated database invalidates its
    sidecar, and a call off the sidecar writes the bytes of a call after
    the sidecar was deleted."""
    from kcftools_tpu_torch.cli import main

    k = 21
    genome = random_seq(rng, 3000)
    ref = str(tmp_path / "ref.fa")
    write_fasta(ref, [("chr1", genome)])
    fa1 = str(tmp_path / "a.fa")
    write_fasta(fa1, [("chr1", mutate(rng, genome, 0.01, 0.0))])
    fa2 = str(tmp_path / "b.fa")
    write_fasta(fa2, [("chr1", mutate(rng, genome, 0.08, 0.01))])
    db = str(tmp_path / "db")
    monkeypatch.setenv("KCFTOOLS_TORCH_DEVICE", "cpu")

    def rows(tag):
        out = str(tmp_path / f"{tag}.kcf")
        assert main(["getVariations", "-r", ref, "-k", db, "-o", out,
                     "-s", "s", "-f", "window", "-w", "500"]) == 0
        with open(out) as fh:
            return [line for line in fh if not line.startswith("#")]

    assert main(["count", "-i", fa1, "-o", db, "-k", str(k)]) == 0
    b1 = rows("o1")
    cache = kmc.sorted_cache_path(db, k)
    assert os.path.exists(cache)
    assert not [f for f in os.listdir(tmp_path)
                if ".kcfsorted." in f and f.endswith(".npz")]

    assert main(["count", "-i", fa2, "-o", db, "-k", str(k)]) == 0
    old = os.path.getmtime(db + ".kmc_pre") - 100
    os.utime(cache, (old, old))  # the sidecar predates the new database
    b2 = rows("o2")
    assert b1 != b2  # the denser sample must change the rows
    rebuilt = os.path.getmtime(cache)
    assert rebuilt > old
    b2_hit = rows("o2_hit")
    assert os.path.getmtime(cache) == rebuilt  # loaded, not rebuilt
    os.unlink(cache)
    b3 = rows("o3")
    assert b2 == b2_hit == b3
