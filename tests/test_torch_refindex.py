"""The port's reference k-mer index cache (``engine/refindex.py``:
``<fasta>.kcfidx.k<k>[.fwd].raw``, a header and the raw, aligned key and
r_idx arrays, loaded as read-only views of a memory map): the round trip
against the JAX package's build, the misses that rebuild the file, and
``getVariations`` off a loaded index against the call that built it
(CPU)."""

import mmap
import os
import shutil
import struct

import numpy as np
import pytest

from kcftools_tpu.engine.refindex import RefKmerIndex as JaxRefKmerIndex
from kcftools_tpu.io.fasta import FastaIndex as JaxFastaIndex
from kcftools_tpu_torch.engine import refindex
from kcftools_tpu_torch.engine.refindex import RefKmerIndex
from kcftools_tpu_torch.io.fasta import FastaIndex
from kcftools_tpu_torch.utils import stagetimer as st

from .gen import random_seq, write_fasta
from .test_torch_sidecar import _call, _sample

# narrow (one uint64 limb), wide (hi/lo limbs) and multi-limb (byte
# record) keys
KS = [21, 31, 33, 45, 64, 75]


@pytest.fixture
def counted(monkeypatch):
    """The stage timer's counters on, from a fresh state."""
    monkeypatch.setenv("KCFTOOLS_STAGE_JSON", os.devnull)
    st.reset()
    yield
    st.reset()


def _fasta(tmp_path, rng):
    """A reference with N runs, a contig shorter than any k (no k-mer,
    an empty r_idx), an all-N contig and a short one, dated in the past
    so that any cache written now is fresh."""
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, [("c1", random_seq(rng, 3000, n_prob=0.01)),
                     ("short", "ACGTACGTAC"),
                     ("allN", "N" * 200),
                     ("c2", random_seq(rng, 40))])
    os.utime(fa, (1e9, 1e9))
    return fa


def _arrays(ridx):
    """(name, array) of an index's keys and every r_idx, in order."""
    keys = (("kmers_hi", ridx.kmers_hi), ("kmers_lo", ridx.kmers_lo)) \
        if ridx.wide else (("kmers", ridx.kmers),)
    return [*keys, *((n, ridx.chrom_r_idx[n]) for n in ridx.chrom_names)]


def _assert_same(got, want):
    assert list(got.chrom_names) == [str(n) for n in want.chrom_names]
    assert (got.k, got.canonical, got.wide, got.mlimb) == (
        want.k, want.canonical, want.wide, want.mlimb)
    for (gn, g), (wn, w) in zip(_arrays(got), _arrays(want), strict=True):
        assert gn == wn
        assert g.dtype == w.dtype and g.shape == w.shape, gn
        np.testing.assert_array_equal(g, w)


def _load(fa, k, canonical=True):
    return RefKmerIndex.load_or_build(fa, FastaIndex(fa), k, canonical)


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", KS)
def test_round_trip_matches_jax_build(tmp_path, rng, counted, k,
                                      canonical):
    """The index built and cached cold, and the one mapped from the
    cache warm, equal the JAX package's build of the same FASTA to the
    bit: keys, names and every r_idx (the short and all-N contigs'
    included)."""
    fa = _fasta(tmp_path, rng)
    want = JaxRefKmerIndex.build(JaxFastaIndex(fa), k, canonical)
    cold = _load(fa, k, canonical)
    assert st.snapshot()["refindex_built"] == 1
    st.reset()
    warm = _load(fa, k, canonical)
    assert st.snapshot() == {"refindex_built": 0,
                             "refindex_bytes": warm.nbytes}
    _assert_same(cold, want)
    _assert_same(warm, want)
    assert warm.chrom_r_idx["short"].shape == (0,)
    assert (warm.chrom_r_idx["allN"] == -1).all()


@pytest.mark.parametrize("k", [31, 45, 75])
def test_cache_is_a_mapped_raw_file(tmp_path, rng, counted, k):
    """The cache is ``.kcfidx.k<k>[.fwd].raw``, no ``.npz`` is written,
    and the loaded keys and r_idx are read-only views of a memory map at
    64-byte-aligned offsets; ``nbytes`` is their bytes."""
    fa = _fasta(tmp_path, rng)
    for canonical in (True, False):
        _load(fa, k, canonical)
    names = sorted(os.listdir(tmp_path))
    assert [n for n in names if ".kcfidx." in n] == [
        f"ref.fa.kcfidx.k{k}.fwd.raw", f"ref.fa.kcfidx.k{k}.raw"]
    path = RefKmerIndex.cache_path(fa, k, True)
    with open(path, "rb") as fh:
        assert fh.read(8) == b"KCFRIDX\0"
    warm = _load(fa, k)
    arrays = _arrays(warm)
    for name, a in arrays:
        assert not a.flags.writeable, name
        assert isinstance(a.base.obj, mmap.mmap), name
        assert a.ctypes.data % 64 == 0 or a.size == 0, name
    assert warm.nbytes == sum(a.nbytes for _, a in arrays)
    assert warm.nbytes == warm.n_kmers * (
        8 if k <= 32 else 16 if k <= 64 else (k + 3) // 4
    ) + 4 * sum(a.size for _, a in arrays[1 + warm.wide:])


def _rewrite(path, at, fmt, value):
    with open(path, "r+b") as fh:
        fh.seek(at)
        fh.write(struct.pack(fmt, value))


def _offsets(path):
    """The section offsets that the file's header lists."""
    with open(path, "rb") as fh:
        head = refindex._HEAD.unpack(fh.read(refindex._HEAD.size))
        n_sections = 2 + (2 if head[2] in range(33, 65) else 1) + head[6]
        return struct.unpack(f"<{n_sections}Q", fh.read(8 * n_sections))


def _damage(fa, path, how):
    """Make the cache of ``fa`` at ``path`` stale, damaged or another
    index's, in the way ``how`` names."""
    size = os.path.getsize(path)
    if how == "fasta_newer":
        # the FASTA as new as the cache: '<=' counts that as stale
        os.utime(path, (1e9, 1e9))
    elif how == "fasta_size":
        # one byte more, the same names and lengths, the old date
        with open(fa, "a") as fh:
            fh.write("\n")
        os.utime(fa, (1e9, 1e9))
        os.unlink(fa + ".faidx")
    elif how == "contig_added":
        with open(fa, "a") as fh:
            fh.write(">c3\nACGTACGTACGTACGTACGTACGTACGTACGT\n")
        os.utime(fa, (1e9, 1e9))
        os.unlink(fa + ".faidx")
    elif how == "renamed":
        # the same lengths and file size, other names
        with open(fa) as fh:
            text = fh.read().replace(">c1\n", ">c9\n")
        with open(fa, "w") as fh:
            fh.write(text)
        os.utime(fa, (1e9, 1e9))
        os.unlink(fa + ".faidx")
    elif how == "truncated":
        os.truncate(path, size - 4)
    elif how == "extended":
        with open(path, "ab") as fh:
            fh.write(b"\0" * 64)
    elif how == "magic":
        _rewrite(path, 0, "8s", b"PK\x03\x04\0\0\0\0")
    elif how == "version":
        _rewrite(path, 8, "<I", 2)
    elif how == "k":
        _rewrite(path, 12, "<I", 23)
    elif how == "strand":
        _rewrite(path, 16, "<I", 0)
    elif how == "kind":
        _rewrite(path, 20, "<I", 2)
    elif how == "offset":
        _rewrite(path, refindex._HEAD.size + 8 * 2, "<Q",
                 _offsets(path)[2] + 64)
    elif how == "ridx_len":
        # the first chromosome's r_idx length in the chromosome table
        _rewrite(path, _offsets(path)[0] + 8, "<q", 2979)
    else:
        raise AssertionError(how)


_MISSES = ["fasta_newer", "fasta_size", "contig_added", "renamed", "truncated", "extended",
           "magic", "version", "k", "strand", "kind", "offset", "ridx_len"]


@pytest.mark.parametrize("how", _MISSES)
def test_miss_rebuilds_and_rewrites(tmp_path, rng, counted, how):
    """A stale, damaged or foreign cache is a miss: the index is built
    again (``refindex_built`` 1, ``refindex_bytes`` 0) and equals the JAX
    build of the FASTA as it now is, and the file is rewritten, so the
    next load maps it."""
    fa = _fasta(tmp_path, rng)
    path = RefKmerIndex.cache_path(fa, 31, True)
    _load(fa, 31)
    _damage(fa, path, how)
    st.reset()
    got = _load(fa, 31)
    assert st.snapshot()["refindex_built"] == 1
    assert st.snapshot()["refindex_bytes"] == 0
    _assert_same(got, JaxRefKmerIndex.build(JaxFastaIndex(fa), 31, True))
    st.reset()
    again = _load(fa, 31)
    assert st.snapshot() == {"refindex_built": 0,
                             "refindex_bytes": again.nbytes}
    _assert_same(again, got)
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_other_k_and_strand_miss(tmp_path, rng, counted):
    """A cache file copied under another k's or the other strand's name
    is a miss, rebuilt under that name."""
    fa = _fasta(tmp_path, rng)
    src = RefKmerIndex.cache_path(fa, 21, True)
    _load(fa, 21)
    for k, canonical in ((23, True), (21, False)):
        shutil.copy2(src, RefKmerIndex.cache_path(fa, k, canonical))
        st.reset()
        got = _load(fa, k, canonical)
        assert st.snapshot()["refindex_built"] == 1
        _assert_same(got, JaxRefKmerIndex.build(JaxFastaIndex(fa), k,
                                                canonical))
        st.reset()
        _load(fa, k, canonical)
        assert st.snapshot()["refindex_built"] == 0


def test_old_npz_cache_is_ignored(tmp_path, rng, counted):
    """A ``.kcfidx.k<k>.npz`` beside the FASTA (the JAX package's cache)
    is neither read nor written: the port builds its ``.raw``."""
    fa = _fasta(tmp_path, rng)
    JaxRefKmerIndex.load_or_build(fa, JaxFastaIndex(fa), 31)
    npz = fa + ".kcfidx.k31.npz"
    assert os.path.exists(npz)
    stamp = os.stat(npz)
    _load(fa, 31)
    assert st.snapshot()["refindex_built"] == 1
    assert os.stat(npz).st_mtime_ns == stamp.st_mtime_ns
    assert os.path.exists(RefKmerIndex.cache_path(fa, 31, True))


def test_unwritable_cache_still_builds(tmp_path, rng, counted,
                                       monkeypatch):
    """Where the cache cannot be written the index is still built and
    returned, and no temporary file is left behind."""
    fa = _fasta(tmp_path, rng)

    def refuse(*a, **k):
        raise OSError("read-only")

    with monkeypatch.context() as mp:
        mp.setattr(os, "replace", refuse)
        got = _load(fa, 31)
    _assert_same(got, JaxRefKmerIndex.build(JaxFastaIndex(fa), 31, True))
    assert not [n for n in os.listdir(tmp_path)
                if ".kcfidx." in n or n.endswith(".tmp")]


@pytest.mark.parametrize("engine,k", [("device", 21), ("dprefix", 21),
                                      ("hybrid", 21), ("dprefix", 45),
                                      ("hybrid", 45)])
def test_get_variations_off_loaded_index(tmp_path, rng, monkeypatch,
                                         engine, k):
    """A call off the mapped index writes the bytes of the call that
    built it (so no consumer writes into the read-only arrays), and of a
    call after the cache was deleted; the warm call counts the index's
    bytes served."""
    fa, db = _sample(tmp_path, rng, k)
    os.utime(fa, (1e9, 1e9))
    cold, cold_st = _call(monkeypatch, tmp_path, fa, db, "cold", engine)
    warm, warm_st = _call(monkeypatch, tmp_path, fa, db, "warm", engine)
    assert (cold_st["refindex_built"], cold_st["refindex_bytes"]) == (1, 0)
    served = _load(fa, k).nbytes
    assert (warm_st["refindex_built"], warm_st["refindex_bytes"]) == (
        0, served)
    os.unlink(RefKmerIndex.cache_path(fa, k, True))
    again, _ = _call(monkeypatch, tmp_path, fa, db, "again", engine)
    assert cold == warm == again
