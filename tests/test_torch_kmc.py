"""The port's KMC writer (kcftools_tpu_torch/io/kmc.py::write_kmc_db):
its bin-major record keys stay exact where nbins x lut_size reaches
2^32 (uint64 keys past it, where uint32 keys wrap), and at the default
lut and signature lengths its databases, written directly and by the
``count`` subcommand, keep the JAX writer's bytes."""

import numpy as np
import pytest

from kcftools_tpu.cli import main as jax_main
from kcftools_tpu.io import kmc as jkmc
from kcftools_tpu_torch.cli import main as port_main
from kcftools_tpu_torch.io import kmc as tkmc

from .gen import random_seq, write_fasta


def _keys(nbins, lut_len, k):
    """A few records of the highest bins of an nbins-bin database, with
    every lut prefix's extremes."""
    suffix_len = k - lut_len
    lut_size = 1 << (2 * lut_len)
    bins = np.array([0, 1, nbins - 2, nbins - 1, nbins - 1], np.uint32)
    prefix = np.array([0, 7, lut_size - 1, 0, lut_size - 1], np.uint64)
    kmers = (prefix << np.uint64(2 * suffix_len)) | np.uint64(5)
    want = bins.astype(np.uint64) * np.uint64(lut_size) + prefix
    got = tkmc._bin_major_keys(bins, kmers, suffix_len, lut_size, nbins)
    return got, want, lut_size


@pytest.mark.parametrize("nbins,lut_len", [(1 << 18, 7), (1 << 20, 8),
                                           ((1 << 16) + 1, 8)])
def test_bin_major_keys_past_2_32(nbins, lut_len):
    """nbins x lut_size >= 2^32 (a caller's larger lut or signature
    length): uint64 keys, exact up to the last bin's last prefix."""
    got, want, lut_size = _keys(nbins, lut_len, 31)
    assert nbins * lut_size >= 1 << 32
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    assert int(got[-1]) == nbins * lut_size - 1
    assert (np.diff(got.astype(np.float64)) >= 0).all()  # still sorted


def test_bin_major_keys_default_stay_uint32():
    """Below 2^32 (the defaults) the keys keep their uint32 width."""
    got, want, lut_size = _keys(1 << 10, 4, 31)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got.astype(np.uint64), want)


def _read(prefix):
    return [open(prefix + ext, "rb").read() for ext in (".kmc_pre",
                                                        ".kmc_suf")]


@pytest.mark.parametrize("k,both_strands", [(15, True), (31, True),
                                            (31, False), (32, True)])
def test_writer_bytes_match_jax(tmp_path, rng, k, both_strands):
    """Default lut and signature lengths: the port's and the JAX writer's
    files are byte-equal."""
    kmers = np.unique(rng.integers(0, 1 << (2 * k) - 1, 5000,
                                   dtype=np.uint64))
    counts = rng.integers(1, 300, kmers.shape[0]).astype(np.uint32)
    for mod, name in ((tkmc, "port"), (jkmc, "jax")):
        mod.write_kmc_db(str(tmp_path / name), kmers, counts, k,
                         both_strands=both_strands)
    assert _read(str(tmp_path / "port")) == _read(str(tmp_path / "jax"))


def test_count_bytes_match_jax(tmp_path, rng):
    """``count`` through both CLIs: the same database bytes."""
    fa = str(tmp_path / "s.fa")
    write_fasta(fa, [("c1", random_seq(rng, 20_000, n_prob=0.01)),
                     ("c2", random_seq(rng, 7_000))])
    for main, name in ((port_main, "port"), (jax_main, "jax")):
        assert main(["count", "-i", fa, "-o", str(tmp_path / name),
                     "-k", "21"]) == 0
    assert _read(str(tmp_path / "port")) == _read(str(tmp_path / "jax"))
