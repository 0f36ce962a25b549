"""The port's CUDA kernel and device engine on the card.

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

from kcftools_tpu_torch._host import canonicalize, pack_kmers, tiling_windows
from kcftools_tpu_torch.engine.device_join import DeviceJoinScorer
from kcftools_tpu_torch.ops import pjoin as tpj

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
    """Tt above the kernel's shared-memory chunk (1024 slots): the
    partition's table is staged in several chunks."""
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
    for dev in (torch.device("cpu"), cuda_device):
        sc = DeviceJoinScorer(_Ref(refk), k, dev, min_count=2)
        sc.add_chrom("c", r_idx, starts, ends)
        sc.submit(0, refk, db, dbc)
        out[dev.type] = sc.collect(0)["c"]
    for f, want in out["cpu"].items():
        np.testing.assert_array_equal(out["cuda"][f], want, err_msg=f)
    assert out["cuda"]["observed"].sum() > 0
