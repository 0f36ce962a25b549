"""The port's partitioned join (kcftools_tpu_torch/ops/pjoin.py) against
the JAX package's.

The same numpy inputs go through the port's plain join (what
``pjoin_join`` runs on CPU tensors), the JAX package's Pallas kernel
bodies ``_kernel`` / ``_kernel_packed`` run through
``pl.pallas_call(..., interpret=True)``, the XLA program of
``pjoin_lookup_fn``, and a dict oracle. All comparisons are exact: the
data are integers. The CUDA kernel itself is compared with the plain
join on the card (tests/test_torch_gpu.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kcftools_tpu.ops import pjoin as jpj
from kcftools_tpu_torch.engine.encode import canonicalize
from kcftools_tpu_torch.ops import pjoin as tpj

_TOP32 = np.uint64(0xFFFFFFFF00000000)  # k=32 T^16A^16 (a palindrome)


def _pallas(qh, ql, th, tl, tc, packed):
    """The JAX package's Pallas kernel bodies, interpreted on the CPU,
    with the block layout of kcftools_tpu/ops/pjoin.py::_pjoin_fn."""
    P, Tq = qh.shape
    Tt = th.shape[1]
    B = 8 if P % 8 == 0 else P
    z = np.int32(0)

    def bs(T):
        return pl.BlockSpec((B, T), lambda p: (p, z))

    kern = jpj._kernel_packed if packed else jpj._kernel
    out = pl.pallas_call(
        kern,
        grid=(P // B,),
        in_specs=[bs(Tq), bs(Tq), bs(Tt), bs(Tt), bs(tc.shape[1])],
        out_specs=bs(Tq),
        out_shape=jax.ShapeDtypeStruct((P, Tq), jnp.int32),
        interpret=True,
    )(qh, ql, th, tl, tc)
    return np.asarray(out).view(np.uint32)


def _xla(qh, ql, th, tl, tc, packed):
    fn = jpj.pjoin_lookup_fn(qh.shape[0], qh.shape[1], th.shape[1],
                             packed=packed)
    return np.asarray(fn(qh, ql, th, tl, tc))


def _port(qh, ql, th, tl, tc, packed):
    out = tpj.pjoin_join(
        tpj.as_i32(qh), tpj.as_i32(ql), tpj.as_i32(th), tpj.as_i32(tl),
        tpj.as_i32(tc), packed=packed,
    )
    return out.numpy().view(np.uint32)


def _counts(rng, n, packed):
    if packed:
        return rng.integers(1, 256, n).astype(np.uint32)
    c = rng.integers(1, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    c[: n // 3] = rng.integers(256, 4096, n // 3).astype(np.uint32)
    if n:
        c[-1] = np.uint32(0xFFFFFFFF)  # KMC counters reach 2^32 - 1
    return c


def _canonical(rng, n, k):
    """n random canonical k-mers, the values a KMC database holds: their
    density falls as 2 - 2u, which the quantile tiling evens out."""
    return canonicalize(rng.integers(0, 1 << (2 * k), n, dtype=np.uint64),
                        k)


@pytest.mark.parametrize("packed", [False, True], ids=["u32", "packed"])
@pytest.mark.parametrize("n_keys", [0, 1, 37, 5000, 200_000])
def test_pjoin_ref_matches_pallas_xla_oracle(n_keys, packed):
    rng = np.random.default_rng(n_keys + packed)
    k = 31
    keys = np.unique(_canonical(rng, max(n_keys, 1), k))[:n_keys]
    if n_keys > 1:
        keys[0] = 0  # the all-A k-mer, which padding slots also match
    counts = _counts(rng, keys.shape[0], packed)
    b = max(1, (keys.shape[0] // 256).bit_length())
    th, tl, tc, _, _ = tpj.tile_sorted(keys, k, b, counts=counts)

    n_q = 4096
    q = np.unique(np.concatenate([
        rng.choice(keys, n_q) if keys.size else np.empty(0, np.uint64),
        _canonical(rng, n_q, k),
        np.zeros(4, np.uint64),
    ]))
    qh, ql, _, rank, part = tpj.tile_sorted(q, k, b)
    tc = tpj.pack_planar(tc) if packed else tc

    got = _port(qh, ql, th, tl, tc, packed)
    assert np.array_equal(got, _pallas(qh, ql, th, tl, tc, packed))
    assert np.array_equal(got, _xla(qh, ql, th, tl, tc, packed))

    oracle = dict(zip(keys.tolist(), counts.tolist()))
    exp = np.array([oracle.get(int(x), 0) for x in q], np.uint32)
    assert np.array_equal(got[part, rank], exp)


def test_tile_sorted_tile_bound():
    """A tile below the fullest partition raises in both packages; a
    tile of exactly its size tiles every key and joins exactly."""
    rng = np.random.default_rng(3)
    k, b = 31, 4
    keys = np.unique(rng.integers(0, 1 << 62, 9000, dtype=np.uint64))
    counts = rng.integers(256, 1 << 20, keys.shape[0]).astype(np.uint32)
    mx = int(np.bincount(tpj.quantile_partition_ids(keys, b, k)).max())
    assert mx % tpj.LANE  # not a width the default tile would pick
    for pj in (tpj, jpj):
        with pytest.raises(OverflowError):
            pj.tile_sorted(keys, k, b, tile=mx - 1, counts=counts)
    th, tl, tc, _, _ = tpj.tile_sorted(keys, k, b, tile=mx, counts=counts)
    for a, w in zip((th, tl, tc),
                    jpj.tile_sorted(keys, k, b, tile=mx, counts=counts)):
        assert np.array_equal(a, w)
    sel = np.arange(0, keys.shape[0], 18)
    qh, ql, _, rank, part = tpj.tile_sorted(keys[sel], k, b)
    got = _port(qh, ql, th, tl, tc, False)
    assert np.array_equal(got, _pallas(qh, ql, th, tl, tc, False))
    assert np.array_equal(got[part, rank], counts[sel])


@pytest.mark.parametrize("k", [17, 21, 31, 32])
def test_tile_sorted_matches_jax(k):
    rng = np.random.default_rng(k)
    keys = np.unique(rng.integers(0, 1 << (2 * k), 20_000, dtype=np.uint64))
    keys = keys[keys < _TOP32] if k == 32 else keys
    counts = rng.integers(1, 1000, keys.shape[0]).astype(np.uint32)
    for b in (1, 4, 6):
        got = tpj.tile_sorted(keys, k, b, counts=counts)
        want = jpj.tile_sorted(keys, k, b, counts=counts)
        for a, w in zip(got, want):
            assert np.array_equal(a, w)


@pytest.mark.parametrize("packed", [False, True], ids=["u32", "packed"])
def test_top_partition_key_is_clamped(packed):
    """T^16A^16 at k=32 has all top-32 bits set: the unclamped quantile
    function sends it to partition P. The port keeps it in P-1 and
    joins it exactly (checked against a dict oracle; the JAX package
    raises on this key, so it is no reference here)."""
    k, b = 32, 5
    P = 1 << b
    assert tpj.raw_quantile_ids(np.array([_TOP32]), b, k)[0] == P
    assert tpj.quantile_partition_ids(np.array([_TOP32]), b, k)[0] == P - 1
    rng = np.random.default_rng(5)
    keys = np.unique(np.concatenate([
        rng.integers(0, 1 << 63, 3000, dtype=np.uint64) << np.uint64(1),
        np.array([0, _TOP32 - np.uint64(1), _TOP32], np.uint64),
    ]))
    ids = tpj.quantile_partition_ids(keys, b, k)
    assert ids.max() == P - 1 and (np.diff(ids) >= 0).all()
    counts = rng.integers(1, 256 if packed else 1 << 32, keys.shape[0],
                          dtype=np.uint64).astype(np.uint32)
    th, tl, tc, _, _ = tpj.tile_sorted(keys, k, b, counts=counts)
    sel = np.r_[np.arange(0, keys.shape[0] - 1, 3), keys.shape[0] - 1]
    qh, ql, _tc, rank, part = tpj.tile_sorted(keys[sel], k, b)
    assert part[-1] == P - 1
    tcw = tpj.pack_planar(tc) if packed else tc
    got = _port(qh, ql, th, tl, tcw, packed)
    assert np.array_equal(got[part, rank], counts[sel])


def test_pjoin_join_checks_operands():
    z = torch.zeros((4, 128), dtype=torch.int32)
    with pytest.raises(TypeError):
        tpj.pjoin_join(z.long(), z, z, z, z, packed=False)
    with pytest.raises(ValueError):
        tpj.pjoin_join(z, z, z, z, z, packed=True)  # tc must be (P, Tt/4)
    with pytest.raises(ValueError):
        tpj.pjoin_join(z, z[:2], z, z, z, packed=False)
    with pytest.raises(ValueError):
        tpj.pjoin_join(z, z, z.t(), z.t(), z.t(), packed=False)
    m = torch.zeros((4, 128), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        tpj.pjoin_join(m, m, m, m, m, packed=False)
    before = (tpj.pjoin_join.launches_u32, tpj.pjoin_join.launches_packed)
    tpj.pjoin_join(z, z, z, z, z, packed=False)
    tpj.pjoin_join(z, z, z, z, z[:, :32].contiguous(), packed=True)
    # CPU tensors run the plain version, never a kernel
    assert (tpj.pjoin_join.launches_u32,
            tpj.pjoin_join.launches_packed) == before
