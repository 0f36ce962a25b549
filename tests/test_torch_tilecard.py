"""The device join's sample tiling (kcftools_tpu_torch/ops/route.py::
tile_sample) on the CPU: the plain version bit for bit against the host
packers it replaced on the main path, ``tile_sorted`` + ``pack_planar``,
the port's ``pack_tiles_host`` (the native ``kcf_pjoin_pack`` where the
library builds) and the JAX package's ``DeviceJoinScorer._pack_tiles``,
on the cases of tests/torch_route_cases.py, and the sticky table width
over samples. The card tests (tests/test_torch_gpu.py) hold the kernels
to the plain version on the same cases."""

import numpy as np
import pytest
import torch

from kcftools_tpu.engine import device_join as jdj
from kcftools_tpu_torch.engine.device_join import pack_tiles_host
from kcftools_tpu_torch.ops import pjoin as tpj
from kcftools_tpu_torch.ops import route as trt

from .torch_route_cases import (
    CASES,
    COUNTS,
    KS,
    route_case,
    sample_case,
    top32_key,
)


def _tile(keys, counts, k, b, tile=None):
    """``tile_sample`` of numpy operands; the buffer as uint32."""
    buf, Tt, packed = trt.tile_sample(
        torch.from_numpy(np.ascontiguousarray(keys, np.uint64)
                         .view(np.int64)),
        tpj.as_i32(counts), k, b, tile)
    assert buf.dtype == torch.int32 and buf.dim() == 1
    return buf.numpy().view(np.uint32), Tt, packed


def _host_pack(keys, counts, k, b, tile, packed):
    """``tile_sorted`` + ``pack_planar``: the flat buffer of the host's
    numpy path."""
    th, tl, tc, _, _ = tpj.tile_sorted(keys, k, b, tile=tile, counts=counts)
    planes = (th, tl, tpj.pack_planar(tc) if packed else tc)
    return np.concatenate([a.ravel() for a in planes])


def _jax_pack(keys, counts, k, b, tile):
    """The JAX package's host pack after a sample that took the width
    ``tile`` (None: the first), or None where a key's raw partition id is
    P: the JAX package's partition function does not clamp it to P - 1,
    and its native packer would write past its buffers."""
    if keys.shape[0] and tpj.raw_quantile_ids(keys, b, k).max() >= 1 << b:
        return None
    sc = jdj.DeviceJoinScorer.__new__(jdj.DeviceJoinScorer)
    sc.P, sc.k, sc._sample_tile = 1 << b, k, tile
    return sc._pack_tiles(np.ascontiguousarray(keys, np.uint64),
                          np.ascontiguousarray(counts, np.uint32))


def _assert_packs(keys, counts, k, b, got, tile=None):
    """``tile_sample``'s (buf, Tt, packed), after a sample that took the
    width ``tile``, equals the host packers' word for word: numpy's at
    Tt, and the port's ``pack_tiles_host`` and the JAX package's, which
    pick Tt and the count layout themselves from ``tile``."""
    buf, Tt, packed = got
    want = _host_pack(keys, counts, k, b, Tt, packed)
    np.testing.assert_array_equal(buf, want)
    for other in (pack_tiles_host(keys, counts, k, b, tile),
                  _jax_pack(keys, counts, k, b, tile)):
        if other is not None:
            assert other[1:] == (Tt, packed)
            np.testing.assert_array_equal(other[0], want)


@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", KS)
def test_plain_tiling_equals_host_pack(k, case, counts):
    """Tt, the count layout and every word of the buffer equal the host
    packers': keys with bit 63 set at k = 32, the top-32 keys clamped to
    P - 1, empty partitions, one partition, one key and an empty sample;
    byte counts, one 256 among them, counts up to 2^32 - 1."""
    keys, b, c = sample_case(case, k, counts, seed=k)
    buf, Tt, packed = _tile(keys, c, k, b)
    per = np.bincount(tpj.quantile_partition_ids(keys, b, k),
                      minlength=1 << b)
    assert Tt == tpj.round_up(int(per.max()) + 64, tpj.LANE)
    assert packed == (counts == "u8" or keys.shape[0] == 0)
    nt = (1 << b) * Tt
    assert buf.shape == (2 * nt + (nt // 4 if packed else nt),)
    _assert_packs(keys, c, k, b, (buf, Tt, packed))


def test_plain_tiling_top_keys_last_partition():
    """At k = 32 the keys whose top 32 bits are all set, the palindrome
    T^16A^16 among them, lie in the last partition, after its other keys:
    their raw partition id is P."""
    k, b = 32, 4
    top = top32_key(k)
    keys, _b, _r = route_case("canonical", k, seed=7, n=3000)
    keys = np.unique(np.concatenate([keys, [top, top + np.uint64(9)]]))
    c = np.arange(1, keys.shape[0] + 1, dtype=np.uint32)
    assert (tpj.raw_quantile_ids(keys, b, k) == 1 << b).sum() == 2
    buf, Tt, packed = _tile(keys, c, k, b)
    assert not packed
    P, nt = 1 << b, (1 << b) * Tt
    hi = buf[:nt].reshape(P, Tt)
    last = np.flatnonzero(hi[P - 1])[-2:]
    np.testing.assert_array_equal(hi[P - 1, last], [0xFFFFFFFF] * 2)
    np.testing.assert_array_equal(buf[2 * nt:].reshape(P, Tt)[P - 1, last],
                                  c[-2:])
    _assert_packs(keys, c, k, b, (buf, Tt, packed))


def test_plain_tiling_sticky_tile():
    """A large sample sets the table width; a smaller one after it keeps
    that width (its partitions padded wider), and a larger one grows it:
    each buffer still equals the host packers' at its width."""
    k = 31
    large, b, c_large = sample_case("canonical", k, "u8", seed=5, n=40_000)
    small, _b, c_small = sample_case("canonical", k, "u32", seed=6, n=8000)
    larger, _b, c_larger = sample_case("canonical", k, "u8", seed=8,
                                       n=90_000)
    first = _tile(large, c_large, k, b)
    _assert_packs(large, c_large, k, b, first)
    Tt = first[1]
    second = _tile(small, c_small, k, b, Tt)
    assert second[1] == Tt and not second[2]
    assert _tile(small, c_small, k, b)[1] < Tt  # alone, it is narrower
    _assert_packs(small, c_small, k, b, second, Tt)
    third = _tile(larger, c_larger, k, b, Tt)
    assert third[1] > Tt and third[2]
    _assert_packs(larger, c_larger, k, b, third, Tt)


def test_sample_tile_rule():
    """The sticky width: need and 64 of headroom rounded up to 128 for
    the first sample and for any that outgrows the width; kept
    otherwise."""
    assert trt.sample_tile(0) == trt.sample_tile(1) == 128
    assert trt.sample_tile(64) == 128 and trt.sample_tile(65) == 256
    assert trt.sample_tile(700) == 768
    assert trt.sample_tile(700, 1024) == 1024
    assert trt.sample_tile(1024, 1024) == 1024
    assert trt.sample_tile(1025, 1024) == 1152


def test_tile_sample_operand_checks():
    keys = torch.arange(10, dtype=torch.int64)
    counts = torch.ones(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        trt.tile_sample(keys.int(), counts, 21, 2)
    with pytest.raises(TypeError):
        trt.tile_sample(keys, counts.long(), 21, 2)
    with pytest.raises(TypeError):
        trt.tile_sample(keys, counts[:9], 21, 2)
    with pytest.raises(ValueError):
        trt.tile_sample(keys[::2], counts[::2], 21, 2)
    with pytest.raises(ValueError):
        trt.tile_sample(keys, counts, 33, 2)
