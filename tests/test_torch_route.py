"""The device join's reference routing (kcftools_tpu_torch/ops/route.py)
on the CPU: the plain version bit for bit against the host numpy it
replaced on the main path (``tile_sorted``, the slot map and
``np.packbits``), and DeviceJoinScorer's statics built through it. The
card tests (tests/test_torch_gpu.py) hold the kernels to the plain
version on the same cases."""

import os

import numpy as np
import pytest
import torch

from kcftools_tpu_torch.engine import device_join as tdj
from kcftools_tpu_torch.engine.windows import tiling_windows
from kcftools_tpu_torch.ops import pjoin as tpj
from kcftools_tpu_torch.ops import route as trt
from kcftools_tpu_torch.utils import stagetimer as st

from .torch_route_cases import CASES, KS, host_slabs, route_case, top32_key


def _keys_t(keys):
    return torch.from_numpy(np.ascontiguousarray(keys, np.uint64)
                            .view(np.int64))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", KS)
def test_plain_routing_equals_host(k, case):
    """Query tiles, Tq, each key's slot (rank and partition), the slot
    maps and the valid bitmaps, equal to the host numpy's."""
    keys, b, r_idx = route_case(case, k, seed=k)
    th, tl, _tc, rank, part = tpj.tile_sorted(keys, k, b)
    qh, ql, slot = trt.route_reference(_keys_t(keys), k, b)
    assert qh.dtype == ql.dtype == slot.dtype == torch.int32
    assert qh.shape == th.shape  # P and Tq
    assert torch.equal(qh, tpj.as_i32(th))
    assert torch.equal(ql, tpj.as_i32(tl))
    want_slot = part * th.shape[1] + rank
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    sm, vb = trt.route_slabs(torch.from_numpy(r_idx), slot)
    want_sm, want_vb = host_slabs(r_idx, want_slot)
    np.testing.assert_array_equal(sm.numpy(), want_sm)
    np.testing.assert_array_equal(vb.numpy(), want_vb)
    assert not vb[1].any()
    assert bool((vb[2] == 0xFF).all()) == (keys.shape[0] > 0)


@pytest.mark.parametrize("b", [1, 8, 16, 30])
@pytest.mark.parametrize("k", KS)
def test_partition_ids_equal_numpy(k, b):
    """The overflow-free int64 partition id equals the uint64 numpy one
    at the edges of x (0, 2^31, 2^32 - 1 and beside them) and on random
    keys, the top key clamped to P - 1."""
    rng = np.random.default_rng(b)
    shift = 2 * k - 32
    xs = np.array([0, 1, 2, 3, (1 << 31) - 1, 1 << 31, (1 << 31) + 1,
                   (1 << 32) - 2, (1 << 32) - 1], np.uint64)
    if shift >= 0:
        edge = (xs << np.uint64(shift)) | (
            np.uint64((1 << shift) - 1) if shift else np.uint64(0))
    else:
        edge = xs >> np.uint64(-shift)
    rand = rng.integers(0, 1 << 63, 5000, dtype=np.uint64) << np.uint64(1)
    if k < 32:
        rand %= np.uint64(1) << np.uint64(2 * k)
    keys = np.concatenate([edge, rand, [top32_key(k)]])
    got = trt.partition_ids(_keys_t(keys), k, b).numpy()
    np.testing.assert_array_equal(got, tpj.quantile_partition_ids(keys, b, k))
    if k >= 16:
        assert got[-1] == (1 << b) - 1


def test_route_operand_checks():
    keys = torch.arange(10, dtype=torch.int64)
    with pytest.raises(TypeError):
        trt.route_reference(keys.int(), 21, 2)
    with pytest.raises(ValueError):
        trt.route_reference(keys, 33, 2)
    with pytest.raises(ValueError):
        trt.route_reference(keys[::2], 21, 2)
    _qh, _ql, slot = trt.route_reference(keys, 21, 2)
    with pytest.raises(ValueError):
        trt.route_slabs(torch.zeros((2, 40), dtype=torch.int32), slot)
    with pytest.raises(TypeError):
        trt.route_slabs(torch.zeros((2, 64), dtype=torch.int64), slot)
    sm, vb = trt.route_slabs(torch.zeros((0, 64), dtype=torch.int32), slot)
    assert sm.shape == (0, 64) and vb.shape == (0, 8)


class _Ref:
    def __init__(self, kmers):
        self.kmers = kmers


@pytest.mark.parametrize("k", [21, 32])
def test_device_join_statics_equal_host_routing(monkeypatch, k):
    """DeviceJoinScorer on a CPU device: its query tiles and stacked slab
    statics equal ``tile_sorted`` and the host slot maps of its layout's
    slabs, and djoin_route_on_card reads 0 (the plain version)."""
    monkeypatch.setenv("KCFTOOLS_STAGE_JSON", os.devnull)
    monkeypatch.setenv("KCFTOOLS_DJOIN_SLAB", str(1 << 13))
    keys, _b, _r = route_case("top32", k, seed=3, n=20_000)
    rng = np.random.default_rng(4)
    chroms = {"a": 20_000, "b": 9_000}
    sc = tdj.DeviceJoinScorer(_Ref(keys), k, "cpu", tile_target=64)
    for name, L in chroms.items():
        r = rng.integers(0, keys.shape[0], L - k + 1).astype(np.int32)
        r[rng.random(r.shape[0]) < 0.1] = -1
        sc.add_chrom(name, r, *tiling_windows(L, 1000, k))
    st.reset()
    sc._finalize()
    snap = st.snapshot()
    st.reset()
    assert snap["djoin_route_on_card"] == 0
    b = sc.P.bit_length() - 1
    th, tl, _tc, rank, part = tpj.tile_sorted(keys, k, b)
    assert torch.equal(sc._q_hi, tpj.as_i32(th))
    assert torch.equal(sc._q_lo, tpj.as_i32(tl))
    slabs = sc._layout.slabs
    assert len(sc._statics) == len(slabs) > 1
    want_sm, want_vb = host_slabs(np.stack([s["r_idx"] for s in slabs]),
                                  part * th.shape[1] + rank)
    np.testing.assert_array_equal(sc._statics.slot_maps.numpy(), want_sm)
    np.testing.assert_array_equal(sc._statics.valid_bits.numpy(), want_vb)
    for name in ("w_start", "w_hi"):
        np.testing.assert_array_equal(
            getattr(sc._statics, name).numpy(),
            np.stack([s[name] for s in slabs]).astype(np.int64))
