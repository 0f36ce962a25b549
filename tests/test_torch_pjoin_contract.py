"""The join's whole contract on the CPU: the port's plain join against
the JAX package's Pallas kernel bodies (interpreted) and a dict oracle,
on operands beyond what real tiles hold (tests/torch_join_cases.py):
duplicate keys that sum, uint32 sums that wrap, the all-ones key as a
table key and as a query, unsorted rows, odd widths. The CUDA kernel is
held to the plain join on the same operands on the card
(tests/test_torch_gpu.py). All comparisons are exact.
"""

import numpy as np
import pytest

from .test_torch_pjoin import _pallas, _port
from .torch_join_cases import EDGE_SHAPES, hard_join_operands, layout_width


def _oracle(qh, ql, th, tl, cnt):
    """Per partition, each query's count summed over every matching
    table slot, mod 2^32."""
    out = np.zeros(qh.shape, np.uint32)
    for p in range(qh.shape[0]):
        sums = {}
        for h, lo, c in zip(th[p].tolist(), tl[p].tolist(), cnt[p].tolist()):
            key = (h, lo)
            sums[key] = (sums.get(key, 0) + c) & 0xFFFFFFFF
        out[p] = [sums.get(key, 0) for key in zip(qh[p].tolist(),
                                                   ql[p].tolist())]
    return out


def _unpacked(tc, packed):
    if not packed:
        return tc
    return np.concatenate(
        [(tc >> np.uint32(8 * b)) & np.uint32(0xFF) for b in range(4)],
        axis=1,
    )


@pytest.mark.parametrize("packed", [False, True], ids=["u32", "packed"])
@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=["x".join(map(str, s)) for s in EDGE_SHAPES])
def test_plain_join_holds_the_contract(shape, packed):
    P, Tq, Tt = shape
    Tt = layout_width(Tt, packed)
    qh, ql, th, tl, tc = hard_join_operands(P + Tt, P, Tq, Tt, packed)
    got = _port(qh, ql, th, tl, tc, packed)
    want = _oracle(qh, ql, th, tl, _unpacked(tc, packed))
    assert np.array_equal(got, want)
    assert np.array_equal(got, _pallas(qh, ql, th, tl, tc, packed))
    # the cases are there: a duplicate pair, the ones key, and (u32)
    # sums that wrapped
    assert (got[:, 2] > 0).any() and (got[::3, 0] > 0).all()
    if not packed:
        assert (got[:, 2] == 0x10).all()
        assert (got[::3, 0] == 0xFFFFFFFE).all()
