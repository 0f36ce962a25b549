"""The port's entry points (kcftools_tpu_torch/dryrun.py), the
counterpart of __graft_entry__.py, on CPU slots: ``entry()`` against the
JAX ``entry()`` on the same tiny problem, and ``dryrun_multichip`` on 8
and on 4 slots (each of its steps checks itself exactly)."""

import numpy as np
import pytest

from kcftools_tpu_torch import dryrun

from .test_torch_cli import _REPO


@pytest.fixture(autouse=True)
def cpu_slots(monkeypatch):
    monkeypatch.setenv("KCFTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("KCFTOOLS_TORCH_VIRTUAL_DEVICES", "8")


def test_entry_matches_jax_entry(monkeypatch):
    monkeypatch.syspath_prepend(_REPO)
    import __graft_entry__

    fn, args = dryrun.entry()
    got = fn(*args)
    jfn, jargs = __graft_entry__.entry()
    want = jfn(*jargs)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(v),
                                      err_msg=key)
    assert (got["total"] > 0).all()


@pytest.mark.parametrize("n", [8, 4])
def test_dryrun_multichip(n):
    dryrun.dryrun_multichip(n)


def test_dryrun_needs_enough_slots(monkeypatch):
    monkeypatch.setenv("KCFTOOLS_TORCH_VIRTUAL_DEVICES", "2")
    with pytest.raises(RuntimeError, match="only 2 slot"):
        dryrun.dryrun_multichip(4)
