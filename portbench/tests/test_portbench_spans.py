"""The readers of the program's spans and counters (``djoin_setup_s``,
``ref_load_s``, ``call_self_s``, ``h2d_gb_per_s``) on a Context recorded
from a tiny window run with the stage timer on, and on the stages of a
program that has none of them (CPU)."""

import pytest

from portbench import harness
from portbench_tiny import WINDOW, run

NEW = ("djoin_setup_s", "ref_load_s", "call_self_s", "h2d_gb_per_s")


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The Context of a tiny window run whose calls all ran with the
    stage timer on (the traced runs' stages, without the profiler)."""
    mp = pytest.MonkeyPatch()
    seen = []
    call, init = harness.Run.call, harness.Context.__init__

    def with_stages(self, files, samples, tag, genome_bp, stages=False):
        return call(self, files, samples, tag, genome_bp, stages=True)

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        seen.append(self)

    mp.setattr(harness.Run, "call", with_stages)
    mp.setattr(harness.Context, "__init__", keep)
    try:
        res = run(tmp_path_factory.mktemp("spans"), WINDOW)
    finally:
        mp.undo()
    assert res["correct"] is True
    return seen[0]


def _ctx(stages_per_call, samples=((0,),)):
    ctx = harness.Context.__new__(harness.Context)
    ctx.calls = []
    for st, smp in zip(stages_per_call, samples * len(stages_per_call)):
        c = harness.Call(list(smp), [], 0)
        c.rc, c.wall_s, c.stages = 0, 10.0, st
        ctx.calls.append(c)
    return ctx


def test_readers_on_a_recorded_run(recorded):
    ctx = recorded
    got = {n: harness._reader(n)(ctx) for n in NEW}
    assert all(v is not None and v > 0 for v in got.values()), got
    n = ctx.samples_done
    for c in ctx.calls:
        st = c.stages
        assert st["refindex_built"] == st["plan_built"] == 0
        assert st["sidecar_built"] == 0
    assert got["djoin_setup_s"] == pytest.approx(
        sum(c.stages["djoin_setup"] for c in ctx.calls) / n)
    # the root span holds the call: its parts add up to it
    unstaged = harness._reader("run_unstaged_s")(ctx)
    spans = got["djoin_setup_s"] + got["ref_load_s"] + got["call_self_s"]
    assert spans <= unstaged + 1e-3 * len(ctx.calls)
    secs = sum(c.stages["djoin_upload"] + c.stages["djoin_static_upload"]
               for c in ctx.calls)
    nbytes = sum(c.stages["djoin_h2d_bytes"] for c in ctx.calls)
    assert got["h2d_gb_per_s"] == pytest.approx(nbytes / 1e9 / secs)


def test_readers_by_hand():
    st = {"getVariations": 7.0, "getVariations.self": 0.5,
          "fasta_index": 0.1, "refindex_load": 0.3, "plan_load": 0.2,
          "djoin_setup": 4.0, "djoin_upload": 0.1,
          "djoin_static_upload": 0.1, "djoin_h2d_bytes": 10**9}
    ctx = _ctx([st, dict(st, djoin_setup=5.0)])
    assert harness._reader("djoin_setup_s")(ctx) == pytest.approx(4.5)
    assert harness._reader("ref_load_s")(ctx) == pytest.approx(0.6)
    assert harness._reader("call_self_s")(ctx) == pytest.approx(0.5)
    assert harness._reader("h2d_gb_per_s")(ctx) == pytest.approx(5.0)
    gene = dict(st, gtf_parse=0.4)
    del gene["refindex_load"], gene["plan_load"]
    assert harness._reader("ref_load_s")(_ctx([gene])) == pytest.approx(0.5)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read(name):
    """A program without the spans (the stages of an older one), a call
    without stages, no calls: None, never an error."""
    old = {"ingest": 0.8, "djoin_pack": 0.3, "djoin_upload": 0.1,
           "djoin_join": 0.01, "djoin_scan": 0.01, "djoin_fetch": 0.01,
           "scan": 0.1, "write": 0.05}
    read = harness._reader(name)
    assert read(_ctx([old, old])) is None
    assert read(_ctx([None])) is None
    assert read(_ctx([])) is None
