"""``spangaps.SpanTrace`` on a synthetic Chrome trace: idle gaps
labelled by the program's innermost span, the window's HtoD copies, and
every number of ``trace.Trace`` unchanged; the stages per sample
(CPU)."""

import pytest

from portbench import harness
from portbench.spangaps import SpanTrace, stages_per_sample
from portbench.trace import Trace


def _ev(name, cat, ts, dur, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


EVENTS = [
    _ev("portbench.window", "user_annotation", 1000, 10000),
    _ev("call c0 s1", "user_annotation", 1000, 6000),
    _ev("call c1 s2", "user_annotation", 7000, 4000),
    _ev("getVariations", "user_annotation", 1100, 5800),
    _ev("djoin_setup", "user_annotation", 1200, 5000),
    _ev("djoin_route", "user_annotation", 1300, 1500),
    _ev("djoin_static_upload", "gpu_user_annotation", 1300, 1500),
    _ev("getVariations", "user_annotation", 7100, 3800),
    _ev("aten::copy_", "cpu_op", 2500, 1000),
    _ev("void (anonymous namespace)::pjoin_staged<true>(unsigned int "
        "const*, int)", "kernel", 3000, 500),
    _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 8000, 1000,
        bytes=4096),
    _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 500, 100,
        bytes=64),  # before the window
    _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 9500, 100,
        bytes=128),
]


def test_numbers_as_trace():
    base, spans = Trace(EVENTS), SpanTrace(EVENTS)
    assert spans.window_s == base.window_s
    assert spans.busy_s == base.busy_s
    assert spans.by_op == base.by_op and spans.by_kernel == base.by_kernel
    assert spans.gaps == base.gaps
    assert spans.breakdown()["device_ops"] == base.breakdown()["device_ops"]


def test_gaps_by_program_span():
    base, spans = Trace(EVENTS), SpanTrace(EVENTS)
    got = spans.breakdown()["idle_gaps"]
    was = base.breakdown()["idle_gaps"]
    assert [s for _, s in got] == [s for _, s in was]
    # busy [3000,3500), [8000,9000), [9500,9600): the gaps' middles,
    # longest first, 5750 (djoin_setup open), 2000 (djoin_route, inside
    # djoin_setup), 10300 and 9250 (getVariations of c1)
    assert [lab for lab, _ in got] == [
        "call c0 s1: djoin_setup: host",
        "call c0 s1: djoin_route: host",
        "call c1 s2: getVariations: host",
        "call c1 s2: getVariations: host",
    ]
    assert [lab for lab, _ in was] == [
        "call c0 s1: host", "call c0 s1: host", "call c1 s2: host",
        "call c1 s2: host"]


@pytest.mark.parametrize("extra,want", [
    ([], "call c0 s1: aten::copy_"),
    ([_ev("djoin_statics", "user_annotation", 2000, 1000)],
     "call c0 s1: djoin_statics: aten::copy_"),
])
def test_label_keeps_the_op(extra, want):
    t = SpanTrace([e for e in EVENTS if e["name"] != "djoin_setup"
                   and e["name"] != "djoin_route"
                   and e["name"] != "getVariations"] + extra)
    assert t.label(2900, 3000) == want


def test_htod_in_the_window():
    b = SpanTrace(EVENTS).breakdown()
    assert b["htod"] == {"copies": 1, "bytes": 4096,
                         "seconds": pytest.approx(1000e-6)}


def _ctx(stages_per_call, samples=(("s1",), ("s2",))):
    ctx = harness.Context.__new__(harness.Context)
    ctx.calls = []
    for st, smp in zip(stages_per_call, samples):
        c = harness.Call(list(smp), [], 0)
        c.rc, c.wall_s, c.stages = 0, 10.0, st
        ctx.calls.append(c)
    return ctx


def test_stages_per_sample():
    got = stages_per_sample(_ctx([
        {"djoin_route": 3.0, "djoin_h2d_bytes": 100},
        {"djoin_route": 4.0, "djoin_h2d_bytes": 300, "refindex_build": 2.0},
    ]))
    assert got == {"djoin_route": 3.5, "djoin_h2d_bytes": 200,
                   "refindex_build": 1.0}
    assert stages_per_sample(_ctx([{"djoin_route": 3.0}, None])) == {}
    assert stages_per_sample(_ctx([])) == {}
    assert SpanTrace(EVENTS).breakdown()["stages"] == {}
