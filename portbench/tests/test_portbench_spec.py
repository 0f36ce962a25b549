"""BENCHMARK.json against the benchmark's contract, the registry of
files found by name, the yardstick's byte counts and the trace reader
(CPU)."""

import os
import re

import pytest

from portbench import harness, yardstick
from portbench.trace import Trace, bare_name
from portbench_tiny import ROOT, full_spec, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_contract():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    s = spec()
    assert list(s) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert 1 <= len(s["paths"]) <= 16
    for p in s["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert len(s["command"]) <= 32 and all(_line(w) for w in s["command"])
    for w in s["command"][1:]:
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w.startswith(p + "/") for p in s["paths"])
    rs = s["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = set()
    cfgs = {}
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in cfgs
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in s["paths"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        cfgs[c["name"]] = c
    pairs = set()
    cells = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cells.add(w["name"])
    assert {w["config"] for w in s["workloads"]} == set(cfgs)
    e2e = {}
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = m
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    layers = {}
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        layers[m["name"]] = m
    for m in list(e2e.values()) + list(layers.values()):
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        c = harness.Cell(s, cell, ROOT)
        got = {m["name"] for m in c.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert cell in m.get("workloads", [cell])
            assert m["moves"] in got


def test_registry_finds_every_file():
    s = spec()
    for w in s["workloads"]:
        cell = harness.Cell(s, w["name"], ROOT)
        assert cell.config["name"] == w["config"]
        assert cell.mix["samples_per_call"] >= 1
        assert cell.cycle()
        cfg = cell.config
        for key in ("source", "reduced", "assumed"):
            assert key in cfg
        assert cfg["reduced"] == next(
            c for c in s["configs"] if c["name"] == w["config"])["reduced"]
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(harness._reader(m["name"]))


def test_cycle_over_samples():
    s = full_spec()
    cell = harness.Cell(s, "lettuce-chr3-w50k.per-sample", ROOT)
    assert cell.cycle() == [[0], [1]]
    cell.mix = {"samples_per_call": 16}
    assert cell.cycle() == [[i % 2 for i in range(16)]]
    cell = harness.Cell(s, "arabidopsis-tair10-gene.per-sample", ROOT)
    assert cell.cycle() == [[0]]


def test_byte_counters():
    assert yardstick.count_width(255) == 1
    assert yardstick.count_width(256) == 4
    # 10 reference k-mers, 4 sample entries of 1-byte counts
    assert yardstick.join_bytes(10, 4, 1) == 80 + 4 * 9 + 10
    assert yardstick.join_bytes(10, 40, 4) == 80 + 10 * 12 + 40
    assert yardstick.scan_bytes(100, 10, 2, 4) == 400 + 40 + 2 * 64
    assert yardstick.hash_bytes(1000, 900, 3, 4) == 1000 + 900 * 12 + 3 * 80
    assert yardstick.roofline_pct(3.35e9, 1e-3) == pytest.approx(100.0)
    assert yardstick.roofline_pct(100, 0.0) is None


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reader():
    events = [
        _ev("portbench.window", "user_annotation", 1000, 10000),
        _ev("call c0 s1", "user_annotation", 1000, 6000),
        _ev("call c1 s2", "user_annotation", 7000, 4000),
        _ev("aten::copy_", "cpu_op", 2500, 1000),
        _ev("void (anonymous namespace)::pjoin_staged<true>(unsigned int "
            "const*, int)", "kernel", 3000, 500),
        _ev("(anonymous namespace)::join_windows((anonymous namespace)::"
            "Params)", "kernel", 3400, 300),
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 8000, 1000),
        _ev("void hash_probe(Probe)", "kernel", 500, 1000),  # half outside
    ]
    t = Trace({"traceEvents": events}["traceEvents"])
    assert t.window_s == pytest.approx(0.01)
    # busy: [1000,1500) + [3000,3700) + [8000,9000)
    assert t.busy_s == pytest.approx((500 + 700 + 1000) / 1e6)
    assert t.kernel_seconds(["pjoin_staged"]) == pytest.approx(500e-6)
    assert t.kernel_seconds(["hash_probe"]) == pytest.approx(500e-6)
    b = t.breakdown()
    assert b["device_ops"][0][0] == "Memcpy HtoD (Pageable -> Device)"
    assert {n for n, _ in b["device_ops"][1:]} == {
        "hash_probe", "pjoin_staged<true>", "join_windows"}
    assert t.kernel_seconds(["join_windows"]) == pytest.approx(300e-6)
    gaps = b["idle_gaps"]
    assert [round(g[1] * 1e6) for g in gaps] == [4300, 2000, 1500]
    assert gaps[0][0] == "call c0 s1: host" or gaps[0][0].startswith("call")
    assert bare_name("void ns::k<true>(int*)") == "k"
    with pytest.raises(ValueError):
        Trace([_ev("x", "kernel", 0, 1)])
