"""The device trace of the measured window: ``torch.profiler`` (CUPTI)
over the window, read from its Chrome trace.

What a traced run takes from it: the seconds the device was busy (the
union of kernel, copy and memset intervals inside the window), each
device operation's seconds by name, each kernel's seconds by its bare
name (for the rooflines), and the idle gaps, each labelled by the
benchmark's span open on the host (``call <i> <sample>``) and the
innermost host-side torch op or CUDA runtime call open there, if any.
"""

import json
import re

import torch

WINDOW_SPAN = "portbench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver"}


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _unqualified(name: str) -> str:
    s = name.replace("(anonymous namespace)::", "").strip()
    return re.sub(r"^void\s+", "", s)


def bare_name(name: str) -> str:
    """A kernel's function name without return type, namespace,
    template arguments or parameters: ``void (anonymous
    namespace)::k<true>(int*)`` -> ``k``."""
    s = _unqualified(name).split("(")[0].split("<")[0]
    return s.split("::")[-1].strip()


def short_name(name: str, cat: str) -> str:
    """A device op's name as the breakdown gives it: a kernel without
    return type, anonymous namespace or parameters (template arguments
    kept), a copy as it is."""
    if cat != "kernel":
        return name
    return _unqualified(name).split("(")[0].strip() or name


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covering(spans, t):
    """The shortest span (a, b, name) with a <= t <= b, or None."""
    best = None
    for a, b, name in spans:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best


class Trace:
    """The window's device activity, read from a Chrome trace file."""

    def __init__(self, events):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError(f"the trace has no {WINDOW_SPAN!r} span")
        t0 = float(win[0]["ts"])
        t1 = t0 + float(win[0]["dur"])
        self.window_s = (t1 - t0) / 1e6
        dev = []
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            a = max(t0, float(e["ts"]))
            b = min(t1, float(e["ts"]) + float(e["dur"]))
            if b > a:
                dev.append((a, b, e["name"], e["cat"]))
        busy = _merge([[a, b] for a, b, _, _ in dev])
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        self.by_op = {}
        self.by_kernel = {}
        for a, b, name, cat in dev:
            s = (b - a) / 1e6
            key = short_name(name, cat)
            self.by_op[key] = self.by_op.get(key, 0.0) + s
            if cat == "kernel":
                bn = bare_name(name)
                self.by_kernel[bn] = self.by_kernel.get(bn, 0.0) + s
        self._calls = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e["name"]) for e in xs
                       if e.get("cat") == "user_annotation"
                       and e.get("name", "").startswith("call ")]
        self._host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in xs if e.get("cat") in HOST_CATS]
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        self.gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2])
                     if b > a]

    def label(self, a, b):
        """What the host was doing in the middle of an idle gap."""
        mid = (a + b) / 2
        call = _covering(self._calls, mid)
        op = _covering(self._host, mid)
        return (call[2] if call else "between calls") + (
            f": {op[2]}" if op else ": host")

    @classmethod
    def load(cls, path):
        with open(path) as fh:
            data = json.load(fh)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)

    def kernel_seconds(self, names) -> float:
        return sum(self.by_kernel.get(n, 0.0) for n in names)

    def breakdown(self, top=10):
        ops = sorted(self.by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.label(a, b), (b - a) / 1e6]
                              for a, b in gaps]}
