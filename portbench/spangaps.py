#!/usr/bin/env python3
"""A traced run of one cell whose idle gaps are labelled by the
program's own spans.

    python3 portbench/spangaps.py --workload <name> --seed <n> --seconds <s>

The same run as ``run.py --trace 1``: the same inputs, calls, metrics,
checks and result line; its ``breakdown`` differs in three things:

- ``idle_gaps`` name, between the benchmark's call span and the host op,
  the innermost span of the program open at the gap's middle (the stage
  timer's ranges, ``kcftools_tpu_torch/utils/stagetimer.py``), e.g.
  ``call c5 s2: djoin_route: host``; where no such span is open, the
  label is ``run.py``'s;
- ``htod`` gives the window's host-to-device copies from the trace:
  ``copies``, ``bytes`` and device ``seconds``;
- ``stages`` gives every stage and counter of the program's stage JSON,
  per sample: the window's sum over its calls over the samples done.

``busy_s`` and every metric read what they read in ``run.py``.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.trace import WINDOW_SPAN, Trace, _covering  # noqa: E402


class SpanTrace(Trace):
    """``Trace`` that also keeps the program's ``user_annotation`` spans
    (all but the window's and the calls') and the window's HtoD copies.
    Kineto's ``gpu_user_annotation`` copies of the spans are left out."""

    def __init__(self, events):
        super().__init__(events)
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self._spans = [
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in xs if e.get("cat") == "user_annotation"
            and e.get("name") != WINDOW_SPAN
            and not e.get("name", "").startswith("call ")]
        win = next(e for e in xs if e.get("name") == WINDOW_SPAN
                   and e.get("cat") == "user_annotation")
        t0 = float(win["ts"])
        t1 = t0 + float(win["dur"])
        htod = [e for e in xs if e.get("cat") == "gpu_memcpy"
                and "HtoD" in e.get("name", "")
                and t0 <= float(e["ts"]) <= t1]
        self.htod = {
            "copies": len(htod),
            "bytes": sum(int((e.get("args") or {}).get("bytes", 0))
                         for e in htod),
            "seconds": sum(float(e["dur"]) for e in htod) / 1e6,
        }
        self.stages = {}

    def label(self, a, b):
        base = super().label(a, b)
        span = _covering(self._spans, (a + b) / 2)
        if span is None:
            return base
        call, _, op = base.partition(": ")
        return f"{call}: {span[2]}: {op}"

    def breakdown(self, top=10):
        out = super().breakdown(top)
        out["htod"] = self.htod
        out["stages"] = self.stages
        return out


def stages_per_sample(ctx):
    """Every stage and counter the window's calls wrote, per sample
    (``Context.per_sample``); {} where a call has no stages."""
    names = sorted({n for c in ctx.calls for n in (c.stages or {})})
    out = {n: ctx.per_sample(lambda c, n=n: c.stages.get(n, 0))
           for n in names}
    return {} if None in out.values() else out


class SpanContext(harness.Context):
    """``Context`` that hands a ``SpanTrace`` the window's stages."""

    def __init__(self, *args):
        super().__init__(*args)
        if isinstance(self.trace, SpanTrace):
            self.trace.stages = stages_per_sample(self)


def main():
    harness.Trace = SpanTrace
    harness.Context = SpanContext
    return harness.main(sys.argv[1:] + ["--trace", "1"], T_START, ROOT)


if __name__ == "__main__":
    sys.exit(main())
