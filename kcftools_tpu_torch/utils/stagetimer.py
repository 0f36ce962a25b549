"""Opt-in spans and counters for the CLI hot paths.

Enabled by setting ``KCFTOOLS_STAGE_JSON=<path>``: stages accumulate
(thread-safely - ingest runs on a worker thread) and ``dump()`` writes
one flat JSON object to that path:

- ``<name>``: the seconds spent in every stage of that name;
- ``<name>.self``: for a stage that had children, those seconds less
  the part its children on the same thread cover (each thread keeps
  its own stack of open stages, so every stage knows its parent);
- the counters of ``count``, under their own names.

While a ``torch.profiler`` is recording, each stage also opens
``torch.profiler.record_function(name)``, so the stage is a range on
the profiler's timeline beside the device's kernels and copies (the
benchmark's traced window, ``portbench/``, and ``KCFTOOLS_PROFILE``).
torch is imported only then (so the host tier runs without it): with
neither the variable set nor a profiler recording, a stage reads no
clock, takes no lock and opens no range. The port's getVariations dumps
one call's stages; the benchmark's traced runs read them
(``portbench/metrics/``).
"""

import json
import os
import sys
import threading
import time

_lock = threading.Lock()
_acc: dict[str, float] = {}
_self: dict[str, float] = {}
_parents: set[str] = set()  # stages that had a child
_counts: dict[str, int] = {}
_local = threading.local()


def enabled() -> bool:
    return bool(os.environ.get("KCFTOOLS_STAGE_JSON"))


def _profiling() -> bool:
    """Whether a torch profiler is recording (torch not imported: no)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return bool(prof is not None
                and getattr(prof, "_is_profiler_enabled", False))


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def reset():
    with _lock:
        _acc.clear()
        _self.clear()
        _parents.clear()
        _counts.clear()


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` (a no-op unless enabled)."""
    if enabled():
        with _lock:
            _counts[name] = _counts.get(name, 0) + int(n)


class stage:
    """Context manager adding the elapsed wall time to ``name``. Reads
    no clock and takes no lock unless KCFTOOLS_STAGE_JSON is set; opens
    a profiler range only while a profiler records."""

    __slots__ = ("name", "t0", "on", "range", "parent", "child_s")

    def __init__(self, name: str):
        self.name = name
        self.t0 = 0.0
        self.on = enabled()
        self.range = None
        self.parent = None
        self.child_s = 0.0

    def __enter__(self):
        if _profiling():
            import torch

            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if self.on:
            st = _stack()
            self.parent = st[-1] if st else None
            st.append(self)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.on:
            dt = time.perf_counter() - self.t0
            st = _stack()
            if st and st[-1] is self:
                st.pop()
            if self.parent is not None:
                self.parent.child_s += dt
            with _lock:
                _acc[self.name] = _acc.get(self.name, 0.0) + dt
                _self[self.name] = (_self.get(self.name, 0.0) + dt
                                    - self.child_s)
                if self.child_s:
                    _parents.add(self.name)
        if self.range is not None:
            self.range.__exit__(*exc)
            self.range = None
        return False


def snapshot() -> dict:
    """What ``dump`` writes: stage seconds, ``<name>.self`` of the
    stages that had children, and the counters."""
    with _lock:
        data = {k: round(v, 4) for k, v in _acc.items()}
        data.update((f"{k}.self", round(_self[k], 4)) for k in _parents)
        data.update(_counts)
    return dict(sorted(data.items()))


def dump():
    path = os.environ.get("KCFTOOLS_STAGE_JSON")
    if not path:
        return
    data = snapshot()
    try:
        with open(path, "w") as fh:
            json.dump(data, fh)
    except OSError:
        pass
