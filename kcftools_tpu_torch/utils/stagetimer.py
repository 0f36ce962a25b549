"""Opt-in per-stage wall-clock accumulation for the CLI hot paths.

Enabled by setting ``KCFTOOLS_STAGE_JSON=<path>``: stages accumulate
(thread-safely - ingest runs on a worker thread) and ``dump()`` writes
one JSON object of seconds-per-stage to that path. Used by bench.py's
e2e rung to record where command time goes (ingest/sort/merge/scan/
write); zero overhead when the variable is unset.
"""

import json
import os
import threading
import time

_lock = threading.Lock()
_acc: dict[str, float] = {}


def enabled() -> bool:
    return bool(os.environ.get("KCFTOOLS_STAGE_JSON"))


def reset():
    with _lock:
        _acc.clear()


class stage:
    """Context manager adding the elapsed wall time to ``name``.
    A no-op (no clock, no lock) unless KCFTOOLS_STAGE_JSON is set."""

    __slots__ = ("name", "t0", "on")

    def __init__(self, name: str):
        self.name = name
        self.t0 = 0.0
        self.on = enabled()

    def __enter__(self):
        if self.on:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.on:
            dt = time.perf_counter() - self.t0
            with _lock:
                _acc[self.name] = _acc.get(self.name, 0.0) + dt
        return False


def dump():
    path = os.environ.get("KCFTOOLS_STAGE_JSON")
    if not path:
        return
    with _lock:
        data = {k: round(v, 4) for k, v in sorted(_acc.items())}
    try:
        with open(path, "w") as fh:
            json.dump(data, fh)
    except OSError:
        pass
