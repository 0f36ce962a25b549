#!/usr/bin/env python3
"""The control of ``correct``: the plain reference put in the program's
place with its counts kept in one byte (KMC's -cs255), the width below
the exact counts the configurations state. Its rows are judged by the
same comparison as the program's, over one cycle of the cell's calls
(the least a window holds); a sound comparison must find it wrong.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--device cuda]

Prints one JSON line a seed: {"seed", "bad_windows" (the control's),
"bad_windows_exact" (the reference against itself: 0), "rows"}. It
runs at the cell's own size and makes no call of the program.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reading(cell, seed, device):
    from portbench import datagen, reference

    cfg = cell.config
    cmd = cfg["command"]
    inputs, _ = datagen.make_inputs(cfg, seed, device)
    if cmd["feature"] == "window":
        wins = reference.Windows.tiling(inputs, int(cmd["window"]))
    else:
        wins = reference.Windows.genes(inputs)
    bad = exact = rows = 0
    for call in cell.cycle():
        for si in call:
            s = inputs.samples[si]
            args = (inputs, wins, s.keys)
            kw = dict(k=inputs.k, min_count=int(cmd["min_count"]),
                      device=device)
            want = reference.rows(wins, reference.window_stats(
                *args, s.counts, **kw)[0])
            ctrl = reference.rows(wins, reference.window_stats(
                *args, reference.saturated(s.counts), **kw)[0])
            bad += reference.bad_rows(ctrl, want)
            exact += reference.bad_rows(list(want), want)
            rows += len(want)
    return {"seed": seed, "bad_windows": bad, "bad_windows_exact": exact,
            "rows": rows}


def main(argv=None):
    import argparse

    sys.path.insert(0, ROOT)
    from portbench.harness import Cell, _load_json

    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = _load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = Cell(spec, args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = reading(cell, seed, args.device)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
