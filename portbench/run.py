#!/usr/bin/env python3
"""The benchmark of the PyTorch + CUDA port (``kcftools_tpu_torch``).

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (see ``portbench/README.md``) from
the root of a checkout, on the CUDA device it is started on, and prints
one JSON object as the last line of standard output. Exits non-zero with
no result where CUDA is missing or has fewer devices than the cell asks
for, or where a JAX module was loaded.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    from portbench.harness import main as run

    return run(sys.argv[1:], T_START, ROOT)


if __name__ == "__main__":
    sys.exit(main())
