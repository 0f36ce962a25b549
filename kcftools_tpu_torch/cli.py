"""kcftools-torch command line entry point: ``python -m kcftools_tpu_torch.cli``.

The same subcommands, flags and output bytes as ``kcftools_tpu.cli``:
the port's copies of the JAX package's host plugins, with the port's
getVariations (whose ``--engine device`` and ``--engine dprefix`` run on
the GPU).
``KCFTOOLS_PROFILE=<dir>`` records a torch.profiler trace of the command
into ``<dir>/trace.json``, the stage timer's stages as ranges on it
(``utils/stagetimer.py``). A multi-process run joins a torch.distributed
process group first: ``KCFTOOLS_COORDINATOR=host:port
KCFTOOLS_NUM_PROCS=N KCFTOOLS_PROC_ID=i`` (NCCL on CUDA devices, gloo on
the CPU); the device mesh then spans every process's devices.
"""

import argparse
import os
import resource
import sys
import time

import torch

from . import __version__
from .utils.logger import KcfError, Logger


def build_parser():
    parser = argparse.ArgumentParser(
        prog="kcftools-torch",
        description="k-mer based genomic variation screening on CUDA GPUs",
    )
    parser.add_argument("--version", action="version", version=__version__)
    subparsers = parser.add_subparsers(dest="command", required=True)
    from .plugins import PLUGINS

    for plugin in PLUGINS:
        plugin.add_parser(subparsers)
    return parser


def _maybe_init_distributed():
    """Join the process group named by the environment (no-op for a
    single process)."""
    n = int(os.environ.get("KCFTOOLS_NUM_PROCS", "1"))
    if n > 1:
        from .parallel.mesh import init_distributed

        init_distributed(
            os.environ.get("KCFTOOLS_COORDINATOR"),
            n,
            int(os.environ.get("KCFTOOLS_PROC_ID", "0")),
        )


def _profiler():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    try:
        _maybe_init_distributed()
    except KcfError:
        return 1
    start = time.time()
    profile_dir = os.environ.get("KCFTOOLS_PROFILE")
    prof = _profiler() if profile_dir else None
    if prof is not None:
        prof.start()
    try:
        args.func(args)
    except KcfError:
        return 1
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            path = os.path.join(profile_dir, "trace.json")
            prof.export_chrome_trace(path)
            Logger.info("KCFTOOLS", f"Profiler trace written to {path}")
    peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    Logger.info(
        "KCFTOOLS", f"Peak host memory: {peak_kb / (1024 * 1024):.2f} GB"
    )
    Logger.info("KCFTOOLS", f"Total execution time: {time.time() - start:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
