"""One run of one cell: inputs from the seed, set-up, the measured
window of back-to-back ``getVariations`` calls through the port's CLI,
the comparison with the plain reference, and the result line.

Everything that belongs to one cell comes from files found by name:
the workload in ``BENCHMARK.json`` names its configuration (the file
under ``configs/``) and its traffic mix (``mixes/<traffic>.json``), and
each metric is read by ``metrics/<name>.py`` (a ``read(ctx)`` returning
a number, or None where it finds nothing to read).

A run:
  1. makes the inputs from the seed on the device (``datagen``), writes
     them to a fresh directory under TMPDIR, and parks the arrays on the
     host;
  2. builds or loads the program's kernels and native library by one
     call on a small input of the same shape of command (so no compile
     lands in a timed call);
  3. makes the first call of the cycle with no index, plan or sorted
     sidecar on disk (``first_run_s``), then one call of every other
     call of the cycle (``setup_s`` ends here);
  4. calls the cycle back to back, whole cycles, until ``--seconds``
     have passed, and lets the last call finish (with ``--trace 1``
     under ``torch.profiler``, the stage timer on);
  5. reads the device's peak memory, checks that no JAX module was
     loaded, frees the program's state, and compares every window
     call's KCF rows with the reference's;
  6. prints the checks last on standard error and the result as the
     last line of standard output.
"""

import contextlib
import gc
import importlib.util
import json
import math
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import torch

from . import datagen, reference, yardstick
from .trace import WINDOW_SPAN, Trace, profiler

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "kcftools_tpu")
BAD_WINDOWS_LIMIT = 0  # an exact comparison
# the program's launch and call counters, read around every call:
# name -> (module, function, attribute)
COUNTERS = {
    "pjoin_packed": ("kcftools_tpu_torch.ops.pjoin", "pjoin_join",
                     "launches_packed"),
    "pjoin_u32": ("kcftools_tpu_torch.ops.pjoin", "pjoin_join",
                  "launches_u32"),
    "gapscan_join": ("kcftools_tpu_torch.ops.gapscan", "slabs_scan_join",
                     "launches"),
    "hash_probe": ("kcftools_tpu_torch.ops.hashscan", "hash_probe",
                   "launches"),
    "hash_scan": ("kcftools_tpu_torch.ops.hashscan", "hash_scan",
                  "launches"),
    "table_lookup_cuda": ("kcftools_tpu_torch.ops.lookup", "table_lookup",
                          "cuda_calls"),
}


def log(msg):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (the name compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_env():
    """The program's build and kernel caches, at fixed paths inside the
    checkout."""
    return {
        "KCFTOOLS_TORCH_BUILD": os.path.join(CACHE, "cuda"),
        "KCFTOOLS_NATIVE_DIR": os.path.join(CACHE, "native"),
        "TRITON_CACHE_DIR": os.path.join(CACHE, "triton"),
        "TORCH_EXTENSIONS_DIR": os.path.join(CACHE, "torch_extensions"),
        "CUDA_CACHE_PATH": os.path.join(CACHE, "cuda_jit"),
    }


def _load_json(path):
    with open(path) as fh:
        return json.load(fh)


def _reader(name):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    """A workload of the benchmark with its configuration, its mix and
    its metrics."""

    def __init__(self, spec, workload, root):
        wl = {w["name"]: w for w in spec["workloads"]}.get(workload)
        if wl is None:
            raise SystemExit(f"no workload {workload!r} in the benchmark")
        self.name = workload
        self.chips = int(wl["chips"])
        entry = {c["name"]: c for c in spec["configs"]}[wl["config"]]
        self.config = _load_json(os.path.join(root, entry["file"]))
        self.mix = _load_json(os.path.join(HERE, "mixes",
                                           f"{wl['traffic']}.json"))
        self.end_to_end = [m for m in spec["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)
        ]

    def cycle(self):
        """The calls of one cycle of the mix, each a list of sample
        indices: ``samples_per_call`` entries a call, taken in turn from
        the configuration's samples until each has come equally often."""
        n_s = len(self.config["samples"])
        per = int(self.mix["samples_per_call"])
        n_calls = n_s // math.gcd(n_s, per)
        return [[(c * per + i) % n_s for i in range(per)]
                for c in range(n_calls)]


def warm_config(cfg):
    """The configuration at a small size with the same command: one
    contig of at most 300 kb (and 60 genes), to build and load every
    kernel before the timed calls."""
    small = json.loads(json.dumps(cfg))
    c = small["contigs"][0]
    small["contigs"] = [{"name": c["name"],
                         "length": min(int(c["length"]), 300_000)}]
    small["n_runs"]["per_contig"] = 2
    if small.get("genes"):
        small["genes"]["count"] = 60
        small["genes"]["transcripts"] = 75
    return small


class Call:
    """One getVariations call: its samples, wall seconds, exit code,
    stage seconds (with the stage timer on), counters and outputs."""

    def __init__(self, samples, outputs, work_bp):
        self.samples = samples
        self.outputs = outputs
        self.work_bp = work_bp
        self.wall_s = None
        self.rc = None
        self.stages = None
        self.counters = {}
        self.host = {}


def _sync(what):
    """Write what came before to the disk now, so that its writeback
    lands in set-up and not in the timed calls that follow."""
    t = time.perf_counter()
    os.sync()
    log(f"sync after {what}: {time.perf_counter() - t} s")


def _host_times():
    """This process's CPU seconds, to read beside a call's wall: the
    host's speed drifts, and user seconds for the same work drift with
    it."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"user_s": ru.ru_utime, "sys_s": ru.ru_stime}


class Run:
    def __init__(self, cell, seed, seconds, trace, t_start, device="cuda"):
        self.cell = cell
        self.cfg = cell.config
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.t_start = t_start
        self.device = device
        self.cuda = device == "cuda"
        self.threads = min(int(self.cfg["command"]["threads"]),
                           len(os.sched_getaffinity(0)))

    # -- calls --------------------------------------------------------

    def _argv(self, files, samples, out):
        cmd = self.cfg["command"]
        names = [self.cfg["samples"][i]["name"] for i in samples]
        if len(samples) > 1:
            names = [f"{n}_{j}" for j, n in enumerate(names)]
        argv = ["getVariations", "-r", files["fasta"],
                "-k", ",".join(files["dbs"][i] for i in samples),
                "-s", ",".join(names), "-o", out,
                "-f", cmd["feature"], "--engine", cmd["engine"],
                "-t", str(self.threads), "-c", str(cmd["min_count"])]
        if cmd.get("window"):
            argv += ["-w", str(cmd["window"])]
        if cmd.get("step"):
            argv += ["-p", str(cmd["step"])]
        if files["gtf"]:
            argv += ["-g", files["gtf"]]
        return argv, names

    def call(self, files, samples, tag, genome_bp, stages=False):
        """One call of the CLI, in process, its log to a file."""
        from kcftools_tpu_torch.cli import main as cli_main

        out_dir = os.path.join(files["root"], "out")
        os.makedirs(out_dir, exist_ok=True)
        if len(samples) > 1:
            out = os.path.join(out_dir, tag)
        else:
            out = os.path.join(out_dir, f"{tag}.kcf")
        argv, names = self._argv(files, samples, out)
        outputs = ([os.path.join(out, f"{n}.kcf") for n in names]
                   if len(samples) > 1 else [out])
        c = Call(samples, outputs, genome_bp * len(samples))
        stage_path = os.path.join(files["root"], f"{tag}.stages.json")
        if stages:
            os.environ["KCFTOOLS_STAGE_JSON"] = stage_path
        else:
            os.environ.pop("KCFTOOLS_STAGE_JSON", None)
        _set_counters(0)
        host0 = _host_times()
        span = (torch.profiler.record_function(
            f"call {tag} {','.join(names)}") if self.trace
            else contextlib.nullcontext())
        t0 = time.perf_counter()
        with open(os.path.join(files["root"], "program.log"), "a") as lg, \
                contextlib.redirect_stdout(lg), span:
            try:
                c.rc = cli_main(argv)
            except Exception:  # a call that raises is a failed call
                traceback.print_exc(file=lg)
                c.rc = -1
            if self.cuda:
                torch.cuda.synchronize()
        c.wall_s = time.perf_counter() - t0
        c.host = {k: v - host0[k] for k, v in _host_times().items()}
        c.counters = _read_counters()
        if stages and os.path.exists(stage_path):
            c.stages = _load_json(stage_path)
        os.environ.pop("KCFTOOLS_STAGE_JSON", None)
        log(f"call {tag}: samples {names} rc {c.rc} wall {c.wall_s} s "
            f"host {json.dumps(c.host)} counters {json.dumps(c.counters)}")
        if c.rc != 0:
            _log_tail(os.path.join(files["root"], "program.log"))
        return c

    # -- the run ------------------------------------------------------

    def execute(self):
        work = tempfile.mkdtemp(prefix="portbench-")
        try:
            return self._execute(work)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    def _execute(self, work):
        cfg = self.cfg
        cycle = self.cell.cycle()
        log(f"{self.cell.name}: seed {self.seed}, {self.seconds} s window, "
            f"trace {int(self.trace)}, cycle {cycle}, -t {self.threads}")
        card = card_info() if self.cuda else {}

        # 1. inputs
        t = time.perf_counter()
        inputs, files = datagen.make_inputs(cfg, self.seed, self.device,
                                            work)
        files["root"] = work
        genome_bp = inputs.genome_bp
        log(f"inputs: {genome_bp} bp, samples "
            f"{[s.keys.shape[0] for s in inputs.samples]} k-mers, "
            f"{time.perf_counter() - t} s")

        # 2. kernels and native library, on a small input
        t = time.perf_counter()
        small_dir = os.path.join(work, "small")
        os.makedirs(small_dir)
        small_cfg = warm_config(cfg)
        _small, small_files = datagen.make_inputs(
            small_cfg, datagen.subseed(self.seed, "small"), self.device,
            small_dir)
        small_files["root"] = small_dir
        del _small
        self._free()
        for i, samples in enumerate(cycle):
            c = self.call(small_files, samples, f"small{i}", 0)
            if c.rc != 0:
                raise RuntimeError(f"the small call {samples} failed")
        log(f"kernels built or loaded: {time.perf_counter() - t} s")
        _sync("inputs")
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()

        # 3. the first call, then every other call of the cycle once
        first = self.call(files, cycle[0], "first", genome_bp)
        if first.rc != 0:
            raise RuntimeError("the first call failed")
        first_run_s = first.wall_s
        for i, samples in enumerate(cycle[1:]):
            if self.call(files, samples, f"warm{i}", genome_bp).rc != 0:
                raise RuntimeError(f"the warm-up call {samples} failed")
        _sync("set-up")
        setup_s = time.perf_counter() - self.t_start

        # 4. the window
        calls = []
        prof = profiler() if self.trace else None
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        span = (torch.profiler.record_function(WINDOW_SPAN) if self.trace
                else contextlib.nullcontext())
        with span:
            while True:
                for samples in cycle:
                    calls.append(self.call(files, samples,
                                           f"c{len(calls)}", genome_bp,
                                           stages=self.trace))
                if time.perf_counter() - t0 >= self.seconds:
                    break
            if self.cuda:
                torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        if prof is not None:
            prof.stop()

        # 5. peak memory, the import check, the comparison
        peak = torch.cuda.max_memory_allocated() if self.cuda else 0
        self._check_imports()
        trace = None
        if prof is not None:
            path = os.path.join(work, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            trace = Trace.load(path)
            os.remove(path)
        self._free()
        bad, sizes = self.compare(inputs, calls)

        # 6. metrics and the result
        ctx = Context(self, inputs, calls, first_run_s, setup_s, window_s,
                      trace, sizes)
        metrics = {}
        for m in (self.cell.per_layer if self.trace
                  else self.cell.end_to_end):
            v = _reader(m["name"])(ctx)
            if v is None:
                if not self.trace:
                    raise RuntimeError(f"no value for {m['name']}")
                log(f"metric {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        failed = sum(1 for c in calls if c.rc != 0)
        device = {
            "platform": "gpu" if self.cuda else "cpu",
            "kind": (torch.cuda.get_device_name(0) if self.cuda
                     else "cpu"),
            "count": self.cell.chips,
            "memory_peak_bytes": int(peak),
        }
        result = {"correct": bad <= BAD_WINDOWS_LIMIT and failed == 0,
                  "attempted": len(calls), "failed": failed,
                  "metrics": metrics, "device": device}
        if trace is not None:
            if trace.busy_s <= 0:
                raise RuntimeError("the profiler recorded no device time")
            device["busy_s"] = trace.busy_s
            device["window_s"] = window_s
            result["breakdown"] = trace.breakdown()
        result["card"] = card
        result["calls"] = {
            "first_run_s": first_run_s, "setup_s": setup_s,
            "window_s": window_s,
            "walls_s": [c.wall_s for c in calls],
        }
        self._check_imports()
        checks = {
            "bad_windows": {"value": bad, "limit": BAD_WINDOWS_LIMIT},
            "failed_calls": {"value": failed, "limit": 0},
        }
        result["checks"] = checks
        for name, c in checks.items():
            log(f"check {name} {c['value']} limit {c['limit']}")
        return result

    def _free(self):
        gc.collect()
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def _check_imports(self):
        bad = forbidden_modules()
        if bad:
            log(f"forbidden modules loaded: {bad}")
            raise SystemExit(3)

    def compare(self, inputs, calls):
        """Rows of every window call's KCF against the reference's;
        returns (bad rows, the problem's sizes)."""
        cmd = self.cfg["command"]
        if cmd["feature"] == "window":
            wins = reference.Windows.tiling(inputs, int(cmd["window"]))
        else:
            wins = reference.Windows.genes(inputs)
        dev = self.device
        want = {}
        sizes = None
        t = time.perf_counter()
        for si in sorted({i for c in calls for i in c.samples}):
            s = inputs.samples[si]
            st, sz = reference.window_stats(
                inputs, wins, s.keys, s.counts, inputs.k,
                int(cmd["min_count"]), device=dev)
            want[si] = reference.rows(wins, st)
            sizes = sizes or sz
        bad = 0
        for c in calls:
            for si, path in zip(c.samples, c.outputs):
                got = (reference.kcf_rows(path) if os.path.exists(path)
                       else [])
                n = reference.bad_rows(got, want[si])
                if n:
                    log(f"{path}: {n} of {len(want[si])} rows differ")
                bad += n
        sizes = dict(sizes or {}, windows=len(wins.labels))
        log(f"reference: {time.perf_counter() - t} s, sizes {sizes}")
        return bad, sizes


class Context:
    """What a metric reader sees."""

    def __init__(self, run, inputs, calls, first_run_s, setup_s, window_s,
                 trace, sizes):
        self.config = run.cfg
        self.mix = run.cell.mix
        self.calls = calls
        self.first_run_s = first_run_s
        self.setup_s = setup_s
        self.window_s = window_s
        self.trace = trace
        self.sizes = sizes
        self.genome_bp = inputs.genome_bp
        self.kmer_positions = datagen.kmer_positions(run.cfg)
        self.samples = [
            {"name": s.name, "keys": int(s.keys.shape[0]),
             "width": yardstick.count_width(int(s.counts.max()))}
            for s in inputs.samples
        ]

    @property
    def samples_done(self) -> int:
        return sum(len(c.samples) for c in self.calls if c.rc == 0)

    def per_sample(self, fn):
        """sum over the window's calls of fn(call) per sample done;
        None where a call has no stages."""
        if not self.calls or any(c.stages is None for c in self.calls):
            return None
        return sum(fn(c) for c in self.calls) / max(1, self.samples_done)

    def roofline(self, kernels, bytes_of_call):
        """Percent of the memory roofline of the window's calls for the
        named kernels; None without a trace or without their time."""
        if self.trace is None:
            return None
        dev_s = self.trace.kernel_seconds(kernels)
        if dev_s <= 0:
            return None
        nbytes = sum(bytes_of_call(c) for c in self.calls)
        return yardstick.roofline_pct(nbytes, dev_s)


def _counter_targets():
    out = {}
    for name, (mod, fn, attr) in COUNTERS.items():
        m = sys.modules.get(mod)
        f = getattr(m, fn, None) if m is not None else None
        if f is not None and hasattr(f, attr):
            out[name] = (f, attr)
    return out


def _set_counters(v):
    for f, attr in _counter_targets().values():
        setattr(f, attr, v)


def _read_counters():
    return {name: getattr(f, attr)
            for name, (f, attr) in _counter_targets().items()}


def _log_tail(path, n=4000):
    try:
        with open(path) as fh:
            fh.seek(max(0, os.path.getsize(path) - n))
            log("program log tail:\n" + fh.read())
    except OSError:
        pass


def card_info():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"unknown ({e})"
    log(f"card: {out}")
    return {"nvidia_smi": out}


def parse(argv):
    import argparse

    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start, root):
    args = parse(argv)
    for key in [k for k in os.environ if k.startswith("KCFTOOLS_")]:
        del os.environ[key]
    os.environ.update(cache_env())
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    cell = Cell(spec, args.workload, root)
    if not torch.cuda.is_available():
        log("CUDA is not available: no result")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
            f"{cell.chips}: no result")
        return 2
    result = Run(cell, args.seed, args.seconds, args.trace,
                 t_start).execute()
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
