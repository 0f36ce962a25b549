"""Build and bind the port's CUDA kernels (``kcftools_tpu_torch/csrc``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C entry point and loaded through ``ctypes``; the
wrapper passes device pointers and the current stream as ``c_void_p``.
The library is built at first use into ``KCFTOOLS_TORCH_BUILD`` (default
``kcftools_tpu_torch/_build``, listed in .gitignore), under a name keyed
by a hash of the source, the headers of ``csrc`` (``*.cuh``, which the
sources include) and the flags, so an edited source or header rebuilds.
A missing ``nvcc`` or a failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs = {}
build_info = {}  # source name -> {"seconds", "log", "path"}


def _build_dir():
    return os.environ.get(
        "KCFTOOLS_TORCH_BUILD", os.path.join(_PKG, "_build")
    )


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA "
            "kernels are built from source at first use"
        )
    return path


def load(name):
    """The ctypes library built from ``csrc/<name>.cu`` (built now if
    its hashed build is missing)."""
    if name in _libs:
        return _libs[name]
    src = os.path.join(_CSRC, f"{name}.cu")
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(_CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            key.update(f.read())
    key = key.hexdigest()
    out_dir = _build_dir()
    lib_path = os.path.join(out_dir, f"lib{name}-{key[:16]}.so")
    info = {"seconds": 0.0, "log": "", "path": lib_path}
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True, text=True,
        )
        info["seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{info['log']}"
            )
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    _libs[name] = lib
    build_info[name] = info
    return lib


def load_all(names):
    """``load`` every named source, their nvcc builds run together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        return list(ex.map(load, names))


_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# entry point -> (its source in csrc, its argument types: tensors, then
# sizes, then the stream; sizes that can pass 2^31 are c_longlong)
_ENTRIES = {
    "kcf_pjoin_launch": ("pjoin", [*[_P] * 6, _I, _I, _I, _I, _P]),
    "kcf_gapscan_join": ("gapscan", [_P, _LL, *[_P] * 8, _LL, _I, _I, _I,
                                     _LL, _P]),
    "kcf_gapscan_rows": ("gapscan", [*[_P] * 6, _LL, _I, _I, _I, _P]),
    "kcf_gapscan_runs": ("gapscan", [_P, _LL, *[_P] * 5, _LL, _I, _I, _I,
                                     _P]),
    "kcf_hash_probe": ("hashscan", [*[_P] * 4, *[_LL] * 6, _I, _I, _P]),
    "kcf_hash_scan": ("hashscan", [*[_P] * 5, _LL, _LL, _LL, _I, _LL, _P]),
    "kcf_route_starts": ("route", [_P, _LL, _P, _I, _I, _P, _P, _P]),
    "kcf_route_tiles": ("route", [_P, _LL, _I, _I, _P, _LL, _P, _P, _P, _P]),
    "kcf_route_slabs": ("route", [_P, _LL, *[_P] * 4]),
    "kcf_sample_tiles": ("route", [_P, _P, _P, _I, _I, _LL, _I, _P, _P]),
    "kcf_h2d_staged": ("h2d", [_P, _P, _P, _I, _P, _LL, _I, _P]),
}


_bound = {}  # entry point -> its ctypes function, argument types set


def _entry(entry):
    fn = _bound.get(entry)
    if fn is None:
        source, argtypes = _ENTRIES[entry]
        fn = getattr(load(source), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _bound[entry] = fn
    return fn


def launch(entry, *args):
    """Call one C entry point of csrc/ (``_ENTRIES``) on the current
    stream of the last tensor argument's device (the output). Tensors
    pass as their pointers, None as a null pointer; the stream is
    appended. Each entry point is bound once. Operands are checked by
    the caller (ops/pjoin.py, ops/gapscan.py, ops/hashscan.py,
    ops/route.py)."""
    out = [a for a in args if isinstance(a, torch.Tensor)][-1]
    call(entry, out.device,
         *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args])


def call(entry, device, *args):
    """Call one C entry point of csrc/ (``_ENTRIES``) with plain values
    (pointers as ints) and, appended, the current stream of the CUDA
    ``device``, with that device current; raise if it returns non-zero.
    The interpreter lock is released for the call (ctypes)."""
    fn = _entry(entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
