"""Build and bind the port's CUDA kernels (``kcftools_tpu_torch/csrc``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C entry point and loaded through ``ctypes``; the
wrapper passes device pointers and the current stream as ``c_void_p``.
The library is built at first use into ``KCFTOOLS_TORCH_BUILD`` (default
``kcftools_tpu_torch/_build``, listed in .gitignore), under a name keyed
by a hash of the source and the flags, so an edited source rebuilds. A
missing ``nvcc`` or a failed build raises.
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
    with open(src, "rb") as f:
        text = f.read()
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
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


def _pjoin_lib():
    lib = load("pjoin")
    fn = lib.kcf_pjoin_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    return fn


def launch_pjoin(qh, ql, th, tl, tc, out, P, Tq, Tt, packed):
    """Launch csrc/pjoin.cu on the current stream of ``out``'s device.
    Operands are checked by the caller (ops/pjoin.py::pjoin_join)."""
    fn = _pjoin_lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(
            qh.data_ptr(), ql.data_ptr(), th.data_ptr(), tl.data_ptr(),
            tc.data_ptr(), out.data_ptr(), P, Tq, Tt, int(packed), stream,
        )
    if rc != 0:
        raise RuntimeError(f"pjoin kernel launch failed: CUDA error {rc}")
