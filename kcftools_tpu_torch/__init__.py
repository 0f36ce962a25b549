"""kcftools_tpu_torch: the PyTorch + CUDA port of kcftools_tpu.

The JAX package ``kcftools_tpu`` stays the reference. This package runs
the same getVariations main path (``-f window --engine device``, k <= 32)
on one NVIDIA GPU: plain torch ops for the scans, and a hand-written
CUDA kernel for the partitioned join (``csrc/pjoin.cu``). It imports
torch and never jax; the shared host tier (I/O, the native C++ library,
the numpy engine modules, the host plugins) comes from ``kcftools_tpu``
through ``_host``.

Layout (mirrors kcftools_tpu):
  torchinit.py          device selection (cuda:0 unless told otherwise)
  ops/pjoin.py          partitioned join: host tiling + kernel wrapper
  ops/_kernels.py       nvcc build and ctypes binding of csrc/*.cu
  engine/device_prefix  the gap-run prefix scan and slab layout
  engine/device_join    DeviceJoinScorer
  plugins/              getVariations with the port's device engine
  cli.py                ``python -m kcftools_tpu_torch.cli``
"""

from ._host import KCF_SOURCE, __version__

__all__ = ["KCF_SOURCE", "__version__"]
