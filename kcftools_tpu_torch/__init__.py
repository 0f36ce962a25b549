"""kcftools_tpu_torch: the PyTorch + CUDA port of kcftools_tpu.

The JAX package ``kcftools_tpu`` stays the reference. This package runs
every getVariations engine of the JAX package on NVIDIA GPUs: on one
device the device-join engine (``-f window --engine device``, k <= 32; a
hand-written CUDA kernel for the partitioned join, ``csrc/pjoin.cu``),
the dprefix engine (``--engine dprefix``, every mode and k, and the
streamed low-memory ingest) and the on-chip hash engine (``-f
gene|transcript --engine device``, k <= 32); over several devices the
multi-device tier (a (data, table) mesh, the sharded hash engine and its
streaming loader, MeshJoinScorer, dprefix's device pool, and
torch.distributed across processes). Plain torch ops do the scans, the
k-mer extraction and the hash lookups. It imports torch and never jax;
the shared host tier (I/O, the native C++ library, the numpy engine
modules, the host plugins) comes from ``kcftools_tpu`` through ``_host``.

Layout (mirrors kcftools_tpu):
  torchinit.py          device selection (cuda:0 unless told otherwise)
                        and the mesh slots (resolve_devices)
  ops/pjoin.py          partitioned join: host tiling + kernel wrapper
  ops/_kernels.py       nvcc build and ctypes binding of csrc/*.cu
  ops/kmerize.py        canonical (hi, lo) k-mers of padded windows
  ops/lookup.py         bucketed hash-table lookup
  engine/device_prefix  the gap-run prefix scan, slab layout and
                        DevicePrefixScorer (dprefix)
  engine/device_join    DeviceJoinScorer, MeshJoinScorer
  engine/pipeline       WindowScorer (the on-chip hash engine)
  parallel/mesh         the (data, table) mesh, init_distributed,
                        the collectives
  parallel/sharded      ShardedWindowScorer (the mesh's hash engine)
  parallel/loader       ShardedTableLoader (KMC -> table shards)
  plugins/              getVariations with the port's device engines
  cli.py                ``python -m kcftools_tpu_torch.cli``
  dryrun.py             entry points (entry, dryrun_multichip)
"""

from ._host import KCF_SOURCE, __version__

__all__ = ["KCF_SOURCE", "__version__"]
