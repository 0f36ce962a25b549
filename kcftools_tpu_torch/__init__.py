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
k-mer extraction and the hash lookups. It imports torch, never jax and
never ``kcftools_tpu``: it carries its own copy of the JAX package's
host tier (I/O, the native C++ library, the numpy engine modules, the
host plugins), which imports no jax there either.

Layout (mirrors kcftools_tpu):
  io/                   host I/O: FASTA, KMC3, GTF, KCF (copies)
  io/rawfile.py         the raw, aligned, mapped cache files (the
                        sorted sidecar, the reference index)
  native/               the C++ host library, built by g++ at first use
                        into _build/ (copy)
  utils/                logging, stage timer, Java formatting (copies)
  engine/encode*, windows, hashtable, prefix_scan, refindex, hostscan
                        the numpy engine modules (copies)
  torchinit.py          device selection (cuda:0 unless told otherwise),
                        the mesh slots (resolve_devices) and ``phase``,
                        the stage that waits for its devices
  ops/pjoin.py          partitioned join: host tiling + kernel wrapper
  ops/_kernels.py       nvcc build and ctypes binding of csrc/*.cu
  ops/kmerize.py        canonical (hi, lo) k-mers of padded windows
  ops/lookup.py         bucketed hash-table lookup
  ops/gapscan.py        the window gap-run scan kernel's wrappers
  ops/route.py          the device join's reference routing kernels'
                        wrappers and plain versions
  ops/hashscan.py       the hash engine's probe and scan kernels'
                        wrappers and plain versions
  engine/slabs          the window-aligned slab layout both device
                        engines scan (Layout)
  engine/device_prefix  DevicePrefixScorer (dprefix)
  engine/device_join    DeviceJoinScorer, MeshJoinScorer
  engine/pipeline       WindowScorer (the on-chip hash engine)
  parallel/mesh         the (data, table) mesh, init_distributed,
                        the collectives
  parallel/sharded      ShardedWindowScorer (the mesh's hash engine)
  parallel/loader       ShardedTableLoader (KMC -> table shards)
  plugins/              getVariations with the port's device engines,
                        and the host plugins (copies)
  cli.py                ``python -m kcftools_tpu_torch.cli``
  dryrun.py             entry points (entry, dryrun_multichip)
"""

# the same version and source tag as kcftools_tpu: io/kcf.py writes them
# into every KCF header, whose bytes the port keeps equal
__version__ = "0.8.0"

KCF_SOURCE = "kcftools"

__all__ = ["KCF_SOURCE", "__version__"]
