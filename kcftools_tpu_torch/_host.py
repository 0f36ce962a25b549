"""The jax-free host tier of kcftools_tpu, as the port uses it.

The port reuses the JAX package's host code (KMC/FASTA/GTF/KCF I/O, the
native C++ library, the numpy engine modules and the host plugins)
instead of copying it. That code is numpy-only, but importing any module
under ``kcftools_tpu.engine`` first runs ``engine/__init__.py``, which
imports the on-chip hash pipeline and with it jax.

So, before the first import, this module registers a bare package module
for ``kcftools_tpu.engine`` whose ``__path__`` is the real engine
directory and whose ``__init__`` has not run. Submodules then import
from their files as usual. A name the bare package lacks (the
``__init__``'s re-exports, such as ``WindowScorer``) runs the real
``__init__`` into the module at that moment - loading jax only then - so
JAX code imported later in the same process still finds everything. If
the real package is already loaded, it is used unchanged.

Every other module of the port reaches the host tier through this one.
"""

import importlib
import importlib.util
import os
import sys

import kcftools_tpu

_ENGINE = "kcftools_tpu.engine"


def _install_engine_package():
    if _ENGINE in sys.modules:
        return
    path = os.path.join(os.path.dirname(kcftools_tpu.__file__), "engine")
    spec = importlib.util.spec_from_file_location(
        _ENGINE, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path],
    )
    pkg = importlib.util.module_from_spec(spec)
    state = {"ran_init": False}

    def __getattr__(name):
        if name.startswith("__"):
            raise AttributeError(name)
        if os.path.exists(os.path.join(path, name + ".py")):
            return importlib.import_module(f"{_ENGINE}.{name}")
        if not state["ran_init"]:
            state["ran_init"] = True
            spec.loader.exec_module(pkg)
            if name in pkg.__dict__:
                return pkg.__dict__[name]
        raise AttributeError(f"module {_ENGINE!r} has no attribute {name!r}")

    pkg.__getattr__ = __getattr__
    sys.modules[_ENGINE] = pkg
    kcftools_tpu.engine = pkg


_install_engine_package()

from kcftools_tpu import KCF_SOURCE, __version__  # noqa: E402
from kcftools_tpu.engine.encode import (  # noqa: E402
    canonicalize,
    pack_kmers,
    split_hi_lo,
)
from kcftools_tpu.engine.hashtable import bucket_hashes_np  # noqa: E402
from kcftools_tpu.engine.refindex import (  # noqa: E402
    FeatureKmerIndex,
    RefKmerIndex,
)
from kcftools_tpu.io.fasta import FastaIndex  # noqa: E402
from kcftools_tpu.io.gtf import GTF  # noqa: E402
from kcftools_tpu.engine.windows import tiling_windows  # noqa: E402
from kcftools_tpu.io.kmc import (  # noqa: E402
    KMCReader,
    load_sorted_cache,
    write_kmc_db,
)
from kcftools_tpu.native import get_lib, set_threads, sort_pairs  # noqa: E402
from kcftools_tpu.plugins import PLUGINS as HOST_PLUGINS  # noqa: E402
from kcftools_tpu.plugins import _common, get_variations  # noqa: E402
from kcftools_tpu.utils import stagetimer  # noqa: E402
from kcftools_tpu.utils.logger import KcfError, Logger  # noqa: E402

__all__ = [
    "FastaIndex",
    "FeatureKmerIndex",
    "GTF",
    "HOST_PLUGINS",
    "KCF_SOURCE",
    "KMCReader",
    "KcfError",
    "Logger",
    "RefKmerIndex",
    "__version__",
    "_common",
    "bucket_hashes_np",
    "canonicalize",
    "get_lib",
    "get_variations",
    "load_sorted_cache",
    "pack_kmers",
    "set_threads",
    "sort_pairs",
    "split_hi_lo",
    "stagetimer",
    "tiling_windows",
    "write_kmc_db",
]
