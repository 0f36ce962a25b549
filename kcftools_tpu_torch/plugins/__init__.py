"""Subcommands: the JAX package's host plugins with the port's
getVariations in place of the JAX one (same order as
kcftools_tpu.plugins)."""

from .._host import HOST_PLUGINS, get_variations as _host_gv
from . import get_variations

PLUGINS = [get_variations if p is _host_gv else p for p in HOST_PLUGINS]
