"""Subcommands, in the order of kcftools_tpu.plugins: the host plugins
are copies of the JAX package's, getVariations is the port's own (its
device engines on torch)."""

from . import (
    get_variations,
    cohort,
    find_ibs,
    split_kcf,
    get_attributes,
    kcf2tsv,
    increase_window,
    kcf2plink,
    score_recalc,
    kcf2gt,
    compare_ibs,
    kcf2matrix,
    count,
)

PLUGINS = [
    get_variations,
    cohort,
    find_ibs,
    split_kcf,
    get_attributes,
    kcf2tsv,
    increase_window,
    kcf2plink,
    score_recalc,
    kcf2gt,
    compare_ibs,
    kcf2matrix,
    count,
]
