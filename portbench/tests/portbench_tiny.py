"""Small copies of the benchmark's cells for the CPU tests."""

import json
import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WINDOW = "lettuce-chr3-w50k.per-sample"
GENE = "arabidopsis-tair10-gene.per-sample"
# the gene cell's entries, kept out of BENCHMARK.json while its host-bound
# rate spreads wider between runs than the largest bound allows; the
# tests still run it, so that it can come back as entries alone
SHELVED = {
    "configs": [{
        "name": "arabidopsis-tair10-gene",
        "source": "TAIR10 (arabidopsis.org): 5 chromosomes, 119,146,348 "
                  "bp, 33,602 genes, 41,671 gene models",
        "file": "portbench/configs/arabidopsis-tair10-gene.json",
        "reduced": [],
        "why": "gene windows of a whole genome through the on-chip hash "
               "engine: KMC decode, host table build and upload, probe "
               "and scan"}],
    "workloads": [{
        "name": GENE, "config": "arabidopsis-tair10-gene",
        "traffic": "per-sample", "chips": 1,
        "why": "one sample a call, repeated: 33,602 genes over 119 Mbp; "
               "KMC decode, host table build and its upload every call"}],
}


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def tiny_config(name):
    """The named configuration at a CPU test's size: the same command,
    samples and counter models, a few hundred kb."""
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as fh:
        cfg = json.load(fh)
    cfg["n_runs"]["per_contig"] = 3
    if cfg.get("genes"):
        cfg["contigs"] = [{"name": "Chr1", "length": 150_000},
                          {"name": "Chr2", "length": 90_000}]
        cfg["genes"]["count"] = 80
        cfg["genes"]["transcripts"] = 99
    else:
        cfg["contigs"] = [{"name": "chr3", "length": 260_000},
                          {"name": "chrX", "length": 70_000}]
        cfg["command"]["window"] = 20_000
    return cfg


def full_spec():
    """BENCHMARK.json with the shelved gene cell added."""
    s = spec()
    for key, entries in SHELVED.items():
        s[key] = s[key] + [dict(e) for e in entries]
    return s


def tiny_spec(tmp):
    """``full_spec()`` with every configuration file replaced by its tiny
    copy under ``tmp``."""
    s = full_spec()
    for c in s["configs"]:
        path = os.path.join(str(tmp), f"{c['name']}.json")
        with open(path, "w") as fh:
            json.dump(tiny_config(c["name"]), fh)
        c["file"] = path
    return s


def run(tmp, workload, seed=2**31 + 7, seconds=0.5, trace=0):
    """One harness run of a tiny cell on the CPU (the program on its
    plain torch paths)."""
    from portbench import harness

    os.environ.update(harness.cache_env())
    os.environ["KCFTOOLS_TORCH_DEVICE"] = "cpu"
    cell = harness.Cell(tiny_spec(tmp), workload, ROOT)
    return harness.Run(cell, seed, seconds, trace, time.perf_counter(),
                       device="cpu").execute()
