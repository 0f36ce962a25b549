"""The port's multi-process mesh on torch.distributed (gloo, CPU).

Mirrors tests/test_distributed.py: two OS processes own 4 CPU slots each
(``KCFTOOLS_TORCH_VIRTUAL_DEVICES=4``) and form one (data 2, table 4)
mesh. Each process streams ONLY its own 2 of the 4 table columns from a
shared KMC database, and the table-axis sum crosses the process boundary
as an ``all_reduce``. Results must equal the JAX single-device
WindowScorer exactly. The same two processes also run the mesh join on
that mesh (its routed counts all-gathered across processes) against the
single-device join. The workers never import jax, run as subprocesses
with a timeout, and are killed when it expires (a gloo rank that loses
its peer waits for ever).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

from kcftools_tpu.engine.encode import str_to_kmer
from kcftools_tpu.engine.hashtable import build_table
from kcftools_tpu.engine.pipeline import PAD_MARGIN, WindowScorer
from kcftools_tpu.engine.windows import pad_batch_varlen
from kcftools_tpu.io.fasta import codes_from_str

from .gen import db_from_seqs, mutate, random_seq
from .test_torch_cli import _REPO, _env

K = 31
_TIMEOUT = 120

_WORKER = r'''
import json, sys
coord, rank, db_prefix, batch_npz, out_path = sys.argv[1:6]
import numpy as np, torch
from kcftools_tpu_torch.engine.encode import canonicalize, pack_kmers
from kcftools_tpu_torch.engine.windows import tiling_windows
from kcftools_tpu_torch.engine.device_join import (
    DeviceJoinScorer, MeshJoinScorer)
from kcftools_tpu_torch.parallel.loader import ShardedTableLoader
from kcftools_tpu_torch.parallel.mesh import init_distributed, make_mesh
from kcftools_tpu_torch.torchinit import device_count, process_index

init_distributed(coord, 2, int(rank))
assert device_count() == 8 and process_index() == int(rank)
mesh = make_mesh(data=2, table=4)
loader = ShardedTableLoader(db_prefix, mesh, slab_records=701)
local_cols = sorted(loader._my_shards(4))
scorer = loader.load_scorer(min_count=1)
z = np.load(batch_npz)
out = scorer.score_batch(z["codes"], z["valid"], z["win_len"])

# the mesh join on the same mesh: routed counts gathered across ranks
rng = np.random.default_rng(5)
L = 20_000
g = rng.integers(0, 4, L).astype(np.uint8)
km, kv = pack_kmers(g, np.ones(L, bool), 31)
canon = canonicalize(km, 31)
refk = np.unique(canon[kv])
r_idx = np.searchsorted(refk, canon).astype(np.int32)
starts, ends = tiling_windows(L, 1000, 31)
db = refk[rng.random(refk.shape[0]) < 0.8]
dbc = rng.integers(1, 9, db.shape[0]).astype(np.uint32)
class R: kmers = refk
res = {}
for name, sc in (("single", DeviceJoinScorer(R, 31, torch.device("cpu"))),
                 ("mesh", MeshJoinScorer(R, 31, mesh))):
    sc.add_chrom("c", r_idx, starts, ends)
    sc.submit(0, refk, db, dbc)
    res[name] = sc.collect(0)["c"]
join_equal = all((res["mesh"][f] == res["single"][f]).all()
                 for f in res["single"])
with open(out_path, "w") as fh:
    json.dump({
        "local_table_columns": local_cols,
        "shards_held": sorted(ti for _dev, ti in scorer.tbl.parts),
        "mesh_join_columns": sorted(sc._q),
        "mesh_join_equal": bool(join_equal),
        "jax_loaded": "jax" in sys.modules,
        "out": {key: v.tolist() for key, v in out.items()},
    }, fh)
print("WORKER_OK", rank, flush=True)
'''


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_mesh(tmp_path, rng):
    genome = random_seq(rng, 5000)
    sample = mutate(rng, genome, snp_rate=0.01)
    prefix = str(tmp_path / "db")
    db = db_from_seqs(prefix, [sample], K)
    windows = [genome[i : i + 400] for i in range(0, 4400, 390)]
    pad = max(len(w) for w in windows) + PAD_MARGIN
    codes, valids = zip(*[codes_from_str(w) for w in windows])
    bcodes, bvalid, wlen = pad_batch_varlen(list(codes), list(valids), pad)
    batch_npz = str(tmp_path / "batch.npz")
    np.savez(batch_npz, codes=bcodes, valid=bvalid, win_len=wlen)
    kmers = np.array([str_to_kmer(s) for s in db], dtype=np.uint64)
    counts = np.array(list(db.values()), dtype=np.uint32)
    ref = WindowScorer(build_table(kmers, counts, K)).score_batch(
        bcodes, bvalid, wlen
    )

    port = _free_port()
    env = _env(KCFTOOLS_TORCH_DEVICE="cpu",
               KCFTOOLS_TORCH_VIRTUAL_DEVICES="4")
    procs, outs = [], []
    for rank in range(2):
        out_path = str(tmp_path / f"worker{rank}.json")
        outs.append(out_path)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, f"127.0.0.1:{port}", str(rank),
             prefix, batch_npz, out_path],
            cwd=_REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        ))
    logs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=_TIMEOUT)
            logs.append(stdout.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{log[-3000:]}"

    for rank, out_path in enumerate(outs):
        with open(out_path) as fh:
            meta = json.load(fh)
        # each process stages only its own 2 of the 4 table columns
        cols = [2 * rank, 2 * rank + 1]
        assert meta["local_table_columns"] == cols, meta
        assert meta["shards_held"] == cols
        assert meta["mesh_join_columns"] == cols
        assert meta["mesh_join_equal"]
        assert not meta["jax_loaded"]
        for key in ref:
            np.testing.assert_array_equal(
                np.array(meta["out"][key]), np.asarray(ref[key]),
                err_msg=f"{rank}:{key}",
            )
