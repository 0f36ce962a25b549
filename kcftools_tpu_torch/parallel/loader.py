"""Streaming KMC -> sharded device hash table loader, in torch.

Port of kcftools_tpu/parallel/loader.py. The loader streams the
``.kmc_suf`` records in bounded slabs, routes each key to the table
shard that owns the top bits of its first bucket hash (the shard-local
placement of parallel/sharded.py, native ``route_shard``), builds each
shard's two-choice table independently - on a worker thread that
overlaps the next pass's streaming - and places it on its slots. Host
staging is bounded by

    slab bytes + 2 x (shards staged per pass) x (keys-per-shard bytes)

regardless of the table size. When the budget holds fewer shards than
the mesh's table axis, the loader makes several passes over the file.
A shard that overflows its buckets makes the whole table grow.

Every process stages only the shards of its own slots (by rank), and
the result is a ``ShardedTable`` holding only those shards: the
counterpart of ``jax.make_array_from_single_device_arrays``.
"""

import threading

import numpy as np
import torch

from ..engine.hashtable import build_fixed, suggest_buckets
from ..io.kmc import KMCReader
from ..native import route_shard
from ..utils.logger import Logger
from ..torchinit import process_index
from .sharded import ShardedTable, ShardedWindowScorer

_CLASS = "ShardedTableLoader"


class ShardedTableLoader:
    """Stream a KMC database into a table-axis-sharded device table.

    Usage:
        loader = ShardedTableLoader(db_prefix, mesh,
                                    ram_budget_bytes=2 << 30)
        scorer = loader.load_scorer(min_count=1)
    """

    def __init__(self, db_prefix, mesh, ram_budget_bytes=None,
                 load_factor: float = 0.8, slab_records=None):
        self.db_prefix = db_prefix
        self.mesh = mesh
        self.load_factor = float(load_factor)
        self.ram_budget = ram_budget_bytes
        self.slab_records = slab_records
        self.reader = KMCReader(db_prefix, materialize=False)
        if self.reader.kmer_length > 32:
            Logger.error(
                _CLASS,
                "sharded device tables support k <= 32 "
                f"(DB has k={self.reader.kmer_length})",
            )

    # -- planning -------------------------------------------------------------

    def _plan(self, nb_total):
        t_axis = self.mesh.shape["table"]
        nb_local = nb_total // t_axis
        n = self.reader.total_kmers
        # host staging bytes per shard: the keys routed to it (hi, lo,
        # count: 3 x u32); builds overlap the next pass's streaming, so
        # two passes' staging may be live at once (the half budget)
        per_shard = (n // t_axis + 1) * 12
        if self.ram_budget:
            shards_per_pass = max(
                1, int((self.ram_budget // 2) // max(per_shard, 1))
            )
            if self.slab_records is None:
                # the decode slab (raw record bytes + decoded key/count
                # arrays) must fit the budget too
                rec = self.reader.suffix_length // 4 + \
                    self.reader.counter_size
                self.slab_records = max(
                    1 << 16, int(self.ram_budget // (2 * (rec + 12)))
                )
        else:
            shards_per_pass = t_axis
        return t_axis, nb_local, shards_per_pass

    def _my_shards(self, t_axis):
        """Table-shard ids owned by THIS process, and the slots that
        must hold each (the table is replicated along 'data')."""
        pidx = process_index()
        mine = {}
        for ti in range(t_axis):
            holders = [
                s for s in self.mesh.devices[:, ti] if s.process_index == pidx
            ]
            if holders:
                mine[ti] = holders
        return mine

    # -- loading --------------------------------------------------------------

    def load(self, nb_total=None):
        """Returns (ShardedTable, nb_total)."""
        n = self.reader.total_kmers
        t_axis = self.mesh.shape["table"]
        if nb_total is None:
            nb_total = max(
                suggest_buckets(n, self.load_factor), t_axis * 2
            )
        while True:
            out = self._load_once(nb_total)
            if out is not None:
                return out, nb_total
            nb_total *= 2
            Logger.warning(
                _CLASS, f"Shard overflow; growing to {nb_total} buckets"
            )

    def _load_once(self, nb_total):
        k = self.reader.kmer_length
        t_axis, nb_local, per_pass = self._plan(nb_total)
        mine = self._my_shards(t_axis)
        shard_ids = sorted(mine)
        n_passes = max(1, -(-len(shard_ids) // per_pass))
        Logger.info(
            _CLASS,
            f"Streaming {self.reader.total_kmers} k-mers into "
            f"{t_axis} shards x {nb_local} buckets "
            f"({len(shard_ids)} local shards, {n_passes} pass(es))",
        )
        self.last_stats = {
            "n_passes": n_passes,
            "local_shards": len(shard_ids),
            "shards_per_pass": per_pass,
            "nb_local": nb_local,
        }
        parts = {}  # (device, shard id) -> int32 tensor
        fail = []
        build_thread = None

        def _build(staged_now):
            """Build and place this pass's shards (on a worker thread,
            overlapping the next pass's file streaming)."""
            for s, st in staged_now.items():
                if fail:
                    return
                if st:
                    shi = np.concatenate([p[0] for p in st])
                    slo = np.concatenate([p[1] for p in st])
                    scn = np.concatenate([p[2] for p in st])
                else:
                    shi = slo = scn = np.empty(0, np.uint32)
                staged_now[s] = None  # free staging before the build
                part = build_fixed(shi, slo, scn, nb_local)
                del shi, slo, scn
                if part is None:
                    fail.append(s)  # overflow -> caller grows nb_total
                    return
                host = torch.from_numpy(
                    np.ascontiguousarray(part, np.uint32).view(np.int32)
                )
                for slot in mine[s]:
                    if (slot.device, s) not in parts:
                        parts[(slot.device, s)] = host.to(slot.device)

        for pi in range(n_passes):
            want = set(shard_ids[pi * per_pass : (pi + 1) * per_pass])
            s_lo, s_hi = min(want), max(want) + 1
            staged = {s: [] for s in want}
            for kmers, counts in self.reader.iter_slabs(self.slab_records):
                hi, lo, cnt, sh = route_shard(
                    kmers, counts, k, nb_total, nb_local, s_lo, s_hi,
                    want_ids=len(want) > 1,
                )
                if len(want) == 1:
                    if hi.shape[0]:
                        staged[s_lo].append((hi, lo, cnt))
                    continue
                # non-contiguous want sets: keys of unwanted mid-range
                # shards pass the range filter but match no s below
                for s in want:
                    sel = np.flatnonzero(sh == s)
                    if sel.size:
                        staged[s].append((hi[sel], lo[sel], cnt[sel]))
            if build_thread is not None:
                build_thread.join()
            if fail:
                return None
            build_thread = threading.Thread(target=_build, args=(staged,))
            build_thread.start()
        if build_thread is not None:
            build_thread.join()
        if fail:
            return None
        return ShardedTable(self.mesh, nb_total, parts)

    def load_scorer(self, min_count: int = 1):
        """A ShardedWindowScorer directly over the streamed table."""
        tbl, nb_total = self.load()
        return ShardedWindowScorer.from_device_table(
            tbl,
            nb_total,
            self.mesh,
            k=self.reader.kmer_length,
            both_strands=self.reader.both_strands,
            min_count=min_count,
        )
