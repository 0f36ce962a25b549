"""Multi-device window scoring over a (data, table) mesh.

Port of kcftools_tpu/parallel/sharded.py, the on-chip hash engine on
several devices. Window batches are split along ``data`` (each data
row scores its own windows); the k-mer table is split along ``table``
under shard-local placement (``ops/hashscan.py::hash_probe`` with
``nb_total``): every key's two candidate buckets live in the shard that
owns its first hash, so each shard computes partial counts for the
queries it can see and the sum over the table axis is exact.

The JAX version is one ``shard_map`` program; here each data row is a
loop step. Every local table shard of a row probes the row's bytes
(``ops/hashscan.py::hash_probe`` with ``nb_total`` / ``shard``: one
launch on the card, 1 byte a position sent to the shard), the partial
counts are summed on the row's first slot (the ``psum`` over ``table``
within a process), ``all_reduce`` adds the other processes' shards, the
sum is masked to 32 bits, and one ``hash_scan`` scores the row. Nothing
synchronises the host before ``collect``.
"""

import numpy as np
import torch

from ..engine.hashtable import build_sharded_hilo
from ..engine.pipeline import _unstack, combine_u8
from ..engine.windows import PAD_MARGIN
from ..ops.hashscan import hash_probe, hash_scan
from ..ops.lookup import _as_i32
from .mesh import all_reduce_sum

_M32 = 0xFFFFFFFF


def _check_table_axis(t_axis, nb_total=None):
    """The bucket-ownership arithmetic needs a power-of-two table axis
    that divides the power-of-two bucket count."""
    if t_axis & (t_axis - 1):
        raise ValueError(f"table axis {t_axis} is not a power of two")
    if nb_total is not None and nb_total % t_axis:
        raise ValueError(
            f"table axis {t_axis} must divide bucket count {nb_total}"
        )


class ShardedTable:
    """The shards of a table-axis-sharded table held by this process:
    ``parts[(device, ti)]`` is table column ``ti``'s (nb_local, 3*S)
    int32 shard on ``device``. Slots that share a device share the
    tensor (a virtual mesh holds each shard once)."""

    def __init__(self, mesh, nb_total, parts):
        self.mesh = mesh
        self.nb_total = int(nb_total)
        self.parts = parts

    @classmethod
    def from_host(cls, tbl, mesh):
        """Split a host (nb_total, 3*S) int32 tensor into the mesh's
        table shards and place this process's on their slots."""
        t_axis = mesh.shape["table"]
        nb_local = tbl.shape[0] // t_axis
        parts = {}
        for ti in range(t_axis):
            for slot in mesh.devices[:, ti]:
                key = (slot.device, ti)
                if mesh.is_local(slot) and key not in parts:
                    parts[key] = tbl[ti * nb_local : (ti + 1) * nb_local].to(
                        slot.device
                    )
        return cls(mesh, tbl.shape[0], parts)

    def shard(self, slot, ti):
        return self.parts[(slot.device, ti)]


def _sharded_lookup(u8, win_len, table, di, *, k, both_strands):
    """The global counts of the k-mers of data row ``di``'s bytes (u8:
    (B, Lp) uint8, win_len: (B,) int64, on the row's device): one
    ``hash_probe`` per local table shard, the partial counts summed on
    the row's device, then across processes, masked to 32 bits. Returns
    (B, Lp - PAD_MARGIN) int32 holding the uint32 counts."""
    mesh = table.mesh
    row_dev = u8.device
    acc = torch.zeros((u8.shape[0], u8.shape[1] - PAD_MARGIN),
                      dtype=torch.int64, device=row_dev)
    for ti, slot in enumerate(mesh.devices[di]):
        if not mesh.is_local(slot):
            continue
        dev = slot.device
        part = hash_probe(u8.to(dev), win_len.to(dev), table.shard(slot, ti),
                          k=k, both_strands=both_strands,
                          nb_total=table.nb_total, shard=ti)
        acc += part.to(row_dev).long() & _M32
    return _as_i32(all_reduce_sum(acc) & _M32)


def make_sharded_scorer(mesh, *, k, min_count, both_strands, nb_total):
    """The mesh's scoring function: fn(u8, win_len, table) with u8 a
    (B, Lp) uint8 sentinel-coded host array, B divisible by the data
    axis, win_len (B,), and ``table`` a ShardedTable. Returns the list
    of each data row's (8, B/data) int64 device tensor."""
    d = mesh.shape["data"]

    def fn(u8, win_len, table):
        if table.nb_total != nb_total:
            raise ValueError("table bucket count changed")
        rows = u8.shape[0] // d
        out = []
        for di in range(d):
            dev = mesh.row_device(di)
            sl = slice(di * rows, (di + 1) * rows)
            row_u8 = torch.from_numpy(np.ascontiguousarray(u8[sl])).to(dev)
            row_len = torch.from_numpy(
                np.asarray(win_len[sl], np.int64)).to(dev)
            counts = _sharded_lookup(row_u8, row_len, table, di, k=k,
                                     both_strands=both_strands)
            out.append(hash_scan(row_u8, counts, row_len, k=k,
                                 min_count=min_count))
        return out

    return fn


def _reshard_table(table, t_axis):
    """Rebuild a host KmerTable with shard-local placement (idempotent:
    entries already placed shard-locally land in the same shards)."""
    live = table.counts != 0
    rows, cols = np.nonzero(live)
    return build_sharded_hilo(
        table.hi[rows, cols], table.lo[rows, cols],
        table.counts[rows, cols], table.k, t_axis,
        both_strands=table.both_strands,
    )


class ShardedWindowScorer:
    """Device-mesh version of engine.pipeline.WindowScorer."""

    def __init__(self, table, mesh, min_count: int = 1):
        t_axis = mesh.shape["table"]
        _check_table_axis(t_axis)
        if t_axis > 1:
            # re-place entries shard-locally so every key's two candidate
            # buckets live on the shard owning its first hash; a table
            # built by the streaming loader already satisfies this
            table = _reshard_table(table, t_axis)
        nb = table.n_buckets
        _check_table_axis(t_axis, nb)
        tbl = torch.from_numpy(
            np.ascontiguousarray(table.tbl, np.uint32).view(np.int32)
        )
        self._init(ShardedTable.from_host(tbl, mesh), mesh, k=table.k,
                   both_strands=table.both_strands, min_count=min_count)

    @classmethod
    def from_device_table(cls, tbl_device, nb_total, mesh, *, k,
                          both_strands, min_count: int = 1):
        """Wrap an already-sharded table (a ShardedTable: the streaming
        loader's, parallel/loader.py) without any host-side copy."""
        _check_table_axis(mesh.shape["table"], nb_total)
        if tbl_device.nb_total != nb_total:
            raise ValueError("sharded table bucket count differs")
        self = cls.__new__(cls)
        self._init(tbl_device, mesh, k=k, both_strands=both_strands,
                   min_count=min_count)
        return self

    def _init(self, tbl, mesh, *, k, both_strands, min_count):
        self.k = int(k)
        self.min_count = int(min_count)
        self.both_strands = bool(both_strands)
        self.mesh = mesh
        self.data_parallel = mesh.shape["data"]
        self.nb_total = tbl.nb_total
        self.tbl = tbl
        self._fn = make_sharded_scorer(
            mesh, k=self.k, min_count=self.min_count,
            both_strands=self.both_strands, nb_total=self.nb_total,
        )

    def score_batch_async(self, codes, valid, win_len):
        """Dispatch one padded batch across the mesh; returns (per-row
        device tensors, B)."""
        codes = np.asarray(codes)
        valid = np.asarray(valid)
        win_len = np.asarray(win_len)
        B = codes.shape[0]
        padn = (-B) % self.data_parallel
        if padn:
            codes = np.vstack(
                [codes, np.zeros((padn, codes.shape[1]), codes.dtype)])
            valid = np.vstack([valid, np.zeros((padn, valid.shape[1]), bool)])
            win_len = np.concatenate(
                [win_len, np.zeros(padn, win_len.dtype)])
        return self._fn(combine_u8(codes, valid), win_len, self.tbl), B

    @staticmethod
    def collect(handle_b) -> dict:
        handle, B = handle_b
        arr = torch.cat([h.cpu() for h in handle], dim=1).numpy()
        return {key: v[:B] for key, v in _unstack(arr).items()}

    def score_batch(self, codes, valid, win_len):
        return self.collect(self.score_batch_async(codes, valid, win_len))
