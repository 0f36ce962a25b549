"""The (data, table) device mesh and its collectives, on torch.distributed.

Port of kcftools_tpu/parallel/mesh.py. Window batches (and genome slabs)
shard along ``data``; a k-mer table's buckets (and the join's quantile
partitions) shard along ``table``. A mesh is a (data, table) grid of
slots (``torchinit.Slot``), the counterpart of ``jax.sharding.Mesh``;
the programs that run on it are plain loops over its slots.

Within one process the table-axis reduction is a sum of the per-shard
partial results on the data row's first slot. Across processes
(``init_distributed``: NCCL for CUDA devices, gloo for CPU devices) the
same sum finishes with one ``all_reduce``. A collective whose tensor
lies on a device the process group's backend does not serve raises:
a CUDA run never goes through gloo.
"""

import datetime

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logger import Logger
from ..torchinit import (
    local_devices,
    process_count,
    process_index,
    resolve_devices,
)

_CLASS = "Mesh"
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


class Mesh:
    """A (data, table) grid of slots. ``devices`` is the (data, table)
    object ndarray of slots, ``shape`` maps each axis to its size."""

    def __init__(self, devices):
        self.devices = devices
        data, table = self.devices.shape
        self.shape = {"data": data, "table": table}

    def is_local(self, slot) -> bool:
        return slot.process_index == process_index()

    def row_device(self, di) -> torch.device:
        """Where data row ``di``'s table-axis sum lands: the row's first
        slot of this process (any local slot if it owns none there)."""
        for slot in self.devices[di]:
            if self.is_local(slot):
                return slot.device
        return self.local_slots()[0].device

    def local_slots(self) -> list:
        return [s for s in self.devices.ravel() if self.is_local(s)]

    def local_columns(self) -> list:
        """Table columns with at least one slot in this process."""
        return [
            ti for ti in range(self.shape["table"])
            if any(self.is_local(s) for s in self.devices[:, ti])
        ]

    def column_device(self, ti) -> torch.device:
        """The device of table column ``ti``'s first local slot."""
        return next(s.device for s in self.devices[:, ti] if self.is_local(s))


def init_distributed(coordinator=None, num_processes=None, process_id=None):
    """Join a ``num_processes``-rank process group at ``coordinator``
    (host:port); no-op for a single process. The backend follows the
    resolved device: NCCL for CUDA, gloo for the CPU."""
    if not num_processes or num_processes <= 1:
        return
    dev = local_devices()[0]
    backend = _BACKEND[dev.type]
    if not coordinator:
        Logger.error(_CLASS, "KCFTOOLS_COORDINATOR (host:port) is required "
                     "for a multi-process run")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(minutes=10),
    )


def check_backend(device):
    """Raise unless the process group's backend serves ``device``'s
    tensors (gloo: CPU; NCCL: CUDA)."""
    if not dist.is_initialized():
        return
    want = _BACKEND[torch.device(device).type]
    backend = dist.get_backend()
    if backend != want:
        raise RuntimeError(
            f"process group backend {backend} cannot serve {device} "
            f"tensors (a {torch.device(device).type} run needs {want})"
        )


def all_reduce_sum(t):
    """In-place sum of ``t`` across processes (no-op in one process)."""
    if process_count() > 1:
        check_backend(t.device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_gather_columns(local, t_axis):
    """{table column: tensor} of this process's columns -> the list of
    every column's tensor, in table order. Across processes each rank
    must hold the same number of columns with equal shapes."""
    if process_count() == 1:
        return [local[ti] for ti in range(t_axis)]
    cols = sorted(local)
    mine = torch.stack([local[ti] for ti in cols])
    check_backend(mine.device)
    ids = torch.tensor(cols, dtype=torch.int64, device=mine.device)
    world = process_count()
    all_ids = [torch.empty_like(ids) for _ in range(world)]
    all_parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(all_ids, ids)
    dist.all_gather(all_parts, mine)
    out = [None] * t_axis
    for ids_r, parts_r in zip(all_ids, all_parts):
        for ti, part in zip(ids_r.tolist(), parts_r):
            out[ti] = part
    if any(p is None for p in out):
        raise RuntimeError("all_gather_columns: a table column has no owner")
    return out


def _slot_array(slots):
    """A 1-D object ndarray of slots (numpy would unpack the tuples)."""
    slots = list(slots)
    arr = np.empty(len(slots), dtype=object)
    for i, s in enumerate(slots):
        arr[i] = s
    return arr


def make_mesh(data: int = None, table: int = 1, devices=None) -> Mesh:
    """2D mesh over (data, table). Defaults: all slots on the data axis.

    Under torch.distributed with table > 1, slots are arranged so the
    TABLE axis partitions the processes: each process then stores a
    disjoint slice of the k-mer table and the streaming loader stages
    only local shards; the data axis stays within each process."""
    if devices is None:
        devices = resolve_devices()
        n_proc = process_count()
        if data is None:
            data = len(devices) // table
        if (
            n_proc > 1
            and table % n_proc == 0
            and data * table == len(devices)
            and len(devices) % n_proc == 0
        ):
            devs = sorted(devices, key=lambda d: (d.process_index, d.index))
            per = len(devices) // n_proc  # slots per process
            cols_pp = table // n_proc  # table columns per process
            arr = np.empty((data, table), dtype=object)
            for p in range(n_proc):
                block = _slot_array(devs[p * per : (p + 1) * per])
                arr[:, p * cols_pp : (p + 1) * cols_pp] = block.reshape(
                    data, cols_pp
                )
            return Mesh(arr)
    flat = _slot_array(devices)
    n = flat.size
    if data is None:
        data = n // table
    if data * table != n:
        Logger.error(_CLASS, f"mesh {data}x{table} != {n} devices")
    return Mesh(flat.reshape(data, table))
