"""Device-join window scorer: the merge join runs on the GPU.

Port of kcftools_tpu/engine/device_join.py::DeviceJoinScorer, the
engine behind ``getVariations --engine device`` at k <= 32.

  per REFERENCE (once a call, device-resident):
    - the sorted unique reference k-mers, each window-aligned slab's
      reference ordinals (r_idx) and its window bounds are uploaded;
    - on the device (ops/route.py, the kernels csrc/route.cu on CUDA):
      the keys are quantile-tiled into static (P, Tq) query tiles, and
      each slab gets its int32 slot map position -> flattened routed
      slot and its packed valid bitmap; the keys are then freed.
  per SAMPLE:
    - the sorted (keys, counts), as the mapped sidecar holds them, are
      copied to the device;
    - on the device (ops/route.py::tile_sample, the kernels
      csrc/route.cu on CUDA): they are quantile-sliced into one flat
      [hi | lo | counts] buffer, the native packer's (counts byte-packed
      4 per word when all are <= 255), and freed;
    - ONE ``pjoin_join`` launch;
    - ONE ``slabs_scan_join`` launch over every slab (ops/gapscan.py,
      the kernel csrc/gapscan.cu; the slabs' statics are stacked): gather
      through each slab's slot map, presence test, the gap-run
      statistics and the count sums, into one (S, 6, win_pad) int64
      device tensor;
    - ``collect`` makes the one device-to-host copy.

Dropped from the JAX engine because they were TPU-only: the fused and
split per-sample programs (``_FUSE_MAX_POS``, ``_get_split_fns``) -
eager torch runs the join and the scan as two launches anyway;
``lax.map`` over slabs - the scan kernel takes the slab as its row; the
two-plane uint32 and float64 count sums - the scan sums in int64,
exactly. The slab size keeps its environment names
(``KCFTOOLS_DJOIN_SLAB``, then ``KCFTOOLS_DPREFIX_SLAB``) and its 2^24
default, which still has to be re-measured on the H100.

``MeshJoinScorer`` runs the same engine over a (data, table) mesh
(parallel/mesh.py): the sample's buffer packed on the host by the
native packer, one join per table shard, the routed counts gathered in
table order, each data row scanning its own slabs in one launch.

With ``KCFTOOLS_STAGE_JSON`` set, the per-sample phases are timed as
the stages djoin_upload, djoin_pack (on the device; on the host in the
mesh, before its upload), djoin_join, djoin_scan and djoin_fetch, and
the per-run set-up as djoin_setup (children djoin_statics: the slab
layout on the host and the slot-map launch; djoin_static_upload: the
copies of the keys, r_idx and window bounds; djoin_route: the query
tiles' launches), with a device synchronisation at the end of each
phase; unset, nothing synchronises before
``collect``. The counter djoin_h2d_bytes adds up every byte the join
copies to its devices, djoin_h2d_staged_bytes those of them that crossed
through pinned staging chunks (all on a CUDA device, 0 on a CPU device);
djoin_route_on_card adds 1 for a set-up routed by the kernels, 0 for one
routed by the plain torch version (a CPU device); djoin_pack_on_card
adds 1 for a sample tiled by the kernels, 0 for one tiled by the plain
torch version.

Every host-to-device copy of the join goes through ``h2d_staged``: a
pageable ``.to(dev)`` runs at CUDA's single-threaded staging rate
(~4.7-6 GB/s on the H100's host), so the bytes are instead filled into
pinned chunks by several host threads side by side (``csrc/h2d.cu``)
and copied from there asynchronously, the fills overlapping the DMAs. A
CPU device copies nothing, as before.
"""

import ctypes
import os
import warnings

import numpy as np
import torch

from ..native import get_lib
from ..ops import _kernels
from ..utils.logger import Logger
from ..ops.gapscan import slabs_scan_join
from ..ops.pjoin import (
    as_i32,
    pack_planar,
    pjoin_join,
    quantile_partition_ids,
    tile_sorted,
)
from ..ops.route import (
    route_reference,
    route_slabs,
    sample_tile,
    tile_sample,
)
from ..parallel.mesh import all_gather_columns
from ..torchinit import phase
from ..utils.stagetimer import count, stage
from .slabs import FIELDS, Layout

_CLASS = "DeviceJoin"

_JFIELDS = FIELDS + ("count_sum",)


class _Slabs:
    """The scan's statics of some slabs, stacked on one device: slot maps
    (S, pos_pad) int32, valid bitmaps (S, pos_pad/8) uint8, window bounds
    (S, win_pad) int64 each. Made by uploading the slabs' reference
    ordinals (r_idx) and window bounds; ``route`` then builds the slot
    maps and valid bitmaps on the device and frees r_idx. ``len`` is the
    slab count."""

    __slots__ = ("r_idx", "slot_maps", "valid_bits", "w_start", "w_hi")

    def __init__(self, slabs, pos_pad, win_pad, dev):
        self.r_idx = _h2d_rows([s["r_idx"] for s in slabs], pos_pad,
                               torch.int32, dev)
        self.w_start, self.w_hi = (
            _h2d_rows([s[key] for s in slabs], win_pad, torch.int64, dev)
            for key in ("w_start", "w_hi")
        )
        self.slot_maps = self.valid_bits = None

    def route(self, slot_of_ord):
        """The slot maps and valid bitmaps from ``route_reference``'s
        slot of each reference ordinal (moved to this device)."""
        self.slot_maps, self.valid_bits = route_slabs(
            self.r_idx, slot_of_ord.to(self.r_idx.device))
        self.r_idx = None
        return self

    def __len__(self):
        return self.w_start.shape[0]


# The pinned staging of ``h2d_staged``: chunks of H2D_CHUNK bytes,
# H2D_DEPTH of them filled or in flight at once, by as many host threads
# (64 MiB pinned). Chosen on the H100 from a sweep of 4, 6 and 8 threads
# over 4-32 MiB chunks, where 8 MiB x 8 led from the heap, and measured
# end to end there (PERF.md section 6). chip_smoke.py's sweep now runs 4
# to 16 threads, and there 16 MiB x 12 read faster from a mapped file
# (PERF.md section 7: not yet measured end to end).
H2D_CHUNK = 8 << 20
H2D_DEPTH = 8


def h2d_staged(copies, chunk=H2D_CHUNK, depth=H2D_DEPTH):
    """Copy each host array or CPU tensor ``src`` of ``copies``, a list of
    (dst, src) pairs, into its contiguous tensor ``dst`` of as many bytes,
    every ``dst`` on one CUDA device, through ``depth`` pinned staging
    buffers of ``chunk`` bytes (fewer, or smaller, where the copies are
    small): one block from torch's caching host allocator, which hands it
    to the next call. ``csrc/h2d.cu``'s ``kcf_h2d_staged`` runs the copy:
    ``depth`` host threads each take the next chunk, fill their buffer
    once its last DMA is done, and queue the chunk's copy on the device's
    current stream, the fills side by side and overlapping the DMAs; it
    returns once every DMA is done. The sources are read only while this
    call runs: they may change or go once it returns."""
    outs, inps = [], []
    for dst, src in copies:
        inp = _host_bytes(src)
        if dst.nbytes != inp.size:
            raise ValueError(f"h2d_staged: {inp.size} source bytes into a "
                             f"{dst.nbytes}-byte destination")
        if inp.size:
            outs.append(dst.view(-1).view(torch.uint8))
            inps.append(inp)
    if not inps:
        return
    dev = outs[0].device
    if dev.type != "cuda" or any(out.device != dev for out in outs):
        raise ValueError("h2d_staged: destinations not all on one CUDA "
                         "device")
    size = min(chunk, max(inp.size for inp in inps))
    workers = min(depth, sum(-(-inp.size // size) for inp in inps))
    staging = torch.empty(workers * size, dtype=torch.uint8, pin_memory=True)
    dsts = np.array([out.data_ptr() for out in outs], np.uint64)
    srcs = np.array([inp.ctypes.data for inp in inps], np.uint64)
    sizes = np.array([inp.size for inp in inps], np.int64)
    _kernels.call("kcf_h2d_staged", dev, dsts.ctypes.data, srcs.ctypes.data,
                  sizes.ctypes.data, len(inps), staging.data_ptr(), size,
                  workers)


def _host_bytes(a):
    """The bytes of a host array or CPU tensor, as a flat uint8 numpy
    array over the same memory (a read-only array stays read-only)."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous().numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _host_tensor(a):
    """A host array as a CPU tensor over the same memory (a tensor as it
    is). The array may be a read-only view of a mapped file (the
    reference index, the sample's sidecar); the tensor is only read, so
    torch's warning that it could write there is silenced for this call
    alone."""
    if not isinstance(a, np.ndarray):
        return a
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", "The given NumPy array is not writable")
        return torch.from_numpy(a)


def _count_h2d(tensors, staged):
    """Count each tensor's bytes as ``djoin_h2d_bytes`` and, where they
    went through ``h2d_staged``, as ``djoin_h2d_staged_bytes`` (else 0)."""
    for t in tensors:
        count("djoin_h2d_bytes", t.nbytes)
        count("djoin_h2d_staged_bytes", t.nbytes if staged else 0)


def _h2d(dev, *arrays):
    """Host arrays or CPU tensors on ``dev``, as a tuple: on a CUDA device
    copied in one ``h2d_staged`` call, on a CPU device the tensors
    themselves (no copy made); their bytes counted by ``_count_h2d``."""
    ts = [_host_tensor(a) for a in arrays]
    staged = torch.device(dev).type == "cuda"
    _count_h2d(ts, staged)
    if not staged:
        return tuple(ts)
    out = tuple(torch.empty(t.shape, dtype=t.dtype, device=dev) for t in ts)
    h2d_staged(list(zip(out, ts)))
    return out


def _h2d_rows(arrays, width, dtype, dev):
    """Host arrays of ``width`` entries as the rows of one (len, width)
    tensor of ``dtype`` on ``dev``, each row copied from its array (all
    in one ``h2d_staged`` call on a CUDA device), which is first cast to
    ``dtype`` on the host where it differs; the copied bytes counted by
    ``_count_h2d``."""
    out = torch.empty((len(arrays), width), dtype=dtype, device=dev)
    ts = [_host_tensor(np.ascontiguousarray(a)).to(dtype) for a in arrays]
    staged = out.device.type == "cuda"
    _count_h2d(ts, staged)
    if staged:
        h2d_staged(list(zip(out, ts)))
    else:
        for row, t in zip(out, ts):
            row.copy_(t)
    return out


def _as_tensor(a, unsigned, signed):
    """A host array of ``unsigned`` values as a CPU tensor of the
    ``signed`` numpy type of the same width and bits: sorted keys
    (uint64 -> int64) or counts (uint32 -> int32), over the same memory
    (``_host_tensor``); it is only read (copied to the device, or routed
    and tiled in place on a CPU device)."""
    return _host_tensor(np.ascontiguousarray(a, unsigned).view(signed))


def pack_tiles_host(db_keys, db_counts, k, b, tile=None):
    """``tile_sample`` on the host, for the mesh: (buf, Tt, packed), buf
    the flat uint32 [hi | lo | counts] buffer of a sorted table in
    (2^b, Tt) planes, Tt = ``sample_tile`` of its largest partition and
    the width ``tile`` an earlier sample took, counts <= 255 byte-packed
    4 per word in the planar layout. The native packer does it where the
    library is built (its partition function clamps to P - 1, as
    ``quantile_partition_ids`` does), else ``tile_sorted`` and
    ``pack_planar``."""
    db_keys = np.ascontiguousarray(db_keys, np.uint64)
    db_counts = np.ascontiguousarray(db_counts, np.uint32)
    n, P = db_keys.shape[0], 1 << b
    lib = get_lib()
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    if lib is not None:
        per = np.zeros(P, np.int64)
        lib.kcf_pjoin_hist(
            db_keys.ctypes.data_as(u64p), ctypes.c_int64(n),
            ctypes.c_int(k), ctypes.c_int(b), per.ctypes.data_as(i64p),
        )
    else:
        per = np.bincount(quantile_partition_ids(db_keys, b, k),
                          minlength=P)
    Tt = sample_tile(int(per.max()), tile)
    packed = bool(db_counts.max(initial=0) <= 0xFF)
    if lib is None:
        th, tl, tc, _, _ = tile_sorted(db_keys, k, b, tile=Tt,
                                       counts=db_counts)
        planes = (th, tl, pack_planar(tc) if packed else tc)
        return np.concatenate([a.ravel() for a in planes]), Tt, packed
    nt = P * Tt
    buf = np.zeros(2 * nt + (nt // 4 if packed else nt), np.uint32)
    lib.kcf_pjoin_pack(
        db_keys.ctypes.data_as(u64p),
        db_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(n), ctypes.c_int(k), ctypes.c_int(b),
        ctypes.c_int64(Tt), ctypes.c_int(int(packed)),
        per.ctypes.data_as(i64p),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return buf, Tt, packed


class DeviceJoinScorer:
    """DevicePrefixScorer-compatible interface; the merge runs on the
    device given. Requires the sample's sorted (keys, counts). k <= 32."""

    def __init__(self, refidx, k, device, min_count=1, batch=None,
                 tile_target=512):
        if k > 32:
            raise ValueError("device-join engine supports k <= 32")
        self.k = int(k)
        self.min_count = int(min_count)
        self.device = torch.device(device)
        if batch is None:
            batch = int(os.environ.get("KCFTOOLS_DEVICE_BATCH", "8"))
        self.batch = max(1, int(batch))
        slab = int(
            os.environ.get(
                "KCFTOOLS_DJOIN_SLAB",
                os.environ.get("KCFTOOLS_DPREFIX_SLAB", str(1 << 24)),
            )
        )
        self._layout = Layout(self.k, slab)
        self._refk = refidx.kmers  # sorted unique uint64
        self._tile_target = int(tile_target)
        self._statics = None
        self._sample_tile = None  # sticky Tt across samples (sample_tile)
        self._handles = {}  # key -> (S, 6, win_pad) device tensor
        self._results = {}

    # -- reference-side setup -------------------------------------------

    def _pick_b(self, n_ref):
        """Partition bits so the MEAN occupancy lands in
        [tile_target, 2*tile_target)."""
        b = 1
        while (n_ref >> b) >= 2 * self._tile_target:
            b += 1
        return b

    def add_chrom(self, name, r_idx, starts, ends):
        self._layout.add_chrom(name, r_idx, starts, ends)

    def add_chrom_kcoords(self, name, r_idx, w_start, w_hi):
        self._layout.add_chrom_kcoords(name, r_idx, w_start, w_hi)

    def _finalize(self):
        if self._statics is not None:
            return
        dev = self.device
        with phase("djoin_setup", dev):
            with stage("djoin_statics"):
                self._layout.finalize()
            with phase("djoin_static_upload", dev):
                keys, = _h2d(dev, _as_tensor(self._refk, np.uint64,
                                             np.int64))
                statics = _Slabs(self._layout.slabs, self._layout.pos_pad,
                                 self._layout.win_pad, dev)
            with phase("djoin_route", dev):
                self._q_hi, self._q_lo, slot_of_ord = self._route(keys)
                del keys
            with phase("djoin_statics", dev):
                self._statics = statics.route(slot_of_ord)
                del slot_of_ord

    def _route(self, keys, min_parts=1):
        """``route_reference`` of the device keys into at least
        ``min_parts`` partitions; sets P and Tq and counts
        djoin_route_on_card."""
        n_ref = keys.shape[0]
        b = self._pick_b(n_ref)
        while (1 << b) < min_parts:
            b += 1
        qh, ql, slot_of_ord = route_reference(keys, self.k, b)
        count("djoin_route_on_card", int(keys.device.type == "cuda"))
        self.P = 1 << b
        self.Tq = qh.shape[1]
        Logger.info(
            _CLASS,
            f"Reference routed: {n_ref} k-mers -> {self.P} x {self.Tq} "
            f"query tiles ({n_ref / (self.P * self.Tq):.2f} fill)",
        )
        return qh, ql, slot_of_ord

    # -- per-sample ------------------------------------------------------

    def submit(self, key, ref_keys, db_keys, db_counts):
        """Ship one sample's sorted table, tile it on the device, join it
        and scan every slab.
        ``ref_keys`` is accepted for interface compatibility with the
        dprefix engine (the reference keys were given at construction)."""
        self._finalize()
        dev = self.device
        with phase("djoin_upload", dev):
            keys, counts = _h2d(dev,
                                _as_tensor(db_keys, np.uint64, np.int64),
                                _as_tensor(db_counts, np.uint32, np.int32))
        with phase("djoin_pack", dev):
            tiles, Tt, packed = tile_sample(
                keys, counts, self.k, self.P.bit_length() - 1,
                self._sample_tile)
            del keys, counts
            self._sample_tile = Tt
            count("djoin_pack_on_card", int(dev.type == "cuda"))
        with phase("djoin_join", dev):
            nt = self.P * Tt
            th = tiles[:nt].view(self.P, Tt)
            tl = tiles[nt : 2 * nt].view(self.P, Tt)
            tc = tiles[2 * nt :].view(self.P, Tt // 4 if packed else Tt)
            flat = pjoin_join(
                self._q_hi, self._q_lo, th, tl, tc, packed=packed
            ).view(-1)
            del tiles, th, tl, tc
        with phase("djoin_scan", dev):
            self._handles[key] = self._scan_slabs(flat, self._statics)

    def _scan_slabs(self, flat, statics):
        """(len(statics), 6, win_pad) int64 stats of the given slabs, in
        one launch."""
        if not len(statics):
            return torch.empty((0, len(_JFIELDS), self._layout.win_pad),
                               dtype=torch.int64, device=flat.device)
        return slabs_scan_join(flat, statics.slot_maps, statics.valid_bits,
                               statics.w_start, statics.w_hi, k=self.k,
                               min_count=self.min_count)

    def _fetch(self, handle):
        """A sample's (S, 6, win_pad) result on the host."""
        return handle.cpu().numpy()

    def submit_counts(self, key, counts_u8, exc_idx, exc_val):
        raise NotImplementedError(
            "device-join needs the sorted sample table; streamed-slab "
            "runs take the dprefix engine"
        )

    def collect(self, key=None):
        if key in self._results:
            return self._results[key]
        with phase("djoin_fetch", self.device):
            arr = self._fetch(self._handles.pop(key))  # (S, 6, win_pad)
        out = {
            name: {f: np.zeros(nw, np.int64) for f in _JFIELDS}
            for name, nw in self._layout.chrom_n_win.items()
        }
        for si, slab in enumerate(self._layout.slabs):
            for chrom, c_off, s_off, cnt in slab["wins"]:
                dst = out[chrom]
                for fi, f in enumerate(_JFIELDS):
                    dst[f][c_off : c_off + cnt] = arr[
                        si, fi, s_off : s_off + cnt
                    ]
        self._results[key] = out
        return out

    def score_chrom(self, name):
        return self.collect(None)[name]

    def discard(self, key=None):
        self._results.pop(key, None)

    def close(self):
        self._handles.clear()
        self._results.clear()


class MeshJoinScorer(DeviceJoinScorer):
    """The device join over a (data, table) mesh: the quantile
    partitions shard across the TABLE axis (each table column holds P/t
    of the reference query tiles and receives P/t of every sample's
    table tiles, so no device holds the whole table), the genome's slabs
    across the DATA axis. Per sample: one ``pjoin_join`` launch per
    table shard, the routed counts gathered in table order (so the
    static slot maps index them as on one device), then each data row
    scans its own slabs. Output identical to DeviceJoinScorer.

    The JAX scorer pads the slab count to the data axis with all-invalid
    dummy slabs so that one program shards evenly; here each data row
    takes a contiguous range of ceil(S / data) slabs and the dummies are
    simply not scanned."""

    def __init__(self, refidx, k, mesh, min_count=1, batch=None,
                 tile_target=512):
        t_axis = mesh.shape["table"]
        if t_axis < 1 or t_axis & (t_axis - 1):
            raise ValueError(
                f"MeshJoinScorer: table axis {t_axis} is not a power of "
                "two; the join's 2^b quantile partitions split evenly only "
                "over a power-of-two table axis"
            )
        super().__init__(refidx, k, mesh.local_slots()[0].device,
                         min_count=min_count, batch=batch,
                         tile_target=tile_target)
        self.mesh = mesh
        self.t_axis = t_axis
        self.d_axis = mesh.shape["data"]

    def _finalize(self):
        """Routes once on the first local slot's device, then moves each
        table column's tiles to its device and builds each data row's
        statics on its device, one row at a time."""
        if self._statics is not None:
            return
        mesh = self.mesh
        slots = mesh.local_slots()
        dev = self.device
        with phase("djoin_setup", *slots):
            with stage("djoin_statics"):
                self._layout.finalize(n_parts=self.d_axis)
            with phase("djoin_static_upload", dev):
                keys, = _h2d(dev, _as_tensor(self._refk, np.uint64,
                                             np.int64))
            with phase("djoin_route", *slots):
                qh, ql, slot_of_ord = self._route(keys, self.t_axis)
                del keys
                pt = self.P // self.t_axis
                # table column -> its query tiles on the column's device
                self._q = {
                    ti: tuple(a[ti * pt : (ti + 1) * pt]
                              .to(mesh.column_device(ti)) for a in (qh, ql))
                    for ti in mesh.local_columns()
                }
                del qh, ql
            slabs = self._layout.slabs
            per = -(-max(len(slabs), 1) // self.d_axis)
            # data row -> (device, stacked statics of its slabs)
            statics = []
            for di in range(self.d_axis):
                row_dev = mesh.row_device(di)
                with phase("djoin_static_upload", row_dev):
                    row = _Slabs(slabs[di * per : (di + 1) * per],
                                 self._layout.pos_pad, self._layout.win_pad,
                                 row_dev)
                with phase("djoin_statics", row_dev):
                    statics.append((row_dev, row.route(slot_of_ord)))
            self._statics = statics

    def submit(self, key, ref_keys, db_keys, db_counts):
        self._finalize()
        slots = self.mesh.local_slots()
        with phase("djoin_pack"):
            buf, Tt, packed = pack_tiles_host(
                db_keys, db_counts, self.k, self.P.bit_length() - 1,
                self._sample_tile)
            self._sample_tile = Tt
        nt = self.P * Tt
        pt = self.P // self.t_axis
        planes = (
            buf[:nt].reshape(self.P, Tt),
            buf[nt : 2 * nt].reshape(self.P, Tt),
            buf[2 * nt :].reshape(self.P, -1),
        )
        with phase("djoin_upload", *slots):
            tiles = {
                ti: _h2d(q[0].device,
                         *(as_i32(a[ti * pt : (ti + 1) * pt]) for a in planes))
                for ti, q in self._q.items()
            }
        with phase("djoin_join", *slots):
            routed = all_gather_columns(
                {
                    ti: pjoin_join(*self._q[ti], *tiles[ti], packed=packed)
                    for ti in self._q
                },
                self.t_axis,
            )
            del tiles
        with phase("djoin_scan", *slots):
            self._handles[key] = [
                self._scan_slabs(
                    torch.cat([r.to(dev) for r in routed]).view(-1), statics
                )
                for dev, statics in self._statics
            ]

    def _fetch(self, handle):
        return np.concatenate([h.cpu().numpy() for h in handle])
