"""Device-join window scorer: the merge join runs on the GPU.

Port of kcftools_tpu/engine/device_join.py::DeviceJoinScorer, the
engine behind ``getVariations --engine device`` at k <= 32.

  per REFERENCE (once, device-resident):
    - the sorted unique reference k-mers are quantile-tiled into static
      (P, Tq) query tiles (ops/pjoin.tile_sorted) and uploaded;
    - per window-aligned slab: the int32 slot map position -> flattened
      routed slot, the packed valid bitmap and the window bounds.
  per SAMPLE:
    - the sorted (keys, counts) are quantile-sliced into one flat
      [hi | lo | counts] buffer by the shared native packer (counts
      byte-packed 4 per word when all are <= 255);
    - ONE host-to-device copy of that buffer, ONE ``pjoin_join`` launch;
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
(parallel/mesh.py): one join per table shard, the routed counts
gathered in table order, each data row scanning its own slabs in one
launch.

With ``KCFTOOLS_STAGE_JSON`` set, the per-sample phases are timed as
the stages djoin_pack, djoin_upload, djoin_join, djoin_scan and
djoin_fetch, with a device synchronisation at the end of each phase;
unset, nothing synchronises before ``collect``.
"""

import ctypes
import os

import numpy as np
import torch

from ..native import get_lib
from ..utils.logger import Logger
from .encode import split_hi_lo
from ..ops.gapscan import slabs_scan_join
from ..ops.pjoin import (
    _round_up,
    as_i32,
    pjoin_join,
    quantile_partition_ids,
    tile_sorted,
)
from ..parallel.mesh import all_gather_columns
from .device_prefix import _FIELDS, _Layout, _phase

_CLASS = "DeviceJoin"

_JFIELDS = _FIELDS + ("count_sum",)


class _Slabs:
    """The scan's statics of some slabs, stacked on one device: slot maps
    (S, pos_pad) int32, valid bitmaps (S, pos_pad/8) uint8, window bounds
    (S, win_pad) int64 each. ``len`` is the slab count."""

    __slots__ = ("slot_maps", "valid_bits", "w_start", "w_hi")

    def __init__(self, slabs, slot_of_ord, pos_pad, win_pad, dev):
        S = len(slabs)
        slot_maps = np.zeros((S, pos_pad), np.int32)
        vbits = np.zeros((S, pos_pad // 8), np.uint8)
        ws = np.zeros((S, win_pad), np.int64)
        wh = np.zeros((S, win_pad), np.int64)
        for si, slab in enumerate(slabs):
            r_idx = slab["r_idx"]
            live = r_idx >= 0
            slot_maps[si, live] = slot_of_ord[r_idx[live]]
            packed = np.packbits(live, bitorder="little")
            vbits[si, : packed.shape[0]] = packed
            ws[si] = slab["w_start"]
            wh[si] = slab["w_hi"]
        self.slot_maps, self.valid_bits, self.w_start, self.w_hi = (
            torch.from_numpy(a).to(dev) for a in (slot_maps, vbits, ws, wh)
        )

    def __len__(self):
        return self.slot_maps.shape[0]


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
        self._layout = _Layout(self.k, slab)
        self._refk = refidx.kmers  # sorted unique uint64
        self._tile_target = int(tile_target)
        self._statics = None
        self._sample_tile = None  # sticky Tt across samples
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
        n_ref = self._refk.shape[0]
        b = self._pick_b(n_ref)
        qh, ql, _tc, rank, part = tile_sorted(self._refk, self.k, b)
        self.P = 1 << b
        self.Tq = qh.shape[1]
        # flattened routed slot of each reference ordinal (static)
        slot_of_ord = (part * self.Tq + rank).astype(np.int64)
        self._q_hi = as_i32(qh).to(self.device)
        self._q_lo = as_i32(ql).to(self.device)
        Logger.info(
            _CLASS,
            f"Reference routed: {n_ref} k-mers -> {self.P} x {self.Tq} "
            f"query tiles ({n_ref / (self.P * self.Tq):.2f} fill)",
        )

        self._layout.finalize()
        self._statics = _Slabs(self._layout.slabs, slot_of_ord,
                               self._layout.pos_pad, self._layout.win_pad,
                               self.device)

    # -- per-sample ------------------------------------------------------

    def _pack_tiles(self, db_keys, db_counts):
        """One flat uint32 buffer [hi | lo | counts] in the sample's
        sticky (P, Tt) tiling. Counts <= 255 byte-pack 4 per word in
        the planar layout, by the native packer where the library is
        built (its partition function clamps to P-1, as
        ``quantile_partition_ids`` does), else by numpy."""
        db_keys = np.ascontiguousarray(db_keys, np.uint64)
        n = db_keys.shape[0]
        b = self.P.bit_length() - 1
        lib = get_lib()
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        if lib is not None:
            per = np.zeros(self.P, np.int64)
            lib.kcf_pjoin_hist(
                db_keys.ctypes.data_as(u64p), ctypes.c_int64(n),
                ctypes.c_int(self.k), ctypes.c_int(b),
                per.ctypes.data_as(i64p),
            )
        else:
            part = quantile_partition_ids(db_keys, b, self.k)
            per = np.bincount(part, minlength=self.P).astype(np.int64)
        need = int(per.max()) if n else 1
        if self._sample_tile is None or need > self._sample_tile:
            # sticky tile with headroom so later samples of similar size
            # keep one shape
            self._sample_tile = _round_up(need + 64, 128)
        Tt = self._sample_tile
        packed = bool(db_counts.max(initial=0) <= 0xFF)
        nt = self.P * Tt
        words = nt // 4 if packed else nt
        buf = np.zeros(2 * nt + words, np.uint32)
        if lib is not None:
            lib.kcf_pjoin_pack(
                db_keys.ctypes.data_as(u64p),
                db_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                ctypes.c_int64(n), ctypes.c_int(self.k),
                ctypes.c_int(b), ctypes.c_int64(Tt),
                ctypes.c_int(int(packed)),
                per.ctypes.data_as(i64p),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            )
        else:
            starts = np.concatenate(([0], np.cumsum(per)))
            rank = np.arange(n) - starts[part]
            hi, lo = split_hi_lo(db_keys, self.k)
            slot = part * Tt + rank
            buf[slot] = hi
            buf[nt + slot] = lo
            if packed:
                # planar layout: byte b of word (p, j) = count of slot
                # p*Tt + b*(Tt/4) + j (ops/pjoin.unpack_planar)
                cnt8 = np.zeros(nt, np.uint8)
                cnt8[slot] = db_counts
                c = cnt8.reshape(self.P, 4, Tt // 4).astype(np.uint32)
                buf[2 * nt :] = (
                    c[:, 0] | (c[:, 1] << np.uint32(8))
                    | (c[:, 2] << np.uint32(16))
                    | (c[:, 3] << np.uint32(24))
                ).ravel()
            else:
                buf[2 * nt + slot] = db_counts
        return buf, Tt, packed

    def submit(self, key, ref_keys, db_keys, db_counts):
        """Ship one sample's sorted table, join it and scan every slab.
        ``ref_keys`` is accepted for interface compatibility with the
        dprefix engine (the reference keys were given at construction)."""
        self._finalize()
        dev = self.device
        with _phase("djoin_pack", dev):
            db_counts = np.ascontiguousarray(db_counts, np.uint32)
            buf, Tt, packed = self._pack_tiles(db_keys, db_counts)
        with _phase("djoin_upload", dev):
            tiles = as_i32(buf).to(dev)  # ONE host-to-device copy
        with _phase("djoin_join", dev):
            nt = self.P * Tt
            th = tiles[:nt].view(self.P, Tt)
            tl = tiles[nt : 2 * nt].view(self.P, Tt)
            tc = tiles[2 * nt :].view(self.P, Tt // 4 if packed else Tt)
            flat = pjoin_join(
                self._q_hi, self._q_lo, th, tl, tc, packed=packed
            ).view(-1)
            del tiles, th, tl, tc
        with _phase("djoin_scan", dev):
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
        with _phase("djoin_fetch", self.device):
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
        if self._statics is not None:
            return
        mesh = self.mesh
        n_ref = self._refk.shape[0]
        b = self._pick_b(n_ref)
        while (1 << b) < self.t_axis:
            b += 1
        qh, ql, _tc, rank, part = tile_sorted(self._refk, self.k, b)
        self.P = 1 << b
        self.Tq = qh.shape[1]
        slot_of_ord = (part * self.Tq + rank).astype(np.int64)
        pt = self.P // self.t_axis
        # table column -> its query tiles on the column's device
        self._q = {
            ti: tuple(
                as_i32(a[ti * pt : (ti + 1) * pt]).to(mesh.column_device(ti))
                for a in (qh, ql)
            )
            for ti in mesh.local_columns()
        }
        Logger.info(
            _CLASS,
            f"Reference routed: {n_ref} k-mers -> {self.P} x {self.Tq} "
            f"query tiles across table={self.t_axis}",
        )
        self._layout.finalize(n_parts=self.d_axis)
        slabs = self._layout.slabs
        per = -(-max(len(slabs), 1) // self.d_axis)
        # data row -> (device, stacked statics of its slabs)
        self._statics = []
        for di in range(self.d_axis):
            dev = mesh.row_device(di)
            self._statics.append((dev, _Slabs(
                slabs[di * per : (di + 1) * per], slot_of_ord,
                self._layout.pos_pad, self._layout.win_pad, dev)))

    def submit(self, key, ref_keys, db_keys, db_counts):
        self._finalize()
        slots = self.mesh.local_slots()
        with _phase("djoin_pack"):
            db_counts = np.ascontiguousarray(db_counts, np.uint32)
            buf, Tt, packed = self._pack_tiles(db_keys, db_counts)
        nt = self.P * Tt
        pt = self.P // self.t_axis
        planes = (
            buf[:nt].reshape(self.P, Tt),
            buf[nt : 2 * nt].reshape(self.P, Tt),
            buf[2 * nt :].reshape(self.P, -1),
        )
        with _phase("djoin_upload", *slots):
            tiles = {
                ti: [as_i32(a[ti * pt : (ti + 1) * pt]).to(q[0].device)
                     for a in planes]
                for ti, q in self._q.items()
            }
        with _phase("djoin_join", *slots):
            routed = all_gather_columns(
                {
                    ti: pjoin_join(*self._q[ti], *tiles[ti], packed=packed)
                    for ti in self._q
                },
                self.t_axis,
            )
            del tiles
        with _phase("djoin_scan", *slots):
            self._handles[key] = [
                self._scan_slabs(
                    torch.cat([r.to(dev) for r in routed]).view(-1), statics
                )
                for dev, statics in self._statics
            ]

    def _fetch(self, handle):
        return np.concatenate([h.cpu().numpy() for h in handle])
