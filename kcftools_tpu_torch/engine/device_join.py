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
    - per slab, in a Python loop: gather through the slot map, presence
      test, the gap-run prefix scan (device_prefix._scan_core) and the
      count sums, into one (S, 6, win_pad) int64 device tensor;
    - ``collect`` makes the one device-to-host copy.

Dropped from the JAX engine because they were TPU-only: the fused and
split per-sample programs (``_FUSE_MAX_POS``, ``_get_split_fns``) -
eager torch runs the join and the scans as separate launches anyway;
``lax.map`` over slabs - a Python loop keeps one slab's scan
temporaries alive at a time; the two-plane uint32 and float64 count
sums - one int64 cumsum is exact. The slab size keeps its environment
names (``KCFTOOLS_DJOIN_SLAB``, then ``KCFTOOLS_DPREFIX_SLAB``) and its
2^24 default, which still has to be re-measured on the H100.

With ``KCFTOOLS_STAGE_JSON`` set, the per-sample phases are timed as
the stages djoin_pack, djoin_upload, djoin_join, djoin_scan and
djoin_fetch, with a device synchronisation at the end of each phase;
unset, nothing synchronises before ``collect``.
"""

import ctypes
import os

import numpy as np
import torch

from .._host import Logger, get_lib, split_hi_lo, stagetimer
from ..ops.pjoin import (
    _round_up,
    as_i32,
    pjoin_join,
    quantile_partition_ids,
    raw_quantile_ids,
    tile_sorted,
)
from .device_prefix import _FIELDS, _Layout, _scan_core

_CLASS = "DeviceJoin"

_JFIELDS = _FIELDS + ("count_sum",)


class _phase(stagetimer.stage):
    """A stagetimer stage that first waits for the device's queued work,
    so that device time lands in the phase that queued it."""

    __slots__ = ("device",)

    def __init__(self, name, device):
        super().__init__(name)
        self.device = device

    def __exit__(self, *exc):
        if self.on and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return super().__exit__(*exc)


def _slab_scan(routed_flat, slot_map, valid_bits, w_start, w_hi, *,
               k: int, min_count: int):
    """One slab's per-window stats from the routed join counts.
    Returns (6, win_pad) int64: observed, variations, inner, left,
    right, count_sum."""
    n = slot_map.shape[0]
    shifts = torch.arange(8, dtype=torch.int32, device=valid_bits.device)
    valid = ((valid_bits.int()[:, None] >> shifts) & 1).reshape(n) != 0
    zero = torch.zeros(1, dtype=torch.int64, device=valid.device)
    cs_tot = torch.cat([zero, torch.cumsum(valid, 0, dtype=torch.int64)])
    # the counts are uint32 bit patterns: compare them unsigned
    cnts = routed_flat.index_select(0, slot_map).long() & 0xFFFFFFFF
    pr = (cnts >= min_count) & valid
    five = _scan_core(pr, cs_tot, w_start, w_hi, k=k)
    csq = torch.cat([zero, torch.cumsum(torch.where(pr, cnts, 0), 0)])
    count_sum = csq[w_hi + 1] - csq[w_start]
    return torch.cat([five, count_sum[None, :]], dim=0)


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
        statics = []
        for slab in self._layout.slabs:
            r_idx = slab["r_idx"]
            live = r_idx >= 0
            slot_map = np.zeros(self._layout.pos_pad, np.int32)
            slot_map[live] = slot_of_ord[r_idx[live]]
            vbits = np.zeros(self._layout.pos_pad // 8, np.uint8)
            packed = np.packbits(live, bitorder="little")
            vbits[: packed.shape[0]] = packed
            statics.append(tuple(
                torch.from_numpy(a).to(self.device)
                for a in (
                    slot_map, vbits, slab["w_start"].astype(np.int64),
                    slab["w_hi"].astype(np.int64),
                )
            ))
        self._statics = statics

    # -- per-sample ------------------------------------------------------

    def _pack_tiles(self, db_keys, db_counts):
        """One flat uint32 buffer [hi | lo | counts] in the sample's
        sticky (P, Tt) tiling. Counts <= 255 byte-pack 4 per word in
        the planar layout. The native packer is used unless the table's
        last key falls one past the last partition (its top 32 bits all
        set), which the native partition function does not clamp."""
        db_keys = np.ascontiguousarray(db_keys, np.uint64)
        n = db_keys.shape[0]
        b = self.P.bit_length() - 1
        lib = get_lib()
        if lib is not None and n and raw_quantile_ids(
            db_keys[-1:], b, self.k
        )[0] >= self.P:
            lib = None
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
            res = torch.empty(
                (len(self._statics), len(_JFIELDS), self._layout.win_pad),
                dtype=torch.int64, device=dev,
            )
            for si, (sm, vb, ws, wh) in enumerate(self._statics):
                res[si] = _slab_scan(flat, sm, vb, ws, wh, k=self.k,
                                     min_count=self.min_count)
        self._handles[key] = res

    def submit_counts(self, key, counts_u8, exc_idx, exc_val):
        raise NotImplementedError(
            "device-join needs the sorted sample table; streamed-slab "
            "runs need the dprefix engine, which is not yet ported"
        )

    def collect(self, key=None):
        if key in self._results:
            return self._results[key]
        with _phase("djoin_fetch", self.device):
            arr = self._handles.pop(key).cpu().numpy()  # (S, 6, win_pad)
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
