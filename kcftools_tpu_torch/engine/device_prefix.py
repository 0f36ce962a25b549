"""Device-resident positional window scorer (the dprefix engine), in torch.

Port of kcftools_tpu/engine/device_prefix.py, the engine behind
``getVariations --engine dprefix`` and the streamed low-memory ingest:
the host owns the per-sample merge join and the positional pack (the
shared native tier), the device owns the scan-shaped work - the
per-window gap-run state machine of Plugins/GetVariants.java:219-273
(``ops/gapscan.py``: ``runs_scan``, ``rows_scan``).

Per sample the host packs, for every slab, either a presence bitmap or
the compact absent-run stream of it (native ``kcf_bits_to_runs``; see
``_score_runs``) and queues it; a group of up to ``batch`` samples is
uploaded as one (S, ...) uint8 tensor per slab and scored by one call of
``_score_runs`` (every sample fit the sticky run budget) or
``_score_batch`` (the bitmaps). The chromosomes are cut into
window-aligned slabs (``slabs.Layout``), so no window straddles a slab.

Every row of a group goes through one ``runs_scan`` (the run program)
or ``rows_scan`` (the bitmap program) per slab and pool slot: on the
card one call of the kernel csrc/gapscan.cu, whose run decode reads
the group's absent runs itself, on the CPU its plain torch version. Its sums are int64, so the inner-distance sum is exact where
the JAX version keeps a uint32 modular prefix.

Over several devices (``devices=``, a list of mesh slots) the genome's
slabs spread across the slots; with more slots than slabs each slab gets
a pool of slots and a group's sample rows split across the pool, as in
the JAX engine. Every slab and pool slot is dispatched before anything
is fetched. Slots that share a device share their static tensors.

Dropped from the JAX engine because they were TPU-only: padding a group
to ``batch`` rows (one compiled program) - only the real rows are
scanned; the asynchronous device-to-host copy - ``collect`` copies
synchronously.

With ``KCFTOOLS_STAGE_JSON`` set, the phases are timed as the stages
dprefix_pack, dprefix_upload, dprefix_scan and dprefix_fetch (and
``merge`` for the host merge join of ``submit``, ``dprefix_setup`` for
the per-reference statics), with a device synchronisation at the end of
each phase.
"""

import os

import numpy as np
import torch

from ..native import (
    _uniform_window_map,
    bits_to_runs,
    build_ordmap,
    merge_counts_u8,
    ordpack,
    pack_posbits,
)
from ..ops.gapscan import rows_scan, runs_scan
from ..utils import stagetimer
from ..torchinit import Slot, phase, process_index
from .slabs import FIELDS, Layout


def _pad_u8(arr, cap):
    """Zero-pad a u8 run array to ``cap`` entries ((0, 0) = no-op)."""
    if arr.shape[0] >= cap:
        return arr[:cap]
    out = np.zeros(cap, np.uint8)
    out[: arr.shape[0]] = arr
    return out


def _count_cuda_call(fn, t):
    if t.device.type == "cuda":
        fn.cuda_calls += 1


def _score_batch(mat, valid_bits, w_start, w_hi, *, k: int):
    """Score S samples over one slab from positional presence BITMAPS.
    mat: (S, slab_pad/8) uint8 LSB-first bitmaps. Returns (5, S,
    win_pad) int64, every row through one ``rows_scan``.
    ``_score_batch.cuda_calls`` counts its calls on a CUDA device."""
    _count_cuda_call(_score_batch, mat)
    return rows_scan(mat, valid_bits, w_start, w_hi, k=k)


def _score_runs(dl, valid_bits, w_start, w_hi, *, k: int):
    """Score S samples over one slab from compact ABSENT-RUN payloads.
    dl: (S, 2, run_cap) uint8 (see ``ops/gapscan.py::_runs_presence``),
    decoded and scanned for all rows at once by one ``runs_scan``.
    Returns (5, S, win_pad) int64. ``_score_runs.cuda_calls`` counts its
    calls on a CUDA device."""
    _count_cuda_call(_score_runs, dl)
    return runs_scan(dl, valid_bits, w_start, w_hi, k=k)


_score_batch.cuda_calls = 0
_score_runs.cuda_calls = 0


class DevicePrefixScorer:
    """Per-reference device state + batched per-sample scoring, on one
    device or over a list of mesh slots (``devices``).

    Single-sample flow (plugin compatibility):
        add_chrom(...) per chromosome, then per sample
        merge_and_upload(...) / set_sample_counts(...) followed by
        score_chrom(name) per chromosome.

    Batched flow:
        submit(key, ref_keys, db_keys, db_counts) or
        submit_counts(key, u8, exc_idx, exc_val) per sample, then
        collect(key) -> {chrom: {field: int64 array}}.

    Samples accumulate into a pending group; when ``batch`` samples are
    queued (or the first collect of one of them arrives) the group is
    uploaded as one tensor per slab and scored by one program call per
    slab (per pool slot). ``programs_run`` holds the programs dispatched
    so far: "runs" (``_score_runs``) and/or "bits" (``_score_batch``).
    """

    def __init__(self, refidx, k, device=None, min_count=1, batch=None,
                 devices=None):
        self.k = int(k)
        self.min_count = int(min_count)
        if devices is None:
            devices = [Slot(0, torch.device(device), process_index())]
        self.devices = list(devices)
        if batch is None:
            batch = int(os.environ.get("KCFTOOLS_DEVICE_BATCH", "8"))
        self.batch = max(1, int(batch))
        self.uplink = os.environ.get("KCFTOOLS_DPREFIX_UPLINK", "auto")
        slab = int(os.environ.get("KCFTOOLS_DPREFIX_SLAB", str(1 << 26)))
        self._layout = Layout(self.k, slab)
        self._statics = None  # per-slab device tensors + host pack maps
        self.programs_run = set()
        self._pending = []  # queued sample slots awaiting dispatch
        self._jobs = {}  # sample key -> (group token, row in group)
        self._group_handles = {}  # group token -> per-slab results
        self._csums = {}  # sample key -> per-slab count sums
        self._results = {}  # key -> {chrom: {field: array}}
        self._merge_buf = None  # reused per-sample merge output
        self._run_cap = None  # sticky run-payload entry budget per slab
        env_cap = os.environ.get("KCFTOOLS_RUNS_CAP")
        self._cap_fixed = bool(env_cap)  # explicit cap: never grown
        if env_cap:
            self._run_cap = max(16, int(env_cap))
        self._seq = 0

    # -- reference-side setup ------------------------------------------------

    def add_chrom(self, name, r_idx, starts, ends):
        """Register one chromosome's static arrays.
        starts/ends: half-open window base ranges (end - start >= k)."""
        self._layout.add_chrom(name, r_idx, starts, ends)

    def add_chrom_kcoords(self, name, r_idx, w_start, w_hi):
        """Windows given directly in k-mer start coordinates (feature
        mode: one window per spliced gene/transcript)."""
        self._layout.add_chrom_kcoords(name, r_idx, w_start, w_hi)

    def _finalize(self):
        if self._statics is None:
            with phase("dprefix_setup", *self.devices):
                self._build_statics()

    def _build_statics(self):
        """Per-slab host pack maps (valid bitmap, occurrence map) and,
        on each slot of the slab's pool, its device tensors (valid
        bitmap, window bounds). Slabs go round-robin over the slots;
        with more slots than slabs each slab gets a pool of ``spread``
        slots, over which a group's sample rows split."""
        n_dev = len(self.devices)
        self._layout.finalize(n_parts=n_dev)
        spread = max(1, n_dev // max(1, len(self._layout.slabs)))
        self._spread = spread
        nbb = self._layout.pos_pad // 8
        self._statics = []
        for si, slab in enumerate(self._layout.slabs):
            pool = [self.devices[(si * spread + j) % n_dev]
                    for j in range(spread)]
            nw = slab["n_win"]
            ws = slab["w_start"][:nw]
            wh = slab["w_hi"][:nw]
            # the ordinal pack's window mapping needs sorted,
            # non-overlapping windows (tiling mode and most feature
            # layouts)
            fusable = bool(
                nw < 2
                or ((ws[1:] > wh[:-1]).all() and (ws[1:] >= ws[:-1]).all())
            )
            valid_bits = np.zeros(nbb, np.uint8)
            packed = np.packbits(slab["r_idx"] >= 0, bitorder="little")
            valid_bits[: packed.shape[0]] = packed
            on_dev = {}  # torch device -> (valid_bits, w_start, w_hi)
            for slot in pool:
                if slot.device not in on_dev:
                    dev = slot.device
                    on_dev[dev] = (
                        torch.from_numpy(valid_bits).to(dev),
                        torch.from_numpy(
                            slab["w_start"].astype(np.int64)).to(dev),
                        torch.from_numpy(
                            slab["w_hi"].astype(np.int64)).to(dev),
                    )
            st = {
                "pool": pool,
                # per pool slot: (valid_bits, w_start, w_hi)
                "tensors": [on_dev[slot.device] for slot in pool],
                # static valid bitmap for the run encoder (host)
                "valid_bits": valid_bits,
                "fusable": fusable,
                "ordmap": None,
                "uni": None,
            }
            if fusable:
                # one-time occurrence map: every sample's pack becomes
                # sequential streams instead of a random positional
                # gather (kcf_ordpack)
                st["ordmap"] = build_ordmap(slab["r_idx"])
                st["uni"] = _uniform_window_map(ws, wh)
            self._statics.append(st)

    # -- per-sample ----------------------------------------------------------

    def merge_and_upload(self, ref_keys, db_keys, db_counts):
        """Native merge join + submit as the single pending sample.
        ref_keys/db_keys: uint64 arrays or (hi, lo) tuples (sorted)."""
        self.submit(None, ref_keys, db_keys, db_counts)

    def set_sample_counts(self, counts_u8, exc_idx, exc_val):
        self.submit_counts(None, counts_u8, exc_idx, exc_val)

    def submit(self, key, ref_keys, db_keys, db_counts):
        n_ref = (
            ref_keys[0].shape[0]
            if isinstance(ref_keys, tuple)
            else ref_keys.shape[0]
        )
        if self._merge_buf is None or self._merge_buf.shape[0] < n_ref:
            self._merge_buf = np.empty(n_ref, np.uint8)
        with stagetimer.stage("merge"):
            u8, ei, ev = merge_counts_u8(
                ref_keys, db_keys, db_counts, out=self._merge_buf[:n_ref]
            )
        self.submit_counts(key, u8, ei, ev)

    def submit_counts(self, key, counts_u8, exc_idx, exc_val):
        """Pack one sample's payload on the host and queue it in the
        pending group. Fusable slabs (sorted, non-overlapping windows)
        pack via the ordinal-space pass (kcf_ordpack) into a presence
        bitmap + count-sum corrections; other slabs use pack_posbits.
        The bitmap is then run-encoded under the sticky run budget.
        Once ``batch`` samples are queued (immediately for the
        single-sample flow, key=None) the group is dispatched."""
        self._finalize()
        if key is None:
            # single-sample flow: a new sample invalidates the old one
            self._results.pop(None, None)
            self._discard_pending(None)
            old = self._jobs.pop(None, None)
            if old is not None and not any(
                t == old[0] for t, _r in self._jobs.values()
            ):
                # drop the stale group's results only when no keyed
                # sample still references them (flows may be mixed)
                self._group_handles.pop(old[0], None)
            self._csums.pop(None, None)
        exc_idx = np.ascontiguousarray(exc_idx, np.int32)
        exc_val = np.ascontiguousarray(exc_val, np.uint32)
        slot = {"key": key, "bits": [], "runs": []}
        count_sums = []
        with phase("dprefix_pack"):
            self._pack_sample(
                slot, count_sums, counts_u8, exc_idx, exc_val,
                self.uplink != "bitmap",
            )
        self._pending.append(slot)
        self._csums[key] = count_sums
        if key is None or len(self._pending) >= self.batch:
            self._flush_pending()

    def _encode_with_cap(self, encode):
        """Run a run-encoder under the sticky per-slab entry budget:
        bootstrap it from the first sample (2x headroom,
        4096-granular), and GROW it when a later sample is denser -
        unless KCFTOOLS_RUNS_CAP pinned it. Samples already queued keep
        the budget they were padded to (``_dispatch_group`` sizes a
        group's payload by its slots). ``encode(cap)`` returns (d, l,
        n); n < 0 = overflow. Returned arrays may exceed the final cap;
        the caller normalizes."""
        scratch = max(4096, self._layout.pos_pad // 16)
        if self._run_cap is None:
            d, l, n = encode(scratch)
            if n >= 0:
                cap = max(4096, -(-2 * max(n, 1) // 4096) * 4096)
                self._run_cap = min(cap, scratch)
            return d, l, n
        d, l, n = encode(self._run_cap)
        if n < 0 and not self._cap_fixed:
            d, l, n = encode(scratch)
            if n >= 0:
                cap = max(4096, -(-2 * n // 4096) * 4096)
                self._run_cap = min(cap, scratch)
        return d, l, n

    def _pack_sample(self, slot, count_sums, counts_u8, exc_idx, exc_val,
                     use_runs):
        """Encode one sample's payload + count-sum info for every slab.
        Fusable slabs: kcf_ordpack -> presence bitmap + count
        CORRECTIONS (count_sum = observed + corr), then kcf_bits_to_runs
        under the sticky run budget - an overflow keeps that slab's
        bitmap. Non-fusable slabs: pack_posbits with full count sums.
        Any bitmap slab drops the whole sample to the bitmap program
        (slot['runs'] = None)."""
        all_runs = True
        nbb = self._layout.pos_pad // 8
        for si, slab in enumerate(self._layout.slabs):
            st = self._statics[si]
            nw = slab["n_win"]
            ws = slab["w_start"][:nw]
            wh = slab["w_hi"][:nw]
            if st["fusable"]:
                occ_ord, occ_pos, seg_off, seg_ord = st["ordmap"]
                bits, corr = ordpack(
                    counts_u8, exc_idx, exc_val, occ_ord, occ_pos,
                    self.min_count, ws, wh, st["valid_bits"], nbb,
                    uni=st["uni"], seg_off=seg_off, seg_ord=seg_ord,
                )
                count_sums.append(("corr", corr))
            else:
                bits, csum = pack_posbits(
                    counts_u8, exc_idx, exc_val, slab["r_idx"],
                    self.min_count, ws, wh, n_bits_bytes=nbb,
                )
                count_sums.append(("full", csum))
            slot["bits"].append(bits)
            if not use_runs:
                all_runs = False
                continue

            def enc(cap, _bits=bits, _vb=st["valid_bits"]):
                return bits_to_runs(_bits, _vb, self._layout.pos_pad, cap)

            d, l, n = self._encode_with_cap(enc)
            if n < 0:
                all_runs = False
            else:
                slot["runs"].append((d, l))
        if use_runs and all_runs:
            cap = self._run_cap
            slot["runs"] = [
                (_pad_u8(d, cap), _pad_u8(l, cap)) for d, l in slot["runs"]
            ]
        else:
            slot["runs"] = None

    def _discard_pending(self, key):
        self._pending = [s for s in self._pending if s["key"] != key]

    def _flush_pending(self):
        """Dispatch the pending group: the run program if every queued
        sample fit the run budget, else the bitmap program for the whole
        group (the presence bitmaps always exist - no re-pack)."""
        group = self._pending
        self._pending = []
        if not group:
            return
        token = self._seq
        self._seq += 1
        kind = "runs" if all(s["runs"] is not None for s in group) else "bits"
        self._group_handles[token] = self._dispatch_group(group, kind)
        for row, slot in enumerate(group):
            self._jobs[slot["key"]] = (token, row)

    def _dispatch_group(self, group, kind):
        """One upload and one program call per slab and pool slot for
        the group's rows: the rows split into chunks of
        ceil(batch / spread), one chunk per pool slot. Returns, per
        slab, the pool slots' (5, rows, win_pad) int64 device results."""
        fn = _score_runs if kind == "runs" else _score_batch
        self.programs_run.add(kind)
        chunk = -(-self.batch // self._spread)
        handles = []
        for si, st in enumerate(self._statics):
            with phase("dprefix_pack"):
                if kind == "runs":
                    # a slot is padded to the budget of its pack time:
                    # size the payload by the slots, so that no queued
                    # sample is cut to a budget set after it was packed
                    cap = max(slot["runs"][si][0].shape[0] for slot in group)
                    mat = np.zeros((len(group), 2, cap), np.uint8)
                    for r, slot in enumerate(group):
                        d, l = slot["runs"][si]
                        mat[r, 0, : d.shape[0]] = d
                        mat[r, 1, : l.shape[0]] = l
                else:
                    mat = np.stack([slot["bits"][si] for slot in group])
            slab_handles = []
            for j, (slot, tensors) in enumerate(zip(st["pool"],
                                                    st["tensors"])):
                if j * chunk >= len(group):
                    break
                with phase("dprefix_upload", slot):
                    payload = torch.from_numpy(
                        mat[j * chunk : (j + 1) * chunk]).to(slot.device)
                with phase("dprefix_scan", slot):
                    slab_handles.append(fn(payload, *tensors, k=self.k))
            handles.append(slab_handles)
        return handles

    def _take_group(self, token):
        """Fetch (once) and cache a dispatched group's result arrays,
        joining the row chunks of each slab's pool."""
        arrs = self._group_handles[token]
        if arrs and not isinstance(arrs[0], np.ndarray):
            with phase("dprefix_fetch", *self.devices):
                arrs = [
                    np.concatenate([h.cpu().numpy() for h in slab], axis=1)
                    for slab in arrs
                ]
            self._group_handles[token] = arrs
        return arrs

    def collect(self, key=None):
        """Return {chrom: {field: (n_windows,) int64 array}} for a
        submitted sample, dispatching its group as needed."""
        if key in self._results:
            return self._results[key]
        if key not in self._jobs and any(
            s["key"] == key for s in self._pending
        ):
            self._flush_pending()
        if key not in self._jobs:
            raise KeyError(f"no submitted sample {key!r}")
        token, row = self._jobs.pop(key)
        group_arrs = self._take_group(token)
        if not any(t == token for t, _r in self._jobs.values()):
            # last sample of its group: release the cached group arrays
            # once sliced below
            self._group_handles.pop(token, None)
        csums = self._csums.pop(key)
        out = {
            name: {f: np.zeros(nw, np.int64) for f in FIELDS + ("count_sum",)}
            for name, nw in self._layout.chrom_n_win.items()
        }
        for si, slab in enumerate(self._layout.slabs):
            arr = group_arrs[si]  # (5, S, win_pad)
            csum_kind, csum = csums[si]
            for chrom, c_off, s_off, cnt in slab["wins"]:
                dst = out[chrom]
                for fi, f in enumerate(FIELDS):
                    dst[f][c_off : c_off + cnt] = arr[
                        fi, row, s_off : s_off + cnt
                    ]
                cs = csum[s_off : s_off + cnt].astype(np.int64)
                if csum_kind == "corr":
                    # ordinal pack ships corrections only:
                    # count_sum = observed + sum(count - 1)
                    cs = cs + arr[0, row, s_off : s_off + cnt]
                dst["count_sum"][c_off : c_off + cnt] = cs
        self._results[key] = out
        return out

    def score_chrom(self, name):
        """Single-sample flow: stats for one chromosome."""
        return self.collect(None)[name]

    def devices_used(self):
        """Distinct slots holding slab state (for tests/telemetry)."""
        self._finalize()
        return {slot for st in self._statics for slot in st["pool"]}

    def sample_rows_devices(self):
        """Distinct slots that would execute a full group's sample rows
        (the sample-axis spread; for dryrun assertions)."""
        self._finalize()
        chunk = -(-self.batch // self._spread)
        return {
            slot
            for st in self._statics
            for j, slot in enumerate(st["pool"])
            if j * chunk < self.batch
        }

    def discard(self, key=None):
        self._results.pop(key, None)

    def close(self):
        """Release queued state and device results."""
        self._pending = []
        self._jobs.clear()
        self._group_handles.clear()
        self._results.clear()
