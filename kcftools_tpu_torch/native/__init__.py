"""ctypes loader for the native host tier (C++), with on-demand
compilation and graceful numpy fallback.

The shared library is compiled once per machine into
``kcftools_tpu_torch/_build`` (or $KCFTOOLS_NATIVE_DIR); failures fall
back to the vectorized numpy implementations.

A copy of kcftools_tpu/native/__init__.py; only the build directory
and the locked, atomic build differ.
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..utils.logger import Logger

_CLASS = "Native"
_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "kcf_native.cpp")
# The port builds into its own gitignored build directory, beside the
# nvcc-built kernels, not into the package directory as the JAX package
# does.
_LIB_DIR = os.environ.get(
    "KCFTOOLS_NATIVE_DIR", os.path.join(os.path.dirname(_DIR), "_build")
)
_LIB = os.path.join(_LIB_DIR, "libkcfnative.so")
_HASH = _LIB + ".srchash"

_lib = None
_tried = False


def _src_hash():
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _compile(src_hash):
    # Built under an exclusive lock into a temporary name, then renamed:
    # processes that start together (test workers) build once and never
    # load a half-written library.
    import fcntl

    os.makedirs(_LIB_DIR, exist_ok=True)
    with open(_LIB + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():
            return
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        cmd = [
            "g++",
            "-O3",
            "-std=c++17",
            "-shared",
            "-fPIC",
            "-o",
            tmp,
            _SRC,
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
        with open(_HASH, "w") as f:
            f.write(src_hash)


def _stale():
    """Content-based staleness: the binary is rebuilt whenever the
    sidecar hash of the source it was built from differs (mtime
    comparisons misfire on fresh checkouts where all files share one
    timestamp)."""
    if not os.path.exists(_LIB):
        return True
    try:
        with open(_HASH) as f:
            return f.read().strip() != _src_hash()
    except OSError:
        return True


def get_lib():
    """Return the loaded native library, or None when unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if _stale():
            _compile(_src_hash())
        lib = ctypes.CDLL(_LIB)
        lib.kcf_set_threads.restype = None
        lib.kcf_set_threads.argtypes = [ctypes.c_int32]
        lib.kcf_release_sort_scratch.restype = None
        lib.kcf_release_sort_scratch.argtypes = []
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.kcf_build_table.restype = ctypes.c_int
        lib.kcf_build_table.argtypes = [u32p] * 3 + [ctypes.c_int64] + [u32p] + [
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.kcf_lookup.restype = None
        lib.kcf_lookup.argtypes = [u32p, u32p, ctypes.c_int64] + [u32p] * 3 + [
            ctypes.c_int64,
            u32p,
            ctypes.c_int32,
        ]
        lib.kcf_encode_bases.restype = None
        lib.kcf_encode_bases.argtypes = [u8p, ctypes.c_int64, u8p, u8p]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.kcf_merge_counts.restype = None
        lib.kcf_merge_counts.argtypes = [
            u64p, ctypes.c_int64, u64p, u32p, ctypes.c_int64, u32p,
        ]
        lib.kcf_gather_counts.restype = None
        lib.kcf_gather_counts.argtypes = [u32p, i32p, ctypes.c_int64, u32p]
        lib.kcf_merge_counts_u8.restype = ctypes.c_int64
        lib.kcf_merge_counts_u8.argtypes = [
            u64p, ctypes.c_int64, ctypes.c_int64, u64p, u32p,
            ctypes.c_int64, u8p, i32p, u32p, ctypes.c_int64,
        ]
        lib.kcf_merge_counts_u8_wide.restype = ctypes.c_int64
        lib.kcf_merge_counts_u8_wide.argtypes = [
            u64p, u64p, ctypes.c_int64, ctypes.c_int64, u64p, u64p, u32p,
            ctypes.c_int64, u8p, i32p, u32p, ctypes.c_int64,
        ]
        _i64p = ctypes.POINTER(ctypes.c_int64)
        lib.kcf_window_scan_u8.restype = None
        lib.kcf_window_scan_u8.argtypes = [
            u8p, ctypes.c_int64, i32p, u32p, ctypes.c_int64, i32p,
            ctypes.c_int64, ctypes.c_uint32, ctypes.c_int32, i32p, i32p,
            ctypes.c_int64, ctypes.c_int32, _i64p,
        ]
        lib.kcf_pack_posbits.restype = None
        lib.kcf_pack_posbits.argtypes = [
            u8p, ctypes.c_int64, i32p, u32p, ctypes.c_int64, i32p,
            ctypes.c_int64, ctypes.c_uint32, i32p, i32p, ctypes.c_int64,
            u8p, ctypes.c_int64, u8p, _i64p,
        ]
        lib.kcf_bits_to_runs.restype = ctypes.c_int64
        lib.kcf_bits_to_runs.argtypes = [
            u8p, u8p, ctypes.c_int64, u8p, u8p, ctypes.c_int64,
        ]
        lib.kcf_ordpack.restype = None
        lib.kcf_ordpack.argtypes = [
            u8p, ctypes.c_int64, i32p, u32p, ctypes.c_int64,
            i32p, i32p, ctypes.c_int64, ctypes.c_uint32,
            i32p, i32p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            u8p, u8p, ctypes.c_int64, _i64p,
            _i64p, i32p, ctypes.c_int64,
        ]
        lib.kcf_build_ordmap.restype = ctypes.c_int64
        lib.kcf_build_ordmap.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int64, i32p, i32p,
        ]
        lib.kcf_route_shard.restype = ctypes.c_int64
        lib.kcf_route_shard.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), u32p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_int32, ctypes.c_int32,
            u32p, u32p, u32p, i32p,
        ]
        lib.kcf_window_stats_bits.restype = None
        lib.kcf_window_stats_bits.argtypes = [
            u8p, u8p, ctypes.c_int64, ctypes.c_int32, i32p, i32p,
            ctypes.c_int64, _i64p,
        ]
        lib.kcf_sorted_lookup.restype = None
        lib.kcf_sorted_lookup.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, i32p,
        ]
        lib.kcf_pack_runs_fused.restype = ctypes.c_int64
        lib.kcf_pack_runs_fused.argtypes = [
            u8p, ctypes.c_int64, i32p, u32p, ctypes.c_int64, i32p,
            ctypes.c_int64, ctypes.c_uint32, i32p, i32p, ctypes.c_int64,
            u8p, u8p, ctypes.c_int64, _i64p,
        ]
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.kcf_chrom_stats2.restype = None
        lib.kcf_chrom_stats2.argtypes = [
            u32p, ctypes.c_int32, i32p, ctypes.c_int64, u8p, ctypes.c_int64,
            ctypes.c_uint32, ctypes.c_int32,
            i32p, i32p, i64p,          # cs_tot cs_obs cs_cnt
            i32p, i32p, i32p, i64p,    # pp p_var p_dist n_present
            i32p, i32p, i64p, i64p,    # run_start run_end f_run n_runs
        ]
        f64p = ctypes.POINTER(ctypes.c_double)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.kcf_format_rows.restype = ctypes.c_int64
        lib.kcf_format_rows.argtypes = (
            [ctypes.c_char_p, i64p, i64p]          # names
            + [ctypes.c_char_p, i64p, i64p]        # ids
            + [i64p] * 4                           # starts ends totals efflen
            + [f64p] * 3 + [i64p] * 2 + [f32p]     # sc stats, ob stats
            + [i64p] * 2                           # va stats
            + [ctypes.c_char_p, i64p, i64p]        # mv strings
            + [i64p] * 6 + [f64p] * 2              # per-sample
            + [ctypes.c_int64, ctypes.c_int64]
            + [ctypes.c_char_p, ctypes.c_int64]
            + [i64p, i64p]
        )
        u64p2 = ctypes.POINTER(ctypes.c_uint64)
        lib.kcf_decode_suffix_records.restype = None
        lib.kcf_decode_suffix_records.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, u64p2, u32p,
        ]
        lib.kcf_decode_kmc_records.restype = None
        lib.kcf_decode_kmc_records.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, u64p2,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, u64p2, u32p,
        ]
        lib.kcf_decode_kmc_records_wide.restype = None
        lib.kcf_decode_kmc_records_wide.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, u64p2,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
            u64p2, u64p2, u32p,
        ]
        lib.kcf_sort_pairs_u64_u32.restype = None
        lib.kcf_sort_pairs_u64_u32.argtypes = [
            u64p2, u32p, ctypes.c_int64, u64p2, u32p,
        ]
        lib.kcf_sort_unique_pairs.restype = ctypes.c_int64
        lib.kcf_sort_unique_pairs.argtypes = [
            u64p2, u64p2, u32p, ctypes.c_int64, u64p2, u64p2, u64p2,
        ]
        lib.kcf_merge_counts_wide.restype = None
        lib.kcf_merge_counts_wide.argtypes = [
            u64p2, u64p2, ctypes.c_int64, u64p2, u64p2, u32p, ctypes.c_int64,
            u32p,
        ]
        lib.kcf_searchsorted_pairs.restype = None
        lib.kcf_searchsorted_pairs.argtypes = [
            u64p2, u64p2, ctypes.c_int64, u64p2, u64p2, u8p, ctypes.c_int64,
            i32p,
        ]
        lib.kcf_signatures_wide.restype = None
        lib.kcf_signatures_wide.argtypes = [
            u64p2, u64p2, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            u32p, u32p,
        ]
        lib.kcf_wide_suffix_bytes.restype = None
        lib.kcf_wide_suffix_bytes.argtypes = [
            u64p2, u64p2, ctypes.c_int64, ctypes.c_int32, u8p,
        ]
        lib.kcf_f32_seq_group_mean.restype = None
        lib.kcf_f32_seq_group_mean.argtypes = [
            ctypes.POINTER(ctypes.c_double), i64p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.kcf_f32_seq_sum.restype = ctypes.c_float
        lib.kcf_f32_seq_sum.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_float,
        ]
        lib.kcf_parse_rows.restype = ctypes.c_int64
        lib.kcf_parse_rows.argtypes = (
            [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
            + [i64p] * 8
            + [i64p] * 7
            + [ctypes.POINTER(ctypes.c_double)]
        )
        if _thread_budget:
            lib.kcf_set_threads(_thread_budget)
        _lib = lib
    except Exception as e:  # pragma: no cover - environment dependent
        Logger.warning(_CLASS, f"native library unavailable ({e}); using numpy")
        _lib = None
    return _lib


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


_thread_budget = 0


def set_threads(n: int):
    """Set the worker-thread budget for all threaded native kernels
    (0 = all hardware threads). The -t/--threads analog of the
    reference's pool sizing (Plugins/GetVariants.java:129)."""
    global _thread_budget
    _thread_budget = int(n)
    lib = get_lib()
    if lib is not None:
        lib.kcf_set_threads(_thread_budget)


def merge_counts(ref_sorted, db_sorted, db_counts):
    """counts of each sorted unique ref k-mer in the sorted db (0 when
    absent). Native linear merge with a numpy searchsorted fallback."""
    lib = get_lib()
    n_ref = ref_sorted.shape[0]
    out = np.zeros(n_ref, np.uint32)
    if lib is None:
        pos = np.searchsorted(db_sorted, ref_sorted)
        pos_c = np.minimum(pos, len(db_sorted) - 1)
        hit = (pos < len(db_sorted)) & (db_sorted[pos_c] == ref_sorted)
        out[hit] = db_counts[pos_c[hit]]
        return out
    ref_sorted = np.ascontiguousarray(ref_sorted, np.uint64)
    db_sorted = np.ascontiguousarray(db_sorted, np.uint64)
    db_counts = np.ascontiguousarray(db_counts, np.uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.kcf_merge_counts(
        ref_sorted.ctypes.data_as(u64p),
        n_ref,
        db_sorted.ctypes.data_as(u64p),
        _u32p(db_counts),
        db_sorted.shape[0],
        _u32p(out),
    )
    return out


def merge_counts_u8(ref_sorted, db_sorted, db_counts, lo=0, hi=None,
                    out=None, exc_cap=None):
    """Merge join over ref_sorted[lo:hi) emitting uint8-saturated counts
    plus an exception list of (index, exact uint32) pairs for counts
    >= 255. Returns (u8_counts, exc_idx, exc_val); on exception-capacity
    overflow the native call is retried once with a slice-sized buffer,
    then falls back to the uint32 merge + numpy compression (also used
    when the native library is missing).

    ref/db may be plain uint64 arrays (k <= 32), (hi, lo) uint64 pairs
    for wide k-mers (33..64), or S{nb} byte records for k > 64."""
    if (
        not isinstance(ref_sorted, tuple)
        and np.asarray(ref_sorted).dtype.kind == "S"
    ):
        from ..engine.encode_mlimb import merge_counts_u8_bytes

        return merge_counts_u8_bytes(
            ref_sorted, db_sorted, db_counts, lo=lo, hi=hi, out=out
        )
    wide_keys = isinstance(ref_sorted, tuple)
    n_ref = ref_sorted[0].shape[0] if wide_keys else ref_sorted.shape[0]
    if hi is None:
        hi = n_ref
    n = hi - lo
    lib = get_lib()
    if out is None:
        out = np.empty(n, np.uint8)
    if exc_cap is None:
        exc_cap = max(1024, n // 64)
    if lib is not None:
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        db_counts_c = np.ascontiguousarray(db_counts, np.uint32)
        if wide_keys:
            rhi = np.ascontiguousarray(ref_sorted[0], np.uint64)
            rlo = np.ascontiguousarray(ref_sorted[1], np.uint64)
            dhi = np.ascontiguousarray(db_sorted[0], np.uint64)
            dlo = np.ascontiguousarray(db_sorted[1], np.uint64)
        else:
            ref_c = np.ascontiguousarray(ref_sorted, np.uint64)
            db_c = np.ascontiguousarray(db_sorted, np.uint64)
        # matched (ref-translated) exceptions are bounded by the slice
        # length, so one retry at cap=n always succeeds
        for cap in (exc_cap, n) if exc_cap < n else (exc_cap,):
            exc_idx = np.empty(cap, np.int32)
            exc_val = np.empty(cap, np.uint32)
            if wide_keys:
                n_exc = lib.kcf_merge_counts_u8_wide(
                    rhi.ctypes.data_as(u64p), rlo.ctypes.data_as(u64p),
                    lo, hi,
                    dhi.ctypes.data_as(u64p), dlo.ctypes.data_as(u64p),
                    _u32p(db_counts_c), dhi.shape[0],
                    out.ctypes.data_as(u8p),
                    exc_idx.ctypes.data_as(i32p), _u32p(exc_val), cap,
                )
            else:
                n_exc = lib.kcf_merge_counts_u8(
                    ref_c.ctypes.data_as(u64p), lo, hi,
                    db_c.ctypes.data_as(u64p), _u32p(db_counts_c),
                    db_c.shape[0],
                    out.ctypes.data_as(u8p),
                    exc_idx.ctypes.data_as(i32p), _u32p(exc_val), cap,
                )
            if n_exc >= 0:
                return out, exc_idx[:n_exc].copy(), exc_val[:n_exc].copy()
    # fallback: exact uint32 merge, compressed in numpy
    if wide_keys:
        c32 = wide.merge_counts(
            ref_sorted[0][lo:hi], ref_sorted[1][lo:hi],
            db_sorted[0], db_sorted[1], db_counts,
        )
    else:
        c32 = merge_counts(ref_sorted[lo:hi], db_sorted, db_counts)
    big = np.flatnonzero(c32 >= 255)
    out[:] = np.minimum(c32, 255).astype(np.uint8)
    return out, (big + lo).astype(np.int32), c32[big].astype(np.uint32)


def window_scan_u8(counts_u8, exc_idx, exc_val, r_idx, min_count, k,
                   w_start, w_hi):
    """Fused per-sample window scan (see kcf_window_scan_u8). Returns the
    engine's sample-dependent fields as a dict of (n_win,) int64 arrays,
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    counts_u8 = np.ascontiguousarray(counts_u8, np.uint8)
    exc_idx = np.ascontiguousarray(exc_idx, np.int32)
    exc_val = np.ascontiguousarray(exc_val, np.uint32)
    r_idx = np.ascontiguousarray(r_idx, np.int32)
    w_start = np.ascontiguousarray(w_start, np.int32)
    w_hi = np.ascontiguousarray(w_hi, np.int32)
    n_win = w_start.shape[0]
    out = np.empty((6, n_win), np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    flags = 1 if os.environ.get("KCFTOOLS_NO_SIMD") else 0
    lib.kcf_window_scan_u8(
        counts_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        counts_u8.shape[0],
        exc_idx.ctypes.data_as(i32p),
        _u32p(exc_val),
        exc_idx.shape[0],
        r_idx.ctypes.data_as(i32p),
        r_idx.shape[0],
        ctypes.c_uint32(min_count),
        ctypes.c_int32(k),
        w_start.ctypes.data_as(i32p),
        w_hi.ctypes.data_as(i32p),
        n_win,
        ctypes.c_int32(flags),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return {
        "observed": out[0],
        "variations": out[1],
        "inner": out[2],
        "left": out[3],
        "right": out[4],
        "count_sum": out[5],
    }


def pack_posbits(counts_u8, exc_idx, exc_val, r_idx, min_count, w_start,
                 w_hi, out_bits=None, n_bits_bytes=None):
    """Positional presence-bit pack for the device engine (see
    kcf_pack_posbits): one host pass gathers per-position counts from
    the u8 merge-join output, emits an LSB-first presence bitmap over
    k-mer start positions (present = valid && exact count >= min_count)
    and exact per-window int64 count sums. Returns (bits, count_sum);
    bits is zero-padded to ``n_bits_bytes`` (default: positions rounded
    up to whole bytes). Falls back to vectorized numpy when the native
    library is unavailable."""
    r_idx = np.ascontiguousarray(r_idx, np.int32)
    w_start = np.ascontiguousarray(w_start, np.int32)
    w_hi = np.ascontiguousarray(w_hi, np.int32)
    n_pos = r_idx.shape[0]
    n_win = w_start.shape[0]
    if n_bits_bytes is None:
        n_bits_bytes = (n_pos + 7) // 8
    if out_bits is None:
        out_bits = np.empty(n_bits_bytes, np.uint8)
    count_sum = np.empty(n_win, np.int64)
    lib = get_lib()
    if lib is not None:
        counts_u8 = np.ascontiguousarray(counts_u8, np.uint8)
        exc_idx = np.ascontiguousarray(exc_idx, np.int32)
        exc_val = np.ascontiguousarray(exc_val, np.uint32)
        cbuf = _buf("posbits_cbuf", n_pos, np.uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.kcf_pack_posbits(
            counts_u8.ctypes.data_as(u8p), counts_u8.shape[0],
            exc_idx.ctypes.data_as(i32p), _u32p(exc_val),
            exc_idx.shape[0],
            r_idx.ctypes.data_as(i32p), n_pos,
            ctypes.c_uint32(min_count),
            w_start.ctypes.data_as(i32p), w_hi.ctypes.data_as(i32p), n_win,
            out_bits.ctypes.data_as(u8p), n_bits_bytes,
            cbuf.ctypes.data_as(u8p),
            count_sum.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out_bits, count_sum
    # numpy fallback: widen exceptions, gather, pack
    wide_c = np.asarray(counts_u8, np.uint32).copy()
    wide_c[np.asarray(exc_idx, np.int64)] = exc_val
    cnt = wide_c[np.maximum(r_idx, 0)]
    pres = (r_idx >= 0) & (cnt >= np.uint32(min_count))
    packed = np.packbits(pres, bitorder="little")
    out_bits[: packed.shape[0]] = packed
    out_bits[packed.shape[0]:] = 0
    cs = np.zeros(n_pos + 1, np.int64)
    np.cumsum(np.where(pres, cnt, 0), out=cs[1:])
    hi_cl = np.minimum(w_hi, n_pos - 1)
    count_sum[:] = np.where(
        hi_cl >= w_start, cs[hi_cl + 1] - cs[w_start], 0
    )
    return out_bits, count_sum


def bits_to_runs(present_bits, valid_bits, n_pos, cap):
    """Compact absent-run encoding of a positional presence bitmap (see
    kcf_bits_to_runs): maximal stretches with no present position,
    trimmed to their first/last valid-but-absent position, as a
    (delta u8, length u8) stream with 255-saturation fillers. Returns
    (d, l, n_runs) with d/l zero-padded to ``cap``, or (None, None, -1)
    when the encoding would exceed ``cap`` entries (caller falls back
    to the bitmap payload). Positions the encoding skips or trims are
    invalid and masked by the device's static valid bitmap, so the
    reconstruction is exact wherever it is read."""
    out_d = np.zeros(cap, np.uint8)
    out_l = np.zeros(cap, np.uint8)
    lib = get_lib()
    if lib is not None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = lib.kcf_bits_to_runs(
            present_bits.ctypes.data_as(u8p),
            valid_bits.ctypes.data_as(u8p),
            n_pos,
            out_d.ctypes.data_as(u8p),
            out_l.ctypes.data_as(u8p),
            cap,
        )
        if n < 0:
            return None, None, -1
        return out_d, out_l, int(n)
    # numpy fallback: transition scan over the unpacked bitmaps
    pres = np.unpackbits(present_bits, bitorder="little")[:n_pos].astype(bool)
    valid = np.unpackbits(valid_bits, bitorder="little")[:n_pos].astype(bool)
    av = valid & ~pres
    if not av.any():
        return out_d, out_l, 0
    # group = stretch between present positions; trim to valid-absent
    grp = np.cumsum(pres)  # group id of each position
    av_pos = np.flatnonzero(av)
    av_grp = grp[av_pos]
    # first/last valid-absent of each group that has one
    new_grp = np.empty(av_grp.shape[0], bool)
    new_grp[0] = True
    new_grp[1:] = av_grp[1:] != av_grp[:-1]
    starts = av_pos[new_grp]
    ends = av_pos[np.concatenate([new_grp[1:], [True]])] + 1
    k = 0
    prev_end = 0
    for s, e in zip(starts.tolist(), ends.tolist()):
        d = s - prev_end
        while d > 255:
            if k >= cap:
                return None, None, -1
            out_d[k] = 255
            out_l[k] = 0
            k += 1
            d -= 255
        ln = e - s
        take = min(ln, 255)
        if k >= cap:
            return None, None, -1
        out_d[k] = d
        out_l[k] = take
        k += 1
        ln -= take
        while ln > 0:
            take = min(ln, 255)
            if k >= cap:
                return None, None, -1
            out_d[k] = 0
            out_l[k] = take
            k += 1
            ln -= take
        prev_end = e
    return out_d, out_l, k


def build_ordmap(r_idx):
    """Static per-slab occurrence map for the ordinal-space pack: the
    valid positions of ``r_idx`` sorted by reference ordinal, plus the
    map's identity-run segments (within a segment
    ord = seg_ord[s] + o - seg_off[s], letting the native kernel load
    counts contiguously instead of gathering). Returns
    (occ_ord int32 non-decreasing, occ_pos int32,
    seg_off int64 (n_seg+1), seg_ord int32 (n_seg)). Built once per
    slab (native radix sort) and reused by every sample."""
    r_idx = np.ascontiguousarray(r_idx, np.int32)
    lib = get_lib()
    n_pos = r_idx.shape[0]
    n_ref = int(r_idx.max(initial=-1)) + 1
    # the counting sort's offset table spans the GLOBAL ordinal range
    # (8 bytes per ordinal); use it only while that scratch stays
    # proportionate to the occurrence arrays and absolutely bounded -
    # sparse/huge ordinal spaces take the radix path instead
    counting_ok = (
        lib is not None
        and n_ref <= max(4 * n_pos, 1024)
        and n_ref <= (1 << 27)
    )
    if counting_ok:
        n_occ_est = int((r_idx >= 0).sum())
        occ_ord = np.empty(n_occ_est, np.int32)
        occ_pos = np.empty(n_occ_est, np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        n_occ = int(lib.kcf_build_ordmap(
            r_idx.ctypes.data_as(i32p), n_pos, max(n_ref, 1),
            occ_ord.ctypes.data_as(i32p), occ_pos.ctypes.data_as(i32p),
        ))
        assert n_occ == n_occ_est
    else:
        pos = np.flatnonzero(r_idx >= 0).astype(np.uint32)
        keys = r_idx[pos.astype(np.int64)].astype(np.uint64)
        sk, sv = sort_pairs(keys, pos)
        occ_ord = sk.astype(np.int32)
        occ_pos = sv.astype(np.int32)
        n_occ = occ_ord.shape[0]
    if n_occ == 0:
        return (occ_ord, occ_pos, np.zeros(1, np.int64),
                np.empty(0, np.int32))
    breaks = np.flatnonzero(np.diff(occ_ord) != 1).astype(np.int64) + 1
    seg_off = np.empty(breaks.shape[0] + 2, np.int64)
    seg_off[0] = 0
    seg_off[1:-1] = breaks
    seg_off[-1] = n_occ
    seg_ord = occ_ord[seg_off[:-1]]
    return occ_ord, occ_pos, seg_off, np.ascontiguousarray(seg_ord)


def _uniform_window_map(w_start, w_hi):
    """(base, stride) when windows form an equally-spaced sorted
    non-overlapping tiling (position -> window is then a division);
    (0, 0) otherwise (binary-search mapping)."""
    n = w_start.shape[0]
    if n == 0:
        return 0, 0
    if n == 1:
        return int(w_start[0]), int(max(w_hi[0] - w_start[0] + 1, 1))
    d = np.diff(w_start.astype(np.int64))
    stride = int(d[0])
    if stride <= 0 or not (d == stride).all():
        return 0, 0
    if not (w_hi[:-1].astype(np.int64) < w_start[1:].astype(np.int64)).all():
        return 0, 0
    return int(w_start[0]), stride


def ordpack(counts_u8, exc_idx, exc_val, occ_ord, occ_pos, min_count,
            w_start, w_hi, valid_bits, n_bits_bytes, uni=None,
            seg_off=None, seg_ord=None):
    """Ordinal-space presence pack (see kcf_ordpack): builds one
    sample's positional presence bitmap and per-window count-sum
    CORRECTIONS (count_sum = observed + corr) from sequential streams -
    no random positional gather. Requires sorted non-overlapping
    windows. Returns (present_bits, corr_int64). Numpy fallback
    composes the same algebra vectorized."""
    w_start = np.ascontiguousarray(w_start, np.int32)
    w_hi = np.ascontiguousarray(w_hi, np.int32)
    n_win = w_start.shape[0]
    if uni is None:
        uni = _uniform_window_map(w_start, w_hi)
    lib = get_lib()
    if lib is not None:
        counts_u8 = np.ascontiguousarray(counts_u8, np.uint8)
        exc_idx = np.ascontiguousarray(exc_idx, np.int32)
        exc_val = np.ascontiguousarray(exc_val, np.uint32)
        present = np.empty(n_bits_bytes, np.uint8)
        corr = np.empty(n_win, np.int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        n_seg = 0 if seg_off is None else seg_off.shape[0] - 1
        lib.kcf_ordpack(
            counts_u8.ctypes.data_as(u8p), counts_u8.shape[0],
            exc_idx.ctypes.data_as(i32p), _u32p(exc_val),
            exc_idx.shape[0],
            occ_ord.ctypes.data_as(i32p), occ_pos.ctypes.data_as(i32p),
            occ_ord.shape[0], ctypes.c_uint32(min_count),
            w_start.ctypes.data_as(i32p), w_hi.ctypes.data_as(i32p),
            n_win, uni[0], uni[1],
            valid_bits.ctypes.data_as(u8p),
            present.ctypes.data_as(u8p), n_bits_bytes,
            corr.ctypes.data_as(i64p),
            seg_off.ctypes.data_as(i64p) if n_seg > 0 else None,
            seg_ord.ctypes.data_as(i32p) if n_seg > 0 else None,
            n_seg,
        )
        return present, corr
    # numpy fallback: widen exceptions, resolve counts per occurrence
    wide_c = np.asarray(counts_u8, np.uint32).copy()
    wide_c[np.asarray(exc_idx, np.int64)] = exc_val
    c = wide_c[occ_ord.astype(np.int64)]
    pres_occ = c >= np.uint32(min_count)
    n_pos = n_bits_bytes * 8
    absent = np.zeros(n_pos, bool)
    absent[occ_pos[~pres_occ].astype(np.int64)] = True
    valid = np.unpackbits(valid_bits, bitorder="little")[:n_pos].astype(bool)
    present = np.packbits(valid & ~absent, bitorder="little")
    out = np.zeros(n_bits_bytes, np.uint8)
    out[: present.shape[0]] = present
    corr = np.zeros(n_win, np.int64)
    sel = pres_occ & (c != 1)
    if sel.any():
        p = occ_pos[sel].astype(np.int64)
        w = np.searchsorted(w_start.astype(np.int64), p, side="right") - 1
        ok = (w >= 0) & (p <= w_hi.astype(np.int64)[np.maximum(w, 0)])
        np.add.at(corr, w[ok], c[sel].astype(np.int64)[ok] - 1)
    return out, corr


def window_stats_bits(present_bits, valid_bits, n_pos, k, w_start, w_hi):
    """Window statistics straight from presence/validity bitmaps (see
    kcf_window_stats_bits): the gap-run state machine over bit words,
    gaps counting valid-absent positions only. Returns the usual dict
    WITHOUT count_sum (use ordpack's corr + observed). None when the
    native library is unavailable (callers fall back to
    window_scan_u8 or the numpy prefix path)."""
    lib = get_lib()
    if lib is None:
        return None
    w_start = np.ascontiguousarray(w_start, np.int32)
    w_hi = np.ascontiguousarray(w_hi, np.int32)
    n_win = w_start.shape[0]
    out = np.empty((5, n_win), np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.kcf_window_stats_bits(
        present_bits.ctypes.data_as(u8p), valid_bits.ctypes.data_as(u8p),
        n_pos, ctypes.c_int32(k),
        w_start.ctypes.data_as(i32p), w_hi.ctypes.data_as(i32p), n_win,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return {
        "observed": out[0],
        "variations": out[1],
        "inner": out[2],
        "left": out[3],
        "right": out[4],
    }


def pack_runs_fused(counts_u8, exc_idx, exc_val, r_idx, min_count,
                    w_start, w_hi, cap):
    """One fused host pass producing the absent-run stream + exact
    per-window int64 count sums via the POSITIONAL gather (see
    kcf_pack_runs_fused). No longer on the device engine's production
    path (kcf_ordpack replaced it); RETAINED as the independent
    differential oracle for the ordinal-space pack - the test suite
    cross-checks ordpack/bits_to_runs against this kernel's positional
    formulation (tests/test_runs_uplink.py, tests/test_ordpack.py).
    Requires windows sorted and non-overlapping in k-mer-start space.
    Returns (d, l, n_runs, count_sum); n_runs = -1 on cap overflow,
    -2 when the windows are not eligible. The numpy fallback composes
    pack_posbits + bits_to_runs directly."""
    r_idx = np.ascontiguousarray(r_idx, np.int32)
    w_start = np.ascontiguousarray(w_start, np.int32)
    w_hi = np.ascontiguousarray(w_hi, np.int32)
    n_pos = r_idx.shape[0]
    n_win = w_start.shape[0]
    lib = get_lib()
    if lib is None:
        bits, count_sum = pack_posbits(
            counts_u8, exc_idx, exc_val, r_idx, min_count, w_start, w_hi
        )
        valid_bits = np.packbits(r_idx >= 0, bitorder="little")
        d, l, n = bits_to_runs(bits, valid_bits, n_pos, cap)
        return d, l, n, count_sum
    counts_u8 = np.ascontiguousarray(counts_u8, np.uint8)
    exc_idx = np.ascontiguousarray(exc_idx, np.int32)
    exc_val = np.ascontiguousarray(exc_val, np.uint32)
    out_d = np.zeros(cap, np.uint8)
    out_l = np.zeros(cap, np.uint8)
    count_sum = np.zeros(n_win, np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = lib.kcf_pack_runs_fused(
        counts_u8.ctypes.data_as(u8p), counts_u8.shape[0],
        exc_idx.ctypes.data_as(i32p), _u32p(exc_val), exc_idx.shape[0],
        r_idx.ctypes.data_as(i32p), n_pos, ctypes.c_uint32(min_count),
        w_start.ctypes.data_as(i32p), w_hi.ctypes.data_as(i32p), n_win,
        out_d.ctypes.data_as(u8p), out_l.ctypes.data_as(u8p), cap,
        count_sum.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n < 0:
        return None, None, int(n), count_sum
    return out_d, out_l, int(n), count_sum


def runs_to_bits(d, l, valid_bits, n_pos):
    """Reconstruct the positional presence bitmap from an absent-run
    payload (inverse of the uplink encoding wherever valid): present =
    valid and not inside any run."""
    dl = np.asarray(d, np.int64)
    ll = np.asarray(l, np.int64)
    ends = np.cumsum(dl + ll)
    starts = ends - ll
    delta = np.zeros(n_pos + 1, np.int32)
    np.add.at(delta, np.clip(starts, 0, n_pos), 1)
    np.add.at(delta, np.clip(ends, 0, n_pos), -1)
    absent = np.cumsum(delta[:n_pos]) > 0
    valid = np.unpackbits(
        np.asarray(valid_bits, np.uint8), bitorder="little"
    )[:n_pos].astype(bool)
    packed = np.packbits(valid & ~absent, bitorder="little")
    out = np.zeros((n_pos + 7) // 8, np.uint8)
    out[: packed.shape[0]] = packed
    return out


def sort_u64(keys):
    """Sorted copy of uint64 keys - the keys-only native radix path
    (no 4n-byte value scratch; half the memory traffic of the pair
    sort). numpy fallback."""
    keys = np.ascontiguousarray(keys, np.uint64)
    lib = get_lib()
    if keys.size == 0 or lib is None:
        return np.sort(keys, kind="stable")
    n = keys.shape[0]
    out_k = np.empty(n, np.uint64)
    lib.kcf_sort_pairs_u64_u32(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        None, n,
        out_k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        None,
    )
    return out_k


def sort_unique_u64(keys):
    """Sorted unique uint64 keys - native threaded radix sort + dedup,
    numpy unique fallback."""
    keys = np.ascontiguousarray(keys, np.uint64)
    if keys.size == 0 or get_lib() is None:
        return np.unique(keys)
    ks = sort_u64(keys)
    keep = np.empty(ks.shape[0], bool)
    keep[:1] = True
    keep[1:] = ks[1:] != ks[:-1]
    return ks[keep]


def sorted_lookup(hay, needles_sorted):
    """Indices of sorted ``needles_sorted`` in sorted ``hay`` (-1 where
    absent) - native linear zipper, numpy searchsorted fallback."""
    hay = np.ascontiguousarray(hay, np.uint64)
    needles_sorted = np.ascontiguousarray(needles_sorted, np.uint64)
    out = np.empty(needles_sorted.shape[0], np.int32)
    lib = get_lib()
    if lib is None:
        idx = np.searchsorted(hay, needles_sorted)
        idx = np.minimum(idx, max(hay.shape[0] - 1, 0))
        hit = (
            hay[idx] == needles_sorted
            if hay.size
            else np.zeros(needles_sorted.shape[0], bool)
        )
        out[:] = np.where(hit, idx, -1)
        return out
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.kcf_sorted_lookup(
        hay.ctypes.data_as(u64p), hay.shape[0],
        needles_sorted.ctypes.data_as(u64p), needles_sorted.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def refsim_scan(codes, k, w_start, w_end, sig_map, sig_len,
                prefix_array, lut_len, suffix_raw, n_rec, suf_bytes,
                counter_size, norm, min_count=1, threads=2):
    """The reference tool's exact per-window lookup mechanics
    (char-by-char k-mer repack + revcomp canonicalization + signature
    scan + prefix-LUT binary search + per-window thread pool;
    KMC.java:292-326, Kmer.java:105-118, GetVariants.java:129-261,
    HelperFunctions.java:232-243) as a measured host baseline. Returns
    per-window observed counts. Requires the native library."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("refsim requires the native library")
    codes = np.ascontiguousarray(codes, np.uint8)
    w_start = np.ascontiguousarray(w_start, np.int32)
    w_end = np.ascontiguousarray(w_end, np.int32)
    sig_map = np.ascontiguousarray(sig_map, np.uint32)
    prefix_array = np.ascontiguousarray(prefix_array, np.uint64)
    suffix_raw = np.ascontiguousarray(suffix_raw, np.uint8)
    norm = np.ascontiguousarray(norm, np.uint32)
    out = np.zeros(w_start.shape[0], np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.kcf_refsim_scan(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(codes.shape[0]), ctypes.c_int(k),
        w_start.ctypes.data_as(i32p), w_end.ctypes.data_as(i32p),
        ctypes.c_int64(w_start.shape[0]),
        _u32p(sig_map), ctypes.c_int(sig_len),
        prefix_array.ctypes.data_as(u64p),
        ctypes.c_int64(prefix_array.shape[0]), ctypes.c_int(lut_len),
        suffix_raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n_rec), ctypes.c_int(suf_bytes),
        ctypes.c_int(counter_size), _u32p(norm),
        ctypes.c_int(min_count), ctypes.c_int(threads),
        out.ctypes.data_as(i64p),
    )
    return out


def release_sort_scratch():
    """Free the calling thread's persistent radix-sort scratch (n x 12
    bytes, kept across calls for reuse). Call after one-off multi-Gbp
    sorts - a 3G-key sort otherwise parks ~36 GB until thread exit."""
    lib = get_lib()
    if lib is not None:
        lib.kcf_release_sort_scratch()


def sort_pairs(keys, vals):
    """Sort (uint64 keys, uint32 values) pairs by key - native threaded
    LSD radix sort, numpy argsort fallback. Returns new arrays."""
    lib = get_lib()
    keys = np.ascontiguousarray(keys, np.uint64)
    vals = np.ascontiguousarray(vals, np.uint32)
    if lib is None:
        order = np.argsort(keys, kind="stable")
        return keys[order], vals[order]
    n = keys.shape[0]
    out_k = np.empty(n, np.uint64)
    out_v = np.empty(n, np.uint32)
    lib.kcf_sort_pairs_u64_u32(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _u32p(vals), n,
        out_k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _u32p(out_v),
    )
    return out_k, out_v


def route_shard(kmers_u64, counts_u32, k, nb_total, nb_local, s_lo, s_hi,
                want_ids=False):
    """Shard-route one decoded KMC slab (see kcf_route_shard): ONE pass
    computes each key's owning table shard (top bits of bucket hash 1)
    and compacts keys routed to [s_lo, s_hi) into (hi, lo, cnt[,
    shard]) staging arrays in file order. Numpy fallback reproduces
    the same selection vectorized."""
    kmers_u64 = np.ascontiguousarray(kmers_u64, np.uint64)
    counts_u32 = np.ascontiguousarray(counts_u32, np.uint32)
    n = kmers_u64.shape[0]
    lib = get_lib()
    if lib is None:
        from ..engine.encode import split_hi_lo
        from ..engine.hashtable import bucket_hashes_np

        hi, lo = split_hi_lo(kmers_u64, k)
        h1, _h2 = bucket_hashes_np(hi, lo, nb_total)
        shard = (h1 // np.uint32(nb_local)).astype(np.int32)
        sel = (shard >= s_lo) & (shard < s_hi)
        out = (hi[sel], lo[sel], counts_u32[sel])
        return out + ((shard[sel],) if want_ids else (None,))
    out_hi = np.empty(n, np.uint32)
    out_lo = np.empty(n, np.uint32)
    out_cnt = np.empty(n, np.uint32)
    out_sh = np.empty(n, np.int32) if want_ids else None
    i32p = ctypes.POINTER(ctypes.c_int32)
    w = lib.kcf_route_shard(
        kmers_u64.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _u32p(counts_u32), n, ctypes.c_int32(k),
        ctypes.c_uint32(nb_total - 1), ctypes.c_uint32(nb_local),
        ctypes.c_int32(s_lo), ctypes.c_int32(s_hi),
        _u32p(out_hi), _u32p(out_lo), _u32p(out_cnt),
        out_sh.ctypes.data_as(i32p) if want_ids else None,
    )
    return (out_hi[:w], out_lo[:w], out_cnt[:w],
            out_sh[:w] if want_ids else None)


def gather_counts(table_u32, idx_i32):
    """out[i] = table[idx[i]] (0 for idx < 0)."""
    lib = get_lib()
    idx_i32 = np.ascontiguousarray(idx_i32, np.int32)
    if lib is None:
        safe = np.maximum(idx_i32, 0)
        out = table_u32[safe]
        out[idx_i32 < 0] = 0
        return out
    table_u32 = np.ascontiguousarray(table_u32, np.uint32)
    out = np.empty(idx_i32.shape[0], np.uint32)
    lib.kcf_gather_counts(
        _u32p(table_u32),
        idx_i32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        idx_i32.shape[0],
        _u32p(out),
    )
    return out


_scratch = {}


def _buf(name, size, dtype):
    """Monotonically-growing reusable scratch buffer (allocation and
    first-touch page faults dominate otherwise on small hosts)."""
    cur = _scratch.get(name)
    if cur is None or cur.shape[0] < size or cur.dtype != np.dtype(dtype):
        cap = max(size, 1)
        if cur is not None and cur.dtype == np.dtype(dtype):
            cap = max(cap, cur.shape[0] * 2)
        _scratch[name] = np.empty(cap, dtype)
    return _scratch[name][:size]


def chrom_stats_native(counts, r_idx, base_valid, min_count, k,
                       indirect=False):
    """Fused chromosome pass; returns the engine/prefix_scan dict or None
    when the native library is unavailable. With ``indirect=True``,
    ``counts`` is the per-unique-kmer table and the per-position gather
    is fused into the scan (counts[r_idx[i]]).

    NOTE: the returned arrays alias reusable scratch buffers - they are
    valid until the next chrom_stats_native call. Callers consume them
    immediately (window_stats), matching the plugin's per-chromosome
    flow.
    """
    lib = get_lib()
    if lib is None:
        return None
    counts_pos = np.ascontiguousarray(counts, np.uint32)
    r_idx = np.ascontiguousarray(r_idx, np.int32)
    base_valid = np.ascontiguousarray(base_valid, np.uint8)
    n_pos = r_idx.shape[0]
    L = base_valid.shape[0]
    cs_tot = _buf("cs_tot", n_pos + 1, np.int32)
    cs_obs = _buf("cs_obs", n_pos + 1, np.int32)
    cs_cnt = _buf("cs_cnt", n_pos + 1, np.int64)
    pp = _buf("pp", max(n_pos, 1), np.int32)
    p_var = _buf("p_var", n_pos + 2, np.int32)
    p_dist = _buf("p_dist", n_pos + 2, np.int32)
    max_runs = L // 2 + 2
    run_start = _buf("run_start", max_runs, np.int32)
    run_end = _buf("run_end", max_runs, np.int32)
    f_run = _buf("f_run", max_runs + 1, np.int64)
    n_present = np.zeros(1, np.int64)
    n_runs = np.zeros(1, np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.kcf_chrom_stats2(
        _u32p(counts_pos),
        ctypes.c_int32(1 if indirect else 0),
        r_idx.ctypes.data_as(i32p),
        n_pos,
        base_valid.ctypes.data_as(u8p),
        L,
        ctypes.c_uint32(min_count),
        ctypes.c_int32(k),
        cs_tot.ctypes.data_as(i32p),
        cs_obs.ctypes.data_as(i32p),
        cs_cnt.ctypes.data_as(i64p),
        pp.ctypes.data_as(i32p),
        p_var.ctypes.data_as(i32p),
        p_dist.ctypes.data_as(i32p),
        n_present.ctypes.data_as(i64p),
        run_start.ctypes.data_as(i32p),
        run_end.ctypes.data_as(i32p),
        f_run.ctypes.data_as(i64p),
        n_runs.ctypes.data_as(i64p),
    )
    npp = int(n_present[0])
    nr = int(n_runs[0])
    return {
        "cs_tot": cs_tot,
        "cs_obs": cs_obs,
        "cs_cnt": cs_cnt,
        "pp": pp[:npp],
        "p_var": p_var[: npp + 1],
        "p_dist": p_dist[: npp + 1],
        "run_start": run_start[:nr],
        "run_end": run_end[:nr],
        "f_run": f_run[: nr + 1],
        "k": k,
    }


def decode_suffix_records(raw: np.ndarray, n: int, suf_bytes: int,
                          counter_size: int):
    """(suffix uint64, count uint32) arrays from flat record bytes, or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, np.uint8)
    suffixes = np.empty(n, np.uint64)
    counts = np.empty(n, np.uint32)
    lib.kcf_decode_suffix_records(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        suf_bytes,
        counter_size,
        suffixes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _u32p(counts),
    )
    return suffixes, counts


def decode_kmc_records(raw, n, suf_bytes, counter_size, bounds, lut_size,
                       suffix_len, rec_offset=0):
    """Full (kmer uint64, count uint32) decode in one native threaded
    pass, or None when unavailable. bounds are absolute record indices
    (prefix LUT concatenation + total-count sentinel); rec_offset maps
    slab record 0 to its absolute index."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, np.uint8)
    bounds = np.ascontiguousarray(bounds, np.uint64)
    kmers = np.empty(n, np.uint64)
    counts = np.empty(n, np.uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.kcf_decode_kmc_records(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, suf_bytes, counter_size,
        bounds.ctypes.data_as(u64p),
        bounds.shape[0] - 1, lut_size, suffix_len,
        rec_offset,
        kmers.ctypes.data_as(u64p),
        _u32p(counts),
    )
    return kmers, counts


def _u64p_of(a):
    # NOTE: callers must pass arrays that are already uint64-contiguous
    # (or hold a reference themselves) - a conversion temp created here
    # would be freed before the foreign call runs.
    assert a.dtype == np.uint64 and a.flags["C_CONTIGUOUS"], a.dtype
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


class _Wide:
    """Namespace for 128-bit pair operations (native, with slow Python
    fallbacks so the pure-numpy configuration stays correct)."""

    @staticmethod
    def decode_kmc_records(raw, n, suf_bytes, counter_size, bounds, lut_size,
                           suffix_len, rec_offset=0):
        lib = get_lib()
        raw = np.ascontiguousarray(raw, np.uint8)
        bounds = np.ascontiguousarray(bounds, np.uint64)
        khi = np.empty(n, np.uint64)
        klo = np.empty(n, np.uint64)
        counts = np.empty(n, np.uint32)
        if lib is None:
            rec = suf_bytes + counter_size
            b = np.asarray(bounds, np.int64)
            bin_of = np.repeat(np.arange(len(b) - 1), np.diff(b))
            bin_of = bin_of[rec_offset : rec_offset + n]
            for i in range(n):
                p = raw[i * rec : i * rec + rec]
                s = 0
                for j in range(suf_bytes):
                    s = (s << 8) | int(p[j])
                c = 0
                for j in range(counter_size):
                    c |= int(p[suf_bytes + j]) << (8 * j)
                v = ((int(bin_of[i]) % lut_size)
                     << (2 * suffix_len)) | s
                khi[i] = v >> 64
                klo[i] = v & 0xFFFFFFFFFFFFFFFF
                counts[i] = c
            return khi, klo, counts
        lib.kcf_decode_kmc_records_wide(
            raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n, suf_bytes, counter_size,
            _u64p_of(bounds), bounds.shape[0] - 1, lut_size, suffix_len,
            rec_offset,
            _u64p_of(khi), _u64p_of(klo), _u32p(counts),
        )
        return khi, klo, counts

    @staticmethod
    def sort_unique(hi, lo, counts=None):
        lib = get_lib()
        n = hi.shape[0]
        if lib is None:
            vals = [(int(h) << 64) | int(l) for h, l in zip(hi, lo)]
            agg = {}
            for i, v in enumerate(vals):
                agg[v] = agg.get(v, 0) + (int(counts[i]) if counts is not None else 1)
            keys = sorted(agg)
            ohi = np.array([v >> 64 for v in keys], np.uint64)
            olo = np.array([v & 0xFFFFFFFFFFFFFFFF for v in keys], np.uint64)
            oc = np.array([agg[v] for v in keys], np.uint64)
            return ohi, olo, oc
        hi = np.ascontiguousarray(hi, np.uint64)
        lo = np.ascontiguousarray(lo, np.uint64)
        out_hi = np.empty(n, np.uint64)
        out_lo = np.empty(n, np.uint64)
        out_c = np.empty(n, np.uint64)
        cptr = (
            np.ascontiguousarray(counts, np.uint32) if counts is not None else None
        )
        m = lib.kcf_sort_unique_pairs(
            _u64p_of(hi), _u64p_of(lo),
            _u32p(cptr) if cptr is not None else None,
            n,
            _u64p_of(out_hi), _u64p_of(out_lo), _u64p_of(out_c),
        )
        return out_hi[:m].copy(), out_lo[:m].copy(), out_c[:m].copy()

    @staticmethod
    def merge_counts(rhi, rlo, dhi, dlo, dcounts):
        lib = get_lib()
        out = np.zeros(rhi.shape[0], np.uint32)
        if lib is None:
            table = {
                (int(h) << 64) | int(l): int(c)
                for h, l, c in zip(dhi, dlo, dcounts)
            }
            for i in range(rhi.shape[0]):
                out[i] = table.get((int(rhi[i]) << 64) | int(rlo[i]), 0)
            return out
        rhi = np.ascontiguousarray(rhi, np.uint64)
        rlo = np.ascontiguousarray(rlo, np.uint64)
        dhi = np.ascontiguousarray(dhi, np.uint64)
        dlo = np.ascontiguousarray(dlo, np.uint64)
        dcounts = np.ascontiguousarray(dcounts, np.uint32)
        lib.kcf_merge_counts_wide(
            _u64p_of(rhi), _u64p_of(rlo), rhi.shape[0],
            _u64p_of(dhi), _u64p_of(dlo),
            _u32p(dcounts), dhi.shape[0],
            _u32p(out),
        )
        return out

    @staticmethod
    def searchsorted(rhi, rlo, qhi, qlo, q_valid):
        lib = get_lib()
        nq = qhi.shape[0]
        out = np.empty(nq, np.int32)
        if lib is None:
            pos = {
                (int(h) << 64) | int(l): i for i, (h, l) in enumerate(zip(rhi, rlo))
            }
            for i in range(nq):
                if q_valid is not None and not q_valid[i]:
                    out[i] = -1
                else:
                    out[i] = pos.get((int(qhi[i]) << 64) | int(qlo[i]), -1)
            return out
        rhi = np.ascontiguousarray(rhi, np.uint64)
        rlo = np.ascontiguousarray(rlo, np.uint64)
        qhi = np.ascontiguousarray(qhi, np.uint64)
        qlo = np.ascontiguousarray(qlo, np.uint64)
        vptr = (
            np.ascontiguousarray(q_valid, np.uint8) if q_valid is not None else None
        )
        lib.kcf_searchsorted_pairs(
            _u64p_of(rhi), _u64p_of(rlo), rhi.shape[0],
            _u64p_of(qhi), _u64p_of(qlo),
            vptr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            if vptr is not None
            else None,
            nq,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out

    @staticmethod
    def signatures(khi, klo, k, m, norm):
        lib = get_lib()
        n = khi.shape[0]
        out = np.empty(n, np.uint32)
        if lib is None:
            mask = (1 << (2 * m)) - 1
            for i in range(n):
                v = (int(khi[i]) << 64) | int(klo[i])
                best = min(
                    int(norm[(v >> (2 * (k - m - t))) & mask])
                    for t in range(k - m + 1)
                )
                out[i] = best
            return out
        khi = np.ascontiguousarray(khi, np.uint64)
        klo = np.ascontiguousarray(klo, np.uint64)
        norm = np.ascontiguousarray(norm, np.uint32)
        lib.kcf_signatures_wide(
            _u64p_of(khi), _u64p_of(klo), n, k, m,
            _u32p(norm), _u32p(out),
        )
        return out

    @staticmethod
    def suffix_bytes(khi, klo, suf_bytes):
        lib = get_lib()
        n = khi.shape[0]
        out = np.empty((n, suf_bytes), np.uint8)
        if lib is None:
            for i in range(n):
                v = (int(khi[i]) << 64) | int(klo[i])
                for j in range(suf_bytes):
                    out[i, j] = (v >> (8 * (suf_bytes - 1 - j))) & 0xFF
            return out
        khi = np.ascontiguousarray(khi, np.uint64)
        klo = np.ascontiguousarray(klo, np.uint64)
        lib.kcf_wide_suffix_bytes(
            _u64p_of(khi), _u64p_of(klo), n, suf_bytes,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out


wide = _Wide


def parse_kcf_rows(text: bytes, n_samples: int, max_rows: int):
    """Native KCF data-row parse. Returns a dict of numeric columns plus
    (name_off, name_len, id_off, id_len) token offsets, or None when the
    native library is unavailable or the input is malformed."""
    lib = get_lib()
    if lib is None:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    cols = {
        name: np.empty(max_rows, np.int64)
        for name in (
            "start", "end", "total", "efflen",
            "name_off", "name_len", "id_off", "id_len",
        )
    }
    per = {
        name: np.empty((n_samples, max_rows), np.int64)
        for name in ("ibs", "va", "ob", "inner", "ld", "rd", "kmer_count")
    }
    kd = np.empty((n_samples, max_rows), np.float64)
    rows = lib.kcf_parse_rows(
        text,
        len(text),
        n_samples,
        max_rows,
        *(cols[name].ctypes.data_as(i64p) for name in (
            "start", "end", "total", "efflen",
            "name_off", "name_len", "id_off", "id_len",
        )),
        *(per[name].ctypes.data_as(i64p) for name in (
            "ibs", "va", "ob", "inner", "ld", "rd", "kmer_count",
        )),
        kd.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rows < 0:
        return None
    return {"rows": int(rows), "cols": cols, "per": per, "kd": kd}


def format_kcf_rows(
    names_buf, name_off, name_len, ids_buf, id_off, id_len,
    starts, ends, totals, efflen,
    min_sc, max_sc, mean_sc, min_ob, max_ob, mean_ob, min_va, max_va,
    mv_buf, mv_off, mv_len,
    ibs, va, ob, inner, ld, rd, kd, sc,
):
    """Native KCF row formatter. Returns (bytes, tie_row_indices) or None.
    Rows listed in tie_row_indices sit near a %.2f rounding tie and must
    be re-rendered with exact decimal arithmetic by the caller."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(starts)
    s = ibs.shape[0]
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    f32p = ctypes.POINTER(ctypes.c_float)

    def I(a):
        return np.ascontiguousarray(a, np.int64).ctypes.data_as(i64p)

    def D(a):
        return np.ascontiguousarray(a, np.float64).ctypes.data_as(f64p)

    cap = len(names_buf) + len(ids_buf) + len(mv_buf) + n * (4200 + 70 * s)
    out = np.empty(cap, np.uint8)  # not zeroed; C writes sequentially
    tie_rows = np.empty(n, np.int64)
    n_tie = np.zeros(1, np.int64)
    # keep converted arrays alive for the duration of the call
    keep = [
        np.ascontiguousarray(x, np.int64)
        for x in (name_off, name_len, id_off, id_len, starts, ends, totals,
                  efflen, min_ob, max_ob, min_va, max_va, mv_off, mv_len,
                  ibs, va, ob, inner, ld, rd)
    ]
    keepd = [np.ascontiguousarray(x, np.float64) for x in (min_sc, max_sc, mean_sc, kd, sc)]
    mean_ob32 = np.ascontiguousarray(mean_ob, np.float32)
    written = lib.kcf_format_rows(
        names_buf, keep[0].ctypes.data_as(i64p), keep[1].ctypes.data_as(i64p),
        ids_buf, keep[2].ctypes.data_as(i64p), keep[3].ctypes.data_as(i64p),
        keep[4].ctypes.data_as(i64p), keep[5].ctypes.data_as(i64p),
        keep[6].ctypes.data_as(i64p), keep[7].ctypes.data_as(i64p),
        keepd[0].ctypes.data_as(f64p), keepd[1].ctypes.data_as(f64p),
        keepd[2].ctypes.data_as(f64p),
        keep[8].ctypes.data_as(i64p), keep[9].ctypes.data_as(i64p),
        mean_ob32.ctypes.data_as(f32p),
        keep[10].ctypes.data_as(i64p), keep[11].ctypes.data_as(i64p),
        mv_buf, keep[12].ctypes.data_as(i64p), keep[13].ctypes.data_as(i64p),
        keep[14].ctypes.data_as(i64p), keep[15].ctypes.data_as(i64p),
        keep[16].ctypes.data_as(i64p), keep[17].ctypes.data_as(i64p),
        keep[18].ctypes.data_as(i64p), keep[19].ctypes.data_as(i64p),
        keepd[3].ctypes.data_as(f64p), keepd[4].ctypes.data_as(f64p),
        n, s,
        ctypes.cast(out.ctypes.data, ctypes.c_char_p), cap,
        tie_rows.ctypes.data_as(i64p), n_tie.ctypes.data_as(i64p),
    )
    if written < 0:
        return None
    return out[:written].tobytes(), tie_rows[: int(n_tie[0])]


def f32_seq_group_mean(scores_f64, group_off):
    """Java-semantics per-group mean (f32 accumulator, double adds).
    scores_f64: flat member scores; group_off: (G+1,) boundaries."""
    lib = get_lib()
    G = len(group_off) - 1
    out = np.empty(G, np.float32)
    scores_f64 = np.ascontiguousarray(scores_f64, np.float64)
    group_off = np.ascontiguousarray(group_off, np.int64)
    if lib is None:
        for g in range(G):
            acc = np.float32(0.0)
            for i in range(group_off[g], group_off[g + 1]):
                acc = np.float32(float(acc) + float(scores_f64[i]))
            cnt = group_off[g + 1] - group_off[g]
            out[g] = acc / np.float32(cnt) if cnt else 0.0
        return out
    lib.kcf_f32_seq_group_mean(
        scores_f64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        group_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        G,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def f32_seq_sum(scores_f64, init=np.float32(0.0)):
    """Resumable Java-semantics sequential sum: fold scores into an f32
    accumulator (double adds, f32 narrowing each step). Returns the new
    accumulator; used by the streaming findIBS summary."""
    scores_f64 = np.ascontiguousarray(scores_f64, np.float64)
    lib = get_lib()
    if lib is None:
        acc = np.float32(init)
        for x in scores_f64:
            acc = np.float32(float(acc) + float(x))
        return acc
    return np.float32(
        lib.kcf_f32_seq_sum(
            scores_f64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            scores_f64.shape[0], ctypes.c_float(float(init)),
        )
    )


def build_table_native(hi, lo, counts, nb, slots=4):
    """Two-choice build straight into the interleaved (nb, 3*slots)
    lookup layout (one ~48-byte row touched per insert; empty slots
    stay zero from the allocation). Returns the table array or None on
    overflow / no native lib."""
    lib = get_lib()
    if lib is None:
        return None
    n = hi.shape[0]
    tbl = np.zeros((nb, 3 * slots), np.uint32)
    hi = np.ascontiguousarray(hi, np.uint32)
    lo = np.ascontiguousarray(lo, np.uint32)
    counts = np.ascontiguousarray(counts, np.uint32)
    rc = lib.kcf_build_table(
        _u32p(hi), _u32p(lo), _u32p(counts), n,
        _u32p(tbl), nb, ctypes.c_int32(slots),
    )
    if rc != 0:
        return None
    return tbl
