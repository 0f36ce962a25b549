"""KMC3 k-mer count database I/O.

Reader: decodes a ``.kmc_pre``/``.kmc_suf`` pair (format per
the reference's docs/formats/kmc.md and Data/KMC.java:107-189) into flat
numpy arrays of packed canonical k-mers + counts. Unlike the reference -
which keeps KMC's signature map + prefix LUTs and answers each query with
a signature scan + binary search (KMC.java:292-326) - we reconstruct every
k-mer once at ingest (prefix = LUT-array index mod 4^lut, suffix from the
record; same reconstruction the reference's own dumpKmerTable debug path
uses, KMC.java:427-450) and hand the flat table to the engine, which
builds a bucketed hash table for O(1) batched device lookups. Only
membership/count semantics must match, not lookup mechanics.

Writer: emits the same binary format (so the reference Java tool could
read our databases), used by the test suite and the built-in ``count``
subcommand - this environment has no KMC binary, and users of the rebuilt
framework get a native counter for free.

K-mers are packed big-endian 2-bit (A=0,C=1,G=2,T=3; first base in the
most-significant bits) into uint64, supporting k <= 32 (the reference's
documented envelope is KMC signature length 9 and k around 31;
docs/general/limitations.md).
"""

import os
import struct
import zipfile

import numpy as np

from ..utils.logger import Logger
from ..utils.stagetimer import count

_CLASS = "KMC"
_HEADER_BYTES = 68  # k..version inclusive: 7*u32 + u64 + 4*u8 + 6*u32 + u32


def _build_norm(sig_len: int) -> np.ndarray:
    """KMC2-style m-mer norm map: norm[m] = min(allowed(m), allowed(rc(m)))
    with disallowed m-mers mapped to the sentinel 4^sig_len.

    Semantics per reference Data/Signature.java:23-76.
    """
    special = 1 << (2 * sig_len)
    m = np.arange(special, dtype=np.uint32)

    # reverse complement of each m-mer
    rev = np.zeros_like(m)
    x = m.copy()
    for _ in range(sig_len):
        rev = (rev << 2) | ((~x) & 0b11)
        x = x >> 2
    rev &= special - 1

    def allowed(sig):
        ok = np.ones(sig.shape, dtype=bool)
        ok &= (sig & 0x3F) != 0x3F  # TTT suffix
        ok &= (sig & 0x3F) != 0x3B  # TGT suffix
        ok &= (sig & 0x3C) != 0x3C  # TG* suffix
        s = sig.copy()
        for _ in range(sig_len - 3):
            ok &= (s & 0xF) != 0  # AA inside
            # reference shifts only when the current check passes; once a
            # disallowed pattern is found the m-mer is rejected outright, so
            # unconditional shift on rejected lanes cannot un-reject them.
            s = s >> 2
        ok &= s != 0  # AAA prefix
        ok &= s != 0x04  # ACA prefix
        ok &= (s & 0xF) != 0  # *AA prefix
        return ok

    str_val = np.where(allowed(m), m, special).astype(np.uint64)
    rev_val = np.where(allowed(rev), rev, special).astype(np.uint64)
    return np.minimum(str_val, rev_val).astype(np.uint32)


def kmer_signatures(kmers: np.ndarray, k: int, sig_len: int, norm=None) -> np.ndarray:
    """Minimum norm over all m-mers of each packed k-mer
    (reference Data/Kmer.java:105-118). Large inputs take the native
    signature kernel (bit-identical; the numpy sliding-window loop
    allocates k-m+1 full-width temporaries, which matters at the
    multi-Gbp DB-writing scale)."""
    if norm is None:
        norm = _build_norm(sig_len)
    if kmers.shape[0] >= (1 << 20) and k <= 32:
        try:
            from ..native import get_lib, wide

            if get_lib() is not None:
                return wide.signatures(
                    np.zeros_like(kmers), kmers, k, sig_len, norm
                )
        except Exception:
            pass
    mask = np.uint64((1 << (2 * sig_len)) - 1)
    best = None
    for t in range(k - sig_len + 1):
        mm = (kmers >> np.uint64(2 * (k - sig_len - t))) & mask
        v = norm[mm.astype(np.int64)]
        best = v if best is None else np.minimum(best, v)
    return best


class KMCReader:
    """Decode a KMC3 database into flat (kmer64, count) arrays.

    ``materialize=False`` reads only the prefix file (header, signature
    map, LUT bounds) and exposes the records through ``iter_slabs()``
    instead of decoding everything into RAM - the low-memory analog of
    the reference's default mmap mode (Data/KMC.java:84-102), used by
    the streaming sharded-table loader (parallel/loader.py) and the
    no---memory merge path so wheat-scale databases never need to fit
    one host."""

    def __init__(self, db_prefix: str, materialize: bool = True):
        self.prefix_file = db_prefix + ".kmc_pre"
        self.suffix_file = db_prefix + ".kmc_suf"
        self._read_prefix_file()
        self.kmers = None
        self.counts = None
        if materialize:
            self._read_records()
        self.print_summary()

    def iter_slabs(self, slab_records: int | None = None):
        """Yield (kmers, counts) per slab in KMC record order without
        materializing the table: kmers is uint64 (k <= 32), an (hi, lo)
        uint64 pair (33..64), or S{nb} byte records (k > 64); counts is
        uint32. Each canonical k-mer appears in exactly one slab."""
        from ..native import decode_kmc_records, get_lib, wide

        slab = slab_records or self._SLAB_RECORDS
        suf_bytes = self.suffix_length // 4
        rec = suf_bytes + self.counter_size
        n = self.total_kmers
        lut_size = 1 << (2 * self.lut_prefix_length)
        bounds_all = np.append(self.prefix_array, np.uint64(n))
        if self.mlimb:
            from ..engine.encode_mlimb import n_bytes

            nb = n_bytes(self.kmer_length)
            p_bytes = nb - suf_bytes
            per_bin = np.diff(bounds_all.astype(np.int64))
            prefixes_all = np.repeat(
                np.arange(len(self.prefix_array), dtype=np.int64) % lut_size,
                per_bin,
            ).astype(np.uint64)
        with open(self.suffix_file, "rb") as fh:
            fh.seek(4)
            done = 0
            while done < n:
                m = min(slab, n - done)
                raw = np.fromfile(fh, dtype=np.uint8, count=m * rec)
                if raw.shape[0] < m * rec:
                    Logger.error(
                        _CLASS, f"Truncated suffix file: {self.suffix_file}"
                    )
                if self.mlimb:
                    raw = raw.reshape(m, rec)
                    keymat = np.empty((m, nb), np.uint8)
                    keymat[:, p_bytes:] = raw[:, :suf_bytes]
                    pv = prefixes_all[done : done + m]
                    for j in range(p_bytes):
                        shift = np.uint64(8 * (p_bytes - 1 - j))
                        keymat[:, j] = (
                            (pv >> shift) & np.uint64(0xFF)
                        ).astype(np.uint8)
                    cnt = np.zeros(m, np.uint32)
                    for j in range(self.counter_size):
                        cnt |= raw[:, suf_bytes + j].astype(
                            np.uint32
                        ) << np.uint32(8 * j)
                    yield keymat.view(f"S{nb}").ravel(), cnt
                elif self.wide:
                    sh, sl, sc = wide.decode_kmc_records(
                        raw, m, suf_bytes, self.counter_size, bounds_all,
                        lut_size, self.suffix_length, rec_offset=done,
                    )
                    yield (sh, sl), sc
                else:
                    part = decode_kmc_records(
                        raw, m, suf_bytes, self.counter_size, bounds_all,
                        lut_size, self.suffix_length, rec_offset=done,
                    )
                    if part is None:  # no native library
                        part = self._decode_slab_numpy(
                            raw, m, rec, suf_bytes, bounds_all, lut_size,
                            done,
                        )
                    yield part[0], part[1]
                done += m

    def _decode_slab_numpy(self, raw, m, rec, suf_bytes, bounds_all,
                           lut_size, done):
        raw = raw.reshape(m, rec)
        suffix = np.zeros(m, dtype=np.uint64)
        for j in range(suf_bytes):
            suffix = (suffix << np.uint64(8)) | raw[:, j].astype(np.uint64)
        counts = np.zeros(m, dtype=np.uint32)
        for j in range(self.counter_size):
            counts |= raw[:, suf_bytes + j].astype(np.uint32) << np.uint32(
                8 * j
            )
        per_bin = np.diff(bounds_all.astype(np.int64))
        prefixes_all = np.repeat(
            np.arange(len(self.prefix_array), dtype=np.int64) % lut_size,
            per_bin,
        ).astype(np.uint64)[done : done + m]
        return (
            (prefixes_all << np.uint64(2 * self.suffix_length)) | suffix,
            counts,
        )

    def _read_prefix_file(self):
        size = os.path.getsize(self.prefix_file)
        with open(self.prefix_file, "rb") as fh:
            mm = np.memmap(fh, dtype=np.uint8, mode="r")
            (header_offset,) = struct.unpack("<i", bytes(mm[size - 8 : size - 4]))
            hstart = size - header_offset - 8
            hdr = bytes(mm[hstart : hstart + _HEADER_BYTES])
            (
                self.kmer_length,
                self.mode,
                self.counter_size,
                self.lut_prefix_length,
                self.signature_length,
                self.min_count,
                self.max_count,
                self.total_kmers,
            ) = struct.unpack("<7iq", hdr[:36])
            both_strands_byte = hdr[36]
            self.both_strands = both_strands_byte == 0  # per KMC.java:133
            (self.version,) = struct.unpack("<i", hdr[64:68])
            if self.version != 0x200:
                Logger.error(_CLASS, "KMC version is not 0x200")
            if self.kmer_length > 256:
                Logger.error(
                    _CLASS,
                    f"k={self.kmer_length} > 256 exceeds the KMC envelope",
                )
            self.mlimb = self.kmer_length > 64  # byte-record keys
            self.wide = 32 < self.kmer_length <= 64
            self.suffix_length = self.kmer_length - self.lut_prefix_length

            sig_map_size = (1 << (2 * self.signature_length)) + 1
            sig_map_start = hstart - sig_map_size * 4
            self.signature_map = (
                np.frombuffer(
                    bytes(mm[sig_map_start : sig_map_start + sig_map_size * 4]),
                    dtype="<u4",
                )
            )
            lut_size = 1 << (2 * self.lut_prefix_length)
            n_luts = (sig_map_start - 8 - 4) // (lut_size * 8)
            self.n_prefix_arrays = n_luts
            self.prefix_array = np.frombuffer(
                bytes(mm[4 : 4 + n_luts * lut_size * 8]), dtype="<u8"
            )

    # records per ingest slab: bounds transient memory to ~slab*rec bytes
    # on top of the decoded output arrays (wheat-scale DBs don't fit twice)
    _SLAB_RECORDS = 1 << 26

    def _read_records(self):
        suf_bytes = self.suffix_length // 4
        rec = suf_bytes + self.counter_size
        n = self.total_kmers

        from ..native import decode_kmc_records, get_lib, wide

        lut_size = 1 << (2 * self.lut_prefix_length)
        bounds_all = np.append(self.prefix_array, np.uint64(n))
        if (np.diff(bounds_all.astype(np.int64)) < 0).any():
            Logger.error(_CLASS, f"Corrupt prefix array in {self.prefix_file}")

        if self.mlimb:
            self._read_records_mlimb(suf_bytes, rec, n, bounds_all, lut_size)
            return
        if get_lib() is not None:
            # slab-streamed native decode against the absolute bin
            # boundaries; the decoder (threaded) maps slab records to
            # absolute indices via rec_offset
            if self.wide:
                self.kmers = None
                self.kmers_hi = np.empty(n, np.uint64)
                self.kmers_lo = np.empty(n, np.uint64)
            else:
                self.kmers = np.empty(n, np.uint64)
            self.counts = np.empty(n, np.uint32)
            with open(self.suffix_file, "rb") as fh:
                fh.seek(4)
                done = 0
                while done < n:
                    m = min(self._SLAB_RECORDS, n - done)
                    raw = np.fromfile(fh, dtype=np.uint8, count=m * rec)
                    if raw.shape[0] < m * rec:
                        Logger.error(
                            _CLASS, f"Truncated suffix file: {self.suffix_file}"
                        )
                    if self.wide:
                        sh, sl, sc = wide.decode_kmc_records(
                            raw, m, suf_bytes, self.counter_size, bounds_all,
                            lut_size, self.suffix_length, rec_offset=done,
                        )
                        self.kmers_hi[done : done + m] = sh
                        self.kmers_lo[done : done + m] = sl
                        self.counts[done : done + m] = sc
                    else:
                        part = decode_kmc_records(
                            raw, m, suf_bytes, self.counter_size, bounds_all,
                            lut_size, self.suffix_length, rec_offset=done,
                        )
                        self.kmers[done : done + m] = part[0]
                        self.counts[done : done + m] = part[1]
                    done += m
            return

        with open(self.suffix_file, "rb") as fh:
            raw = np.fromfile(fh, dtype=np.uint8, offset=4, count=n * rec)
        if raw.shape[0] < n * rec:
            Logger.error(_CLASS, f"Truncated suffix file: {self.suffix_file}")
        if self.wide:
            self.kmers_hi, self.kmers_lo, self.counts = wide.decode_kmc_records(
                raw, n, suf_bytes, self.counter_size, bounds_all, lut_size,
                self.suffix_length,
            )
            self.kmers = None
            return
        # numpy fallback
        raw = raw.reshape(n, rec)
        # suffix: bytes hold 4 bases each, first base in the top 2 bits
        suffix = np.zeros(n, dtype=np.uint64)
        for j in range(suf_bytes):
            suffix = (suffix << np.uint64(8)) | raw[:, j].astype(np.uint64)
        # counter: little-endian 1..4 bytes
        counts = np.zeros(n, dtype=np.uint32)
        for j in range(self.counter_size):
            counts |= raw[:, suf_bytes + j].astype(np.uint32) << np.uint32(8 * j)

        # prefix of each record from the LUT-array bin boundaries
        bounds = bounds_all.astype(np.int64)
        per_bin = np.diff(bounds)
        if (per_bin < 0).any():
            Logger.error(_CLASS, f"Corrupt prefix array in {self.prefix_file}")
        prefixes = np.repeat(
            np.arange(len(self.prefix_array), dtype=np.int64) % lut_size, per_bin
        ).astype(np.uint64)
        if prefixes.shape[0] != n:
            Logger.error(_CLASS, "Prefix array does not cover all records")

        self.kmers = (prefixes << np.uint64(2 * self.suffix_length)) | suffix
        self.counts = counts

    def _read_records_mlimb(self, suf_bytes, rec, n, bounds_all, lut_size):
        """k > 64: decode records into big-endian S{nb} byte keys (see
        engine/encode_mlimb.py). The record's suffix bytes ARE the low
        key bytes; the prefix (lut_prefix_length bases) fills the high
        bytes - (pad + lut_len) is always a whole number of bytes
        because the suffix is whole bytes."""
        from ..engine.encode_mlimb import n_bytes

        k = self.kmer_length
        nb = n_bytes(k)
        p_bytes = nb - suf_bytes
        keymat = np.empty((n, nb), np.uint8)
        self.counts = np.empty(n, np.uint32)
        per_bin = np.diff(bounds_all.astype(np.int64))
        prefixes_all = np.repeat(
            np.arange(len(self.prefix_array), dtype=np.int64) % lut_size,
            per_bin,
        ).astype(np.uint64)
        if prefixes_all.shape[0] != n:
            Logger.error(_CLASS, "Prefix array does not cover all records")
        with open(self.suffix_file, "rb") as fh:
            fh.seek(4)
            done = 0
            while done < n:
                m = min(self._SLAB_RECORDS, n - done)
                raw = np.fromfile(fh, dtype=np.uint8, count=m * rec)
                if raw.shape[0] < m * rec:
                    Logger.error(
                        _CLASS, f"Truncated suffix file: {self.suffix_file}"
                    )
                raw = raw.reshape(m, rec)
                keymat[done : done + m, p_bytes:] = raw[:, :suf_bytes]
                pv = prefixes_all[done : done + m]
                for j in range(p_bytes):
                    shift = np.uint64(8 * (p_bytes - 1 - j))
                    keymat[done : done + m, j] = (
                        (pv >> shift) & np.uint64(0xFF)
                    ).astype(np.uint8)
                cnt = np.zeros(m, np.uint32)
                for j in range(self.counter_size):
                    cnt |= raw[:, suf_bytes + j].astype(np.uint32) << np.uint32(
                        8 * j
                    )
                self.counts[done : done + m] = cnt
                done += m
        self.kmers = None
        self.kmers_bytes = keymat.view(f"S{nb}").ravel()

    def print_summary(self):
        rows = [
            ("KMC prefix file", self.prefix_file),
            ("KMC suffix file", self.suffix_file),
            ("Kmer length", self.kmer_length),
            ("Mode", self.mode),
            ("Counter size", self.counter_size),
            ("LUT prefix length", self.lut_prefix_length),
            ("Signature length", self.signature_length),
            ("Min count", self.min_count),
            ("Max count", self.max_count),
            ("Total kmers", self.total_kmers),
            ("Both strands", self.both_strands),
        ]
        Logger.info(_CLASS, "==================== KMC INFO ====================")
        for k, v in rows:
            Logger.info(_CLASS, f"{k:<25}: {v}")
        Logger.info(_CLASS, "==================================================")


def choose_lut_prefix_length(k: int) -> int:
    """Smallest lut length >= 1 with (k - lut) % 4 == 0 (KMC stores whole
    suffix bytes)."""
    for lut in range(1, k):
        if (k - lut) % 4 == 0:
            return lut
    return k  # degenerate tiny k


def sorted_cache_path(db_prefix: str, k: int) -> str:
    return f"{db_prefix}.kcfsorted.k{k}.npz"


def load_sorted_cache(db_prefix: str, k: int):
    """Staleness-checked sorted-key sidecar for a KMC database (the
    same caching pattern as .faidx / .kcfidx: the reference regenerates
    its index sidecars on staleness, FastaIndex.java:31-36). Returns
    (keys, counts) - keys uint64 for k <= 32, an (hi, lo) pair for
    33..64 - or None when absent/stale. The cache spares every later
    run the KMC-record decode + radix sort, the dominant per-sample
    ingest cost. A hit adds 0 to the stage timer's ``sidecar_built``."""
    path = sorted_cache_path(db_prefix, k)
    try:
        m = os.path.getmtime(path)
        # '<=' (not '<'): a DB regenerated within the filesystem's
        # timestamp granularity of the sidecar write must re-sort - the
        # safe direction. The stored .kmc_pre/.kmc_suf sizes are a cheap
        # content fingerprint for the same window.
        if m <= os.path.getmtime(db_prefix + ".kmc_pre") or m <= (
            os.path.getmtime(db_prefix + ".kmc_suf")
        ):
            return None
        with np.load(path) as z:
            if int(z["format_version"][0]) != 1:
                return None
            if "src_sizes" in z:
                sizes = (
                    os.path.getsize(db_prefix + ".kmc_pre"),
                    os.path.getsize(db_prefix + ".kmc_suf"),
                )
                if tuple(z["src_sizes"]) != sizes:
                    return None
            counts = z["counts"]
            keys = ((z["keys_hi"], z["keys_lo"]) if "keys_hi" in z
                    else z["keys"])
        count("sidecar_built", 0)
        return keys, counts
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None


def save_sorted_cache(db_prefix: str, k: int, keys, counts) -> None:
    """Best-effort atomic write of the sorted-key sidecar; a written one
    adds 1 to the stage timer's ``sidecar_built``."""
    path = sorted_cache_path(db_prefix, k)
    payload = {"format_version": np.array([1]),
               "counts": np.asarray(counts, np.uint32)}
    try:
        payload["src_sizes"] = np.array(
            [os.path.getsize(db_prefix + ".kmc_pre"),
             os.path.getsize(db_prefix + ".kmc_suf")], np.int64)
    except OSError:
        pass
    if isinstance(keys, tuple):
        payload["keys_hi"] = keys[0]
        payload["keys_lo"] = keys[1]
    else:
        payload["keys"] = keys
    try:
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, path)
        count("sidecar_built", 1)
    except OSError as e:
        Logger.warning(_CLASS, f"Could not cache sorted DB at {path}: {e}")


def write_kmc_db(
    db_prefix: str,
    kmers: np.ndarray,
    counts: np.ndarray,
    k: int,
    sig_len: int = 9,
    lut_len: int | None = None,
    counter_size: int = 4,
    both_strands: bool = True,
    min_count: int = 1,
    max_count: int = 1_000_000_000,
    mode: int = 0,
):
    """Write a KMC3-format database readable by both this package and the
    reference Java implementation.

    ``kmers`` must be unique packed k-mers (canonical if both_strands):
    a uint64 array for k <= 32, or a (hi, lo) tuple of 128-bit value
    limbs for 32 < k <= 64.
    """
    if isinstance(kmers, tuple):
        return _write_kmc_db_wide(
            db_prefix, kmers[0], kmers[1], counts, k, sig_len, lut_len,
            counter_size, both_strands, min_count, max_count, mode,
        )
    if getattr(np.asarray(kmers).dtype, "kind", None) == "S":
        return _write_kmc_db_mlimb(
            db_prefix, np.asarray(kmers), counts, k, sig_len, lut_len,
            counter_size, both_strands, min_count, max_count, mode,
        )
    kmers = np.asarray(kmers, dtype=np.uint64)
    counts = np.asarray(counts)
    if lut_len is None:
        lut_len = choose_lut_prefix_length(k)
    suffix_len = k - lut_len
    if suffix_len % 4 != 0:
        raise ValueError("k - lut_prefix_length must be divisible by 4")
    n = kmers.shape[0]

    sigs = (
        kmer_signatures(kmers, k, sig_len)
        if n
        else np.empty(0, np.uint32)
    )
    uniq_sigs = np.unique(sigs)
    nbins = max(1, len(uniq_sigs))
    sig_map = np.zeros((1 << (2 * sig_len)) + 1, dtype=np.uint32)
    sig_map[uniq_sigs.astype(np.int64)] = np.arange(len(uniq_sigs), dtype=np.uint32)

    bins = sig_map[sigs.astype(np.int64)] if n else np.empty(0, np.uint32)
    del sigs
    kmers_s, counts_s, bins_s = _bin_sort(kmers, counts, bins, n)
    del kmers, counts, bins

    lut_size = 1 << (2 * lut_len)
    keys = _bin_major_keys(bins_s, kmers_s, suffix_len, lut_size, nbins)
    prefix_array = np.searchsorted(
        keys, np.arange(nbins * lut_size, dtype=keys.dtype)
    ).astype("<u8")
    del keys, bins_s

    _emit_kmc_files_streamed(
        db_prefix, prefix_array, sig_map, kmers_s, counts_s, suffix_len,
        n, k, mode, counter_size, lut_len, sig_len, min_count, max_count,
        both_strands,
    )


def _bin_major_keys(bins_s, kmers_s, suffix_len, lut_size, nbins):
    """The records' bin-major keys, bin * lut_size + lut prefix. uint32
    while nbins * lut_size < 2^32 (the default lut and signature
    lengths), uint64 past it, where uint32 keys would wrap (the wide
    writers' keys are uint64 throughout). Filled in chunks, so the
    multi-Gbp writer's temporaries stay bounded."""
    dt = np.uint32 if nbins * lut_size < 1 << 32 else np.uint64
    n = kmers_s.shape[0]
    keys = np.empty(n, dt)
    _CH = 1 << 26
    for i in range(0, n, _CH):
        j = min(n, i + _CH)
        keys[i:j] = bins_s[i:j].astype(dt, copy=False) * dt(lut_size) + (
            kmers_s[i:j] >> np.uint64(2 * suffix_len)
        ).astype(dt)
    return keys


_BIG_SORT_MIN = 1 << 26  # records below this keep the np.lexsort path


def _bin_sort(kmers, counts, bins, n):
    """(kmers, counts, bins) sorted bin-major, kmer-minor.

    Large ALREADY-SORTED key sets (the np.unique / sort_unique_u64
    output every caller produces) skip np.lexsort: a stable native LSD
    radix pass over the composite (bin << 32 | index) key yields the
    bin-major order directly - the difference between minutes and hours
    when writing multi-Gbp databases (3G-key wheat-scale samples)."""
    from ..native import get_lib, sort_pairs

    big = n >= _BIG_SORT_MIN and n < (1 << 32) and get_lib() is not None
    if big:
        ch = 1 << 25
        is_sorted = all(
            bool((kmers[max(i - 1, 0) : min(n, i + ch)][1:]
                  >= kmers[max(i - 1, 0) : min(n, i + ch)][:-1]).all())
            for i in range(0, n, ch)
        )
        if is_sorted:
            # chunked stable counting sort by bin: within a bin the
            # already-sorted kmer order is preserved, temporaries stay
            # chunk-sized, and no 3G-element radix scratch is ever
            # allocated (wheat-scale writes would otherwise spike the
            # host by an extra ~36 GB)
            nbins_tot = int(bins.max()) + 1 if n else 1
            offsets = np.zeros(nbins_tot, np.int64)
            for i in range(0, n, ch):
                j = min(n, i + ch)
                offsets += np.bincount(bins[i:j], minlength=nbins_tot)
            offsets = np.concatenate(([0], np.cumsum(offsets)[:-1]))
            kmers_s = np.empty(n, np.uint64)
            counts_s = np.empty(n, counts.dtype)
            bins_s = np.empty(n, np.uint32)
            for i in range(0, n, ch):
                j = min(n, i + ch)
                cb = bins[i:j]
                # stable grouping within the chunk via one small radix
                comp = (cb.astype(np.uint64) << np.uint64(25)) | (
                    np.arange(j - i, dtype=np.uint64)
                )
                comp_s, _ = sort_pairs(
                    comp, np.empty(j - i, np.uint32)
                )
                loc = (comp_s & np.uint64((1 << 25) - 1)).astype(np.int64)
                gbins = (comp_s >> np.uint64(25)).astype(np.uint32)
                starts = np.flatnonzero(
                    np.concatenate(([True], gbins[1:] != gbins[:-1]))
                )
                grp = np.zeros(j - i, np.int64)
                grp[starts[1:]] = 1
                grp = np.cumsum(grp)
                rank = np.arange(j - i) - starts[grp]
                pos = offsets[gbins] + rank
                kmers_s[pos] = kmers[i:j][loc]
                counts_s[pos] = counts[i:j][loc]
                bins_s[pos] = gbins
                offsets += np.bincount(cb, minlength=nbins_tot)
            return kmers_s, counts_s, bins_s
    order = np.lexsort((kmers, bins))
    return kmers[order], np.asarray(counts, np.uint64)[order], bins[order]


def _emit_kmc_files_streamed(db_prefix, prefix_array, sig_map, kmers_s,
                             counts_s, suffix_len, n, k, mode,
                             counter_size, lut_len, sig_len, min_count,
                             max_count, both_strands):
    """Emit .kmc_pre / .kmc_suf with the suffix records packed and
    written in bounded chunks (a flat record matrix for 3G keys would
    be another ~27 GB resident)."""
    header = struct.pack(
        "<7iq", k, mode, counter_size, lut_len, sig_len, min_count,
        max_count, n,
    )
    header += bytes([0 if both_strands else 1, 0, 0, 0])
    header += b"\x00" * 24
    header += struct.pack("<i", 0x200)
    assert len(header) == _HEADER_BYTES

    with open(db_prefix + ".kmc_pre", "wb") as fh:
        fh.write(b"KMCP")
        fh.write(prefix_array.tobytes())
        fh.write(struct.pack("<q", n))  # guard
        fh.write(sig_map.astype("<u4").tobytes())
        fh.write(header)
        fh.write(struct.pack("<i", _HEADER_BYTES))
        fh.write(b"KMCP")

    suf_bytes = suffix_len // 4
    suf_mask = np.uint64((1 << (2 * suffix_len)) - 1)
    _CH = 1 << 26
    with open(db_prefix + ".kmc_suf", "wb") as fh:
        fh.write(b"KMCS")
        for i in range(0, n, _CH):
            j = min(n, i + _CH)
            suffix_vals = kmers_s[i:j] & suf_mask
            cnt = counts_s[i:j]
            rec = np.zeros((j - i, suf_bytes + counter_size), np.uint8)
            for b in range(suf_bytes):
                shift = np.uint64(8 * (suf_bytes - 1 - b))
                rec[:, b] = (suffix_vals >> shift) & np.uint64(0xFF)
            for b in range(counter_size):
                rec[:, suf_bytes + b] = (
                    cnt >> cnt.dtype.type(8 * b)
                ).astype(np.uint8)
            fh.write(rec.tobytes())
        fh.write(b"KMCS")


def _emit_kmc_files(db_prefix, prefix_array, sig_map, rec, n, k, mode,
                    counter_size, lut_len, sig_len, min_count, max_count,
                    both_strands):
    header = struct.pack(
        "<7iq", k, mode, counter_size, lut_len, sig_len, min_count,
        max_count, n,
    )
    header += bytes([0 if both_strands else 1, 0, 0, 0])
    header += b"\x00" * 24
    header += struct.pack("<i", 0x200)
    assert len(header) == _HEADER_BYTES

    with open(db_prefix + ".kmc_pre", "wb") as fh:
        fh.write(b"KMCP")
        fh.write(prefix_array.tobytes())
        fh.write(struct.pack("<q", n))  # guard
        fh.write(sig_map.astype("<u4").tobytes())
        fh.write(header)
        fh.write(struct.pack("<i", _HEADER_BYTES))
        fh.write(b"KMCP")

    with open(db_prefix + ".kmc_suf", "wb") as fh:
        fh.write(b"KMCS")
        fh.write(rec.tobytes())
        fh.write(b"KMCS")


def _write_kmc_db_wide(db_prefix, khi, klo, counts, k, sig_len, lut_len,
                       counter_size, both_strands, min_count, max_count,
                       mode):
    """Wide-k (33..64) database writer; kmers as 128-bit value limbs."""
    from ..native import wide

    khi = np.asarray(khi, np.uint64)
    klo = np.asarray(klo, np.uint64)
    counts = np.asarray(counts, np.uint64)
    if lut_len is None:
        lut_len = choose_lut_prefix_length(k)
    suffix_len = k - lut_len
    if suffix_len % 4 != 0:
        raise ValueError("k - lut_prefix_length must be divisible by 4")
    n = khi.shape[0]

    norm = _build_norm(sig_len)
    sigs = wide.signatures(khi, klo, k, sig_len, norm) if n else np.empty(0, np.uint32)
    uniq_sigs = np.unique(sigs)
    nbins = max(1, len(uniq_sigs))
    sig_map = np.zeros((1 << (2 * sig_len)) + 1, dtype=np.uint32)
    sig_map[uniq_sigs.astype(np.int64)] = np.arange(len(uniq_sigs), dtype=np.uint32)
    bin_of_sig = {int(s): i for i, s in enumerate(uniq_sigs)}
    bins = (
        np.array([bin_of_sig[int(s)] for s in sigs], dtype=np.uint64)
        if n
        else np.empty(0, np.uint64)
    )
    order = np.lexsort((klo, khi, bins))
    khi_s, klo_s = khi[order], klo[order]
    counts_s = counts[order]
    bins_s = bins[order]

    lut_size = 1 << (2 * lut_len)
    # prefix = v >> 2*suffix_len; 2*suffix_len >= 64 always for k > 32
    r = 2 * suffix_len
    prefix_of = khi_s >> np.uint64(r - 64)
    keys = bins_s * np.uint64(lut_size) + prefix_of
    prefix_array = np.searchsorted(
        keys, np.arange(nbins * lut_size, dtype=np.uint64)
    ).astype("<u8")

    suf_bytes = suffix_len // 4
    suffixes = wide.suffix_bytes(khi_s, klo_s, suf_bytes)
    rec = np.zeros((n, suf_bytes + counter_size), dtype=np.uint8)
    rec[:, :suf_bytes] = suffixes
    for j in range(counter_size):
        rec[:, suf_bytes + j] = (counts_s >> np.uint64(8 * j)) & np.uint64(0xFF)

    _emit_kmc_files(
        db_prefix, prefix_array, sig_map, rec, n, k, mode, counter_size,
        lut_len, sig_len, min_count, max_count, both_strands,
    )


def _write_kmc_db_mlimb(db_prefix, kmers, counts, k, sig_len, lut_len,
                        counter_size, both_strands, min_count, max_count,
                        mode):
    """k > 64 database writer; kmers as big-endian S{nb} byte records
    (engine/encode_mlimb.py). The record layout falls out directly: the
    low suffix bytes of each key ARE the stored suffix bytes."""
    from ..engine.encode_mlimb import n_bytes, signatures_bytes

    counts = np.asarray(counts, np.uint64)
    if lut_len is None:
        lut_len = choose_lut_prefix_length(k)
    suffix_len = k - lut_len
    if suffix_len % 4 != 0:
        raise ValueError("k - lut_prefix_length must be divisible by 4")
    n = kmers.shape[0]
    nb = n_bytes(k)
    suf_bytes = suffix_len // 4
    p_bytes = nb - suf_bytes

    norm = _build_norm(sig_len)
    sigs = (
        signatures_bytes(kmers, k, sig_len, norm)
        if n
        else np.empty(0, np.uint32)
    )
    uniq_sigs = np.unique(sigs)
    nbins = max(1, len(uniq_sigs))
    sig_map = np.zeros((1 << (2 * sig_len)) + 1, dtype=np.uint32)
    sig_map[uniq_sigs.astype(np.int64)] = np.arange(
        len(uniq_sigs), dtype=np.uint32
    )
    bin_of_sig = {int(s): i for i, s in enumerate(uniq_sigs)}
    bins = (
        np.array([bin_of_sig[int(s)] for s in sigs], dtype=np.uint64)
        if n
        else np.empty(0, np.uint64)
    )
    # (bin, key) order via two stable passes (np.lexsort rejects bytes)
    order = np.argsort(kmers, kind="stable")
    order = order[np.argsort(bins[order], kind="stable")]
    keymat = (
        np.frombuffer(kmers.tobytes(), np.uint8).reshape(n, nb)[order]
        if n
        else np.empty((0, nb), np.uint8)
    )
    counts_s = counts[order]
    bins_s = bins[order]

    lut_size = 1 << (2 * lut_len)
    prefix_of = np.zeros(n, np.uint64)
    for j in range(p_bytes):
        prefix_of = (prefix_of << np.uint64(8)) | keymat[:, j].astype(
            np.uint64
        )
    keys = bins_s * np.uint64(lut_size) + prefix_of
    prefix_array = np.searchsorted(
        keys, np.arange(nbins * lut_size, dtype=np.uint64)
    ).astype("<u8")

    rec = np.zeros((n, suf_bytes + counter_size), dtype=np.uint8)
    rec[:, :suf_bytes] = keymat[:, p_bytes:]
    for j in range(counter_size):
        rec[:, suf_bytes + j] = (counts_s >> np.uint64(8 * j)) & np.uint64(
            0xFF
        )

    _emit_kmc_files(
        db_prefix, prefix_array, sig_map, rec, n, k, mode, counter_size,
        lut_len, sig_len, min_count, max_count, both_strands,
    )
