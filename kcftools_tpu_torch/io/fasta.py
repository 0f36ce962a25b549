"""FASTA random access with a faidx-style sidecar index.

Produces both raw sequence strings (for KCF-compatible code paths) and
2-bit code arrays + validity masks (the engine's native representation).

Index file format and regeneration-on-staleness match the reference
(reference: Data/FastaIndex.java:26-77,239-299): ``<fasta>.faidx`` with
rows ``name\\tlength\\toffset\\tlineBases\\tlineWidth``, one per sequence,
in file order. Unlike the reference (per-line mmap copies under a global
lock, FastaIndex.java:138-179), extraction here is a vectorized gather
over a numpy memmap, so it is both thread-safe and O(bytes).
"""

import gzip
import hashlib
import os

import numpy as np

from ..utils.logger import Logger

_CLASS = "FastaIndex"

_GZ_MAGIC = b"\x1f\x8b"


def is_gzipped(path: str) -> bool:
    """Gzip sniff by magic bytes (reference:
    Utils/HelperFunctions.java:188-199 ``isCompressed``)."""
    with open(path, "rb") as fh:
        return fh.read(2) == _GZ_MAGIC


def _decompress_cache_path(path: str) -> str:
    """Sidecar path for the decompressed copy of a gzipped FASTA.
    Prefer a sibling file (shared across runs, like ``.faidx``); fall
    back to ``~/.cache/kcftools_tpu/fasta`` when the directory is not
    writable."""
    sidecar = path + ".kcfdecomp"
    d = os.path.dirname(os.path.abspath(path)) or "."
    if os.access(d, os.W_OK):
        return sidecar
    cache_dir = os.path.join(
        os.path.expanduser("~"), ".cache", "kcftools_tpu", "fasta"
    )
    os.makedirs(cache_dir, exist_ok=True)
    tag = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:16]
    return os.path.join(cache_dir, tag + ".kcfdecomp")


def ensure_decompressed(path: str) -> str:
    """Return a plain-text path for ``path``: itself when uncompressed,
    else a cached decompressed sidecar (regenerated on staleness).

    Deliberate divergence from the reference, which refuses gzipped
    FASTA outright (Data/FastaIndex.java:239-242); gzipped references
    are ordinary inputs in this domain, so they are transparently
    decompressed once and reused."""
    if not is_gzipped(path):
        return path
    out = _decompress_cache_path(path)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(path):
        Logger.info(_CLASS, f"Using cached decompressed fasta: {out}")
        return out
    Logger.info(_CLASS, f"Decompressing gzipped fasta: {path} -> {out}")
    tmp = out + ".tmp"
    with gzip.open(path, "rb") as src, open(tmp, "wb") as dst:
        while True:
            chunk = src.read(1 << 26)
            if not chunk:
                break
            dst.write(chunk)
    os.replace(tmp, out)
    return out

# base -> 2-bit code (A=0 C=1 G=2 T=3, case-insensitive); invalid -> 0 + mask
_CODE_LUT = np.zeros(256, dtype=np.uint8)
_VALID_LUT = np.zeros(256, dtype=bool)
for _b, _c in zip(b"ACGT", range(4)):
    _CODE_LUT[_b] = _c
    _CODE_LUT[_b + 32] = _c  # lowercase
    _VALID_LUT[_b] = True
    _VALID_LUT[_b + 32] = True

_IUPAC = set(b"ACGTYRWSMKHBVDNacgtyrwsmkhbvdn")


class FastaIndexEntry:
    __slots__ = ("seq_id", "name", "length", "offset", "line_bases", "line_width")

    def __init__(self, seq_id, name, length, offset, line_bases, line_width):
        self.seq_id = seq_id
        self.name = name
        self.length = length
        self.offset = offset
        self.line_bases = line_bases
        self.line_width = line_width


class FastaIndex:
    def __init__(self, fasta_path: str):
        self.source_path = fasta_path
        # gzipped inputs are decompressed once to a cached sidecar; the
        # faidx is keyed to the ORIGINAL path so re-runs find it
        data_path = ensure_decompressed(fasta_path)
        self.fasta_path = data_path
        faidx_path = fasta_path + ".faidx"
        if not os.access(os.path.dirname(os.path.abspath(faidx_path)) or ".",
                         os.W_OK) and data_path != fasta_path:
            faidx_path = data_path + ".faidx"
        if (not os.path.exists(faidx_path)) or (
            os.path.getmtime(faidx_path) < os.path.getmtime(fasta_path)
        ):
            Logger.info(_CLASS, f"Generating/Updating index file: {faidx_path}")
            self._generate_index(data_path, faidx_path)
        else:
            Logger.info(_CLASS, f"Using existing index file: {faidx_path}")

        self.entries = {}
        self.sequence_names = []
        with open(faidx_path) as fh:
            for seq_id, line in enumerate(fh):
                f = line.rstrip("\n").split("\t")
                e = FastaIndexEntry(
                    seq_id, f[0], int(f[1]), int(f[2]), int(f[3]), int(f[4])
                )
                if e.name in self.entries:
                    Logger.error(_CLASS, f"Duplicate sequence name in index: {e.name}")
                self.entries[e.name] = e
                self.sequence_names.append(e.name)
        self._mm = np.memmap(data_path, dtype=np.uint8, mode="r")

    # -- index generation ---------------------------------------------------

    @staticmethod
    def _generate_index(fasta_path: str, faidx_path: str):
        mm = np.memmap(fasta_path, dtype=np.uint8, mode="r")
        n = mm.shape[0]
        if n == 0 or mm[0] != ord(">"):
            Logger.error(_CLASS, f"Invalid fasta file: {fasta_path}")

        # newline positions, chunked to bound memory
        chunk = 1 << 28
        nl_parts = []
        for off in range(0, n, chunk):
            part = np.flatnonzero(mm[off : off + chunk] == 10)
            nl_parts.append(part + off)
        newlines = np.concatenate(nl_parts) if nl_parts else np.empty(0, np.int64)
        line_starts = np.concatenate(([0], newlines + 1))
        if line_starts[-1] >= n:
            line_starts = line_starts[:-1]
        line_ends = np.concatenate((newlines, [n]))[: len(line_starts)]
        first_bytes = mm[line_starts]
        is_header = first_bytes == ord(">")

        rows = []
        header_idx = np.flatnonzero(is_header)
        seen = set()
        for hi_pos, h in enumerate(header_idx):
            hdr = bytes(mm[line_starts[h] + 1 : line_ends[h]]).decode()
            name = hdr.split(" ")[0].split("\t")[0]
            if name in seen:
                Logger.error(_CLASS, f"Duplicate sequence name in fasta file: {name}")
            seen.add(name)
            lo = h + 1
            hi = header_idx[hi_pos + 1] if hi_pos + 1 < len(header_idx) else len(line_starts)
            if lo >= hi:
                rows.append((name, 0, int(line_ends[h]) + 1, 0, 1))
                continue
            seq_line_lens = line_ends[lo:hi] - line_starts[lo:hi]
            seq_len = int(seq_line_lens.sum())
            line_bases = int(seq_line_lens[0])
            # actual on-disk stride of the first sequence line
            stride = (
                int(line_starts[lo + 1] - line_starts[lo])
                if hi > lo + 1
                else line_bases + 1
            )
            rows.append((name, seq_len, int(line_starts[lo]), line_bases, stride))

        # validate characters (vectorized, whole file minus headers/newlines)
        allowed = np.zeros(256, dtype=bool)
        for b in _IUPAC:
            allowed[b] = True
        allowed[10] = True
        allowed[13] = True
        allowed[ord(">")] = True  # header lines are checked structurally
        for off in range(0, n, chunk):
            seg = mm[off : off + chunk]
            bad = ~allowed[seg]
            if bad.any():
                # ignore anything on header lines
                pos = np.flatnonzero(bad) + off
                li = np.searchsorted(line_starts, pos, side="right") - 1
                really_bad = ~is_header[li]
                if really_bad.any():
                    p = int(pos[really_bad][0])
                    Logger.error(
                        _CLASS,
                        f"Invalid character '{chr(mm[p])}' in fasta file: {fasta_path}",
                    )

        with open(faidx_path, "w") as out:
            for name, seq_len, offset, line_bases, line_width in rows:
                out.write(f"{name}\t{seq_len}\t{offset}\t{line_bases}\t{line_width}\n")

    # -- queries ------------------------------------------------------------

    def get_entry(self, name):
        return self.entries.get(name)

    def __len__(self):
        return len(self.sequence_names)

    def get_sequence_names(self):
        return list(self.sequence_names)

    def get_sequence_length(self, name) -> int:
        e = self.get_entry(name)
        if e is None:
            Logger.error(_CLASS, f"Sequence not found in index: {name}")
        return e.length

    def _gather_bytes(self, e: FastaIndexEntry, start: int, length: int) -> np.ndarray:
        end = start + length
        if start < 0 or end > e.length or start >= end:
            Logger.error(
                _CLASS, f"Invalid range: {start}-{end} for sequence: {e.name}"
            )
        if e.line_bases == 0:
            return np.empty(0, np.uint8)
        lb, lw = e.line_bases, e.line_width
        first_line = start // lb
        last_line = (end - 1) // lb
        lo = e.offset + first_line * lw
        hi = min(e.offset + last_line * lw + lw, self._mm.shape[0])
        raw = np.asarray(self._mm[lo:hi])
        n_lines = last_line - first_line + 1
        if raw.shape[0] >= n_lines * lw:
            # whole lines available: strip line terminators via reshape
            seq = raw[: n_lines * lw].reshape(n_lines, lw)[:, :lb].reshape(-1)
        else:
            # ragged tail (last line short): reshape what we can, append rest
            full = raw.shape[0] // lw
            head = raw[: full * lw].reshape(full, lw)[:, :lb].reshape(-1)
            tail = raw[full * lw :][:lb]
            seq = np.concatenate([head, tail])
        s0 = start - first_line * lb
        return seq[s0 : s0 + length]

    def get_sequence_bytes(self, name, start=None, length=None) -> np.ndarray:
        e = self.get_entry(name)
        if e is None:
            Logger.error(_CLASS, f"Sequence not found in index: {name}")
        if start is None:
            start, length = 0, e.length
        return self._gather_bytes(e, start, length)

    def get_sequence(self, name, start=None, length=None) -> str:
        return bytes(self.get_sequence_bytes(name, start, length)).decode("ascii")

    def sequence_codes(self, name, start=None, length=None):
        """Return (codes uint8 in 0..3, valid bool) for a subsequence."""
        raw = self.get_sequence_bytes(name, start, length)
        return _CODE_LUT[raw], _VALID_LUT[raw]

    def close(self):
        self._mm = None


def fold_seq(seq: str, length: int = 60) -> str:
    """Fold a sequence to fixed-width lines, trailing newline included
    (reference: Utils/HelperFunctions.fold_seq :204-211)."""
    return "".join(seq[i : i + length] + "\n" for i in range(0, len(seq), length))


def write_fasta_records(path: str, records, fold: int = 60):
    """records: iterable of (name, description, sequence)."""
    with open(path, "w") as fh:
        for name, desc, seq in records:
            fh.write(f">{name} {desc}\n")
            fh.write(fold_seq(seq, fold))


def codes_from_bytes(raw: np.ndarray):
    """2-bit encode a raw byte sequence -> (codes, valid)."""
    raw = np.asarray(raw, dtype=np.uint8)
    return _CODE_LUT[raw], _VALID_LUT[raw]


def codes_from_str(seq: str):
    return codes_from_bytes(np.frombuffer(seq.encode("ascii"), dtype=np.uint8))
