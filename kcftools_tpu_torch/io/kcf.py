"""KCF text format: header model, columnar window blocks, reader/writer.

Format contract (reference: Data/KCFHeader.java:291-330, Data/Window.java
:125-152, Data/Data.java:120-132, Utils/Configs.java:14-37):

  ##format=KCF<version> / ##date= / ##source= / ##reference=
  ##contig=<ID=name,length=N>          (FASTA order)
  ##INFO=... (10 fixed lines)  ##FORMAT=... (8 fixed lines)
  ##PARAM=<ID=key,value=v>             (window step kmer IBS nwindow wti wtt wtk)
  ##CMD=...
  #CHROM START END ID TOTAL_KMERS INFO FORMAT sample...

Row INFO = EFFLEN;IS;XS;MS;IO;XO;MO;IV;XV;MV with Java float/double
formatting semantics; FORMAT = GT:VA:OB:ID:LD:RD:KD:SC; per-sample field
is colon-joined with %.2f for KD/SC.

Unlike the reference's per-window object model, windows live in columnar
numpy arrays (a "block"): every transform (cohort, findIBS, score recalc,
genotype thresholding...) is a vectorized array op. Scores are always
*recomputed* from the integer fields at read time exactly as the
reference does (Window.java:57-83 -> Data.computeScore), with k-mer count
sums reconstituted as round(meanKmerCount*observedKmers) (Window.java:70).
"""

import datetime

import numpy as np

from .. import __version__, KCF_SOURCE
from ..utils import javafmt
from ..utils.logger import Logger

_CLASS = "KCF"

INFO_LINES = [
    '<ID=EFFLEN,Type=Integer,Description="Effective length of the window">',
    '<ID=IS,Type=Float,Description="Minimum score for the window">',
    '<ID=XS,Type=Float,Description="Maximum score for the window">',
    '<ID=MS,Type=Float,Description="Mean score for the window">',
    '<ID=IO,Type=Integer,Description="Minimum observed kmers in the window">',
    '<ID=XO,Type=Integer,Description="Maximum observed kmers in the window">',
    '<ID=MO,Type=Integer,Description="Mean observed kmers in the window">',
    '<ID=IV,Type=Integer,Description="Minimum variations in the window">',
    '<ID=XV,Type=Integer,Description="Maximum variations in the window">',
    '<ID=MV,Type=Integer,Description="Mean variations in the window">',
]

FORMAT_LINES = [
    '<ID=IB,Type=Integer,Description="IBS number">',
    '<ID=VA,Type=Integer,Description="Variations">',
    '<ID=OB,Type=Integer,Description="Observed kmers">',
    '<ID=ID,Type=Integer,Description="Inner Distance">',
    '<ID=LD,Type=Integer,Description="Kmer Variation Distance at the leftTail">',
    '<ID=RD,Type=Integer,Description="Kmer Variation Distance at the rightTail">',
    '<ID=KD,Type=Float,Description="Mean Kmer Depth">',
    '<ID=SC,Type=Float,Description="Score">',
]

PARAM_ORDER = ["window", "step", "kmer", "IBS", "nwindow", "wti", "wtt", "wtk"]


def java_round(x):
    """Java Math.round(double): floor(x + 0.5) as int64."""
    return np.floor(np.asarray(x, dtype=np.float64) + 0.5).astype(np.int64)


def compute_scores(ob, total, eff, inner, tail, weights):
    """Identity score, elementwise, with the reference's exact double-op
    order (Data/Data.java:95-107). ``total``/``eff`` broadcast against
    ``ob``-shaped arrays. Weights are (wi, wt, wr) and must sum to 1.0
    under left-to-right double addition, as the reference requires."""
    wi, wt, wr = (float(w) for w in weights)
    if wi + wt + wr != 1.0:
        Logger.error(_CLASS, "Weights should sum to 1.0")
    ob = np.asarray(ob, dtype=np.float64)
    total = np.asarray(total, dtype=np.float64)
    eff = np.asarray(eff, dtype=np.float64)
    inner = np.asarray(inner, dtype=np.float64)
    tail = np.asarray(tail, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = wr * (ob / total)
        b = wi * (1.0 - inner / eff)
        c = wt * (1.0 - tail / eff)
        s = ((a + b) + c) * 100.0
    zero = (ob == 0) | (total == 0) | (eff == 0)
    return np.where(zero, 0.0, s)


class KCFHeader:
    def __init__(self):
        self.version = __version__
        self.source = KCF_SOURCE
        self.date = datetime.date.today().isoformat()
        self.reference = ""
        self.contigs = []  # list of (name, length), insertion order
        self._contig_ids = {}
        self.command_lines = []
        self.samples = []
        self.params = {}  # key -> string value

    # -- parse --------------------------------------------------------------

    @classmethod
    def parse(cls, header_text: str) -> "KCFHeader":
        h = cls()
        for line in header_text.split("\n"):
            if line.startswith("##reference="):
                h.reference = line[12:]
            elif line.startswith("##contig="):
                body = line[10:-1]  # strip '##contig=<' and '>'
                parts = body.split(",")
                h.add_contig(parts[0][3:], int(parts[1][7:]))
            elif line.startswith("##CMD="):
                h.command_lines.append(line[6:])
            elif line.startswith("##PARAM="):
                body = line[9:-1]
                parts = body.split(",")
                key = parts[0][3:]
                value = parts[1][6:]
                if key in PARAM_ORDER:
                    h.params[key] = value
            elif line.startswith("#CHROM"):
                fields = line.split("\t")
                h.samples = fields[7:]
        return h

    # -- typed accessors ----------------------------------------------------

    def _int_param(self, key):
        return int(self.params[key]) if key in self.params else 0

    def _dbl_param(self, key):
        return float(self.params[key]) if key in self.params else 0.0

    @property
    def window_size(self):
        return self._int_param("window")

    @window_size.setter
    def window_size(self, v):
        self.params["window"] = str(int(v))

    @property
    def step_size(self):
        return self._int_param("step")

    @step_size.setter
    def step_size(self, v):
        self.params["step"] = str(int(v))

    @property
    def kmer_size(self):
        return self._int_param("kmer")

    @kmer_size.setter
    def kmer_size(self, v):
        self.params["kmer"] = str(int(v))

    @property
    def is_ibs(self):
        return self.params.get("IBS", "false") == "true"

    @is_ibs.setter
    def is_ibs(self, v):
        self.params["IBS"] = "true" if v else "false"

    @property
    def window_count(self):
        return self._int_param("nwindow")

    @window_count.setter
    def window_count(self, v):
        self.params["nwindow"] = str(int(v))

    def set_weights(self, wi, wt, wr):
        self.params["wti"] = javafmt.dbl(wi)
        self.params["wtt"] = javafmt.dbl(wt)
        self.params["wtk"] = javafmt.dbl(wr)

    @property
    def weights(self):
        """(wi, wt, wr) per reference KCFHeader.getWeights (:451-453)."""
        return (
            self._dbl_param("wti"),
            self._dbl_param("wtt"),
            self._dbl_param("wtk"),
        )

    # -- contigs ------------------------------------------------------------

    def add_contig(self, name, length):
        if name not in self._contig_ids:
            self._contig_ids[name] = len(self.contigs)
            self.contigs.append((name, int(length)))

    def get_contig_id(self, name) -> int:
        if name not in self._contig_ids:
            Logger.error(_CLASS, f"Contig {name} not found in the KCF header")
        return self._contig_ids[name]

    def add_sample(self, name):
        self.samples.append(name)

    def add_command_line(self, cmd):
        self.command_lines.append(cmd)

    def has_sample(self, name):
        return name in self.samples

    # -- emit ---------------------------------------------------------------

    def to_string(self) -> str:
        out = [
            f"##format=KCF{self.version}",
            f"##date={self.date}",
            f"##source={self.source}",
            f"##reference={self.reference}",
        ]
        for name, length in self.contigs:
            out.append(f"##contig=<ID={name},length={length}>")
        for line in INFO_LINES:
            out.append(f"##INFO={line}")
        for line in FORMAT_LINES:
            out.append(f"##FORMAT={line}")
        for key in PARAM_ORDER:
            if key in self.params:
                out.append(f"##PARAM=<ID={key},value={self.params[key]}>")
        for cmd in self.command_lines:
            out.append(f"##CMD={cmd}")
        chrom = "#CHROM\tSTART\tEND\tID\tTOTAL_KMERS\tINFO\tFORMAT"
        if self.samples:
            chrom += "\t" + "\t".join(self.samples)
        out.append(chrom)
        return "\n".join(out) + "\n"

    # -- compatibility ------------------------------------------------------

    def check_compatible(self, other: "KCFHeader"):
        """Fatal on mismatch, mirroring KCFHeader.equals (:333-370)."""
        checks = [
            (self.window_size != other.window_size, "Window size"),
            (self.kmer_size != other.kmer_size, "Kmer size"),
            (self.is_ibs != other.is_ibs, "IBS processing"),
            (self.window_count != other.window_count, "Number of windows"),
            (self._dbl_param("wti") != other._dbl_param("wti"), "Weight Inner Distance"),
            (self._dbl_param("wtt") != other._dbl_param("wtt"), "Weight Tail Distance"),
            (self._dbl_param("wtk") != other._dbl_param("wtk"), "Weight Kmer Ratio"),
            (self.step_size != other.step_size, "Step size"),
        ]
        for bad, what in checks:
            if bad:
                Logger.error(_CLASS, f"{what} mismatch between the KCFs")

    def merge(self, other: "KCFHeader"):
        self.check_compatible(other)
        self.samples.extend(other.samples)
        self.command_lines.extend(other.command_lines)


class WindowBlock:
    """Columnar batch of KCF windows.

    Window-level arrays have shape (N,); per-sample arrays (S, N) in the
    sample order of ``samples``.
    """

    __slots__ = (
        "seq_names",
        "start",
        "end",
        "window_id",
        "total_kmers",
        "eff_length",
        "samples",
        "present",
        "ibs",
        "va",
        "ob",
        "inner",
        "left",
        "right",
        "kmer_count",
        "score",
        "mean_kd",
    )

    def __init__(self, n, samples):
        s = len(samples)
        self.seq_names = [None] * n
        self.start = np.zeros(n, np.int64)
        self.end = np.zeros(n, np.int64)
        self.window_id = [None] * n
        self.total_kmers = np.zeros(n, np.int64)
        self.eff_length = np.zeros(n, np.int64)
        self.samples = list(samples)
        self.present = np.ones((s, n), bool)
        self.ibs = np.full((s, n), -1, np.int64)
        self.va = np.zeros((s, n), np.int64)
        self.ob = np.zeros((s, n), np.int64)
        self.inner = np.zeros((s, n), np.int64)
        self.left = np.zeros((s, n), np.int64)
        self.right = np.zeros((s, n), np.int64)
        self.kmer_count = np.zeros((s, n), np.int64)
        self.score = np.zeros((s, n), np.float64)
        self.mean_kd = np.zeros((s, n), np.float64)

    def __len__(self):
        return len(self.start)

    @property
    def n_samples(self):
        return len(self.samples)

    @property
    def tail(self):
        return self.left + self.right

    def finalize(self, weights):
        """Recompute mean_kd and score from the integer fields (the
        reference does this on every read and on addData)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            self.mean_kd = np.where(
                self.kmer_count > 0, self.kmer_count / np.maximum(self.ob, 1), 0.0
            )
        self.score = compute_scores(
            self.ob,
            self.total_kmers[None, :],
            self.eff_length[None, :],
            self.inner,
            self.tail,
            weights,
        )

    def recalc_scores(self, weights):
        self.score = compute_scores(
            self.ob,
            self.total_kmers[None, :],
            self.eff_length[None, :],
            self.inner,
            self.tail,
            weights,
        )

    def select(self, idx):
        """Return a new block with windows at ``idx`` (array of indices)."""
        idx = np.asarray(idx)
        out = WindowBlock(0, self.samples)
        out.seq_names = [self.seq_names[i] for i in idx]
        out.window_id = [self.window_id[i] for i in idx]
        for name in (
            "start",
            "end",
            "total_kmers",
            "eff_length",
        ):
            setattr(out, name, getattr(self, name)[idx])
        for name in (
            "present",
            "ibs",
            "va",
            "ob",
            "inner",
            "left",
            "right",
            "kmer_count",
            "score",
            "mean_kd",
        ):
            setattr(out, name, getattr(self, name)[:, idx])
        return out

    @staticmethod
    def concat(blocks):
        blocks = [b for b in blocks if len(b) > 0]
        if not blocks:
            raise ValueError("no blocks")
        samples = blocks[0].samples
        out = WindowBlock(0, samples)
        out.seq_names = sum((b.seq_names for b in blocks), [])
        out.window_id = sum((b.window_id for b in blocks), [])
        for name in ("start", "end", "total_kmers", "eff_length"):
            setattr(out, name, np.concatenate([getattr(b, name) for b in blocks]))
        for name in (
            "present",
            "ibs",
            "va",
            "ob",
            "inner",
            "left",
            "right",
            "kmer_count",
            "score",
            "mean_kd",
        ):
            setattr(
                out, name, np.concatenate([getattr(b, name) for b in blocks], axis=1)
            )
        return out

    # -- formatting ---------------------------------------------------------

    def info_stats(self):
        """Per-window INFO stats with the reference's mixed float/double
        accumulation (Window.calculateStats, Window.java:177-214):
        obs/var means accumulate in float32 step-by-step; score mean in
        float64."""
        s = self.n_samples
        min_ob = self.ob.min(axis=0)
        max_ob = self.ob.max(axis=0)
        mean_ob = np.cumsum(self.ob.astype(np.float32), axis=0, dtype=np.float32)[
            -1
        ] / np.float32(s)
        min_va = self.va.min(axis=0)
        max_va = self.va.max(axis=0)
        mean_va = np.cumsum(self.va.astype(np.float32), axis=0, dtype=np.float32)[
            -1
        ] / np.float32(s)
        min_sc = self.score.min(axis=0)
        max_sc = self.score.max(axis=0)
        mean_sc = np.cumsum(self.score, axis=0)[-1] / s
        return (
            min_ob,
            max_ob,
            mean_ob,
            min_va,
            max_va,
            mean_va,
            min_sc,
            max_sc,
            mean_sc,
        )


def format_block_rows(block: WindowBlock):
    """Yield KCF data rows for a block (no trailing newline)."""
    f2 = javafmt.f2
    flt = javafmt.flt
    (
        min_ob,
        max_ob,
        mean_ob,
        min_va,
        max_va,
        mean_va,
        min_sc,
        max_sc,
        mean_sc,
    ) = block.info_stats()
    n = len(block)
    s = block.n_samples
    if not block.present.all():
        Logger.error(
            _CLASS, "Cannot write KCF: some windows are missing sample data"
        )
    # pre-extract python scalars row-wise for speed
    start = block.start.tolist()
    end = block.end.tolist()
    tot = block.total_kmers.tolist()
    eff = block.eff_length.tolist()
    ibs = block.ibs.tolist()
    va = block.va.tolist()
    ob = block.ob.tolist()
    inner = block.inner.tolist()
    left = block.left.tolist()
    right = block.right.tolist()
    kd = block.mean_kd.tolist()
    sc = block.score.tolist()
    min_ob = min_ob.tolist()
    max_ob = max_ob.tolist()
    min_va = min_va.tolist()
    max_va = max_va.tolist()
    for i in range(n):
        info = (
            f"EFFLEN={eff[i]};IS={f2(min_sc[i])};XS={f2(max_sc[i])};"
            f"MS={f2(mean_sc[i])};IO={min_ob[i]};XO={max_ob[i]};"
            f"MO={f2(float(mean_ob[i]))};IV={min_va[i]};XV={max_va[i]};"
            f"MV={flt(mean_va[i])}"
        )
        parts = [
            block.seq_names[i],
            str(start[i]),
            str(end[i]),
            block.window_id[i],
            str(tot[i]),
            info,
            "GT:VA:OB:ID:LD:RD:KD:SC",
        ]
        for j in range(s):
            ib = ibs[j][i]
            parts.append(
                f"{'N' if ib == -1 else ib}:{va[j][i]}:{ob[j][i]}:{inner[j][i]}:"
                f"{left[j][i]}:{right[j][i]}:{f2(kd[j][i])}:{f2(sc[j][i])}"
            )
        yield "\t".join(parts)


_flt_cache = {}


def _flt_cached(v):
    key = float(v)
    s = _flt_cache.get(key)
    if s is None:
        s = javafmt.flt(v)
        _flt_cache[key] = s
    return s


def _pack_strs(strings):
    """(bytes_buffer, offsets, lengths) for a list of strings."""
    lens = np.fromiter((len(s) for s in strings), np.int64, len(strings))
    offs = np.zeros(len(strings), np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    return "".join(strings).encode(), offs, lens


def format_block_bytes(block: WindowBlock):
    """Render a block's rows to bytes via the native formatter, falling
    back to the Python path; rows near a %.2f rounding tie are re-rendered
    exactly."""
    from ..native import format_kcf_rows

    if not block.present.all():
        Logger.error(
            _CLASS, "Cannot write KCF: some windows are missing sample data"
        )
    (
        min_ob, max_ob, mean_ob, min_va, max_va, mean_va,
        min_sc, max_sc, mean_sc,
    ) = block.info_stats()
    mv_strings = [_flt_cached(v) for v in mean_va]
    names_buf, name_off, name_len = _pack_strs(block.seq_names)
    ids_buf, id_off, id_len = _pack_strs(block.window_id)
    mv_buf, mv_off, mv_len = _pack_strs(mv_strings)
    res = format_kcf_rows(
        names_buf, name_off, name_len, ids_buf, id_off, id_len,
        block.start, block.end, block.total_kmers, block.eff_length,
        min_sc, max_sc, mean_sc, min_ob, max_ob, mean_ob, min_va, max_va,
        mv_buf, mv_off, mv_len,
        block.ibs, block.va, block.ob, block.inner, block.left, block.right,
        block.mean_kd, block.score,
    )
    if res is None:
        return ("\n".join(format_block_rows(block)) + "\n").encode()
    data, tie_rows = res
    if len(tie_rows):
        lines = data.split(b"\n")
        sub = block.select(tie_rows)
        for li, row in zip(tie_rows, format_block_rows(sub)):
            lines[li] = row.encode()
        data = b"\n".join(lines)
    return data


class KCFWriter:
    def __init__(self, path):
        self.path = path
        self._fh = open(path, "wb")
        Logger.info(_CLASS, f"Writing KCF file: {path}")

    def write_header(self, header: KCFHeader):
        self._fh.write(header.to_string().encode())

    def write_block(self, block: WindowBlock):
        self._fh.write(format_block_bytes(block))

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class KCFReader:
    def __init__(self, path):
        self.path = path
        self._header = None
        Logger.info(_CLASS, f"Reading KCF file:{path}")

    @property
    def header(self) -> KCFHeader:
        if self._header is None:
            lines = []
            with open(self.path) as fh:
                for line in fh:
                    if line.startswith("##"):
                        lines.append(line.rstrip("\n"))
                    else:
                        lines.append(line.rstrip("\n"))
                        break
            self._header = KCFHeader.parse("\n".join(lines))
        return self._header

    def _parse_lines(self, lines) -> WindowBlock:
        header = self.header
        samples = header.samples
        s = len(samples)
        n = len(lines)
        ncols = 7 + 8 * s
        block = WindowBlock(n, samples)

        # native path: single-pass C++ parse
        from ..native import parse_kcf_rows

        raw = ("\n".join(lines) + "\n").encode()
        res = parse_kcf_rows(raw, s, n)
        if res is not None and res["rows"] == n:
            cols, per = res["cols"], res["per"]
            block.start = cols["start"][:n]
            block.end = cols["end"][:n]
            block.total_kmers = cols["total"][:n]
            block.eff_length = cols["efflen"][:n]
            no, nl = cols["name_off"], cols["name_len"]
            io_, il = cols["id_off"], cols["id_len"]
            block.seq_names = [
                raw[no[i] : no[i] + nl[i]].decode() for i in range(n)
            ]
            block.window_id = [
                raw[io_[i] : io_[i] + il[i]].decode() for i in range(n)
            ]
            block.ibs = per["ibs"][:, :n]
            block.va = per["va"][:, :n]
            block.ob = per["ob"][:, :n]
            block.inner = per["inner"][:, :n]
            block.left = per["ld"][:, :n]
            block.right = per["rd"][:, :n]
            block.kmer_count = per["kmer_count"][:, :n]
            block.finalize(header.weights)
            return block

        # fast path: one flat split (sample fields are colon-joined with a
        # fixed 8-subfield layout; window IDs never contain ':' or tabs)
        flat = "\t".join(lines).replace(":", "\t").split("\t")
        # FORMAT column contributes 8 tokens (GT..SC) after ':' expansion
        T = 6 + 8 + 8 * s
        if len(flat) == n * T:
            # column access via C-level list slicing; numpy parses string
            # lists directly into numeric dtypes
            def col(j, dtype=None):
                c = flat[j::T]
                return c if dtype is None else np.array(c, dtype=dtype)

            block.seq_names = col(0)
            block.start = col(1, np.int64)
            block.end = col(2, np.int64)
            block.window_id = col(3)
            block.total_kmers = col(4, np.int64)
            block.eff_length = np.array(
                [_parse_efflen(v) for v in col(5)], dtype=np.int64
            )
            base = 14  # 6 fixed + 8 FORMAT tokens
            for j in range(s):
                off = base + 8 * j
                ib = col(off)
                block.ibs[j] = np.array(
                    [-1 if v == "N" else int(v) for v in ib], np.int64
                )
                block.va[j] = col(off + 1, np.int64)
                block.ob[j] = col(off + 2, np.int64)
                block.inner[j] = col(off + 3, np.int64)
                block.left[j] = col(off + 4, np.int64)
                block.right[j] = col(off + 5, np.int64)
                kd = col(off + 6, np.float64)
                block.kmer_count[j] = java_round(kd * block.ob[j])
        else:
            # robust path (IDs containing ':' etc.)
            for i, line in enumerate(lines):
                f = line.split("\t")
                if len(f) != ncols:
                    Logger.error(_CLASS, f"Malformed KCF row: {line[:80]}")
                block.seq_names[i] = f[0]
                block.start[i] = int(f[1])
                block.end[i] = int(f[2])
                block.window_id[i] = f[3]
                block.total_kmers[i] = int(f[4])
                block.eff_length[i] = _parse_efflen(f[5])
                for j in range(s):
                    sd = f[7 + j].split(":")
                    block.ibs[j, i] = -1 if sd[0] == "N" else int(sd[0])
                    block.va[j, i] = int(sd[1])
                    block.ob[j, i] = int(sd[2])
                    block.inner[j, i] = int(sd[3])
                    block.left[j, i] = int(sd[4])
                    block.right[j, i] = int(sd[5])
                    block.kmer_count[j, i] = java_round(float(sd[6]) * block.ob[j, i])

        block.finalize(header.weights)
        return block

    def read_all(self) -> WindowBlock:
        _ = self.header
        lines = []
        with open(self.path) as fh:
            for line in fh:
                if line.startswith("#"):
                    continue
                line = line.rstrip("\n")
                if line:
                    lines.append(line)
        if not lines:
            return WindowBlock(0, self.header.samples)
        return self._parse_lines(lines)

    def batches(self, batch_rows=200_000):
        _ = self.header
        buf = []
        with open(self.path) as fh:
            for line in fh:
                if line.startswith("#"):
                    continue
                line = line.rstrip("\n")
                if not line:
                    continue
                buf.append(line)
                if len(buf) >= batch_rows:
                    yield self._parse_lines(buf)
                    buf = []
        if buf:
            yield self._parse_lines(buf)


def _parse_efflen(info: str) -> int:
    for part in info.split(";"):
        if part.startswith("EFFLEN="):
            return int(part[7:])
    Logger.error(_CLASS, f"INFO field missing EFFLEN: {info}")


# Backwards-friendly aliases used by plugins
Window = WindowBlock
