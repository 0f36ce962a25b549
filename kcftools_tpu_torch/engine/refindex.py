"""Reference k-mer index: per-position canonical k-mer identities,
computed once per (reference, k) and cached on disk.

``getVariations`` screens the *same* reference k-mer stream against every
sample's database. Factoring the stream as

  R      = sorted unique canonical k-mers of the reference
  r_idx  = per-position index into R (-1 where the k-mer spans non-ACGT)

turns each sample's lookup phase into one sorted-merge join of R against
the sample's (sorted) KMC table plus one small-table gather - both
host-bandwidth operations in the native tier - leaving the TPU the dense
window-scan work. The artifact is cached beside the FASTA
(``<fasta>.kcfidx.k<k>[.fwd].raw``) and regenerated on staleness, like
the reference's faidx sidecar (FastaIndex.java:31-36).

The cache is a file of ``io/rawfile.py``: a fixed little-endian header
(magic, format version, k, the canonical flag, the key kind and a key's
width in bytes, the chromosome count, the key count, the FASTA's size
as a content fingerprint, the names' UTF-8 length, the file's total
length), every section's byte offset, then the sections at 64-byte-
aligned offsets: the chromosome table (int64 rows of a name's UTF-8
length and its r_idx length), the names as one UTF-8 blob, the key
arrays (kind 1: one uint64 limb, k <= 32; kind 2: the hi and lo limbs,
33..64; kind 3: S{width} byte records, k > 64) and each chromosome's
int32 r_idx. A load maps the file and views the keys and r_idx in
place, read-only: their pages fault in where they are first read.
"""

import os
import struct

import numpy as np

from ..io import rawfile
from ..utils.logger import Logger
from ..utils.stagetimer import count, stage
from .encode import canonicalize, pack_kmers
from .encode_mlimb import n_bytes

_CLASS = "RefKmerIndex"
_MAGIC = b"KCFRIDX\0"
_VERSION = 1
_HEAD = struct.Struct("<8s6I4Q")


def _key_kind(k):
    """(kind, a key's width in bytes, the key arrays' dtypes) for k."""
    if k <= 32:
        return 1, 8, ("<u8",)
    if k <= 64:
        return 2, 16, ("<u8", "<u8")
    nb = n_bytes(k)
    return 3, nb, (f"S{nb}",)


def _layout(n_keys, dtypes, names_bytes, ridx_lens):
    """Every section's byte offset and the total length of an index
    file of ``n_keys`` keys over chromosomes of ``ridx_lens``."""
    n_chroms = len(ridx_lens)
    head = _HEAD.size + 8 * (2 + len(dtypes) + n_chroms)
    sizes = [16 * n_chroms, names_bytes]
    sizes += [np.dtype(d).itemsize * n_keys for d in dtypes]
    sizes += [4 * int(m) for m in ridx_lens]
    return rawfile.layout(head, sizes)


def _chrom_table(names, ridx_lens):
    """The names' UTF-8 blob and the (n, 2) int64 table of each name's
    byte length and r_idx length."""
    blobs = [n.encode() for n in names]
    table = np.array([(len(b), m) for b, m in zip(blobs, ridx_lens)],
                     "<i8").reshape(-1, 2)
    return b"".join(blobs), table


class RefKmerIndex:
    def __init__(self, kmers, chrom_names, chrom_r_idx, k, canonical,
                 kmers_hi=None, kmers_lo=None):
        self.kmers = kmers  # (n_r,) uint64 sorted unique (k <= 32)
        self.kmers_hi = kmers_hi  # wide-k: 128-bit value limbs
        self.kmers_lo = kmers_lo
        self.chrom_names = chrom_names
        self.chrom_r_idx = chrom_r_idx  # name -> int32 (L-k+1,), -1 invalid
        self.k = k
        self.canonical = canonical

    @property
    def wide(self):
        return self.kmers_hi is not None

    @property
    def mlimb(self):
        """k > 64: kmers are big-endian S{nb} byte records."""
        return self.kmers is not None and self.kmers.dtype.kind == "S"

    @property
    def n_kmers(self):
        return (
            self.kmers_hi.shape[0] if self.wide else self.kmers.shape[0]
        )

    @staticmethod
    def cache_path(fasta_path, k, canonical):
        suffix = f".kcfidx.k{k}" + ("" if canonical else ".fwd") + ".raw"
        return fasta_path + suffix

    @property
    def nbytes(self):
        """The bytes of the keys and every r_idx."""
        keys = (self.kmers_hi.nbytes + self.kmers_lo.nbytes if self.wide
                else self.kmers.nbytes)
        return keys + sum(r.nbytes for r in self.chrom_r_idx.values())

    @classmethod
    def build(cls, index, k, canonical=True):
        """index: io.fasta.FastaIndex."""
        if 32 < k <= 64:
            return cls._build_wide(index, k, canonical)
        if k <= 32:
            total = sum(
                index.get_sequence_length(n)
                for n in index.get_sequence_names()
            )
            if total >= int(
                os.environ.get("KCFTOOLS_REFIDX_LEAN_MIN", str(10 ** 9))
            ):
                return cls._build_lean(index, k, canonical)
        names = index.get_sequence_names()
        per_chrom_kmers = {}
        per_chrom_valid = {}
        if k > 64:
            # byte-record keys share this exact algorithm: numpy S{nb}
            # comparisons are memcmp, so unique/searchsorted order
            # matches the packed numeric order (engine/encode_mlimb.py)
            from .encode_mlimb import canonical_kmer_bytes

            empty = np.empty(0, f"S{n_bytes(k)}")
        else:
            empty = np.empty(0, np.uint64)
        for name in names:
            codes, valid = index.sequence_codes(name)
            if k > 64:
                kmers, kvalid = canonical_kmer_bytes(codes, valid, k,
                                                     canonical)
            else:
                kmers, kvalid = pack_kmers(codes, valid, k)
                if canonical and kmers.size:
                    kmers = canonicalize(kmers, k)
            per_chrom_kmers[name] = kmers
            per_chrom_valid[name] = kvalid

        from ..native import sort_pairs, sort_unique_u64, sorted_lookup

        if k <= 32:
            # fast path: the threaded radix sort + a linear zipper
            # replace numpy unique/searchsorted (the cold-build cost is
            # dominated by the 5M-key binary searches otherwise); both
            # helpers fall back to numpy without the native library
            parts = [
                per_chrom_kmers[name][per_chrom_valid[name]]
                for name in names
                if per_chrom_kmers[name].size
            ]
            R = sort_unique_u64(np.concatenate(parts)) if parts else empty
            chrom_r_idx = {}
            for name in names:
                kmers = per_chrom_kmers[name]
                kvalid = per_chrom_valid[name]
                r_idx = np.full(kmers.shape[0], -1, np.int32)
                if kmers.size and kvalid.any():
                    vpos = np.flatnonzero(kvalid).astype(np.uint32)
                    ks, pos = sort_pairs(kmers[kvalid], vpos)
                    r_idx[pos.astype(np.int64)] = sorted_lookup(R, ks)
                chrom_r_idx[name] = r_idx
        else:
            uniq_parts = [
                np.unique(per_chrom_kmers[name][per_chrom_valid[name]])
                for name in names
                if per_chrom_kmers[name].size
            ]
            R = (
                np.unique(np.concatenate(uniq_parts))
                if uniq_parts
                else empty
            )

            chrom_r_idx = {}
            for name in names:
                kmers = per_chrom_kmers[name]
                kvalid = per_chrom_valid[name]
                r_idx = np.full(kmers.shape[0], -1, np.int32)
                if kmers.size:
                    pos = np.searchsorted(R, kmers[kvalid]).astype(np.int32)
                    r_idx[kvalid] = pos
                chrom_r_idx[name] = r_idx
        Logger.info(
            _CLASS,
            f"Built reference k-mer index: {R.size} unique {k}-mers over "
            f"{len(names)} sequences",
        )
        return cls(R, names, chrom_r_idx, k, canonical)

    @classmethod
    def _build_lean(cls, index, k, canonical=True):
        """Multi-Gbp build (k <= 32): one preallocated key buffer, one
        global radix sort with its scratch released afterwards, and
        per-chromosome k-mers RECOMPUTED in the r_idx pass instead of
        held - peak host memory ~24 bytes/base instead of the ~40+ the
        dictionary-of-chromosomes build costs (decisive at 3 Gbp+,
        where the eager build can exceed host RAM)."""
        from ..native import (
            release_sort_scratch,
            sort_pairs,
            sort_unique_u64,
            sorted_lookup,
        )

        names = index.get_sequence_names()

        def chrom_kmers(name):
            codes, valid = index.sequence_codes(name)
            kmers, kvalid = pack_kmers(codes, valid, k)
            if canonical and kmers.size:
                kmers = canonicalize(kmers, k)
            return kmers, kvalid

        total_pos = sum(
            max(0, index.get_sequence_length(n) - k + 1) for n in names
        )
        buf = np.empty(total_pos, np.uint64)
        fill = 0
        for name in names:
            kmers, kvalid = chrom_kmers(name)
            kk = kmers[kvalid]
            buf[fill : fill + kk.size] = kk
            fill += kk.size
            del kmers, kvalid, kk
        R = sort_unique_u64(buf[:fill])
        del buf
        release_sort_scratch()

        chrom_r_idx = {}
        for name in names:
            kmers, kvalid = chrom_kmers(name)
            r_idx = np.full(kmers.shape[0], -1, np.int32)
            if kmers.size and kvalid.any():
                vpos = np.flatnonzero(kvalid).astype(np.uint32)
                ks, pos = sort_pairs(kmers[kvalid], vpos)
                del kmers, kvalid
                r_idx[pos.astype(np.int64)] = sorted_lookup(R, ks)
                del ks, pos
            chrom_r_idx[name] = r_idx
        release_sort_scratch()
        Logger.info(
            _CLASS,
            f"Built reference k-mer index (lean): {R.size} unique "
            f"{k}-mers over {len(names)} sequences",
        )
        return cls(R, names, chrom_r_idx, k, canonical)

    @classmethod
    def _build_wide(cls, index, k, canonical=True):
        from ..native import wide
        from .encode_wide import canonicalize_wide, pack_kmers_wide, to_value_limbs

        names = index.get_sequence_names()
        per_chrom = {}
        parts_hi, parts_lo = [], []
        for name in names:
            codes, valid = index.sequence_codes(name)
            A, B, kvalid = pack_kmers_wide(codes, valid, k)
            if canonical and A.size:
                A, B = canonicalize_wide(A, B, k)
            vhi, vlo = to_value_limbs(A, B, k)
            per_chrom[name] = (vhi, vlo, kvalid)
            if A.size:
                uh, ul, _ = wide.sort_unique(vhi[kvalid], vlo[kvalid])
                parts_hi.append(uh)
                parts_lo.append(ul)
        if parts_hi:
            R_hi, R_lo, _ = wide.sort_unique(
                np.concatenate(parts_hi), np.concatenate(parts_lo)
            )
        else:
            R_hi = R_lo = np.empty(0, np.uint64)

        chrom_r_idx = {}
        for name in names:
            vhi, vlo, kvalid = per_chrom[name]
            chrom_r_idx[name] = wide.searchsorted(
                R_hi, R_lo, vhi, vlo, kvalid.astype(np.uint8)
            )
        Logger.info(
            _CLASS,
            f"Built reference k-mer index: {R_hi.size} unique {k}-mers "
            f"(wide) over {len(names)} sequences",
        )
        return cls(None, names, chrom_r_idx, k, canonical,
                   kmers_hi=R_hi, kmers_lo=R_lo)

    @classmethod
    def load_or_build(cls, fasta_path, index, k, canonical=True):
        """The index of ``fasta_path`` from its cache file, or built and
        cached where the file is missing, stale or not this reference's.
        A hit adds 0 to the stage timer's ``refindex_built`` and the key
        and r_idx bytes it served to ``refindex_bytes``; a miss adds 1
        and 0."""
        path = cls.cache_path(fasta_path, k, canonical)
        obj = cls._load(path, fasta_path, index, k, canonical)
        if obj is not None:
            Logger.info(_CLASS, f"Loaded cached index: {path}")
            count("refindex_built", 0)
            count("refindex_bytes", obj.nbytes)
            return obj
        count("refindex_built", 1)
        count("refindex_bytes", 0)
        with stage("refindex_build"):  # the build and its cache write
            obj = cls.build(index, k, canonical)
            try:
                obj._save(path, fasta_path)
                Logger.info(_CLASS, f"Cached index: {path}")
            except OSError as e:
                Logger.warning(_CLASS, f"Could not cache index at {path}: {e}")
            return obj

    @classmethod
    def _load(cls, path, fasta_path, index, k, canonical):
        """The cache file's arrays as read-only views of a memory map, or
        None where it is absent, stale, damaged or another index's. The
        checks read the header and the .fai's names and lengths, never
        the sequence."""
        kind, width, dtypes = _key_kind(k)
        names = index.get_sequence_names()
        ridx_lens = [max(0, index.get_sequence_length(n) - k + 1)
                     for n in names]
        blob, table = _chrom_table(names, ridx_lens)
        try:
            with open(path, "rb") as fh:
                st = os.fstat(fh.fileno())
                fasta = os.stat(fasta_path)
                # '<=' (not '<'): a FASTA rewritten within the
                # filesystem's timestamp granularity of the cache write
                # must rebuild - the safe direction; its size is a cheap
                # content fingerprint for the same window.
                if st.st_mtime <= fasta.st_mtime:
                    raise ValueError("stale")
                (magic, version, hk, hcanon, hkind, hwidth, n_chroms,
                 n_keys, size, names_bytes, htotal) = _HEAD.unpack(
                    fh.read(_HEAD.size))
                if (magic, version, hk, hcanon, hkind, hwidth, n_chroms,
                        size, names_bytes) != (
                        _MAGIC, _VERSION, k, int(canonical), kind, width,
                        len(names), fasta.st_size, len(blob)):
                    raise ValueError("not this reference's index")
                offs, total = _layout(n_keys, dtypes, len(blob), ridx_lens)
                got = struct.unpack(f"<{len(offs)}Q",
                                    fh.read(8 * len(offs)))
                if (list(got), htotal) != (offs, total) or (
                        total != st.st_size):
                    raise ValueError("damaged")
                mm = rawfile.map_readonly(fh)
        except (OSError, ValueError, struct.error):
            return None
        if (np.frombuffer(mm, "<i8", table.size, offs[0]).tobytes()
                != table.tobytes()
                or mm[offs[1]:offs[1] + len(blob)] != blob):
            return None
        keys = [np.frombuffer(mm, d, n_keys, off)
                for d, off in zip(dtypes, offs[2:])]
        ridx = {n: np.frombuffer(mm, "<i4", m, off)
                for n, m, off in zip(names, ridx_lens,
                                     offs[2 + len(dtypes):])}
        if kind == 2:
            return cls(None, names, ridx, k, canonical,
                       kmers_hi=keys[0], kmers_lo=keys[1])
        return cls(keys[0], names, ridx, k, canonical)

    def _save(self, path, fasta_path):
        """Write the index to ``path`` (``io/rawfile.py::write``: atomic,
        raises OSError)."""
        kind, width, dtypes = _key_kind(self.k)
        keys = ((self.kmers_hi, self.kmers_lo) if self.wide
                else (self.kmers,))
        keys = [np.ascontiguousarray(a, d) for a, d in zip(keys, dtypes)]
        ridx = [np.ascontiguousarray(self.chrom_r_idx[n], "<i4")
                for n in self.chrom_names]
        ridx_lens = [r.shape[0] for r in ridx]
        blob, table = _chrom_table(self.chrom_names, ridx_lens)
        n_keys = keys[0].shape[0]
        offs, total = _layout(n_keys, dtypes, len(blob), ridx_lens)
        head = _HEAD.pack(_MAGIC, _VERSION, self.k, int(self.canonical),
                          kind, width, len(ridx), n_keys,
                          os.path.getsize(fasta_path), len(blob), total)
        head += struct.pack(f"<{len(offs)}Q", *offs)
        blob_arr = np.frombuffer(blob, np.uint8)
        rawfile.write(path, head, offs, total, [table, blob_arr, *keys, *ridx])


class FeatureKmerIndex:
    """Per-feature (gene/transcript) analog of RefKmerIndex for the
    hybrid engine: the exon-merged spliced sequence of every feature
    (reference GTF.java:223-248, GetVariants.java:324-348) is
    concatenated per chromosome with k-1 non-ACGT separator bases - so
    no k-mer spans a feature boundary - packed once, and indexed
    against the sorted unique feature k-mer set. Each feature is one
    window [w_start, w_hi] in k-mer coordinates of the concatenation;
    the same merge-join + window-scan machinery as fixed windows then
    scores every feature, for any k the encoders support (k <= 64)."""

    def __init__(self, k, canonical, is_gene, kmers, chrom_plans,
                 kmers_hi=None, kmers_lo=None):
        self.k = k
        self.canonical = canonical
        self.is_gene = is_gene
        self.kmers = kmers  # sorted unique (k <= 32)
        self.kmers_hi = kmers_hi  # wide-k value limbs
        self.kmers_lo = kmers_lo
        # name -> dict(r_idx, w_start, w_hi, feats, total, eff) or None
        self.chrom_plans = chrom_plans

    @property
    def wide(self):
        return self.kmers_hi is not None

    @classmethod
    def build(cls, index, gtf, k, canonical, is_gene):
        from .prefix_scan import static_window_stats

        wide_k = 32 < k <= 64
        if wide_k:
            from ..native import wide
            from .encode_wide import (
                canonicalize_wide,
                pack_kmers_wide,
                to_value_limbs,
            )

        def pack_canon(codes_cat, valid_cat):
            # narrow (uint64) and mlimb (S{nb} byte-record) keys share
            # the numpy unique/searchsorted machinery
            if k > 64:
                from .encode_mlimb import canonical_kmer_bytes

                return canonical_kmer_bytes(codes_cat, valid_cat, k,
                                            canonical)
            kmers, kvalid = pack_kmers(codes_cat, valid_cat, k)
            if canonical and kmers.size:
                kmers = canonicalize(kmers, k)
            return kmers, kvalid

        names = index.get_sequence_names()
        per_chrom = {}
        parts = []  # narrow: arrays; wide: (hi, lo) tuples
        n_feats = 0
        for name in names:
            feats = []  # (window_id, chrom, start, end)
            genes = gtf.get_genes(name)
            if not genes and not is_gene:
                Logger.warning(
                    _CLASS,
                    f"No genes found in GTF file for sequence: {name}",
                )
            for gene in genes:
                if is_gene:
                    chrom, start, end, _ = gtf.get_loci(gene)
                    feats.append((gene, chrom, start, end))
                else:
                    transcripts = gtf.get_transcripts(gene)
                    if not transcripts:
                        Logger.error(
                            _CLASS,
                            f"No transcripts found for gene: {gene} in GTF "
                            f"file for sequence: {name}",
                        )
                    for tr in transcripts:
                        chrom, start, end, _ = gtf.get_loci(tr)
                        feats.append((tr, chrom, start, end))
            if not feats:
                per_chrom[name] = None
                continue
            sep_c = np.zeros(k - 1, np.uint8)
            sep_v = np.zeros(k - 1, bool)
            codes_parts, valid_parts = [], []
            offs = np.empty(len(feats), np.int64)
            lens = np.empty(len(feats), np.int64)
            cur = 0
            for i, (wid, _c, _s, _e) in enumerate(feats):
                cv = gtf.spliced_codes(wid, index, is_gene)
                if cv is None:
                    Logger.error(
                        _CLASS, f"Fasta object is null for window: {wid}"
                    )
                c, v = cv
                offs[i] = cur
                lens[i] = c.shape[0]
                codes_parts.extend((c, sep_c))
                valid_parts.extend((v, sep_v))
                cur += c.shape[0] + k - 1
            codes_cat = np.concatenate(codes_parts)
            valid_cat = np.concatenate(valid_parts)

            if wide_k:
                A, B, kvalid = pack_kmers_wide(codes_cat, valid_cat, k)
                if canonical and A.size:
                    A, B = canonicalize_wide(A, B, k)
                vhi, vlo = to_value_limbs(A, B, k)
                keys = (vhi, vlo)
                if A.size and kvalid.any():
                    uh, ul, _ = wide.sort_unique(vhi[kvalid], vlo[kvalid])
                    parts.append((uh, ul))
            else:
                kmers, kvalid = pack_canon(codes_cat, valid_cat)
                keys = kmers
                if kmers.size and kvalid.any():
                    if k <= 32:
                        from ..native import sort_unique_u64

                        parts.append(sort_unique_u64(kmers[kvalid]))
                    else:
                        parts.append(np.unique(kmers[kvalid]))

            # sample-independent per-feature stats; features shorter than
            # k carry zeros (reference: empty k-mer list, eff length 0)
            total = np.zeros(len(feats), np.int64)
            eff = np.zeros(len(feats), np.int64)
            sel = np.flatnonzero(lens >= k)
            if sel.size:
                marker = np.where(kvalid, 0, -1).astype(np.int32)
                t, e = static_window_stats(
                    marker, valid_cat, k, offs[sel], offs[sel] + lens[sel]
                )
                total[sel] = t
                eff[sel] = e
            per_chrom[name] = {
                "keys": keys,
                "kvalid": kvalid,
                "valid": valid_cat,
                "feats": feats,
                "w_start": offs.astype(np.int32),
                "w_hi": (offs + lens - k).astype(np.int32),
                "total": total,
                "eff": eff,
            }
            n_feats += len(feats)

        # global unique key set, then per-chromosome position index
        if wide_k:
            from ..native import wide

            if parts:
                R_hi, R_lo, _ = wide.sort_unique(
                    np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]),
                )
            else:
                R_hi = R_lo = np.empty(0, np.uint64)
            R = None
        else:
            if parts and k <= 32:
                from ..native import sort_unique_u64

                R = sort_unique_u64(np.concatenate(parts))
            elif parts:
                R = np.unique(np.concatenate(parts))
            elif k > 64:
                R = np.empty(0, f"S{n_bytes(k)}")
            else:
                R = np.empty(0, np.uint64)
            R_hi = R_lo = None
        chrom_plans = {}
        for name, pl in per_chrom.items():
            if pl is None:
                chrom_plans[name] = None
                continue
            keys = pl.pop("keys")
            kvalid = pl.pop("kvalid")
            if wide_k:
                from ..native import wide

                pl["r_idx"] = wide.searchsorted(
                    R_hi, R_lo, keys[0], keys[1], kvalid.astype(np.uint8)
                )
            else:
                r_idx = np.full(keys.shape[0], -1, np.int32)
                if keys.size and kvalid.any():
                    if k <= 32:
                        from ..native import sort_pairs, sorted_lookup

                        vpos = np.flatnonzero(kvalid).astype(np.uint32)
                        ks, pos = sort_pairs(keys[kvalid], vpos)
                        r_idx[pos.astype(np.int64)] = sorted_lookup(R, ks)
                    else:
                        r_idx[kvalid] = np.searchsorted(
                            R, keys[kvalid]
                        ).astype(np.int32)
                pl["r_idx"] = r_idx
            chrom_plans[name] = pl
        n_unique = R_hi.shape[0] if wide_k else R.shape[0]
        Logger.info(
            _CLASS,
            f"Built feature k-mer index: {n_feats} features, {n_unique} "
            f"unique {k}-mers over {len(names)} sequences",
        )
        return cls(k, canonical, is_gene, R, chrom_plans,
                   kmers_hi=R_hi, kmers_lo=R_lo)
