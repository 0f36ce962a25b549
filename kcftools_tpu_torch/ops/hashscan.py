"""The on-chip hash engine's per-batch scoring: wrappers and plain
versions.

Port of what kcftools_tpu/engine/pipeline.py::score_windows_core runs for
a padded batch of windows, in two steps:

- ``hash_probe``: every k-mer of the batch's sentinel-coded rows built,
  made canonical, hashed and looked up in the two buckets of the
  (nb, 12) table (kcftools_tpu/ops/kmerize.py, ops/lookup.py::
  table_lookup; with ``nb_total`` / ``shard`` one shard's partial counts
  under the mesh's shard-local placement, parallel/sharded.py::
  _sharded_lookup). (B, Lp - PAD_MARGIN) int32: the uint32 count of each
  valid k-mer, 0 elsewhere.
- ``hash_scan``: the per-window gap-run statistics, the exact count sum
  and the effective length from the same rows and those counts
  (pipeline.py::gap_scan_core and the count sum of score_windows_core).
  (8, B) int64 in FIELDS order.

A k-mer start i < Lp - PAD_MARGIN of a row is valid when its k bytes are
all bases (0..3; any other byte is invalid) and i <= win_len - k.

On CUDA tensors each wrapper launches its kernel in ``csrc/hashscan.cu``
(bound in ``_kernels.py``) once; on CPU tensors it takes its plain
version, the torch ops the port ran before (``ops/kmerize.py``,
``ops/lookup.py::table_lookup`` masked to the valid k-mers;
``gap_scan_core`` plus the count sum). A CUDA tensor never reaches a
plain version. Each wrapper's ``.launches`` counts its kernel's
launches.
"""

import torch

from ..engine.windows import PAD_MARGIN
from .gapscan import _on_card
from .kmerize import assemble_kmers, canonical_select, rolling_pack_u32
from .lookup import _M32, _as_i32, table_lookup

FIELDS = (
    "total",
    "observed",
    "variations",
    "inner",
    "left",
    "right",
    "count_sum",
    "eff_length",
)
SENTINEL = 4  # the code of a non-ACGT or out-of-window byte
TABLE_WIDTH = 12  # uint32 words of a bucket row: hi x 4 | lo x 4 | cnt x 4
MAX_K = 32
_CHUNK = 1024  # positions of a chunk of the scan kernel (a warp's)
_SCAN_WARPS = 16  # chunks a block of the scan kernel spans at most
_SUM_WORDS = 5  # int64 words of a stored block summary (40 bytes)


# -- the plain versions ---------------------------------------------------


def _exclusive_cummax(x, init: int):
    """Running max along the last axis of everything before each
    element (``init`` before the first)."""
    shifted = torch.cat([torch.full_like(x[..., :1], init), x[..., :-1]],
                        dim=-1)
    return torch.cummax(shifted, dim=-1).values


def _kmer_valid(valid, win_len, k: int, n_out: int):
    """(B, n_out) bool: the k-mer at each start is all ACGT and inside
    its window."""
    B = valid.shape[0]
    cv = torch.cumsum(valid, dim=1, dtype=torch.int64)
    cv_pad = torch.cat([cv.new_zeros((B, 1)), cv], dim=1)
    run_k = cv_pad[:, k : k + n_out] - cv_pad[:, 0:n_out]
    pos = torch.arange(n_out, device=valid.device)[None, :]
    return (run_k == k) & (pos <= win_len[:, None] - k)


def gap_scan_core(valid, present, win_len, *, k: int):
    """The data-parallel gap-run scan.

    valid: (B, Lp) bool base-level validity; present: (B, Lp) bool k-mer
    start presence; win_len: (B,) int64. Returns a dict of (B,) int64:
    total, observed, variations, inner, left, right, count_sum (zeros)
    and eff_length."""
    B, Lp = valid.shape
    n_out = Lp - PAD_MARGIN
    kmer_valid = _kmer_valid(valid, win_len, k, n_out)
    present = present[:, :n_out] & kmer_valid

    vidx = torch.cumsum(kmer_valid, dim=1, dtype=torch.int64) - 1
    pres_ord = torch.where(present, vidx, -1)
    prev = _exclusive_cummax(pres_ord, -1)

    gap_before = vidx - prev - 1
    closed = present & (gap_before > 0)
    leading = closed & (prev == -1)
    interior = closed & (prev >= 0)

    d = gap_before - (k - 1)
    dist = torch.where(d > 0, d, torch.abs(d + 1))

    left = torch.where(leading, gap_before, 0).sum(dim=1)
    inner = torch.where(interior, dist, 0).sum(dim=1)
    var_closed = closed.sum(dim=1)

    total = kmer_valid.sum(dim=1)
    observed = present.sum(dim=1)
    last_p = pres_ord.max(dim=1).values
    trailing = total - 1 - last_p
    has_trailing = trailing > 0
    right = torch.where(has_trailing, trailing, 0)
    variations = var_closed + has_trailing.long()

    bpos = torch.arange(Lp, device=valid.device)[None, :]
    no = torch.zeros((B, 1), dtype=torch.bool, device=valid.device)
    prev_valid = torch.cat([no, valid[:, :-1]], dim=1)
    next_valid = torch.cat([valid[:, 1:], no], dim=1)
    run_start = valid & ~prev_valid
    run_end = valid & ~next_valid
    start_pos = torch.cummax(torch.where(run_start, bpos, -1), dim=1).values
    run_len = bpos - start_pos + 1
    eff = torch.where(run_end & (run_len >= k), run_len, 0).sum(dim=1)

    return {
        "total": total,
        "observed": observed,
        "variations": variations,
        "inner": inner,
        "left": left,
        "right": right,
        "count_sum": torch.zeros_like(total),
        "eff_length": eff,
    }


def kmers_ref(u8, *, k: int, both_strands: bool):
    """The (hi, lo) int64 halves of the k-mer at every start of the
    rows (the canonical one with ``both_strands``), from the rolling
    packs; invalid bytes read as code 0."""
    codes = torch.where(u8 < SENTINEL, u8, 0).long()
    w32, rcw32 = rolling_pack_u32(codes)
    parts = assemble_kmers(w32, rcw32, k, u8.shape[1] - PAD_MARGIN)
    return canonical_select(*parts) if both_strands else parts[:2]


def hash_probe_ref(u8, win_len, tbl, *, k: int, both_strands: bool,
                   nb_total=None, shard: int = 0):
    """Plain version of ``hash_probe``: ``kmers_ref`` and
    ``table_lookup`` at every start, masked to the valid k-mers."""
    hi, lo = kmers_ref(u8, k=k, both_strands=both_strands)
    counts = table_lookup(hi, lo, tbl, nb_total=nb_total, shard=shard)
    kv = _kmer_valid(u8 < SENTINEL, win_len, k, hi.shape[1])
    return _as_i32(torch.where(kv, counts, 0))


def hash_scan_ref(u8, counts, win_len, *, k: int, min_count: int):
    """Plain version of ``hash_scan``: ``gap_scan_core`` on the rows'
    validity and the unsigned presence test, and the count sum of the
    present valid k-mers."""
    valid = u8 < SENTINEL
    cnt = counts.long() & _M32
    present = cnt >= min_count
    pad = present.new_zeros((present.shape[0], PAD_MARGIN))
    res = gap_scan_core(valid, torch.cat([present, pad], dim=1), win_len,
                        k=k)
    kv = _kmer_valid(valid, win_len, k, counts.shape[1])
    res["count_sum"] = torch.where(kv & present, cnt, 0).sum(dim=1)
    return torch.stack([res[f] for f in FIELDS])


# -- the wrappers ---------------------------------------------------------


def _check_rows(what, u8, win_len, k, *others):
    """Device, dtype, shape and contiguity of the rows, their lengths and
    ``others``; returns (B, Lp, n_out)."""
    for t in (u8, win_len, *others):
        if t.device != u8.device:
            raise ValueError(f"{what}: operands on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: contiguous operands")
    if u8.dtype != torch.uint8 or u8.dim() != 2:
        raise TypeError(f"{what}: rows must be (B, Lp) uint8")
    B, Lp = u8.shape
    if Lp < PAD_MARGIN:
        raise ValueError(f"{what}: rows of {Lp} bytes, under the "
                         f"{PAD_MARGIN}-byte padding")
    if win_len.dtype != torch.int64 or win_len.shape != (B,):
        raise TypeError(f"{what}: win_len must be ({B},) int64")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{what}: k = {k} outside 1..{MAX_K}")
    return B, Lp, Lp - PAD_MARGIN


def _scan_scratch(B, Lp):
    """int64 words of the scan kernel's scratch: where a row spans more
    than one block (more than _SCAN_WARPS chunks), each block's summary
    and an int32 ticket a row; else one unused word."""
    n_chunks = -(-Lp // _CHUNK)
    if n_chunks <= _SCAN_WARPS:
        return 1
    return B * -(-n_chunks // _SCAN_WARPS) * _SUM_WORDS + -(-B // 2)


def _pow2(x):
    return x > 0 and not x & (x - 1)


def hash_probe(u8, win_len, tbl, *, k: int, both_strands: bool,
               nb_total=None, shard: int = 0):
    """The uint32 count of every valid k-mer of a padded batch.

    u8: (B, Lp) uint8 sentinel-coded rows; win_len: (B,) int64; tbl:
    (nb, 12) int32 bucket rows (uint32 bits), nb a power of two. With
    ``nb_total`` (a power-of-two multiple of nb) the table is shard
    ``shard`` of an nb_total-bucket table under shard-local placement,
    and the result is this shard's partial count (0 for keys it does not
    own). Returns (B, Lp - PAD_MARGIN) int32 holding uint32 counts, 0
    where the k-mer is not valid."""
    B, Lp, n_out = _check_rows("hash_probe", u8, win_len, k, tbl)
    if tbl.dtype != torch.int32 or tbl.dim() != 2 or (
            tbl.shape[1] != TABLE_WIDTH):
        raise TypeError(f"hash_probe: table must be (nb, {TABLE_WIDTH}) "
                        "int32")
    nb = tbl.shape[0]
    nb_total = nb if nb_total is None else int(nb_total)
    if not (_pow2(nb) and _pow2(nb_total) and nb_total % nb == 0
            and nb_total <= 1 << 32):
        raise ValueError(f"hash_probe: {nb} buckets of {nb_total}: both "
                         "powers of two, the first dividing the second")
    if not 0 <= shard < nb_total // nb:
        raise ValueError(f"hash_probe: shard {shard} of {nb_total // nb}")
    if not _on_card("hash_probe", u8.device):
        return hash_probe_ref(u8, win_len, tbl, k=k,
                              both_strands=both_strands, nb_total=nb_total,
                              shard=shard)
    from ._kernels import launch

    if tbl.data_ptr() % 16:
        raise ValueError("hash_probe: the table must be 16-byte aligned")
    out = torch.empty((B, n_out), dtype=torch.int32, device=u8.device)
    if out.numel() == 0:
        return out
    launch("kcf_hash_probe", u8, win_len, tbl, out, B, Lp, n_out, nb,
           nb_total, int(shard), int(k), int(bool(both_strands)))
    hash_probe.launches += 1
    return out


def hash_scan(u8, counts, win_len, *, k: int, min_count: int):
    """The per-window statistics of a padded batch from its k-mer counts.

    u8: (B, Lp) uint8 sentinel-coded rows; counts: (B, Lp - PAD_MARGIN)
    int32 holding uint32 counts (read only where the k-mer is valid);
    win_len: (B,) int64. A valid k-mer is present where its count, taken
    unsigned, is at least ``min_count``. Returns (8, B) int64 in FIELDS
    order."""
    B, Lp, n_out = _check_rows("hash_scan", u8, win_len, k, counts)
    if counts.dtype != torch.int32 or counts.shape != (B, n_out):
        raise TypeError(f"hash_scan: counts must be ({B}, {n_out}) int32")
    if not _on_card("hash_scan", u8.device):
        return hash_scan_ref(u8, counts, win_len, k=k, min_count=min_count)
    from ._kernels import launch

    out = torch.empty((len(FIELDS), B), dtype=torch.int64, device=u8.device)
    if B == 0:
        return out
    scratch = torch.empty(_scan_scratch(B, Lp), dtype=torch.int64,
                          device=u8.device)
    launch("kcf_hash_scan", u8, counts, win_len, scratch, out, B, Lp, n_out,
           int(k), int(min_count))
    hash_scan.launches += 1
    return out


hash_probe.launches = 0
hash_scan.launches = 0
