"""Bucketed hash-table lookup, in torch.

Port of kcftools_tpu/ops/lookup.py against the host-built table of
kcftools_tpu/engine/hashtable.py: one interleaved (nb, 3*S) uint32
array, row = [hi x S | lo x S | cnt x S] (S = 4 slots), every key in
one of its two buckets. Two row gathers + vectorised compares per
query. The hashes must stay bit-identical with
``hashtable.bucket_hashes_np``, or every lookup misses. This is the plain
version's lookup (ops/hashscan.py::hash_probe_ref); on the card the
probe kernel csrc/hashscan.cu does it.

torch has no uint32 arithmetic on the CPU: the keys and hashes are
int64 tensors in [0, 2^32), and the table is an int32 tensor holding
the uint32 bits. A 32-bit product is formed from 16-bit halves of the
constant, so no int64 product overflows.
"""

import torch

_M32 = 0xFFFFFFFF
_C1A = 0x9E3779B1
_C1B = 0x85EBCA77
_C2A = 0xC2B2AE3D
_C2B = 0x27D4EB2F
_S1 = 0xA5A5A5A5
_S2 = 0x3C6EF372


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant:
    x * (c mod 2^16) < 2^48 and the high half's product only matters
    mod 2^16."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def bucket_hashes(hi, lo, n_buckets: int):
    """The two candidate buckets of each (hi, lo) key (int64 tensors in
    [0, 2^32)); ``n_buckets`` is a power of two."""
    mask = n_buckets - 1
    h1 = _fmix32((_mul32(hi, _C1A) + _mul32(lo, _C1B) + _S1) & _M32) & mask
    h2 = _fmix32((_mul32(hi, _C2A) + _mul32(lo, _C2B) + _S2) & _M32) & mask
    return h1, h2


def _as_i32(x):
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def table_lookup(hi, lo, tbl, nb_total=None, shard=0):
    """int64 counts in [0, 2^32) for queries (hi, lo) of any shape
    against the (nb, 3*S) int32 table; 0 for absent keys. A key lives in
    exactly one bucket, so where h1 == h2 the second probe is dropped.

    With ``nb_total`` the table is shard ``shard`` (global buckets
    [shard*nb, (shard+1)*nb)) of an ``nb_total``-bucket table under
    shard-local placement (kcftools_tpu/parallel/sharded.py:33-75): a
    key's owning shard is the top bits of its first bucket hash, and its
    second candidate is that shard's base | the low bits of the second
    hash. The result is then this shard's partial count (0 for keys it
    does not own); the caller sums the partials over the table axis.
    ``table_lookup.cuda_calls`` counts its calls on a CUDA device."""
    if tbl.device.type == "cuda":
        table_lookup.cuda_calls += 1
    nb = tbl.shape[0]
    S = tbl.shape[1] // 3
    nb_total = nb if nb_total is None else int(nb_total)
    lm = nb - 1
    h1, h2 = bucket_hashes(hi, lo, nb_total)
    b2 = (h1 & ~lm) | (h2 & lm)
    base = int(shard) * nb
    qh = _as_i32(hi)[..., None]
    ql = _as_i32(lo)[..., None]
    out = torch.zeros(hi.shape, dtype=torch.int64, device=hi.device)
    for b, dedup in ((h1, None), (b2, b2 != h1)):
        owned = None
        if nb_total != nb:
            # int64: the range test needs both bounds (no uint32 wrap)
            b = b - base
            owned = (b >= 0) & (b < nb)
            b = torch.where(owned, b, 0)
        rows = tbl[b]  # (..., 3*S): one contiguous row per probe
        cnt = rows[..., 2 * S :]
        match = (rows[..., 0:S] == qh) & (rows[..., S : 2 * S] == ql) & (
            cnt != 0
        )
        if owned is not None:
            match &= owned[..., None]
        contrib = torch.where(match, cnt.long() & _M32, 0).sum(dim=-1)
        if dedup is not None:
            contrib = torch.where(dedup, contrib, 0)
        out = out + contrib
    return out & _M32


table_lookup.cuda_calls = 0
