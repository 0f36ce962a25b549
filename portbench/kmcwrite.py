"""The benchmark's own KMC3 database writer, kept frozen here so that no
change to the program can move the inputs.

Format (the KMC3 file layout, version 0x200): ``<prefix>.kmc_pre`` holds
"KMCP", the LUT of record offsets (one uint64 per signature bin and
lut-prefix, bin-major), a uint64 guard (the record count), the
signature map (uint32, 4^sig_len + 1 entries: signature -> bin), the
68-byte header, its length as int32, and "KMCP". ``<prefix>.kmc_suf``
holds "KMCS", one record per k-mer (the suffix bases after the lut
prefix, 4 to a byte, big-endian; then the count, little-endian, in
``counter_bytes``), and "KMCS". Records are ordered by (bin, k-mer). A
k-mer's signature is the least normalised m-mer over its m-mers (KMC's
signature rule: an m-mer and its reverse complement, the smaller
"allowed" one, disallowed m-mers mapped past the end).

The bin sort, the LUT and the records are made with torch on the device
that holds the keys; only the finished bytes go to the host.
"""

import struct

import numpy as np
import torch

SIG_LEN = 9
HEADER_BYTES = 68
CHUNK = 1 << 25  # records packed and written at a time


def lut_prefix_length(k: int) -> int:
    """The smallest lut prefix >= 1 whose suffix is whole bytes."""
    for lut in range(1, k):
        if (k - lut) % 4 == 0:
            return lut
    return k


def norm_table(sig_len: int = SIG_LEN) -> np.ndarray:
    """norm[m] = min(allowed(m), allowed(revcomp(m))), a disallowed
    m-mer mapped to 4^sig_len."""
    special = 1 << (2 * sig_len)
    m = np.arange(special, dtype=np.uint32)
    rev = np.zeros_like(m)
    x = m.copy()
    for _ in range(sig_len):
        rev = (rev << 2) | ((~x) & 3)
        x >>= 2
    rev &= special - 1

    def allowed(sig):
        ok = (sig & 0x3F) != 0x3F  # ends TTT
        ok &= (sig & 0x3F) != 0x3B  # ends TGT
        ok &= (sig & 0x3C) != 0x3C  # ends TG.
        s = sig.copy()
        for _ in range(sig_len - 3):
            ok &= (s & 0xF) != 0  # AA inside
            s >>= 2
        ok &= s != 0  # starts AAA
        ok &= s != 0x04  # starts ACA
        ok &= (s & 0xF) != 0  # starts .AA
        return ok

    fwd = np.where(allowed(m), m, special).astype(np.int64)
    bwd = np.where(allowed(rev), rev, special).astype(np.int64)
    return np.minimum(fwd, bwd)


def signatures(keys: torch.Tensor, k: int, norm: torch.Tensor):
    mask = (1 << (2 * SIG_LEN)) - 1
    best = None
    for t in range(k - SIG_LEN + 1):
        v = norm[(keys >> (2 * (k - SIG_LEN - t))) & mask]
        best = v if best is None else torch.minimum(best, v)
    return best


def write_db(prefix: str, keys: torch.Tensor, counts: torch.Tensor, k: int,
             counter_bytes: int):
    """Write sorted unique canonical k-mers (int64, k <= 32) and their
    counts (int64, 1 .. 2^(8 counter_bytes) - 1) as a both-strands KMC3
    database."""
    dev = keys.device
    n = keys.shape[0]
    lut = lut_prefix_length(k)
    suffix_len = k - lut
    suf_bytes = suffix_len // 4
    norm = torch.from_numpy(norm_table()).to(dev)
    sigs = signatures(keys, k, norm)
    uniq, bins = torch.unique(sigs, sorted=True, return_inverse=True)
    del sigs
    n_bins = max(1, uniq.shape[0])
    sig_map = np.zeros((1 << (2 * SIG_LEN)) + 1, np.uint32)
    sig_map[uniq.cpu().numpy()] = np.arange(uniq.shape[0], dtype=np.uint32)
    # keys are sorted, so a stable sort by bin gives (bin, key) order
    order = torch.sort(bins, stable=True).indices
    bins = bins[order]
    keys_s = keys[order]
    counts_s = counts[order]
    del order
    lut_size = 1 << (2 * lut)
    slot = bins * lut_size + (keys_s >> (2 * suffix_len))
    del bins
    offsets = torch.searchsorted(
        slot, torch.arange(n_bins * lut_size, device=dev))
    del slot
    header = struct.pack("<7iq", k, 0, counter_bytes, lut, SIG_LEN, 1,
                         (1 << (8 * counter_bytes)) - 1
                         if counter_bytes < 4 else (1 << 31) - 1, n)
    header += bytes([0, 0, 0, 0])  # 0: both strands (canonical k-mers)
    header += b"\x00" * 24
    header += struct.pack("<i", 0x200)
    assert len(header) == HEADER_BYTES
    with open(prefix + ".kmc_pre", "wb") as fh:
        fh.write(b"KMCP")
        fh.write(offsets.cpu().numpy().astype("<u8").tobytes())
        fh.write(struct.pack("<q", n))
        fh.write(sig_map.astype("<u4").tobytes())
        fh.write(header)
        fh.write(struct.pack("<i", HEADER_BYTES))
        fh.write(b"KMCP")
    suf_mask = (1 << (2 * suffix_len)) - 1
    with open(prefix + ".kmc_suf", "wb") as fh:
        fh.write(b"KMCS")
        for i in range(0, n, CHUNK):
            j = min(n, i + CHUNK)
            suf = keys_s[i:j] & suf_mask
            cnt = counts_s[i:j]
            rec = torch.empty((j - i, suf_bytes + counter_bytes),
                              dtype=torch.uint8, device=dev)
            for b in range(suf_bytes):
                rec[:, b] = (suf >> (8 * (suf_bytes - 1 - b))) & 0xFF
            for b in range(counter_bytes):
                rec[:, suf_bytes + b] = (cnt >> (8 * b)) & 0xFF
            fh.write(rec.cpu().numpy().tobytes())
        fh.write(b"KMCS")
