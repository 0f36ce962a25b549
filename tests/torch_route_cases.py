"""Operands of the device join's reference routing and sample tiling
(kcftools_tpu_torch/ops/route.py, the kernels csrc/route.cu): sorted
unique reference k-mers with P = 2^b quantile partitions, the stacked
slabs' reference ordinals, and the same keys as a sample's sorted table
with uint32 counts (``sample_case``). The cases reach every path: keys of
the canonical distribution, a key with the top bit of its 2k bits set
(bit 63 at k = 32), the key whose top 32 bits are all set (at k >= 16
its raw partition id is P, clamped to P - 1), mostly empty partitions (and
partitions skipped before the first and after the last key), every key
in one partition (Tq far above the 128 granule), one key and no key;
every case has one all-dead slab and one that is all live; the counts
are all <= 255 (byte-packed), the same with one 256 (not), or up to
2^32 - 1. numpy only: shared by the CPU tests (the plain versions
against ``tile_sorted``, ``pack_planar`` and the native packer) and the
card tests (the kernels against the plain versions).
"""

import numpy as np

KS = (15, 21, 31, 32)
CASES = ("canonical", "top_bit", "top32", "empty_parts", "one_part",
         "one_key", "no_keys")
SLABS, SLAB_POS = 4, 4096  # positions a multiple of 32
COUNTS = ("u8", "one_256", "u32")


def _canonical(rng, n, k):
    """n random k-mers of about the canonical distribution (the smaller of
    two uniform k-mers, as min(fwd, rc) is)."""
    span = np.uint64(1) << np.uint64(2 * k) if k < 32 else None

    def uniform():
        v = rng.integers(0, 1 << 63, n, dtype=np.uint64) << np.uint64(1)
        v |= rng.integers(0, 2, n, dtype=np.uint64)
        return v if span is None else v % span

    return np.minimum(uniform(), uniform())


def top32_key(k):
    """The key whose top 32 of 2k bits are all set, the rest clear (at
    k = 32 the palindrome T^16A^16)."""
    if 2 * k >= 32:
        return np.uint64(0xFFFFFFFF) << np.uint64(2 * k - 32)
    return (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)


def route_case(name, k, seed=0, n=6000):
    """(keys, b, r_idx): sorted unique uint64 keys, the partition bits,
    and (SLABS, SLAB_POS) int32 reference ordinals (-1: dead), slab 1 all
    dead and slab 2 all live."""
    rng = np.random.default_rng(seed)
    b = 5
    top = np.uint64((1 << (2 * k)) - 1) if k < 32 else np.uint64(2**64 - 1)
    if name == "canonical":
        keys = _canonical(rng, n, k)
    elif name == "top_bit":
        hi = np.uint64(1) << np.uint64(2 * k - 1)
        keys = np.concatenate([_canonical(rng, n, k),
                               [hi, hi | np.uint64(5), top]])
    elif name == "top32":
        keys = np.concatenate([_canonical(rng, n, k),
                               [top32_key(k), top]])
    elif name == "empty_parts":
        # a few keys spread over many partitions, none in the first or
        # the last ones
        b = 10
        keys = _canonical(rng, 40, k) | np.uint64(1 << (2 * k - 8))
        keys &= ~(np.uint64(1) << np.uint64(2 * k - 1))
    elif name == "one_part":
        keys = rng.integers(0, 1 << max(12, 2 * k - 24), 700,
                            dtype=np.uint64)
        b = 8
    elif name == "one_key":
        keys = np.array([top32_key(k) >> np.uint64(3)], np.uint64)
    elif name == "no_keys":
        keys = np.zeros(0, np.uint64)
    else:
        raise ValueError(name)
    keys = np.unique(np.asarray(keys, np.uint64))
    n_ref = keys.shape[0]
    if n_ref:
        r_idx = rng.integers(0, n_ref, (SLABS, SLAB_POS)).astype(np.int32)
        r_idx[rng.random((SLABS, SLAB_POS)) < 0.3] = -1
        r_idx[0, :7] = -1  # a word's first bits dead
        r_idx[0, -1] = n_ref - 1
        r_idx[2] = rng.integers(0, n_ref, SLAB_POS)
    else:
        r_idx = np.full((SLABS, SLAB_POS), -1, np.int32)
    r_idx[1] = -1
    return keys, b, r_idx


def host_slabs(r_idx, slot_of_ord):
    """The slot maps and valid bitmaps as the host built them: numpy's
    masked gather and ``np.packbits(live, bitorder="little")``."""
    slot_maps = np.zeros(r_idx.shape, np.int32)
    live = r_idx >= 0
    slot_maps[live] = slot_of_ord[r_idx[live]]
    return slot_maps, np.packbits(live, axis=1, bitorder="little")


def sample_case(name, k, counts, seed=0, n=6000):
    """(keys, b, counts): ``route_case``'s keys and partition bits as a
    sample's sorted table, with uint32 counts: "u8" 1..255 (they
    byte-pack), "one_256" the same but one 256 (they do not), "u32" up to
    2^32 - 1, which is among them."""
    keys, b, _r_idx = route_case(name, k, seed, n)
    rng = np.random.default_rng(seed + 1)
    m = keys.shape[0]
    if counts == "u32":
        c = rng.integers(1, 1 << 32, m, dtype=np.uint64).astype(np.uint32)
        c[m // 3 : m // 3 + 1] = 0xFFFFFFFF
    else:
        c = rng.integers(1, 256, m).astype(np.uint32)
        c[:1] = 255
        if counts == "one_256" and m:
            c[m // 2] = 256
    return keys, b, c

