"""The yardstick: the card's peak and the bytes each layer's problem
needs, counted from the cell's sizes and data, never from a kernel's
tiles or arguments. Every input is read once and every output written
once; a roofline share is the least time those bytes take at the peak
over the device time the layer's kernels took.

``width`` is the bytes of a count: 1 where every count of the sample
fits a byte, else 4.
"""

# H100 SXM 80 GB HBM3, NVIDIA's data sheet (at the 700 W power limit;
# the run records the card's limit beside every share)
HBM_BYTES_PER_S = 3.35e12
WINDOW_BOUNDS = 16  # a window's start and end, int64
JOIN_STATS = 48  # a window's six sample statistics of the join path, int64
HASH_STATS = 64  # a feature's eight statistics of the hash engine, int64


def count_width(max_count: int) -> int:
    return 1 if max_count <= 0xFF else 4


def join_bytes(n_ref: int, n_sample: int, width: int) -> int:
    """Resolve the count of each of ``n_ref`` distinct reference k-mers
    against a sample of ``n_sample`` (key, count) entries: the reference
    keys read (8 B each), the sample entries a join needs (the fewer of
    the two sets, 8 B + ``width`` each), a count written per reference
    k-mer."""
    return 8 * n_ref + min(n_ref, n_sample) * (8 + width) + width * n_ref


def scan_bytes(n_pos: int, n_ref: int, n_win: int, width: int) -> int:
    """The gap-run statistics of ``n_win`` windows over ``n_pos`` k-mer
    positions: each position's reference k-mer ordinal read (4 B, an
    invalid position marked in it), each reference k-mer's count read
    once, the windows' bounds read and their statistics written."""
    return (4 * n_pos + width * n_ref
            + (WINDOW_BOUNDS + JOIN_STATS) * n_win)


def hash_bytes(n_bases: int, n_kmers: int, n_feat: int, width: int) -> int:
    """The hash engine's features: each spliced base read (1 B), each
    valid k-mer's sample entry looked up (8 B + ``width``), the
    features' bounds read and their statistics written."""
    return (n_bases + n_kmers * (8 + width)
            + (WINDOW_BOUNDS + HASH_STATS) * n_feat)


def roofline_pct(nbytes: int, device_s: float):
    """Percent of the memory roofline; None without device time."""
    if not device_s or device_s <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
