"""increaseWindow: coarsen a KCF by merging consecutive same-chromosome
windows (reference: Plugins/IncreaseWindows.java).

Merge algebra (combineWindows, :133-212): groups of
windowSize/currentWindowSize + 1 consecutive windows; within a group the
first window keeps its left tail (its right tail folds into the inner
distance), the last keeps its right tail, middles fold both; a variation
is de-duplicated when the previous window ended with a right-tail gap
and the current starts with a left-tail gap; per-sample k-mer totals
re-accumulate mean*observed with Java's long-compound-assignment
truncation at every step. Stepped inputs are rejected.
"""

import numpy as np

from ..io.kcf import KCFReader, KCFWriter, WindowBlock
from ..utils.logger import Logger
from ._common import get_command_line

_CLASS = "IncreaseWindows"


def add_parser(subparsers):
    p = subparsers.add_parser(
        "increaseWindow",
        help="Increase the window size of a KCF file by merging windows",
    )
    p.add_argument("-i", "--input", required=True, help="Input KCF file")
    p.add_argument("-o", "--output", required=True, help="Output KCF file")
    p.add_argument("-w", "--window", type=int, required=True, help="Window size")
    p.set_defaults(func=run)
    return p


def run(args):
    reader = KCFReader(args.input)
    header = reader.header
    if header.step_size > 0:
        Logger.error(
            _CLASS,
            "Cannot increase window size of a KCF file with overlapping "
            "windows (stepSize > 0)",
        )
    current = header.window_size
    if current > args.window:
        Logger.error(_CLASS, "Window size is smaller than the current window size")

    step = args.window // current + 1

    # Stream input batches; the (possibly incomplete) last group of each
    # batch carries into the next so merges never split. The final
    # header windowSize (max merged effLength, IncreaseWindows.java:97)
    # is only known at the end, so merged rows go to a temp body file
    # first. Peak memory: one batch + one merged batch.
    import os
    import tempfile

    from ..io.kcf import format_block_bytes

    max_eff = 0
    fd, body_path = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(args.output)) or ".",
        prefix=".kcfiw_",
    )
    carry = None
    try:
        with os.fdopen(fd, "wb") as body:
            for block in reader.batches():
                if carry is not None and len(carry):
                    block = WindowBlock.concat([carry, block])
                # hold back the trailing group: the next batch may
                # continue it (same chromosome, group not yet full)
                names = block.seq_names
                n = len(block)
                cut = n
                last_name = names[-1]
                run_len = 0
                while cut > 0 and names[cut - 1] == last_name:
                    cut -= 1
                    run_len += 1
                hold = run_len % step or step
                cut = n - min(hold, run_len)
                carry = block.select(np.arange(cut, n))
                if cut == 0:
                    continue
                merged = _merge_groups(
                    block.select(np.arange(cut)), step, header.weights
                )
                if len(merged):
                    max_eff = max(max_eff, int(merged.eff_length.max()))
                    body.write(format_block_bytes(merged))
            if carry is not None and len(carry):
                merged = _merge_groups(carry, step, header.weights)
                if len(merged):
                    max_eff = max(max_eff, int(merged.eff_length.max()))
                    body.write(format_block_bytes(merged))

        header.window_size = max_eff
        header.add_command_line(get_command_line())
        with KCFWriter(args.output) as writer:
            writer.write_header(header)
            with open(body_path, "rb") as body:
                while True:
                    chunk = body.read(1 << 24)
                    if not chunk:
                        break
                    writer._fh.write(chunk)
    finally:
        if os.path.exists(body_path):
            os.unlink(body_path)


def _merge_groups(block, step, weights):
    """Merge one batch's complete groups (vectorized combineWindows)."""
    n = len(block)
    s = block.n_samples

    # group ids: consecutive same-chromosome runs chunked by `step`
    names = block.seq_names
    group_id = np.zeros(n, np.int64)
    win_index = np.zeros(n, np.int64)
    gid = -1
    idx_in_group = 0
    last_name = None
    for i in range(n):
        if names[i] != last_name or idx_in_group == step:
            gid += 1
            idx_in_group = 0
            last_name = names[i]
        group_id[i] = gid
        win_index[i] = idx_in_group
        idx_in_group += 1
    n_groups = gid + 1

    group_size = np.bincount(group_id, minlength=n_groups)
    first_row = np.searchsorted(group_id, np.arange(n_groups))
    last_row = np.searchsorted(group_id, np.arange(n_groups), side="right") - 1

    tot = np.bincount(group_id, weights=block.total_kmers, minlength=n_groups).astype(
        np.int64
    )

    va = np.zeros((s, n_groups), np.int64)
    ob = np.zeros((s, n_groups), np.int64)
    idist = np.zeros((s, n_groups), np.int64)
    ld = np.zeros((s, n_groups), np.int64)
    rd = np.zeros((s, n_groups), np.int64)
    kt = np.zeros((s, n_groups), np.int64)
    prev_rd = np.zeros((s, n_groups), np.int64)

    max_t = int(group_size.max()) if n_groups else 0
    for t in range(max_t):
        gmask = group_size > t  # groups having a t-th member
        rows = first_row[gmask] + t
        g = np.flatnonzero(gmask)
        left = block.left[:, rows]
        right = block.right[:, rows]
        vars_ = block.va[:, rows]
        single = group_size[g] == 1
        is_first = t == 0
        is_last = t == group_size[g] - 1

        dedup = (prev_rd[:, g] > 0) & (left > 0) & (vars_ > 0)
        va[:, g] += np.where(dedup, vars_ - 1, vars_)
        ob[:, g] += block.ob[:, rows]
        idist[:, g] += block.inner[:, rows]
        # Java: kt[i] += mean*obs with compound-assignment truncation
        kt[:, g] = (kt[:, g].astype(np.float64)
                    + block.mean_kd[:, rows] * block.ob[:, rows]).astype(np.int64)

        if is_first:
            ld[:, g] += left
            idist[:, g] += np.where(single, 0, right)
            rd[:, g] += np.where(single, right, 0)
        else:
            rd_add = np.where(is_last, right, 0)
            id_add = np.where(is_last, left, left + right)
            rd[:, g] += rd_add
            idist[:, g] += id_add
        prev_rd[:, g] = right

    out = WindowBlock(n_groups, block.samples)
    out.seq_names = [names[first_row[g]] for g in range(n_groups)]
    out.start = block.start[first_row]
    out.end = block.end[last_row]
    out.window_id = [
        f"{out.seq_names[g]}_{out.start[g]}" for g in range(n_groups)
    ]
    out.total_kmers = tot
    out.eff_length = out.end - out.start
    out.va = va
    out.ob = ob
    out.inner = idist
    out.left = ld
    out.right = rd
    out.kmer_count = kt
    out.finalize(weights)
    return out
