"""Entry points of the port for compile checks and multi-device dry
runs, the counterpart of the repository's ``__graft_entry__.py``.

``entry()`` returns the single-device forward step of the hash engine
(canonical k-mer extraction -> shard-layout hash lookups -> gap-run
window scoring) with example arguments on the resolved device.

``dryrun_multichip(n)`` runs, on the first n mesh slots
(``torchinit.resolve_devices``; ``KCFTOOLS_TORCH_VIRTUAL_DEVICES=n``
makes n slots on one device), one step of every multi-device path at
tiny shapes: the sharded hash engine from an in-RAM table and from the
streaming loader (several passes), the dprefix engine's slab and sample
spread, and the mesh-sharded device join; each against its
single-device or host result, exactly.

    KCFTOOLS_TORCH_DEVICE=cpu KCFTOOLS_TORCH_VIRTUAL_DEVICES=8 \\
        python -m kcftools_tpu_torch.dryrun
"""

import functools
import os
import sys
import tempfile

import numpy as np
import torch

from .engine.encode import canonicalize, pack_kmers
from .engine.hashtable import build_table
from .engine.prefix_scan import chromosome_stats_indirect, window_stats
from .engine.windows import PAD_MARGIN, tiling_windows
from .io.kmc import write_kmc_db
from .torchinit import resolve_device, resolve_devices

_FIELDS = ("observed", "variations", "inner", "left", "right", "count_sum")


def _tiny_problem(n_windows=8, win_len=192, k=31, seed=0):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=4096).astype(np.uint8)
    valid = np.ones(genome.shape, bool)
    kmers, kvalid = pack_kmers(genome, valid, k)
    canon = np.unique(canonicalize(kmers[kvalid], k))
    counts = rng.integers(1, 50, size=canon.size).astype(np.uint32)
    table = build_table(canon, counts, k)

    Lp = win_len + PAD_MARGIN
    starts = rng.integers(0, genome.size - win_len, size=n_windows)
    codes = np.stack(
        [genome[s : s + win_len] for s in starts]
    ).astype(np.uint32)
    codes = np.pad(codes, ((0, 0), (0, Lp - win_len)))
    bvalid = np.zeros((n_windows, Lp), bool)
    bvalid[:, :win_len] = True
    win_lens = np.full(n_windows, win_len, np.int32)
    return table, codes, bvalid, win_lens, k


def _score_windows_device(codes, valid, win_len, tbl, *, k, min_count,
                          both_strands):
    from .engine.pipeline import FIELDS, SENTINEL, _score_u8_batch

    u8 = torch.where(valid, codes.to(torch.uint8), int(SENTINEL))
    res = _score_u8_batch(u8, win_len, tbl, k=k, min_count=min_count,
                          both_strands=both_strands)
    return dict(zip(FIELDS, res))


def entry():
    """(fn, example_args) of the single-device scoring step."""
    from .engine.pipeline import _table_tensor

    dev = resolve_device()
    table, codes, bvalid, win_lens, k = _tiny_problem()
    fn = functools.partial(
        _score_windows_device, k=k, min_count=1, both_strands=True
    )
    example_args = (
        torch.from_numpy(codes.astype(np.int64)).to(dev),
        torch.from_numpy(bvalid).to(dev),
        torch.from_numpy(win_lens.astype(np.int64)).to(dev),
        _table_tensor(table, dev),
    )
    return fn, example_args


def _slots(n_devices):
    slots = resolve_devices()
    if len(slots) < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}): only {len(slots)} slot(s); "
            "set KCFTOOLS_TORCH_VIRTUAL_DEVICES for a virtual mesh"
        )
    return slots[:n_devices]


def dryrun_multichip(n_devices: int) -> None:
    """One step of every multi-device path on an n-slot mesh (see the
    module docstring); raises on any disagreement."""
    from .parallel.loader import ShardedTableLoader
    from .parallel.mesh import make_mesh
    from .parallel.sharded import ShardedWindowScorer

    slots = _slots(n_devices)
    table_axis = 2 if n_devices % 2 == 0 else 1
    data_axis = n_devices // table_axis
    mesh = make_mesh(data=data_axis, table=table_axis, devices=slots)

    table, codes, bvalid, win_lens, k = _tiny_problem(
        n_windows=max(8, data_axis)
    )

    # in-RAM sharded path (host-built table re-placed shard-locally)
    scorer = ShardedWindowScorer(table, mesh, min_count=1)
    out = scorer.score_batch(codes, bvalid, win_lens)
    assert out["total"].shape[0] == codes.shape[0]
    assert (out["total"] > 0).all()

    # streaming loader path: write the same keys as a KMC database and
    # stream it onto the mesh under a budget that forces several passes
    live = table.counts != 0
    rows, cols = np.nonzero(live)
    hi = table.hi[rows, cols].astype(np.uint64)
    lo = table.lo[rows, cols].astype(np.uint64)
    n_lo = k - min(k, 16)  # split_hi_lo inverse (engine/encode.py)
    kmers = (hi << np.uint64(2 * n_lo)) | lo
    counts = table.counts[rows, cols].astype(np.uint64)
    order = np.argsort(kmers)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "db")
        write_kmc_db(prefix, kmers[order], counts[order], k)
        loader = ShardedTableLoader(
            prefix, mesh, ram_budget_bytes=1, slab_records=512
        )
        streamed = loader.load_scorer(min_count=1)
        out2 = streamed.score_batch(codes, bvalid, win_lens)
    for key in out:
        np.testing.assert_array_equal(out2[key], out[key], err_msg=key)

    _dryrun_dprefix(slots)
    _dryrun_mesh_join(slots)


def _dryrun_dprefix(slots) -> None:
    """The path ``--engine auto`` takes with more than one device: the
    dprefix engine spreads the genome's window-aligned slabs over every
    slot. Its slabs must land on more than one slot and its results
    match the host prefix-decomposition oracle exactly; with fewer slabs
    than slots, a group's sample rows must spread over a slab's pool."""
    from .engine.device_prefix import DevicePrefixScorer

    rng = np.random.default_rng(7)
    k = 31
    seq_len = 8192
    n_ref = 6000
    starts, ends = tiling_windows(seq_len, 512, k)
    n_pos = seq_len - k + 1
    r_idx = rng.integers(0, n_ref, n_pos).astype(np.int32)
    r_idx[rng.random(n_pos) < 0.05] = -1  # k-mers spanning non-ACGT
    counts_u8 = rng.integers(0, 12, n_ref).astype(np.uint8)
    exc_sel = np.sort(rng.choice(n_ref, 5, replace=False))
    counts_u8[exc_sel] = 255  # saturated: exact values ride exceptions
    exc_idx = exc_sel.astype(np.int32)
    exc_val = (255 + rng.integers(0, 100, 5)).astype(np.uint32)

    dsc = DevicePrefixScorer(None, k, min_count=1, devices=slots)
    dsc.add_chrom("c", r_idx, starts, ends)
    dsc.submit_counts(0, counts_u8, exc_idx, exc_val)
    res = dsc.collect(0)["c"]
    used = dsc.devices_used()
    dsc.close()
    assert len(used) > 1, f"dprefix slabs on {len(used)} slot(s), want >1"

    counts_r = counts_u8.astype(np.uint32)
    counts_r[exc_idx] = exc_val
    st = chromosome_stats_indirect(
        counts_r, r_idx, np.ones(seq_len, bool), 1, k
    )
    want = window_stats(st, starts, ends)
    for key in _FIELDS:
        np.testing.assert_array_equal(res[key], want[key], err_msg=key)

    if len(slots) > 1:
        seq2 = 1024
        n_pos2 = seq2 - k + 1
        r2 = rng.integers(0, 800, n_pos2).astype(np.int32)
        s2, e2 = tiling_windows(seq2, 512, k)
        dsc2 = DevicePrefixScorer(None, k, min_count=1, batch=4,
                                  devices=slots)
        dsc2.add_chrom("c", r2, s2, e2)
        sample_counts = []
        for i in range(4):
            cu8 = rng.integers(0, 7, 800).astype(np.uint8)
            sample_counts.append(cu8)
            dsc2.submit_counts(i, cu8, np.empty(0, np.int32),
                               np.empty(0, np.uint32))
        rows_devs = dsc2.sample_rows_devices()
        assert len(rows_devs) > 1, (
            f"sample rows on {len(rows_devs)} slot(s), want >1"
        )
        for i, cu8 in enumerate(sample_counts):
            got = dsc2.collect(i)["c"]
            st2 = chromosome_stats_indirect(
                cu8.astype(np.uint32), r2, np.ones(seq2, bool), 1, k
            )
            want2 = window_stats(st2, s2, e2)
            for key in ("observed", "variations", "count_sum"):
                np.testing.assert_array_equal(
                    got[key], want2[key], err_msg=f"s{i} {key}"
                )
        dsc2.close()


def _dryrun_mesh_join(slots) -> None:
    """The mesh-sharded device join (partitions over the table axis,
    slabs over the data axis, one join per table shard) must match the
    single-device join scorer exactly."""
    if len(slots) < 2:
        return
    from .engine.device_join import DeviceJoinScorer, MeshJoinScorer
    from .parallel.mesh import make_mesh

    rng = np.random.default_rng(5)
    k = 31
    length = 16_384
    genome = rng.integers(0, 4, length).astype(np.uint8)
    kmers, kv = pack_kmers(genome, np.ones(length, bool), k)
    canon = canonicalize(kmers, k)
    refk = np.unique(canon[kv])
    r_idx = np.searchsorted(refk, canon).astype(np.int32)
    starts, ends = tiling_windows(length, 1024, k)
    db = refk[rng.random(refk.shape[0]) < 0.8]
    dbc = rng.integers(1, 9, db.shape[0]).astype(np.uint32)

    class _R:
        pass

    ref = _R()
    ref.kmers = refk
    single = DeviceJoinScorer(ref, k, slots[0].device, min_count=1)
    single.add_chrom("c", r_idx, starts, ends)
    single.submit(0, refk, db, dbc)
    want = single.collect(0)["c"]

    t_axis = 2 if len(slots) % 2 == 0 else 1
    mesh = make_mesh(data=len(slots) // t_axis, table=t_axis, devices=slots)
    msc = MeshJoinScorer(ref, k, mesh, min_count=1)
    msc.add_chrom("c", r_idx, starts, ends)
    msc.submit(0, refk, db, dbc)
    got = msc.collect(0)["c"]
    for key in _FIELDS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    n_slices = len(msc._q)
    assert n_slices == t_axis, f"table sliced {n_slices}x, want {t_axis}"
    assert all(q[0].shape[0] == msc.P // t_axis for q in msc._q.values())


def main():
    fn, args = entry()
    out = fn(*args)
    print({key: v.shape for key, v in out.items()})
    dryrun_multichip(len(resolve_devices()))
    print("dryrun ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
