"""The plain reference against a naive per-window state machine, against
the port's host engine, and its control (CPU)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import datagen, reference
from portbench_tiny import ROOT, tiny_config

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _canon(s):
    rc = "".join(_COMP[c] for c in reversed(s))
    return min(s, rc)


def _naive(seq, k, db, min_count=1):
    """The reference tool's window loop on a string (N resets nothing:
    only valid k-mers are visited)."""
    total = observed = var = inner = left = right = csum = 0
    gap, is_tail = 0, True
    for i in range(len(seq) - k + 1):
        km = seq[i:i + k]
        if any(c not in "ACGT" for c in km):
            continue
        total += 1
        cnt = db.get(_canon(km), 0)
        if cnt >= min_count:
            csum += cnt
            observed += 1
            if gap > 0:
                var += 1
                if is_tail:
                    left += gap
                else:
                    d = gap - (k - 1)
                    inner += abs(d + 1) if d <= 0 else d
            is_tail = False
            gap = 0
        else:
            gap += 1
    if total > 0 and gap > 0:
        var += 1
        right += gap
    eff = stretch = 0
    for c in seq + "N":
        if c in "ACGT":
            stretch += 1
        else:
            eff += stretch if stretch >= k else 0
            stretch = 0
    return {"total": total, "observed": observed, "variations": var,
            "inner": inner, "left": left, "right": right,
            "count_sum": csum, "eff_length": eff}


def _decode(key, k):
    return "".join("ACGT"[(key >> (2 * (k - 1 - t))) & 3] for t in range(k))


def _seq(contig):
    s = np.frombuffer(b"ACGT", np.uint8)[contig.codes.numpy()].copy()
    s[~contig.valid.numpy()] = ord("N")
    return s.tobytes().decode()


@pytest.mark.parametrize("mode", ["window", "gene"])
def test_reference_matches_naive(mode):
    k = 11
    cfg = {"k": k, "contigs": [{"name": "a", "length": 3000},
                               {"name": "b", "length": 1700}],
           "n_runs": {"per_contig": 4, "length": [1, 40]},
           "samples": [{"name": "s", "counts": "raised", "snp_rate": 0.05,
                        "error_frac": 0.1}],
           "genes": ({"count": 25, "transcripts": 31, "span": [20, 400],
                      "exons": [1, 10]} if mode == "gene" else None)}
    inp, _ = datagen.make_inputs(cfg, 99, "cpu")
    s = inp.samples[0]
    # a third of the sample's k-mers fall below the min count
    counts = s.counts.clone()
    counts[::3] = 1
    db = {_decode(x, k): c for x, c in zip(s.keys.tolist(), counts.tolist())}
    if mode == "window":
        wins = reference.Windows.tiling(inp, 300)
    else:
        wins = reference.Windows.genes(inp)
    st, sizes = reference.window_stats(inp, wins, s.keys, counts, k,
                                       min_count=2)
    seqs = [_seq(c) for c in inp.contigs]
    by_win = {}
    for w, ci, a, b in wins.ranges:
        by_win.setdefault(w, []).append(seqs[ci][a:b])
    assert len(by_win) == len(wins.labels)
    for w, parts in by_win.items():
        want = _naive("".join(parts), k, db, min_count=2)
        got = {f: int(st[f][w]) for f in reference.FIELDS}
        assert got == want, (w, wins.labels[w])
    assert sizes["kmers"] == int(st["total"].sum())


def test_exon_union():
    assert reference.exon_union([[(5, 9), (20, 30)], [(8, 12), (31, 31)],
                                 [(40, 40)]]) == [[5, 12], [20, 31],
                                                  [40, 40]]


def test_f2_rounds_exact_double_half_up():
    assert reference.f2(0.125) == "0.13"
    assert reference.f2(2.675) == "2.67"  # the double lies below .675
    assert reference.f2(0.0) == "0.00"
    assert reference.f2(4294967295.0) == "4294967295.00"


@pytest.mark.parametrize("name", ["lettuce-chr3-w50k",
                                  "arabidopsis-tair10-gene"])
def test_reference_rows_equal_host_engine(tmp_path, name):
    """The reference's rows equal the port's ``--engine hybrid`` KCF."""
    cfg = tiny_config(name)
    inp, files = datagen.make_inputs(cfg, 2**31 + 5, "cpu", str(tmp_path))
    cmd = cfg["command"]
    if cmd["feature"] == "window":
        wins = reference.Windows.tiling(inp, cmd["window"])
    else:
        wins = reference.Windows.genes(inp)
    for s, db in zip(inp.samples, files["dbs"]):
        out = str(tmp_path / f"{s.name}.kcf")
        argv = [sys.executable, "-m", "kcftools_tpu_torch.cli",
                "getVariations", "-r", files["fasta"], "-k", db, "-s",
                s.name, "-o", out, "-f", cmd["feature"], "--engine",
                "hybrid"]
        argv += (["-w", str(cmd["window"])] if cmd["feature"] == "window"
                 else ["-g", files["gtf"]])
        env = dict(os.environ, KCFTOOLS_TORCH_DEVICE="cpu")
        subprocess.run(argv, check=True, cwd=ROOT, env=env,
                       capture_output=True)
        st, _ = reference.window_stats(inp, wins, s.keys, s.counts, inp.k)
        want = reference.rows(wins, st)
        got = reference.kcf_rows(out)
        assert len(got) == len(want) > 0
        assert reference.bad_rows(got, want) == 0


@pytest.mark.parametrize("name", ["lettuce-chr3-w50k",
                                  "arabidopsis-tair10-gene"])
def test_control_is_found_wrong(name):
    """The control (counts kept in a byte) fails the comparison; the
    reference passes it."""
    from portbench import control, harness
    from portbench_tiny import tiny_spec

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        cell = harness.Cell(tiny_spec(tmp), f"{name}.per-sample", ROOT)
        r = control.reading(cell, 2**31 + 9, "cpu")
    assert r["bad_windows_exact"] == 0
    assert r["bad_windows"] > 0
    assert reference.saturated(torch.tensor([1, 255, 256, 1 << 32])).tolist(
    ) == [1, 255, 255, 255]
