"""The generators and the frozen KMC writer (CPU)."""

import numpy as np
import pytest
import torch

from portbench import datagen, kmcwrite
from portbench_tiny import tiny_config


def _same(a, b):
    assert len(a.contigs) == len(b.contigs)
    for x, y in zip(a.contigs, b.contigs):
        assert torch.equal(x.codes, y.codes) and torch.equal(x.valid, y.valid)
    for x, y in zip(a.samples, b.samples):
        if not (torch.equal(x.keys, y.keys)
                and torch.equal(x.counts, y.counts)):
            return False
    return True


@pytest.mark.parametrize("name", ["lettuce-chr3-w50k",
                                  "arabidopsis-tair10-gene"])
def test_inputs_deterministic_from_seed(name):
    cfg = tiny_config(name)
    a, _ = datagen.make_inputs(cfg, 2**31 + 3, "cpu")
    b, _ = datagen.make_inputs(cfg, 2**31 + 3, "cpu")
    c, _ = datagen.make_inputs(cfg, 2**31 + 4, "cpu")
    assert _same(a, b)
    if a.genes:
        assert [(g.start, g.end, g.transcripts) for g in a.genes] == [
            (g.start, g.end, g.transcripts) for g in b.genes]
    assert not torch.equal(a.contigs[0].codes, c.contigs[0].codes)
    # sizes are the configuration's, whatever the seed
    assert a.genome_bp == c.genome_bp
    assert len(a.genes or []) == len(c.genes or [])


def test_sample_counts_models():
    cfg = tiny_config("lettuce-chr3-w50k")
    inp, _ = datagen.make_inputs(cfg, 11, "cpu")
    s1, s2 = inp.samples
    assert int(s1.counts.max()) <= 255 and int(s1.counts.min()) >= 1
    assert int(s2.counts.min()) >= 256
    assert int(s2.counts.max()) == (1 << 32) - 1
    assert bool((s1.keys[1:] > s1.keys[:-1]).all())


def test_genes_shape():
    cfg = tiny_config("arabidopsis-tair10-gene")
    inp, _ = datagen.make_inputs(cfg, 5, "cpu")
    g = inp.genes
    assert len(g) == cfg["genes"]["count"]
    assert sum(len(x.transcripts) for x in g) == cfg["genes"]["transcripts"]
    for x in g:
        assert 1 <= len(x.transcripts) <= 3
        for exons in x.transcripts:
            assert 1 <= len(exons) <= 10
            for a, b in exons:
                assert x.start <= a <= b <= x.end


@pytest.mark.parametrize("counter_bytes", [1, 4])
def test_kmc_writer_reads_back(tmp_path, counter_bytes):
    """The frozen writer's databases through the port's reader."""
    from kcftools_tpu_torch.io.kmc import KMCReader

    g = torch.Generator().manual_seed(1)
    k = 31
    raw = torch.randint(0, 1 << (2 * k), (5000,), generator=g)
    keys = torch.unique(torch.minimum(raw, datagen.revcomp_packed(raw, k)))
    hi = 255 if counter_bytes == 1 else (1 << 32) - 1
    counts = torch.randint(1, hi + 1, keys.shape, generator=g)
    prefix = str(tmp_path / "db")
    kmcwrite.write_db(prefix, keys, counts, k, counter_bytes)
    r = KMCReader(prefix)
    assert r.kmer_length == k and r.both_strands
    assert r.counter_size == counter_bytes
    order = np.argsort(r.kmers)
    np.testing.assert_array_equal(r.kmers[order], keys.numpy().astype(np.uint64))
    np.testing.assert_array_equal(r.counts[order], counts.numpy().astype(np.uint32))


def test_signatures_match_kmc_rule():
    """A k-mer's signature is the least normalised m-mer of its m-mers."""
    norm = kmcwrite.norm_table()
    g = torch.Generator().manual_seed(2)
    keys = torch.randint(0, 1 << 62, (200,), generator=g)
    got = kmcwrite.signatures(keys, 31, torch.from_numpy(norm)).numpy()
    m = kmcwrite.SIG_LEN
    for x, s in zip(keys.tolist(), got):
        want = min(int(norm[(x >> (2 * (31 - m - t))) & ((1 << 2 * m) - 1)])
                   for t in range(31 - m + 1))
        assert s == want
