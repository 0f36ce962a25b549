"""Inputs of a cell, made from the seed with torch on the device.

Everything a run feeds the program comes from here: the reference genome
(FASTA), each sample's canonical k-mer set with its counts (written as a
KMC3 database by ``kmcwrite``) and, for feature modes, a GTF. The same
seed gives the same inputs on the same device. Sizes come from the
configuration alone, so every seed does the same amount of work; the
seed moves only where things are (bases, SNPs, N runs, genes).

The arrays are made on the device and returned on the host, so that
they take no device memory while the program runs.
"""

import hashlib
import os
from dataclasses import dataclass, field

import numpy as np
import torch

ASCII = np.frombuffer(b"ACGTN", np.uint8)
FASTA_WIDTH = 60
# a KMC counter of one byte (KMC's default -cs255) or of four
COUNTER_BYTES = {"byte": 1, "raised": 4}


def subseed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named random stream of a run."""
    h = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, stream))
    return g


# -- k-mers -------------------------------------------------------------


def revcomp_packed(x: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of 2-bit packed k-mers (first base highest)."""
    out = torch.zeros_like(x)
    for t in range(k):
        b = (x >> (2 * (k - 1 - t))) & 3
        out |= (3 - b) << (2 * t)
    return out


def kmers(codes: torch.Tensor, valid: torch.Tensor, k: int):
    """Canonical k-mers of every start of a code array and whether the
    k bases there are all ACGT: (canon int64 (n-k+1,), ok bool)."""
    n = codes.shape[0]
    m = n - k + 1
    dev = codes.device
    if m <= 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    fwd = torch.zeros(m, dtype=torch.int64, device=dev)
    rev = torch.zeros(m, dtype=torch.int64, device=dev)
    for t in range(k):
        x = codes[t:t + m].to(torch.int64)
        fwd <<= 2
        fwd |= x
        rev |= (3 - x) << (2 * t)
    bad = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    bad[1:] = torch.cumsum((~valid).to(torch.int32), 0)
    ok = (bad[k:] - bad[:m]) == 0
    return torch.minimum(fwd, rev), ok


# -- the reference genome -----------------------------------------------


@dataclass
class Contig:
    name: str
    codes: torch.Tensor  # uint8 2-bit codes (0 where N)
    valid: torch.Tensor  # bool, ACGT


@dataclass
class Gene:
    """One gene of the GTF: 1-based inclusive coordinates, its
    transcripts' exons as (start, end) pairs."""

    gene_id: str
    contig: int
    start: int
    end: int
    strand: str
    transcripts: list = field(default_factory=list)


@dataclass
class Sample:
    name: str
    keys: torch.Tensor  # sorted unique canonical k-mers, int64
    counts: torch.Tensor  # int64, >= 1
    counter_bytes: int


@dataclass
class Inputs:
    k: int
    contigs: list
    samples: list
    genes: list | None = None

    @property
    def genome_bp(self) -> int:
        return sum(c.codes.shape[0] for c in self.contigs)


def make_contigs(cfg, seed, device):
    """Random bases, with ``n_runs`` runs of N per contig."""
    lo, hi = cfg["n_runs"]["length"]
    out = []
    for ci, c in enumerate(cfg["contigs"]):
        g = generator(seed, f"contig/{ci}", device)
        n = int(c["length"])
        codes = torch.randint(0, 4, (n,), generator=g, device=device,
                              dtype=torch.uint8)
        nr = int(cfg["n_runs"]["per_contig"])
        at = torch.randint(0, max(1, n - hi), (nr,), generator=g,
                           device=device)
        ln = torch.randint(lo, hi + 1, (nr,), generator=g, device=device)
        d = torch.zeros(n + hi + 1, dtype=torch.int32, device=device)
        one = torch.ones(nr, dtype=torch.int32, device=device)
        d.index_add_(0, at, one)
        d.index_add_(0, at + ln, -one)
        valid = torch.cumsum(d, 0)[:n] == 0
        codes[~valid] = 0
        out.append(Contig(c["name"], codes, valid))
    return out


def write_fasta(path, contigs):
    """FASTA with 60-base lines, N where a base is not ACGT."""
    with open(path, "wb") as fh:
        for c in contigs:
            fh.write(f">{c.name}\n".encode())
            asc = torch.where(c.valid, c.codes, 4).cpu().numpy()
            asc = ASCII[asc]
            n_full = asc.shape[0] // FASTA_WIDTH
            body = np.empty((n_full, FASTA_WIDTH + 1), np.uint8)
            body[:, :FASTA_WIDTH] = asc[: n_full * FASTA_WIDTH].reshape(
                -1, FASTA_WIDTH)
            body[:, FASTA_WIDTH] = ord("\n")
            fh.write(body.tobytes())
            if asc.shape[0] > n_full * FASTA_WIDTH:
                fh.write(asc[n_full * FASTA_WIDTH:].tobytes() + b"\n")


# -- samples --------------------------------------------------------------


def kmer_positions(cfg) -> int:
    """k-mer start positions of the genome (a size of the config, the
    same for every seed)."""
    k = int(cfg["k"])
    return sum(max(0, int(c["length"]) - k + 1) for c in cfg["contigs"])


def make_sample(cfg, contigs, si, seed, device) -> Sample:
    """The canonical k-mers of a copy of the genome with SNPs at
    ``snp_rate``, plus ``error_frac`` x the genome's k-mer positions of
    random error k-mers; counts are each k-mer's multiplicity times a
    depth, by the sample's counter model."""
    sc = cfg["samples"][si]
    k = int(cfg["k"])
    g = generator(seed, f"sample/{si}", device)
    parts = []
    for c in contigs:
        n = c.codes.shape[0]
        snp = torch.rand(n, generator=g, device=device) < sc["snp_rate"]
        shift = torch.randint(1, 4, (n,), generator=g, device=device,
                              dtype=torch.uint8)
        mutated = torch.where(snp, (c.codes + shift) % 4, c.codes)
        del snp, shift
        canon, ok = kmers(mutated, c.valid, k)
        parts.append(canon[ok])
        del mutated, canon, ok
    n_err = int(sc["error_frac"] * kmer_positions(cfg))
    err = torch.randint(0, 1 << (2 * k), (n_err,), generator=g,
                        device=device, dtype=torch.int64)
    parts.append(torch.minimum(err, revcomp_packed(err, k)))
    del err
    keys, mult = torch.unique(torch.cat(parts), sorted=True,
                              return_counts=True)
    del parts
    model = sc["counts"]
    if model == "byte":
        depth = torch.randint(3, 60, keys.shape, generator=g, device=device)
        counts = torch.clamp(mult * depth, max=255)
    elif model == "raised":
        depth = torch.randint(256, 5000, keys.shape, generator=g,
                              device=device)
        counts = mult * depth
        big = torch.randint(0, keys.shape[0], (1000,), generator=g,
                            device=device)
        counts[big] = torch.randint(1 << 31, 1 << 32, (1000,), generator=g,
                                    device=device)
        counts[big[0]] = (1 << 32) - 1
    else:
        raise ValueError(f"unknown counts model {model!r}")
    return Sample(sc["name"], keys, counts.to(torch.int64),
                  COUNTER_BYTES[model])


# -- genes ----------------------------------------------------------------


def make_genes(cfg, contigs, seed, device):
    """``genes.count`` genes spread over the contigs by length, spans
    log-uniform in ``genes.span``, starts strictly increasing per contig;
    ``genes.transcripts`` transcripts in all, 1-3 a gene; 1-10 exons a
    transcript, each an interval between two sorted random cut points of
    the gene's span (exons may touch or overlap)."""
    gc = cfg["genes"]
    g = generator(seed, "genes", device)
    lengths = np.array([c.codes.shape[0] for c in contigs], np.int64)
    n_total = int(gc["count"])
    share = np.floor(n_total * lengths / lengths.sum()).astype(np.int64)
    share[: n_total - int(share.sum())] += 1
    lo, hi = gc["span"]
    max_ex = int(gc["exons"][1])
    n_extra = int(gc["transcripts"]) - n_total
    extra_slot = torch.randperm(2 * n_total, generator=g, device=device)
    n_tr = torch.ones(n_total, dtype=torch.int64, device=device)
    n_tr.index_add_(0, extra_slot[:n_extra] // 2,
                    torch.ones(n_extra, dtype=torch.int64, device=device))
    n_tr = n_tr.cpu().numpy()
    genes = []
    gi = 0
    for ci, c in enumerate(contigs):
        n = int(share[ci])
        span = torch.exp(
            torch.empty(n, device=device, dtype=torch.float64).uniform_(
                float(np.log(lo)), float(np.log(hi)), generator=g)
        ).round().to(torch.int64)
        room = int(lengths[ci]) - hi - n - 1
        starts = torch.sort(torch.randint(
            0, room, (n,), generator=g, device=device)).values
        starts = starts + torch.arange(n, device=device) + 1  # 1-based
        strand = torch.randint(0, 2, (n,), generator=g, device=device)
        n_t = int(n_tr[gi: gi + n].sum())
        n_ex = torch.randint(int(gc["exons"][0]), max_ex + 1, (n_t,),
                             generator=g, device=device)
        # 2 * max_ex cuts a transcript; the first 2 * n_ex, sorted, bound
        # its exons
        u = torch.rand((n_t, 2 * max_ex), generator=g, device=device,
                       dtype=torch.float64)
        tr_gene = torch.repeat_interleave(
            torch.arange(n, device=device),
            torch.from_numpy(n_tr[gi: gi + n]).to(device))
        cuts = (u * span[tr_gene, None].to(torch.float64)).floor().to(
            torch.int64)
        cuts = torch.minimum(cuts, span[tr_gene, None] - 1)
        take = torch.arange(2 * max_ex, device=device)[None, :] < (
            2 * n_ex[:, None])
        cuts = torch.where(take, cuts, torch.iinfo(torch.int64).max)
        cuts = torch.sort(cuts, dim=1).values
        span, starts, strand = (a.cpu().numpy() for a in (span, starts,
                                                          strand))
        cuts, n_ex, tr_gene = (a.cpu().numpy() for a in (cuts, n_ex,
                                                         tr_gene))
        t = 0
        for j in range(n):
            gs = int(starts[j])
            gene = Gene(f"G{gi + j + 1:05d}", ci, gs, gs + int(span[j]) - 1,
                        "+-"[int(strand[j])])
            for _ in range(int(n_tr[gi + j])):
                cs = cuts[t, : 2 * int(n_ex[t])].reshape(-1, 2) + gs
                gene.transcripts.append([(int(a), int(b)) for a, b in cs])
                t += 1
            genes.append(gene)
        gi += n
    return genes


def write_gtf(path, contigs, genes):
    """A gene line, and per transcript an mRNA line (first exon start to
    last exon end) and its exon lines."""
    rows = []
    for gene in genes:
        chrom = contigs[gene.contig].name
        pre = f"{chrom}\tportbench\t"
        post = f"\t.\t{gene.strand}\t.\t"
        rows.append(f"{pre}gene\t{gene.start}\t{gene.end}{post}"
                    f'gene_id "{gene.gene_id}";\n')
        for t, exons in enumerate(gene.transcripts):
            attrs = (f'gene_id "{gene.gene_id}"; transcript_id '
                     f'"{gene.gene_id}.{t + 1}";')
            rows.append(f"{pre}mRNA\t{exons[0][0]}\t{exons[-1][1]}{post}"
                        f"{attrs}\n")
            for a, b in exons:
                rows.append(f"{pre}exon\t{a}\t{b}{post}{attrs}\n")
    with open(path, "w") as fh:
        fh.writelines(rows)


def make_inputs(cfg, seed, device, workdir=None):
    """Make every input of a run and, given ``workdir``, write the files
    the program reads there. Returns (Inputs on the host, {"fasta",
    "gtf", "dbs"})."""
    from . import kmcwrite

    k = int(cfg["k"])
    contigs = make_contigs(cfg, seed, device)
    files = {"fasta": None, "gtf": None, "dbs": []}
    if workdir is not None:
        files["fasta"] = os.path.join(workdir, "ref.fa")
        write_fasta(files["fasta"], contigs)
    genes = None
    if cfg.get("genes"):
        genes = make_genes(cfg, contigs, seed, device)
        if workdir is not None:
            files["gtf"] = os.path.join(workdir, "genes.gtf")
            write_gtf(files["gtf"], contigs, genes)
    samples = []
    for si in range(len(cfg["samples"])):
        s = make_sample(cfg, contigs, si, seed, device)
        if workdir is not None:
            prefix = os.path.join(workdir, s.name)
            kmcwrite.write_db(prefix, s.keys, s.counts, k, s.counter_bytes)
            files["dbs"].append(prefix)
        s.keys, s.counts = s.keys.cpu(), s.counts.cpu()
        samples.append(s)
    for c in contigs:
        c.codes, c.valid = c.codes.cpu(), c.valid.cpu()
    return Inputs(k, contigs, samples, genes), files
