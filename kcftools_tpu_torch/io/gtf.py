"""GTF parser: chromosome -> gene -> transcript -> exon hierarchy with
merged-loci spliced sequence extraction.

Mirrors the reference's graph model (reference: Data/GTF.java:26-100)
without the graph library: plain insertion-ordered child lists. Feature
coordinates are 1-based inclusive as in GTF; spliced extraction merges
overlapping same-strand loci, sorts by (chromosome, start) and
concatenates subsequences (GTF.java:223-248,278-293).
"""

from ..utils.logger import Logger

_CLASS = "GTF"

_TRANSCRIPT_TYPES = {
    "transcript",
    "mRNA",
    "RNA",
    "lnc_RNA",
    "rRNA",
    "tRNA",
    "snRNA",
    "snoRNA",
}


class Feature:
    __slots__ = ("chromosome", "start", "end", "strand", "type", "id")

    def __init__(self, chromosome, start, end, strand, type_, id_):
        self.chromosome = chromosome
        self.start = start
        self.end = end
        self.strand = strand
        self.type = type_
        self.id = id_


def _parse_attributes(attr_str):
    out = {}
    for attr in attr_str.split(";"):
        pair = attr.strip().replace('"', "").split(" ")
        if len(pair) == 2:
            out[pair[0]] = pair[1]
    return out


class GTF:
    def __init__(self, path):
        self.path = path
        self.feature_map = {}
        self._children = {}  # parent id -> [child ids] insertion order
        self._chromosomes = []  # insertion order
        self._parse()

    def _add_child(self, parent, child):
        lst = self._children.setdefault(parent, [])
        if child != parent:
            lst.append(child)

    def _parse(self):
        Logger.info(_CLASS, f"Parsing GTF file at: {self.path}")
        exon_counts = {}
        seen_vertices = set()
        with open(self.path) as fh:
            for line in fh:
                if line.startswith("#") or not line.strip():
                    continue
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 9:
                    Logger.error(_CLASS, f"Malformed line: {line.rstrip()}")
                attributes = _parse_attributes(fields[8])
                type_ = fields[2]
                chrom = fields[0]
                if chrom not in seen_vertices:
                    seen_vertices.add(chrom)
                    self._chromosomes.append(chrom)

                if type_ in ("gene", "pseudogene"):
                    feature_id = attributes.get("gene_id")
                    parent_id = chrom
                elif type_ in _TRANSCRIPT_TYPES:
                    feature_id = attributes.get("transcript_id")
                    parent_id = attributes.get("gene_id")
                    if feature_id == parent_id:
                        Logger.error(
                            _CLASS,
                            f"Transcript ID is the same as Gene ID: {feature_id}. "
                            "Fix the GTF file using AGAT.",
                        )
                    if parent_id not in seen_vertices:
                        seen_vertices.add(parent_id)
                        gene = Feature(
                            chrom,
                            int(fields[3]),
                            int(fields[4]),
                            fields[6][0],
                            "gene",
                            parent_id,
                        )
                        self._add_child(chrom, parent_id)
                        self.feature_map[parent_id] = gene
                    gene = self.feature_map.get(parent_id)
                    if gene is not None:
                        gene.start = min(gene.start, int(fields[3]))
                        gene.end = max(gene.end, int(fields[4]))
                elif type_ == "exon":
                    parent_id = attributes.get("transcript_id")
                    count = exon_counts.get(parent_id, 0) + 1
                    exon_counts[parent_id] = count
                    feature_id = f"{parent_id}-e-{count}"
                else:
                    continue

                feature = Feature(
                    chrom,
                    int(fields[3]),
                    int(fields[4]),
                    fields[6][0],
                    type_,
                    feature_id,
                )
                seen_vertices.add(feature_id)
                self.feature_map[feature_id] = feature
                if parent_id is not None:
                    self._add_child(parent_id, feature_id)

    # -- hierarchy ----------------------------------------------------------

    def get_chromosomes(self):
        return list(self._chromosomes)

    def get_genes(self, chrom):
        return list(self._children.get(chrom, []))

    def get_transcripts(self, gene):
        return list(self._children.get(gene, []))

    def get_exons(self, transcript):
        return list(self._children.get(transcript, []))

    def get_loci(self, feature_id):
        if feature_id not in self.feature_map:
            Logger.error(_CLASS, f"Feature ID not found: {feature_id}")
        f = self.feature_map[feature_id]
        return (f.chromosome, f.start, f.end, f.strand)

    # -- splicing -----------------------------------------------------------

    def merged_loci(self, feature_id, is_gene: bool):
        """Merged exon loci (chrom, start, end, strand), 1-based inclusive,
        sorted by (chromosome, start)."""
        if feature_id not in self._children and feature_id not in self.feature_map:
            return []
        targets = (
            self.get_transcripts(feature_id) if is_gene else self.get_exons(feature_id)
        )
        loci = set()
        for t in targets:
            exons = self.get_exons(t) if is_gene else [t]
            for exon_id in exons:
                f = self.feature_map.get(exon_id)
                if f is not None:
                    loci.add((f.chromosome, f.start, f.end, f.strand))
        if not loci:
            return []
        ordered = sorted(loci, key=lambda x: (x[0], x[1]))
        merged = []
        for cur in ordered:
            if merged:
                last = merged[-1]
                if (
                    last[0] == cur[0]
                    and last[3] == cur[3]
                    and last[1] <= cur[2]
                    and cur[1] <= last[2]
                ):
                    merged[-1] = (
                        last[0],
                        min(last[1], cur[1]),
                        max(last[2], cur[2]),
                        last[3],
                    )
                    continue
            merged.append(cur)
        merged.sort(key=lambda x: (x[0], x[1]))
        return merged

    def spliced_codes(self, feature_id, index, is_gene: bool):
        """Concatenated (codes, valid) arrays of the merged loci, or None
        when the feature has no exon loci."""
        import numpy as np

        merged = self.merged_loci(feature_id, is_gene)
        if not merged:
            return None
        codes_parts, valid_parts = [], []
        for chrom, start, end, _strand in merged:
            c, v = index.sequence_codes(chrom, start - 1, end - start + 1)
            codes_parts.append(c)
            valid_parts.append(v)
        return np.concatenate(codes_parts), np.concatenate(valid_parts)

    def spliced_sequence(self, feature_id, index, is_gene: bool):
        merged = self.merged_loci(feature_id, is_gene)
        if not merged:
            return None
        return "".join(
            index.get_sequence(chrom, start - 1, end - start + 1)
            for chrom, start, end, _ in merged
        )

    # -- export utilities (reference GTF.java:108-150, 254-272) -------------

    def write_fasta(self, output_file, index, is_gene: bool):
        """Write spliced gene or transcript sequences to a FASTA file."""
        from .fasta import fold_seq

        with open(output_file, "w") as fh:
            for chrom in self.get_chromosomes():
                for gene in self.get_genes(chrom):
                    ids = [gene] if is_gene else self.get_transcripts(gene)
                    for fid in ids:
                        merged = self.merged_loci(fid, is_gene)
                        if not merged:
                            continue
                        seq = self.spliced_sequence(fid, index, is_gene)
                        desc = " ".join(
                            f"{c}:{s}-{e}[{st}]" for c, s, e, st in merged
                        )
                        fh.write(f">{fid} {desc}\n")
                        fh.write(fold_seq(seq))

    def export_gtf(self, output_file):
        """Re-emit the parsed hierarchy in GTF format."""
        source = "KCFtools"
        with open(output_file, "w") as fh:
            def emit(f, type_, attrs):
                fh.write(
                    f"{f.chromosome}\t{source}\t{type_}\t{f.start}\t{f.end}"
                    f"\t.\t{f.strand}\t.\t{attrs}\n"
                )

            for chrom in self.get_chromosomes():
                for gene in self.get_genes(chrom):
                    gf = self.feature_map.get(gene)
                    if gf is None:
                        continue
                    emit(gf, gf.type, f'gene_id "{gene}";')
                    for tr in self.get_transcripts(gene):
                        tf = self.feature_map.get(tr)
                        if tf is None:
                            continue
                        emit(
                            tf,
                            tf.type,
                            f'gene_id "{gene}"; transcript_id "{tr}";',
                        )
                        for ex in self.get_exons(tr):
                            ef = self.feature_map.get(ex)
                            if ef is None:
                                continue
                            emit(
                                ef,
                                "exon",
                                f'gene_id "{gene}"; transcript_id "{tr}"; '
                                f'exon_id "{ex}";',
                            )
