from .fasta import FastaIndex
from .kmc import KMCReader, write_kmc_db
from .kcf import KCFHeader, Window, KCFReader, KCFWriter
from .gtf import GTF

__all__ = [
    "FastaIndex",
    "KMCReader",
    "write_kmc_db",
    "KCFHeader",
    "Window",
    "KCFReader",
    "KCFWriter",
    "GTF",
]
