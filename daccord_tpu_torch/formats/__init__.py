from .dazzdb import DazzDB, DazzRead, read_db, write_db
from .fasta import FastaRecord, read_fasta, write_fasta
from .las import OVL_COMP, LasFile, Overlap, index_las, write_las

__all__ = ["DazzDB", "DazzRead", "read_db", "write_db", "FastaRecord",
           "read_fasta", "write_fasta", "OVL_COMP", "LasFile", "Overlap",
           "index_las", "write_las"]
