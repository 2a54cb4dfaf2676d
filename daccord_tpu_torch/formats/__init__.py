from .dazzdb import DazzDB, DazzRead, read_db, read_track, write_db, write_track
from .fasta import FastaRecord, read_fasta, write_fasta
from .las import OVL_COMP, LasFile, Overlap, index_las, read_las, write_las

__all__ = ["DazzDB", "DazzRead", "read_db", "read_track", "write_db",
           "write_track", "FastaRecord", "read_fasta", "write_fasta", "OVL_COMP",
           "LasFile", "Overlap", "index_las", "read_las", "write_las"]
