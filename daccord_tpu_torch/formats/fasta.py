"""Minimal FASTA writer (and reader, for tests and tools).

The writer wraps at 80 columns like the reference tool output, and the record
layout matches ``daccord_tpu.formats.fasta`` byte for byte.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Iterable, Iterator

from ..utils import aio


@dataclass
class FastaRecord:
    name: str
    seq: str


def read_fasta(path_or_file) -> Iterator[FastaRecord]:
    """Stream records from a FASTA path or an open text file object."""
    own = isinstance(path_or_file, (str, bytes))
    fh = open(path_or_file, "rt") if own else path_or_file
    try:
        name = None
        chunks: list[str] = []
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield FastaRecord(name, "".join(chunks))
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield FastaRecord(name, "".join(chunks))
    finally:
        if own:
            fh.close()


def write_fasta(path_or_file, records: Iterable[FastaRecord | tuple], width: int = 80) -> None:
    own = isinstance(path_or_file, (str, bytes))
    fh: io.TextIOBase = aio.open_output(path_or_file, "wt") if own else path_or_file
    try:
        for rec in records:
            if isinstance(rec, tuple):
                rec = FastaRecord(*rec)
            fh.write(f">{rec.name}\n")
            s = rec.seq
            for i in range(0, len(s), width):
                fh.write(s[i : i + width])
                fh.write("\n")
            if not s:
                fh.write("\n")
    finally:
        if own:
            fh.close()
