"""DALIGNER .las overlap file reader/writer + aread-range byte index.

On-disk layout follows the public DALIGNER ``align.h`` convention and matches
``daccord_tpu.formats.las`` byte for byte:

Header::

    int64 novl          total number of overlap records
    int32 tspace        trace-point spacing (A-read tiles)

Record (40 bytes, the Overlap struct minus its leading trace pointer, LP64
field layout)::

    int32 tlen, diffs, abpos, bbpos, aepos, bepos
    uint32 flags                      (bit 0 = B complemented)
    int32 aread, bread
    4 bytes struct tail padding

followed by the trace array: ``tlen`` values, uint8 when
``tspace <= TRACE_XOVR(125)`` else uint16, laid out as pairs
``(diffs_in_tile, b_bases_in_tile)`` — ``tlen/2`` tiles covering
``[abpos, aepos)`` cut at multiples of ``tspace``.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Iterable, Iterator

import numpy as np

TRACE_XOVR = 125
OVL_COMP = 0x1  # flags bit: B read is complemented

_REC_FMT = "<6iI2i4x"
_REC_SIZE = struct.calcsize(_REC_FMT)
assert _REC_SIZE == 40, _REC_SIZE

_HDR_FMT = "<qi4x"
_HDR_SIZE = struct.calcsize(_HDR_FMT)


@dataclass
class Overlap:
    aread: int
    bread: int
    abpos: int
    aepos: int
    bbpos: int
    bepos: int
    flags: int = 0
    diffs: int = 0
    # trace: shape (ntiles, 2) int32 — per-tile (diffs, b_bases)
    trace: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), dtype=np.int32))

    @property
    def is_comp(self) -> bool:
        return bool(self.flags & OVL_COMP)

    def tile_bounds(self, tspace: int) -> np.ndarray:
        """A-read tile boundaries: array of len ntiles+1, [abpos..aepos]."""
        bounds = [self.abpos]
        nxt = (self.abpos // tspace + 1) * tspace
        while nxt < self.aepos:
            bounds.append(nxt)
            nxt += tspace
        bounds.append(self.aepos)
        return np.asarray(bounds, dtype=np.int64)


def _trace_dtype(tspace: int):
    return np.uint8 if tspace <= TRACE_XOVR else np.uint16


def write_las(path: str, tspace: int, overlaps: Iterable[Overlap]) -> int:
    """Write overlaps to a .las file; returns the record count. The file is
    written under a temporary name and renamed into place, so a reader never
    sees a header whose ``novl`` was not yet patched."""
    tdt = _trace_dtype(tspace)
    tmp = f"{path}.tmp.{os.getpid()}"
    novl = 0
    with open(tmp, "wb") as fh:
        fh.write(struct.pack(_HDR_FMT, 0, tspace))  # novl patched at the end
        for ovl in overlaps:
            trace = np.asarray(ovl.trace, dtype=np.int64).reshape(-1)
            fh.write(struct.pack(_REC_FMT, len(trace), ovl.diffs, ovl.abpos,
                                 ovl.bbpos, ovl.aepos, ovl.bepos, ovl.flags,
                                 ovl.aread, ovl.bread))
            fh.write(trace.astype(tdt).tobytes())
            novl += 1
        fh.seek(0)
        fh.write(struct.pack("<q", novl))
    os.replace(tmp, path)
    return novl


class LasFile:
    """Streaming .las reader with optional byte-range restriction."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            hdr = fh.read(_HDR_SIZE)
        if len(hdr) < _HDR_SIZE:
            raise ValueError(f"{path}: truncated LAS header")
        self.novl, self.tspace = struct.unpack(_HDR_FMT, hdr)
        if not (1 <= self.tspace <= 1_000_000) or self.novl < 0:
            raise ValueError(f"{path}: bad LAS header (novl={self.novl}, "
                             f"tspace={self.tspace})")
        self._tdt = _trace_dtype(self.tspace)
        self._tsize = np.dtype(self._tdt).itemsize

    def __iter__(self) -> Iterator[Overlap]:
        return self.iter_range()

    def iter_range(self, start: int | None = None, end: int | None = None) -> Iterator[Overlap]:
        """Iterate records in byte range [start, end) (defaults: whole file)."""
        with open(self.path, "rb") as fh:
            fh.seek(start if start is not None else _HDR_SIZE)
            limit = end if end is not None else os.path.getsize(self.path)
            while fh.tell() < limit:
                off = fh.tell()
                raw = fh.read(_REC_SIZE)
                if len(raw) < _REC_SIZE:
                    break
                (tlen, diffs, abpos, bbpos, aepos, bepos, flags, aread,
                 bread) = struct.unpack(_REC_FMT, raw)
                traw = fh.read(max(tlen, 0) * self._tsize)
                if tlen < 0 or tlen % 2 or len(traw) < tlen * self._tsize:
                    raise ValueError(f"{self.path}: bad trace (tlen={tlen}) "
                                     f"in the record at byte {off}")
                trace = np.frombuffer(traw, dtype=self._tdt).astype(np.int32).reshape(-1, 2)
                yield Overlap(aread=aread, bread=bread, abpos=abpos, aepos=aepos,
                              bbpos=bbpos, bepos=bepos, flags=flags, diffs=diffs,
                              trace=trace)

    def iter_piles(self, start: int | None = None, end: int | None = None) -> Iterator[tuple[int, list[Overlap]]]:
        """Group a (sorted-by-aread) stream into (aread, pile) tuples."""
        pile: list[Overlap] = []
        cur = None
        for ovl in self.iter_range(start, end):
            if cur is not None and ovl.aread != cur:
                yield cur, pile
                pile = []
            cur = ovl.aread
            pile.append(ovl)
        if cur is not None:
            yield cur, pile


def index_las(path: str) -> np.ndarray:
    """Aread index: rows (aread, byte_offset_of_first_record), once per
    distinct aread in file order (the file must be sorted by aread)."""
    f = LasFile(path)
    rows: list[tuple[int, int]] = []
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        fh.seek(_HDR_SIZE)
        last = None
        while fh.tell() < size:
            off = fh.tell()
            raw = fh.read(_REC_SIZE)
            if len(raw) < _REC_SIZE:
                break
            tlen = struct.unpack_from("<i", raw)[0]
            aread = struct.unpack_from("<i", raw, 28)[0]
            if tlen < 0 or off + _REC_SIZE + tlen * f._tsize > size:
                raise ValueError(f"{path}: bad trace (tlen={tlen}) in the "
                                 f"record at byte {off}")
            if aread != last:
                rows.append((aread, off))
                last = aread
            fh.seek(tlen * f._tsize, os.SEEK_CUR)
    return np.asarray(rows, dtype=np.int64).reshape(-1, 2)
