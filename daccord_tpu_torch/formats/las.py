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

Malformed bytes raise :class:`~.ingest.IngestError` (kind, byte offset,
pile), never a bare ``struct.error``. The aread index (:func:`index_las`)
persists as a ``<path>.idx`` sidecar and is the byte-range sharding unit
(:func:`shard_ranges`, :func:`range_for_areads`).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Iterable, Iterator

import numpy as np

from ..utils import aio
from .ingest import IngestError, IngestIssue

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

    def ntiles(self, tspace: int) -> int:
        if self.aepos <= self.abpos:
            return 0
        first = (self.abpos // tspace + 1) * tspace
        if first >= self.aepos:
            return 1
        return 1 + (self.aepos - first + tspace - 1) // tspace

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


def _write_las_stream(fh, tspace: int, overlaps: Iterable[Overlap]) -> int:
    """Write the header and the records to an open binary stream, patching
    the header's ``novl`` at the end; returns the record count."""
    tdt = _trace_dtype(tspace)
    novl = 0
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
    return novl


def write_las(path: str, tspace: int, overlaps: Iterable[Overlap]) -> int:
    """Write overlaps to a .las path or ``mem:`` URL; returns the record
    count. A file commits through ``aio.durable_write`` (a tmp name, fsync,
    rename), so a crash never leaves a LAS whose header was not yet patched
    at the target path; a ``mem:`` file commits at close."""
    if aio.is_mem(path):
        with aio.open_output(path, "wb") as fh:
            novl = _write_las_stream(fh, tspace, overlaps)
    else:
        novl = aio.durable_write(path, lambda fh: _write_las_stream(fh, tspace, overlaps))
    invalidate_index(path)
    return novl


def invalidate_index(path: str) -> None:
    """Drop the aread-index sidecar of a (re)written LAS."""
    if aio.is_mem(path):
        return
    try:
        os.remove(aio.local_path(path) + ".idx")
    except OSError:
        pass


class LasFile:
    """Streaming .las reader with optional byte-range restriction; paths or
    ``mem:`` URLs (``utils/aio.py``)."""

    def __init__(self, path: str):
        self.path = path
        with aio.open_input(path, "rb") as fh:
            hdr = fh.read(_HDR_SIZE)
        if len(hdr) < _HDR_SIZE:
            raise IngestError(IngestIssue(
                "truncation", path, len(hdr),
                f"file holds {len(hdr)} of the {_HDR_SIZE}-byte LAS header"))
        self.novl, self.tspace = struct.unpack(_HDR_FMT, hdr)
        if not (1 <= self.tspace <= 1_000_000):
            raise IngestError(IngestIssue(
                "bad_header", path, 8, f"tspace={self.tspace} out of range"))
        if self.novl < 0:
            # novl merely OVERSTATING the record bytes is not rejected here:
            # that is what a truncated file looks like, and the validating
            # scan (formats/ingest.py) quarantines truncation per pile
            raise IngestError(IngestIssue(
                "bad_header", path, 0, f"novl={self.novl} negative"))
        self._tdt = _trace_dtype(self.tspace)
        self._tsize = np.dtype(self._tdt).itemsize

    def __iter__(self) -> Iterator[Overlap]:
        return self.iter_range()

    def iter_range(self, start: int | None = None, end: int | None = None) -> Iterator[Overlap]:
        """Iterate records in byte range [start, end) (defaults: whole file)."""
        with aio.open_input(self.path, "rb") as fh:
            fh.seek(start if start is not None else _HDR_SIZE)
            limit = end if end is not None else aio.getsize(self.path)
            while fh.tell() < limit:
                off = fh.tell()
                raw = fh.read(_REC_SIZE)
                if len(raw) < _REC_SIZE:
                    break
                (tlen, diffs, abpos, bbpos, aepos, bepos, flags, aread,
                 bread) = struct.unpack(_REC_FMT, raw)
                if tlen < 0 or tlen % 2:
                    raise IngestError(IngestIssue(
                        "bad_tlen", self.path, off,
                        f"tlen={tlen} (negative or odd)", aread=aread))
                traw = fh.read(tlen * self._tsize)
                if len(traw) < tlen * self._tsize:
                    raise IngestError(IngestIssue(
                        "truncation", self.path, off,
                        f"trace of tlen={tlen} cut {tlen * self._tsize - len(traw)} "
                        f"bytes short", aread=aread))
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


def read_las(path: str) -> tuple[int, list[Overlap]]:
    """(tspace, every record) of a LAS."""
    f = LasFile(path)
    return f.tspace, list(f)


def index_las(path: str, use_sidecar: bool = True) -> np.ndarray:
    """Aread index: rows (aread, byte_offset_of_first_record), once per
    distinct aread in file order (the file must be sorted by aread).

    The index persists as a ``<path>.idx`` sidecar (``LIDX`` magic, count,
    int64 pairs) so N array jobs sharing one LAS pay one scan; a sidecar
    older than the LAS, or malformed, is rebuilt. A corrupt tlen raises
    :class:`~.ingest.IngestError` instead of steering the walk."""
    if aio.is_mem(path):
        use_sidecar = False
    fs_path = aio.local_path(path)
    sidecar = fs_path + ".idx"
    if use_sidecar and os.path.exists(sidecar) \
            and os.path.getmtime(sidecar) >= os.path.getmtime(fs_path):
        try:
            with open(sidecar, "rb") as fh:
                hdr = fh.read(8)
                if len(hdr) == 8:
                    magic, n = struct.unpack("<4sI", hdr)
                    payload = fh.read(16 * n)
                    if magic == b"LIDX" and len(payload) == 16 * n:
                        return np.frombuffer(payload, dtype=np.int64).reshape(-1, 2)
        except OSError:
            pass
    f = LasFile(path)
    rows: list[tuple[int, int]] = []
    size = aio.getsize(path)
    with aio.open_input(path, "rb") as fh:
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
                raise IngestError(IngestIssue(
                    "bad_tlen", path, off,
                    f"tlen={tlen} (negative or past EOF at size {size})",
                    aread=last))
            if aread != last:
                rows.append((aread, off))
                last = aread
            fh.seek(tlen * f._tsize, os.SEEK_CUR)
    idx = np.asarray(rows, dtype=np.int64).reshape(-1, 2)
    if use_sidecar:
        try:
            # per-process tmp name: concurrent jobs building the same index
            # must not interleave writes into one tmp inode
            tmp = f"{sidecar}.{os.getpid()}.tmp"
            with open(tmp, "wb") as fh:
                fh.write(struct.pack("<4sI", b"LIDX", len(idx)))
                fh.write(idx.tobytes())
            os.replace(tmp, sidecar)
        except OSError:
            pass  # read-only directory: the index simply isn't cached
    return idx


def shard_ranges(path: str, nshards: int) -> list[tuple[int, int]]:
    """Split a .las into ``nshards`` aread-aligned byte ranges (about equal
    bytes): the ``-J i,n`` sharding as byte ranges over one file."""
    size = aio.getsize(path)
    if nshards <= 1:
        # no cut points to choose: a single-shard run (a quarantine run over
        # a damaged LAS included) never needs the aread index
        return [(_HDR_SIZE, size)]
    idx = index_las(path)
    if len(idx) == 0:
        return [(_HDR_SIZE, size)] + [(size, size)] * (nshards - 1)
    starts = idx[:, 1]
    # cut points at the pile boundaries closest to equal byte splits
    cuts = [_HDR_SIZE]
    for s in range(1, nshards):
        target = _HDR_SIZE + (size - _HDR_SIZE) * s // nshards
        j = min(int(np.searchsorted(starts, target)), len(starts) - 1)
        cuts.append(int(starts[j]))
    cuts.append(size)
    for i in range(1, len(cuts)):       # monotone on tiny files
        cuts[i] = max(cuts[i], cuts[i - 1])
    return [(cuts[i], cuts[i + 1]) for i in range(nshards)]


def range_for_areads(path: str, lo: int, hi: int) -> tuple[int, int]:
    """Byte range of the records whose aread is in [lo, hi): DB block i
    (``formats.dazzdb.db_blocks``) maps to the LAS byte range of its piles.
    Requires an aread-sorted LAS; uses the sidecar index."""
    idx = index_las(path)
    size = aio.getsize(path)
    if len(idx) == 0:
        return size, size
    areads = idx[:, 0]
    i = int(np.searchsorted(areads, lo, side="left"))
    j = int(np.searchsorted(areads, hi, side="left"))
    start = int(idx[i, 1]) if i < len(idx) else size
    end = int(idx[j, 1]) if j < len(idx) else size
    return start, end
