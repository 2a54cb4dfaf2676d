"""Dazzler database (.db / .idx / .bps) reader and writer.

The binary layout follows the public DAZZ_DB ``DB.h`` structures as written to
disk by ``fwrite(&db, sizeof(DAZZ_DB), ...)`` on LP64 platforms, and matches
``daccord_tpu.formats.dazzdb`` byte for byte, so a DB written by either package
reads in the other:

``.<name>.idx``::

    DAZZ_DB header, 112 bytes:
      int32  ureads, treads, cutoff, allarr        @ 0,4,8,12
      f32[4] freq                                  @ 16
      int32  maxlen                                @ 32   (+4 pad)
      int64  totlen                                @ 40
      int32  nreads, trimmed, part, ufirst, tfirst @ 48..67 (+4 pad)
      ptr    path                                  @ 72  (garbage on disk)
      int32  loaded                                @ 80   (+4 pad)
      ptr    bases, reads, tracks                  @ 88,96,104 (garbage)
    then ureads records of DAZZ_READ, 40 bytes each:
      int32 origin, rlen, fpulse                   @ 0,4,8 (+4 pad)
      int64 boff, coff                             @ 16,24
      int32 flags                                  @ 32   (+4 pad)

``.<name>.bps``::   2-bit packed bases, 4/byte, first base in the top bits.

``<name>.db``  ::   small text stub (file list + block partition).

Variable-length tracks (``.<name>.<track>.anno`` offsets, ``.data`` bytes;
e.g. the ``inqual`` intrinsic-QV track) read with :func:`read_track`. Only
what the consensus path reads and the simulator writes lives here. Every
.idx byte is validated before it steers a decode (:func:`read_db`), with the
structured errors of ``formats/ingest.py``.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from ..native.api import decode_reads_batch
from ..utils.bases import pack_2bit, unpack_2bit
from .ingest import IngestError, IngestIssue

_HDR_FMT = "<4i4fi4xq5i4x8si4x8s8s8s"  # 112 bytes, pointers as opaque 8-byte pads
_HDR_SIZE = struct.calcsize(_HDR_FMT)
assert _HDR_SIZE == 112, _HDR_SIZE

_READ_FMT = "<3i4x2qi4x"  # 40 bytes
_READ_SIZE = struct.calcsize(_READ_FMT)
assert _READ_SIZE == 40, _READ_SIZE


@dataclass
class DazzRead:
    origin: int
    rlen: int
    fpulse: int
    boff: int
    coff: int = -1
    flags: int = 0


@dataclass
class DazzDB:
    """In-memory handle over a Dazzler DB; bases stay packed until asked for."""

    path: str
    nreads: int
    totlen: int
    maxlen: int
    cutoff: int
    reads: list[DazzRead]
    bps: np.ndarray = field(repr=False)  # uint8 packed base store
    names: list[str] = field(default_factory=list, repr=False)
    # read ids whose .idx record failed validation under read_db(strict=False)
    # (quarantine policy): their rlen/boff are garbage, so their bases are
    # never decoded and piles referencing them quarantine at ingest
    bad_reads: set = field(default_factory=set, repr=False)

    def __post_init__(self) -> None:
        self._boffs = np.fromiter((r.boff for r in self.reads), np.int64, len(self.reads))
        self._rlens = np.fromiter((r.rlen for r in self.reads), np.int32, len(self.reads))

    def read_bases(self, i: int) -> np.ndarray:
        """Decode read ``i`` to an int8 array of 0..3."""
        r = self.reads[i]
        nbytes = (r.rlen + 3) // 4
        return unpack_2bit(self.bps[r.boff : r.boff + nbytes], r.rlen)

    def read_bases_batch(self, ids) -> list[np.ndarray]:
        """Decode many reads in one call of the host library's 2-bit decode;
        views over one buffer, equal to :meth:`read_bases` of each."""
        ids = np.fromiter(ids, np.int64)
        return decode_reads_batch(self.bps, self._boffs[ids], self._rlens[ids])

    def read_length(self, i: int) -> int:
        return self.reads[i].rlen

    def __len__(self) -> int:
        return self.nreads


def _db_stems(path: str) -> tuple[str, str]:
    """Return (dir, stem) for a ``foo.db`` path."""
    d, b = os.path.split(path)
    if b.endswith(".db"):
        b = b[:-3]
    return d, b


def write_db(path: str, seqs: list[np.ndarray], names: list[str] | None = None,
             cutoff: int = 0) -> DazzDB:
    """Write reads (int8 arrays of 0..3) as a Dazzler DB triple (.db/.idx/.bps)."""
    d, stem = _db_stems(path)
    names = names or [f"read/{i}/0_{len(s)}" for i, s in enumerate(seqs)]

    reads: list[DazzRead] = []
    bps_chunks: list[bytes] = []
    boff = 0
    counts = np.zeros(4, dtype=np.int64)
    for i, s in enumerate(seqs):
        s = np.asarray(s, dtype=np.int8)
        packed = pack_2bit(s)
        reads.append(DazzRead(origin=i, rlen=len(s), fpulse=0, boff=boff))
        bps_chunks.append(packed)
        boff += len(packed)
        counts += np.bincount(s.astype(np.int64), minlength=4)[:4]

    totlen = int(sum(len(s) for s in seqs))
    maxlen = int(max((len(s) for s in seqs), default=0))
    freq = (counts / max(totlen, 1)).astype(np.float32)
    n = len(seqs)

    with open(os.path.join(d, f".{stem}.bps"), "wb") as fh:
        for c in bps_chunks:
            fh.write(c)

    with open(os.path.join(d, f".{stem}.idx"), "wb") as fh:
        fh.write(struct.pack(
            _HDR_FMT,
            n, n, cutoff, 1,              # ureads, treads, cutoff, allarr
            *freq.tolist(),
            maxlen,
            totlen,
            n, 1, -1, 0, 0,               # nreads, trimmed, part(-1=whole), ufirst, tfirst
            b"\0" * 8, 0, b"\0" * 8, b"\0" * 8, b"\0" * 8,
        ))
        for r in reads:
            fh.write(struct.pack(_READ_FMT, r.origin, r.rlen, r.fpulse, r.boff,
                                 r.coff, r.flags))

    db_path = os.path.join(d, f"{stem}.db")
    with open(db_path, "wt") as fh:
        fh.write("files =         1\n")
        fh.write(f"{n:>11} {stem} {stem}\n")
        fh.write(f"blocks = {1:>9}\n")
        fh.write(f"size = {200_000_000:>11} cutoff = {cutoff:>10} all = 1\n")
        for b in (0, n):
            fh.write(f"{b:>11} {b:>11}\n")

    with open(os.path.join(d, f".{stem}.names"), "wt") as fh:
        for nm in names:
            fh.write(nm + "\n")

    return DazzDB(path=db_path, nreads=n, totlen=totlen, maxlen=maxlen,
                  cutoff=cutoff, reads=reads,
                  bps=np.frombuffer(b"".join(bps_chunks), dtype=np.uint8),
                  names=names)


def read_db(path: str, strict: bool = True) -> DazzDB:
    """Load a DB triple written by :func:`write_db` (or DAZZ_DB-compatible).

    A torn header or a read count the .idx cannot hold raises a structured
    :class:`~.ingest.IngestError`. A read record whose ``rlen``/``boff``
    would index outside the base store raises under ``strict`` (the
    default); with ``strict=False`` (the quarantine policy) its id lands in
    ``DazzDB.bad_reads`` so piles referencing it are contained at ingest."""
    d, stem = _db_stems(path)
    idx_path = os.path.join(d, f".{stem}.idx")
    bps = np.fromfile(os.path.join(d, f".{stem}.bps"), dtype=np.uint8)
    idx_size = os.path.getsize(idx_path)
    with open(idx_path, "rb") as fh:
        hdr = fh.read(_HDR_SIZE)
        if len(hdr) < _HDR_SIZE:
            raise IngestError(IngestIssue(
                "truncation", idx_path, len(hdr),
                f"idx holds {len(hdr)} of the {_HDR_SIZE}-byte DB header"))
        fields = struct.unpack(_HDR_FMT, hdr)
        ureads, cutoff, maxlen, totlen, nreads = (fields[0], fields[2],
                                                  fields[8], fields[9],
                                                  fields[10])
        if ureads < 0 or totlen < 0 or not (0 <= nreads <= ureads):
            raise IngestError(IngestIssue(
                "bad_header", idx_path, 0,
                f"ureads={ureads} nreads={nreads} totlen={totlen} fail sanity"))
        if idx_size < _HDR_SIZE + _READ_SIZE * ureads:
            raise IngestError(IngestIssue(
                "truncation", idx_path, idx_size,
                f"idx holds {(idx_size - _HDR_SIZE) // _READ_SIZE} of "
                f"{ureads} read records"))
        raw = fh.read(_READ_SIZE * ureads)
    reads = []
    bad: set[int] = set()
    issues: list[IngestIssue] = []
    for i in range(ureads):
        origin, rlen, fpulse, boff, coff, flags = struct.unpack_from(
            _READ_FMT, raw, i * _READ_SIZE)
        if rlen < 0 or boff < 0 or boff + (rlen + 3) // 4 > len(bps):
            issues.append(IngestIssue(
                "db_read", idx_path, _HDR_SIZE + i * _READ_SIZE,
                f"read {i}: rlen={rlen} boff={boff} outside the "
                f"{len(bps)}-byte base store", aread=i, record=i))
            bad.add(i)
        reads.append(DazzRead(origin, rlen, fpulse, boff, coff, flags))
    if issues and strict:
        raise IngestError(issues)

    names: list[str] = []
    name_path = os.path.join(d, f".{stem}.names")
    if os.path.exists(name_path):
        with open(name_path) as fh:
            names = [ln.rstrip("\n") for ln in fh]
    return DazzDB(path=os.path.join(d, f"{stem}.db"), nreads=nreads,
                  totlen=totlen, maxlen=maxlen, cutoff=cutoff, reads=reads,
                  bps=bps, names=names, bad_reads=bad)


def db_blocks(db_path: str) -> list[tuple[int, int]]:
    """The block partition of the .db stub as [start, end) read pairs."""
    d, stem = _db_stems(db_path)
    with open(os.path.join(d, f"{stem}.db"), "rt") as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    nfiles = int(lines[0].split("=")[1])
    nb = int(lines[1 + nfiles].split("=")[1])
    bounds = [int(ln.split()[0]) for ln in lines[3 + nfiles : 3 + nfiles + nb + 1]]
    return [(bounds[i], bounds[i + 1]) for i in range(nb)]


def _track_paths(db_path: str, track: str) -> tuple[str, str]:
    """(.anno, .data) paths of a whole-DB track."""
    d, stem = _db_stems(db_path)
    return (os.path.join(d, f".{stem}.{track}.anno"),
            os.path.join(d, f".{stem}.{track}.data"))


def read_track(db_path: str, track: str) -> list[np.ndarray]:
    """A variable-length track as per-read uint8 arrays. Raises
    ``FileNotFoundError`` when the track is absent, ``ValueError`` when its
    files disagree."""
    anno_path, data_path = _track_paths(db_path, track)
    with open(anno_path, "rb") as fh:
        head = fh.read(8)
        if len(head) < 8:
            raise ValueError(f"{anno_path}: truncated track header")
        nreads, size = struct.unpack("<2i", head)
        if size != 0:
            raise ValueError(f"{anno_path}: unsupported fixed-size track (size={size})")
        offsets = np.frombuffer(fh.read(8 * (nreads + 1)), dtype=np.int64)
    data = np.fromfile(data_path, dtype=np.uint8)
    if (nreads < 0 or len(offsets) != nreads + 1 or offsets[0] < 0
            or (np.diff(offsets) < 0).any() or offsets[-1] > len(data)):
        raise ValueError(f"{anno_path}: offsets do not fit {data_path}")
    return [data[offsets[i] : offsets[i + 1]] for i in range(nreads)]
