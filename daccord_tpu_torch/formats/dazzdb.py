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
e.g. the ``inqual`` intrinsic-QV track) are written and read with
:func:`write_track` and :func:`read_track`, per DB block with ``block=``
(``.<name>.<block>.<track>.*``, merged by :func:`catrack`). :func:`split_db`
rewrites the .db stub's block partition. Every .idx byte is validated before
it steers a decode (:func:`read_db`), with the structured errors of
``formats/ingest.py``.
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

    def _need_bases(self, ids) -> None:
        if len(self.bps) == 0 and any(self.reads[i].rlen > 0 for i in ids):
            raise ValueError("DB was opened with load_bases=False (no base store); "
                             "use read_db(path) or decode_reads_from_bps for bases")

    def read_bases(self, i: int) -> np.ndarray:
        """Decode read ``i`` to an int8 array of 0..3."""
        self._need_bases((i,))
        r = self.reads[i]
        nbytes = (r.rlen + 3) // 4
        return unpack_2bit(self.bps[r.boff : r.boff + nbytes], r.rlen)

    def read_bases_batch(self, ids) -> list[np.ndarray]:
        """Decode many reads in one call of the host library's 2-bit decode;
        views over one buffer, equal to :meth:`read_bases` of each."""
        ids = np.fromiter(ids, np.int64)
        self._need_bases(ids)
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


def _write_block_section(fh, bounds: list[int], block_bases: int, cutoff: int) -> None:
    """The .db stub's ``blocks =`` section (fasta2DB layout; what
    :func:`db_blocks` reads)."""
    fh.write(f"blocks = {len(bounds) - 1:>9}\n")
    fh.write(f"size = {block_bases:>11} cutoff = {cutoff:>10} all = 1\n")
    for b in bounds:
        fh.write(f"{b:>11} {b:>11}\n")  # untrimmed == trimmed (all = 1)


def read_lengths(path: str) -> np.ndarray:
    """Per-read lengths from the .idx alone (no base-store load)."""
    d, stem = _db_stems(path)
    with open(os.path.join(d, f".{stem}.idx"), "rb") as fh:
        hdr = fh.read(_HDR_SIZE)
        ureads = struct.unpack_from("<i", hdr, 0)[0]
        raw = fh.read(_READ_SIZE * ureads)
    arr = np.frombuffer(raw, dtype=np.uint8).reshape(ureads, _READ_SIZE)
    return arr[:, 4:8].copy().view("<i4").reshape(-1)


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
        _write_block_section(fh, [0, n], 200_000_000, cutoff)

    with open(os.path.join(d, f".{stem}.names"), "wt") as fh:
        for nm in names:
            fh.write(nm + "\n")

    return DazzDB(path=db_path, nreads=n, totlen=totlen, maxlen=maxlen,
                  cutoff=cutoff, reads=reads,
                  bps=np.frombuffer(b"".join(bps_chunks), dtype=np.uint8),
                  names=names)


def read_db(path: str, load_bases: bool = True, strict: bool = True) -> DazzDB:
    """Load a DB triple written by :func:`write_db` (or DAZZ_DB-compatible).

    ``load_bases=False`` skips the .bps base store (multi-GB on real DBs) for
    the tools that need only read lengths, so per-block jobs stay O(block);
    the base-store bounds of the read records are then not checked.

    A torn header or a read count the .idx cannot hold raises a structured
    :class:`~.ingest.IngestError`. A read record whose ``rlen``/``boff``
    would index outside the base store raises under ``strict`` (the
    default); with ``strict=False`` (the quarantine policy) its id lands in
    ``DazzDB.bad_reads`` so piles referencing it are contained at ingest."""
    d, stem = _db_stems(path)
    idx_path = os.path.join(d, f".{stem}.idx")
    bps_path = os.path.join(d, f".{stem}.bps")
    bps = (np.fromfile(bps_path, dtype=np.uint8) if load_bases
           else np.zeros(0, np.uint8))
    bps_size = (len(bps) if load_bases else
                os.path.getsize(bps_path) if os.path.exists(bps_path) else None)
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
        if rlen < 0 or boff < 0 or (bps_size is not None
                                    and boff + (rlen + 3) // 4 > bps_size):
            issues.append(IngestIssue(
                "db_read", idx_path, _HDR_SIZE + i * _READ_SIZE,
                f"read {i}: rlen={rlen} boff={boff} outside the "
                f"{bps_size}-byte base store", aread=i, record=i))
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


def decode_reads_from_bps(db: DazzDB, ids) -> list[np.ndarray]:
    """Decode selected reads by seeking the .bps on disk: O(selected bytes)
    memory, for lengths-only handles (``read_db(load_bases=False)``)."""
    d, stem = _db_stems(db.path)
    out: list[np.ndarray] = []
    with open(os.path.join(d, f".{stem}.bps"), "rb") as fh:
        for i in ids:
            r = db.reads[i]
            fh.seek(r.boff)
            buf = np.frombuffer(fh.read((r.rlen + 3) // 4), dtype=np.uint8)
            out.append(unpack_2bit(buf, r.rlen))
    return out


def _track_paths(db_path: str, track: str, block: int | None = None) -> tuple[str, str]:
    """(.anno, .data) paths of a track; a block track is
    ``.<stem>.<block>.<track>.*`` (the Catrack convention), so per-block jobs
    never collide."""
    d, stem = _db_stems(db_path)
    mid = f"{block}.{track}" if block is not None else track
    return (os.path.join(d, f".{stem}.{mid}.anno"),
            os.path.join(d, f".{stem}.{mid}.data"))


def write_track(db_path: str, track: str, payloads: list,
                block: int | None = None) -> None:
    """Write a variable-length track (.anno = offsets, .data = bytes), of
    DB block ``block`` alone when given (merge with :func:`catrack`). Each
    file goes through a tmp name and ``os.replace``, .data first, so a crash
    never leaves a truncated file and a reader never sees a new .anno
    without its .data."""
    anno_path, data_path = _track_paths(db_path, track, block)
    blobs = [np.asarray(p, dtype=np.uint8).tobytes() if isinstance(p, np.ndarray)
             else bytes(p) for p in payloads]
    offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    anno_tmp = f"{anno_path}.tmp.{os.getpid()}"
    data_tmp = f"{data_path}.tmp.{os.getpid()}"
    with open(anno_tmp, "wb") as fh:
        fh.write(struct.pack("<2i", len(blobs), 0))
        fh.write(offsets.tobytes())
    with open(data_tmp, "wb") as fh:
        for b in blobs:
            fh.write(b)
    os.replace(data_tmp, data_path)
    os.replace(anno_tmp, anno_path)


def read_track(db_path: str, track: str, block: int | None = None) -> list[np.ndarray]:
    """A variable-length track (of DB block ``block`` when given) as
    per-read uint8 arrays. Raises ``FileNotFoundError`` when the track is
    absent, ``ValueError`` when its files disagree."""
    anno_path, data_path = _track_paths(db_path, track, block)
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


def split_db(db_path: str, block_bases: int = 200_000_000) -> list[tuple[int, int]]:
    """Recompute the .db stub's block partition (DAZZ_DB ``DBsplit -s``):
    consecutive reads of at most ``block_bases`` bases a block (a longer
    read alone), from the .idx alone. Rewrites the stub's ``blocks =``
    section atomically and returns the [start, end) read pairs."""
    rlens = read_lengths(db_path)
    d, stem = _db_stems(db_path)
    with open(os.path.join(d, f".{stem}.idx"), "rb") as fh:
        cutoff = struct.unpack_from("<4i", fh.read(16), 0)[2]
    bounds = [0]
    acc = 0
    for i, rlen in enumerate(rlens):
        if acc > 0 and acc + int(rlen) > block_bases:
            bounds.append(i)
            acc = 0
        acc += int(rlen)
    bounds.append(len(rlens))
    stub = os.path.join(d, f"{stem}.db")
    with open(stub, "rt") as fh:
        lines = fh.readlines()
    nfiles = int(lines[0].split("=")[1])
    tmp = f"{stub}.tmp.{os.getpid()}"
    with open(tmp, "wt") as fh:
        fh.writelines(lines[: 1 + nfiles])
        _write_block_section(fh, bounds, block_bases, cutoff)
    os.replace(tmp, stub)
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def catrack(db_path: str, track: str, delete: bool = False) -> int:
    """Merge the per-block tracks into the whole-DB track (DAZZ_DB
    ``Catrack``): every block of the stub's partition must have its track,
    covering exactly its reads. Returns the merged read count; ``delete``
    removes the block tracks after the merge (Catrack ``-d``)."""
    blocks = db_blocks(db_path)
    payloads: list[np.ndarray] = []
    for i, (lo, hi) in enumerate(blocks, start=1):
        p = read_track(db_path, track, block=i)
        if len(p) != hi - lo:
            raise ValueError(
                f"block {i} track '{track}' covers {len(p)} reads, expected {hi - lo}")
        payloads.extend(p)
    write_track(db_path, track, payloads)
    if delete:
        for i in range(1, len(blocks) + 1):
            for path in _track_paths(db_path, track, i):
                os.remove(path)
    return len(payloads)
