"""Ingest integrity layer: validated LAS/DB decode + quarantine planning.

The port's copy of ``daccord_tpu/formats/ingest.py``. Every record header
streamed off a .las byte range is validated BEFORE its bytes steer a seek or
a decode (the port's host library trusts every offset), and every violation
becomes a structured :class:`IngestIssue` (kind, byte offset, pile) instead
of a bare exception that kills the run. Containment is per pile: one bad
artifact quarantines one pile, never a run.

Issue taxonomy (``IngestIssue.kind``):

==============  ============================================================
``truncation``  file/range ends mid-record or mid-trace, or header count
                promises more records than the bytes hold
``bad_header``  LAS header (novl/tspace) or DB .idx header fails sanity
``bad_magic``   a sidecar magic tag does not match (``LIDX`` index sidecar)
``bad_tlen``    negative, odd, or past-EOF trace length — framing is lost
                from this record on (recovered by :func:`_resync`)
``bad_coords``  overlap coordinates out of read bounds / degenerate span /
                negative diffs (framing intact; the pile is quarantined)
``bad_read_id`` aread/bread outside ``[0, len(db))``
``sort_order``  aread went backwards (the pipeline requires DALIGNER order)
``trace_mismatch``  tlen disagrees with the tile count implied by
                [abpos, aepos) and tspace — a coordinate or tlen bit flipped
``db_read``     the record references a DB read whose .idx entry failed
                validation (see ``read_db(strict=False)``)
==============  ============================================================

The scanner (:func:`scan_las_range`) is a header-only pass (it seeks over
trace payloads), producing a :class:`LasScanReport`: the issue list, the
clean byte segments safe for the fast native/numpy decoders, and one
quarantine marker per contained pile. When framing is lost it resyncs by
scanning forward for a chain of plausible records starting a later pile.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from ..utils import aio

#: records a resync candidate must chain through before it is believed
_RESYNC_CHAIN = 3
#: buffer granularity of the forward resync scan
_RESYNC_CHUNK = 1 << 20


@dataclass
class IngestIssue:
    """One validated-decode violation, pinned to its byte offset and pile."""

    kind: str
    path: str
    offset: int
    detail: str
    aread: int | None = None   # pile the issue lands in (None = unknown)
    record: int | None = None  # record index within the scanned range

    def describe(self) -> str:
        where = f"record {self.record}" if self.record is not None else "range"
        pile = f" pile aread={self.aread}" if self.aread is not None else ""
        return (f"{self.path}: offset={self.offset} {where}{pile}: "
                f"[{self.kind}] {self.detail}")


class IngestError(ValueError):
    """Structured ingest failure: carries the full issue list.

    Subclasses ``ValueError`` so handlers of corrupt files that catch
    ``ValueError`` keep working unchanged.
    """

    def __init__(self, issues: list[IngestIssue] | IngestIssue, max_report: int = 10):
        if isinstance(issues, IngestIssue):
            issues = [issues]
        self.issues = issues
        first = issues[0]
        self.kind, self.offset, self.path = first.kind, first.offset, first.path
        lines = [iss.describe() for iss in issues[:max_report]]
        if len(issues) > max_report:
            lines.append(f"... {len(issues) - max_report} more issues")
        super().__init__(
            f"ingest integrity failure ({len(issues)} issue"
            f"{'s' if len(issues) != 1 else ''}):\n  " + "\n  ".join(lines))


@dataclass
class LasScanReport:
    """Result of a validating scan over one LAS byte range.

    ``segments`` is the byte-ordered quarantine plan consumed by the
    pipeline: ``("clean", start, end)`` ranges safe for the unvalidated fast
    decoders, interleaved with ``("quarantine", aread|None, offset, kind,
    detail)`` markers — one per contained pile (or unknown region when
    framing was lost and the pile identity with it).
    """

    path: str
    start: int
    end: int
    n_records: int = 0
    n_piles: int = 0                    # clean piles only
    issues: list = field(default_factory=list)
    segments: list = field(default_factory=list)
    pile_ranges: list = field(default_factory=list)  # clean (start, end) per pile

    @property
    def ok(self) -> bool:
        return not self.issues

    def error(self) -> IngestError:
        return IngestError(self.issues)


def _expected_tiles(abpos: int, aepos: int, tspace: int) -> int:
    # mirror of Overlap.ntiles without constructing the dataclass
    if aepos <= abpos:
        return 0
    first = (abpos // tspace + 1) * tspace
    if first >= aepos:
        return 1
    return 1 + (aepos - first + tspace - 1) // tspace


def _check_record(vals: tuple, off: int, limit: int, tsize: int, tspace: int,
                  rlens: np.ndarray | None, nreads: int | None,
                  prev_aread: int | None, bad_reads: frozenset | set,
                  fsize: int | None = None) -> tuple[str, str] | None:
    """First violation of one unpacked record header, or None when valid.

    Returns ``(kind, detail)``. Check order matters: read-id bounds come
    before any ``rlens[...]`` use, and tlen (the framing field) is checked
    before the coordinate checks so a framing loss is reported as such.
    A trace running past the physical file end (``fsize``) is ``truncation``
    (the bytes are gone); past only ``limit`` is ``bad_tlen`` (absurd value).
    """
    from .las import _REC_SIZE

    tlen, diffs, abpos, bbpos, aepos, bepos, _flags, aread, bread = vals
    if aread < 0 or (nreads is not None and aread >= nreads):
        return "bad_read_id", f"aread={aread} outside [0, {nreads})"
    if bread < 0 or (nreads is not None and bread >= nreads):
        return "bad_read_id", f"bread={bread} outside [0, {nreads})"
    if aread in bad_reads or bread in bad_reads:
        which = "aread" if aread in bad_reads else "bread"
        return "db_read", f"{which}={aread if which == 'aread' else bread} " \
                          f"references a corrupt DB read record"
    if prev_aread is not None and aread < prev_aread:
        return "sort_order", f"aread went backwards ({prev_aread} -> {aread})"
    if tlen < 0 or tlen % 2:
        return "bad_tlen", f"tlen={tlen} (negative or odd)"
    rec_end = off + _REC_SIZE + tlen * tsize
    if fsize is not None and rec_end > fsize:
        return "truncation", (f"trace of tlen={tlen} runs {rec_end - fsize} "
                              f"bytes past EOF")
    if rec_end > limit:
        return "bad_tlen", (f"tlen={tlen} runs {rec_end - limit} "
                            f"bytes past the range end")
    rlen_a = int(rlens[aread]) if rlens is not None else None
    rlen_b = int(rlens[bread]) if rlens is not None else None
    if not (0 <= abpos < aepos and (rlen_a is None or aepos <= rlen_a)):
        return "bad_coords", (f"a-span [{abpos},{aepos}) out of bounds "
                              f"(A read length {rlen_a})")
    if not (0 <= bbpos < bepos and (rlen_b is None or bepos <= rlen_b)):
        return "bad_coords", (f"b-span [{bbpos},{bepos}) out of bounds "
                              f"(B read length {rlen_b})")
    if diffs < 0:
        return "bad_coords", f"diffs={diffs} negative"
    if tlen != 2 * _expected_tiles(abpos, aepos, tspace):
        return "trace_mismatch", (f"tlen={tlen} but [abpos,aepos) at tspace "
                                  f"{tspace} implies {2 * _expected_tiles(abpos, aepos, tspace)}")
    return None


def _try_chain(fh, off: int, limit: int, min_aread: int, tsize: int,
               tspace: int, rlens: np.ndarray | None, nreads: int | None,
               bad_reads) -> bool:
    """True when ``off`` starts a chain of plausible records opening a pile
    strictly after ``min_aread`` (the resync acceptance rule)."""
    from .las import _REC_FMT, _REC_SIZE

    prev = None
    for step in range(_RESYNC_CHAIN):
        if off == limit:
            return step > 0          # clean landing on the range end
        fh.seek(off)
        raw = fh.read(_REC_SIZE)
        if len(raw) < _REC_SIZE:
            return False
        vals = struct.unpack(_REC_FMT, raw)
        if _check_record(vals, off, limit, tsize, tspace, rlens, nreads,
                         prev, bad_reads) is not None:
            return False
        if step == 0 and vals[7] <= min_aread:
            return False             # must open a LATER pile, never rejoin
        prev = vals[7]
        off += _REC_SIZE + vals[0] * tsize
    return True


def _candidate_offsets(buf: bytes, span: int, min_aread: int,
                       nreads: int | None) -> np.ndarray:
    """Byte offsets in ``buf[:span]`` whose tlen/aread fields pass the cheap
    plausibility filter — vectorized over all four int32 alignment phases so
    the resync never pays a Python unpack per byte (a multi-GB unrecoverable
    region would otherwise stall the scan for hours)."""
    cands = []
    for p in range(4):
        if len(buf) - p < 4:
            # a 1-3 byte chunk residue has no int32 at this phase;
            # np.frombuffer would raise on the negative count
            continue
        a32 = np.frombuffer(buf, "<i4", offset=p,
                            count=(len(buf) - p) // 4)
        # offset i = p + 4j carries tlen at a32[j] and aread at a32[j + 7]
        m = min(len(a32) - 7, (span - p + 3) // 4)
        if m <= 0:
            continue
        tl = a32[:m]
        ar = a32[7 : 7 + m]
        ok = (tl >= 0) & ((tl & 1) == 0) & (ar > min_aread)
        if nreads is not None:
            ok &= ar < nreads
        cands.append(p + 4 * np.nonzero(ok)[0].astype(np.int64))
    if not cands:
        return np.zeros(0, np.int64)
    return np.sort(np.concatenate(cands))


def _resync(fh, pos: int, limit: int, min_aread: int, tsize: int, tspace: int,
            rlens: np.ndarray | None, nreads: int | None, bad_reads) -> int | None:
    """Forward-scan for the next believable pile start after a framing loss.

    Byte-granular over buffered chunks; a vectorized tlen/aread plausibility
    filter rejects almost every offset, and survivors must pass the full
    record check plus chain ``_RESYNC_CHAIN`` records. Returns the resync
    offset, or None when no later pile exists.
    """
    from .las import _REC_FMT, _REC_SIZE

    base = pos
    while base < limit:
        fh.seek(base)
        buf = fh.read(min(_RESYNC_CHUNK + _REC_SIZE, limit - base))
        span = min(len(buf), _RESYNC_CHUNK)
        for i in _candidate_offsets(buf, span, min_aread, nreads):
            i = int(i)
            if i + _REC_SIZE > len(buf):
                break
            vals = struct.unpack_from(_REC_FMT, buf, i)
            if _check_record(vals, base + i, limit, tsize, tspace, rlens,
                             nreads, None, bad_reads) is not None:
                continue
            if _try_chain(fh, base + i, limit, min_aread, tsize, tspace,
                          rlens, nreads, bad_reads):
                return base + i
        base += span
    return None


def scan_las_range(las, start: int | None = None, end: int | None = None,
                   rlens: np.ndarray | None = None,
                   bad_reads=frozenset(), max_issues: int = 1000) -> LasScanReport:
    """Validating header-only scan of ``las`` (a :class:`~.las.LasFile`) over
    ``[start, end)``; returns the :class:`LasScanReport` quarantine plan.

    With ``rlens`` (per-read lengths of the companion DB) coordinates are
    bounds-checked against read lengths and read ids against ``len(db)``;
    ``bad_reads`` marks DB read records that themselves failed validation so
    piles referencing them quarantine as ``db_read``.
    """
    from .las import _HDR_SIZE, _REC_FMT, _REC_SIZE

    path = las.path
    size = aio.getsize(path)
    s = _HDR_SIZE if start is None else int(start)
    e = size if end is None else int(end)
    # the novl cross-check applies whenever the RANGE covers the whole file,
    # however it was spelled — run_shard passes the full range explicitly
    whole_file = s == _HDR_SIZE and e == size
    nreads = len(rlens) if rlens is not None else None
    rep = LasScanReport(path=path, start=s, end=e)
    tsize, tspace = las._tsize, las.tspace

    def issue(kind: str, off: int, detail: str, aread=None, record=None):
        if len(rep.issues) < max_issues:
            rep.issues.append(IngestIssue(kind=kind, path=path, offset=off,
                                          detail=detail, aread=aread,
                                          record=record))

    segments: list = []
    clean_from: int | None = None      # start of the current run of clean piles

    def close_clean(upto: int):
        nonlocal clean_from
        if clean_from is not None and upto > clean_from:
            segments.append(("clean", clean_from, upto))
        clean_from = None

    pos = s
    nrec = 0
    cur_aread: int | None = None       # pile being walked
    pile_start = pos
    pile_bad: tuple[str, str] | None = None
    taint_next: tuple[str, str] | None = None  # mark the NEXT pile bad too
                                       # (set when a corrupt record's own
                                       # aread field is untrustworthy, so
                                       # pile membership is ambiguous)

    def close_pile(upto: int):
        """Commit the walked pile [pile_start, upto) as clean or quarantined."""
        nonlocal clean_from
        if cur_aread is None:
            return
        if pile_bad is None:
            if clean_from is None:
                clean_from = pile_start
            rep.n_piles += 1
            rep.pile_ranges.append((pile_start, upto))
        else:
            close_clean(pile_start)
            segments.append(("quarantine", cur_aread, pile_start,
                             pile_bad[0], pile_bad[1]))

    with aio.open_input(path, "rb") as fh:
        while pos < e:
            fh.seek(pos)
            raw = fh.read(_REC_SIZE)
            if pos + _REC_SIZE > e or len(raw) < _REC_SIZE:
                issue("truncation", pos, "range ends mid-record header",
                      aread=cur_aread, record=nrec)
                q_start = pile_start if cur_aread is not None else pos
                close_clean(q_start)
                segments.append(("quarantine", cur_aread, q_start,
                                 "truncation", "range ends mid-record"))
                cur_aread = None
                pos = e
                break
            vals = struct.unpack(_REC_FMT, raw)
            bad = _check_record(vals, pos, e, tsize, tspace, rlens, nreads,
                                cur_aread, bad_reads, fsize=size)
            if bad is None:
                aread = vals[7]
                if aread != cur_aread:
                    close_pile(pos)
                    cur_aread = aread
                    pile_start = pos
                    pile_bad = taint_next
                    taint_next = None
                nrec += 1
                pos += _REC_SIZE + vals[0] * tsize
                continue
            kind, detail = bad
            # which pile does this corrupt record belong to? When its aread
            # field survived the id/sort checks it is trustworthy: a
            # differing aread OPENS a new pile — the previous pile is
            # complete and clean, and must not be quarantined for its
            # neighbor's corruption. An untrustworthy aread (the aread
            # field itself violated, or sort order broke) leaves membership
            # ambiguous: taint the current pile AND the next one
            # (conservative containment beats silent divergence).
            trusted_aread = not (kind == "sort_order"
                                 or (kind == "bad_read_id"
                                     and detail.startswith("aread")))
            if (trusted_aread and cur_aread is not None
                    and vals[7] != cur_aread):
                close_pile(pos)
                cur_aread = vals[7]
                pile_start = pos
                pile_bad = None
                # a pending taint is satisfied by this pile: it IS the "next
                # pile" the ambiguous record may have belonged to, and it is
                # being quarantined anyway — a leaked taint would otherwise
                # falsely contain the next CLEAN pile after this one
                taint_next = None
            elif not trusted_aread:
                taint_next = (kind, detail)
            issue(kind, pos, detail, aread=cur_aread, record=nrec)
            nrec += 1
            # the reported kind may be an earlier check (read id, sort
            # order), but only a SANE tlen may steer the walk forward — a
            # doubly-corrupt record must go through resync, not advance by
            # a garbage (possibly negative) trace length
            framing_ok = (vals[0] >= 0 and vals[0] % 2 == 0
                          and pos + _REC_SIZE + vals[0] * tsize <= e)
            if kind in ("bad_tlen", "truncation") or not framing_ok:
                if cur_aread is None and trusted_aread:
                    # framing lost on the range-opening record, but its
                    # aread passed the id/sort checks: adopt it as the
                    # quarantined pile's key so the resync floor is the
                    # REAL pile id — otherwise resync (min_aread=-1) would
                    # rejoin this same pile mid-pile and its read would be
                    # silently corrected from partial evidence
                    cur_aread = vals[7]
                    pile_start = pos
                # framing lost: quarantine from the pile start and resync
                q_start = pile_start if cur_aread is not None else pos
                q_aread = cur_aread
                close_clean(q_start)
                nxt = _resync(fh, pos + 1, e,
                              cur_aread if cur_aread is not None else -1,
                              tsize, tspace, rlens, nreads, bad_reads)
                stop = nxt if nxt is not None else e
                segments.append(("quarantine", q_aread, q_start, kind,
                                 detail + f" (skipped {stop - q_start} bytes)"))
                cur_aread = None
                pile_bad = None
                # any pending ambiguity is wholly contained in the resync
                # quarantine segment; a taint surviving past it would
                # falsely contain the first clean pile after the resync
                taint_next = None
                pos = stop
                if nxt is None:
                    break
                continue
            # framing intact: the record still frames the stream — keep
            # walking the pile, which is now marked for quarantine
            if cur_aread is None:
                # a corrupt record opens the range: adopt its aread as the
                # pile key (emission bounds-checks it again downstream)
                cur_aread = vals[7]
                pile_start = pos
            if pile_bad is None:
                pile_bad = (kind, detail)
            pos += _REC_SIZE + vals[0] * tsize
    close_pile(pos)
    close_clean(pos)
    already_truncated = any(s[0] == "quarantine" and s[3] == "truncation"
                            for s in segments)
    # the count cross-check must run even when OTHER issue kinds were found
    # (a bad record mid-file must not mask a record-boundary EOF cut); it is
    # suppressed only when a truncation was already detected positionally
    if whole_file and nrec != las.novl and not already_truncated:
        if nrec < las.novl:
            # fewer records than promised: a record-boundary truncation only
            # this header cross-check can see
            issue("truncation", pos,
                  f"header promises {las.novl} records, file holds {nrec}")
            segments.append(("quarantine", None, pos, "truncation",
                             f"{las.novl - nrec} records missing at EOF"))
        else:
            # MORE records than promised: every byte is present and valid —
            # the header count is what's wrong (bit-flipped low, or records
            # appended without patching novl); nothing to quarantine
            issue("bad_header", 0,
                  f"header promises {las.novl} records, file holds {nrec} "
                  f"(surplus)")
    rep.n_records = nrec
    rep.segments = segments
    return rep


def scan_with_db(db, las, start: int | None = None,
                 end: int | None = None) -> LasScanReport:
    """:func:`scan_las_range` wired to a loaded DB: read lengths and any
    ``bad_reads`` marked by ``read_db(strict=False)`` feed the coordinate /
    read-id / db_read checks. The one construction shared by every policy
    gate (the pipeline and the CLI's ``-E`` pre-estimation)."""
    rlens = np.fromiter((r.rlen for r in db.reads), np.int64, len(db.reads))
    return scan_las_range(las, start, end, rlens=rlens,
                          bad_reads=frozenset(getattr(db, "bad_reads", None)
                                              or set()))


def sidecar_issues(las_path: str) -> list[IngestIssue]:
    """Validate the ``<path>.idx`` aread-index sidecar, when present.

    The index loader itself silently rebuilds on any malformation (a torn
    sidecar must never sink a run); this is the *diagnostic* face of the same
    checks, so an operator learns a sidecar is torn before N array jobs
    each pay a silent full rescan.
    """
    if aio.is_mem(las_path):
        return []
    sidecar = aio.local_path(las_path) + ".idx"
    if not os.path.exists(sidecar):
        return []
    issues: list[IngestIssue] = []
    try:
        with open(sidecar, "rb") as fh:
            hdr = fh.read(8)
            if len(hdr) < 8:
                issues.append(IngestIssue("truncation", sidecar, len(hdr),
                                          "sidecar shorter than its header"))
                return issues
            magic, n = struct.unpack("<4sI", hdr)
            if magic != b"LIDX":
                issues.append(IngestIssue("bad_magic", sidecar, 0,
                                          f"magic {magic!r} != b'LIDX'"))
                return issues
            payload = fh.read(16 * n)
            if len(payload) < 16 * n:
                # short payload only: the loader reads exactly 16*n bytes,
                # so trailing extra bytes are harmless, not a torn sidecar
                issues.append(IngestIssue(
                    "truncation", sidecar, 8 + len(payload),
                    f"payload holds {len(payload)} bytes, header promises "
                    f"{16 * n}"))
    except OSError as ex:
        issues.append(IngestIssue("truncation", sidecar, 0, f"unreadable ({ex})"))
    return issues
