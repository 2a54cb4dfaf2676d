"""Write-ahead job journal: the serve tier's crash-durability spine.

The port's copy of the JAX package's ``serve/journal.py``.

Every job the service admits is recorded here BEFORE any other effect, in an
append-only, per-record-fsync'd jsonl file (``<workdir>/journal.jsonl``).
The lifecycle a job's records trace::

    admitted    spec + tenant charge + optional client idempotency key
    running     a worker claimed it
    progress    per-job pipeline checkpoint landed (emitted reads + durable
                ``out.fasta.part`` bytes — the resume point)
    committing  the FASTA bytes are fsync'd; the publishing rename is next
    committed   out.fasta + manifest durably published
    aborted     client abort (terminal)
    failed      run failed / replay re-admission refused (terminal)
    interrupted bounded-drain shutdown gave up waiting (resumable)
    replayed    a restart re-admitted this orphan through the quota path
    demoted     lease ownership lost mid-run (a peer took the job over)

On restart the service replays the journal (:func:`replay`): terminal jobs
contribute only their idempotency keys; a job with a ``committing`` record
whose part file matches the recorded byte count is FINISHED in place (the
rename + manifest the crash interrupted — no recompute); every other
non-terminal job is an *orphan*, re-admitted through the normal quota path
and re-run — resuming from its per-job checkpoint where one landed.

Torn tails are tolerated exactly like torn manifests: a crash can
land mid-append, so an unparseable trailing line is skipped, never fatal —
what was fsync'd before it is the truth. (Mid-file garbage is skipped too,
counted, and surfaced; only the records that parse are trusted.)

The journal COMPACTS at startup (after replay) and shutdown: live jobs keep
their full record chain, terminal jobs collapse to one ``admitted`` +
terminal pair — kept only while they carry an idempotency key, so duplicate
submissions keep answering with the committed job without the file growing
with lifetime job count.

``serve_crash:N`` fault injection lives here by design: the Nth fsync'd
append returns, THEN the process dies hard (``os._exit(137)``) — the
injected crash can never claim durability it doesn't have.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass

from ..utils import aio

#: journal record kinds that end a job's lifecycle
TERMINAL_RECS = ("committed", "aborted", "failed")


@dataclass
class JournalEntry:
    """Replayed per-job state: the last-record-wins fold of one job's chain."""

    job: str
    state: str = "admitted"           # last lifecycle record kind
    tenant: str = "default"
    nbytes: int = 0                   # the admission charge to restore
    spec: dict | None = None          # JobSpec fields (asdict form)
    dir: str | None = None            # jobdir (absolute; foreign on takeover)
    idem: str | None = None           # client idempotency key
    takeover: bool = False            # admitted via peer takeover
    part_bytes: int = 0               # committing: fsync'd part-file bytes
    part_name: str | None = None      # the attempt-private part file those
                                      # bytes live in (basename)
    part_sha: str | None = None       # committing: sha256 of those fsync'd
                                      # bytes — replay/takeover finalize
                                      # refuses a part whose content belies
                                      # the journaled digest

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_RECS


class JobJournal:
    """Append-side handle. One per service process; thread-safe (HTTP
    threads, workers, and the ticker all append)."""

    def __init__(self, path: str, faults=None):
        self.path = path
        self.faults = faults
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)
        self.appended = 0
        # disk-says-no accounting: appends that failed to reach
        # durability (ENOSPC/EIO, real or injected) and the last error text —
        # the service's disk-pressure governor reads both
        self.append_failures = 0
        self.last_error: str | None = None

    def append(self, rec: str, job: str, **fields) -> bool:
        """Durably append one record: the write and fsync complete before
        this returns True — the WRITE-AHEAD contract every state transition
        in the service leans on. The ``serve_crash`` fault fires here, AFTER
        durability, so an injected death never loses a record it claims.

        Returns False when the record did NOT become durable: the closed-fd
        shutdown-drain window (the durable manifest is already the truth),
        or a disk refusal (ENOSPC/EIO — real, or injected via the
        ``@journal`` fault domain). A refusal never raises — the appenders
        are HTTP threads, workers, and the ticker, none of which may die
        for a full volume; the service reads False and enters its
        ``disk_pressure`` state instead."""
        line = json.dumps({"rec": rec, "job": job, "ts": time.time(),
                           **fields}) + "\n"
        with self._lock:
            if self._fd is None:
                return False
            try:
                aio.io_gate("journal", op="append")
                os.write(self._fd, line.encode())
                os.fsync(self._fd)
            except OSError as e:
                # a partial write may have torn the tail; replay tolerates
                # torn lines, so the journal stays replayable either way
                self.append_failures += 1
                self.last_error = f"{type(e).__name__}: {e}"
                return False
            self.appended += 1
        if self.faults is not None and self.faults.serve_crash_check():
            # test-only hard death (see runtime/faults.py serve_crash): the
            # record above is durable; nothing after it is — exactly a
            # SIGKILL landing between syscalls
            os._exit(137)
        return True

    def size_bytes(self) -> int:
        """Current on-disk journal size (0 when unreadable) — the online
        compaction watermark's input."""
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def compact_online(self) -> dict | None:
        """Compact the LIVE journal in place — the restart-only compaction
        (replay → :func:`compact`) without the restart, triggered by the
        service at a size/free-space watermark so an ENOSPC'd volume can be
        relieved by the journal's own garbage (terminal chains without
        idempotency keys) instead of waiting for an operator bounce.

        Replays from disk under the append lock (disk state IS the truth —
        records that failed to append were never durable), durably rewrites,
        then swaps the append fd to the new file. Returns a summary dict
        (``before``/``after`` bytes, ``kept`` jobs, ``torn`` lines) or None
        when the rewrite itself was refused — the old fd keeps appending,
        nothing is lost, and the caller may retry at the next watermark."""
        with self._lock:
            if self._fd is None:
                return None
            before = self.size_bytes()
            entries, torn = replay(self.path)
            try:
                compact(self.path, entries)
                fd = os.open(self.path,
                             os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            except OSError:
                return None  # disk still refusing; keep the old fd
            os.close(self._fd)
            self._fd = fd
            return {"before": before, "after": self.size_bytes(),
                    "kept": sum(1 for e in entries.values()
                                if not e.terminal or e.idem),
                    "torn": torn}

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None


def replay(path: str) -> tuple[dict[str, JournalEntry], int]:
    """Fold the journal into per-job :class:`JournalEntry` state.

    Returns ``(entries, torn)``: ``entries`` keyed by job id in first-seen
    order, ``torn`` the count of unparseable lines tolerated (a crash mid-
    append tears at most the tail; anything else is surfaced for the
    sentinel, not trusted)."""
    entries: dict[str, JournalEntry] = {}
    torn = 0
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except OSError:
        return entries, 0
    for line in raw.split(b"\n"):
        if not line.strip():
            continue
        try:
            rec = json.loads(line.decode())
        except (json.JSONDecodeError, UnicodeDecodeError):
            torn += 1
            continue
        if not isinstance(rec, dict) or "rec" not in rec or "job" not in rec:
            torn += 1
            continue
        job = str(rec["job"])
        e = entries.get(job)
        if e is None:
            e = entries[job] = JournalEntry(job=job)
        kind = str(rec["rec"])
        b = rec.get("bytes")
        if isinstance(b, (int, float)) and not isinstance(b, bool):
            # any record may carry the durable part-file byte count (the
            # compaction tail does for non-committing states too)
            e.part_bytes = int(b)
        if isinstance(rec.get("part"), str):
            e.part_name = os.path.basename(rec["part"])
        if isinstance(rec.get("sha"), str):
            e.part_sha = rec["sha"]
        if kind == "admitted":
            e.tenant = str(rec.get("tenant", e.tenant))
            e.nbytes = int(rec.get("nbytes", e.nbytes) or 0)
            e.spec = rec.get("spec") if isinstance(rec.get("spec"), dict) \
                else e.spec
            e.dir = rec.get("dir") or e.dir
            e.idem = rec.get("idem") or e.idem
            e.takeover = bool(rec.get("takeover", e.takeover))
            e.state = "admitted"
        elif kind == "progress":
            pass   # refines the resume point; not a state change
        elif kind == "committing":
            e.state = "committing"
        elif kind in ("running", "replayed", "interrupted", "demoted",
                      *TERMINAL_RECS):
            e.state = kind
        # unknown record kinds: forward-compat, folded as a no-op
    return entries, torn


def compact(path: str, entries: dict[str, JournalEntry]) -> None:
    """Durably rewrite the journal from replayed state: live jobs keep an
    ``admitted`` record (plus their resume state), terminal jobs collapse to
    an ``admitted``+terminal pair kept ONLY while they carry an idempotency
    key (the dedupe memory). Without compaction an always-on server's
    journal — and every restart's replay — grows with lifetime job count."""

    def _write(fh) -> None:
        now = time.time()
        for e in entries.values():
            if e.terminal and not e.idem:
                continue
            admitted = {"rec": "admitted", "job": e.job, "ts": now,
                        "tenant": e.tenant, "nbytes": e.nbytes,
                        "spec": e.spec, "dir": e.dir, "idem": e.idem,
                        "takeover": e.takeover}
            fh.write((json.dumps(admitted) + "\n").encode())
            if e.state != "admitted":
                tail = {"rec": e.state, "job": e.job, "ts": now}
                if e.state == "committing" or e.part_bytes:
                    tail["bytes"] = e.part_bytes
                if e.part_name:
                    tail["part"] = e.part_name
                if e.part_sha:
                    tail["sha"] = e.part_sha
                fh.write((json.dumps(tail) + "\n").encode())

    aio.durable_write(path, _write, mode="wb", domain="journal")
