"""Shared-filesystem lease protocol.

The port's copy of the JAX package's ``utils/lease.py``. One file = one
lease. A claimant atomically creates the lease file (``O_CREAT|O_EXCL``,
:func:`aio.exclusive_create`) with a JSON payload naming the holder; of N
processes racing, exactly one wins. The holder renews by bumping the file's
mtime every heartbeat; a lease whose mtime is older than the TTL is *stale*
(its holder died or wedged) and any process may take it over by removing
the stale file and re-claiming. No coordinator, no network protocol: the
shared filesystem is the control plane.

The four protocol rules, shared by the serve tier's per-job leases and its
announce lease:

- **claim**: ``O_EXCL`` create arbitrates every race; takeover of a stale
  lease goes through ``os.replace`` to a grave name, which succeeds for
  exactly one taker (the loser's replace raises ``FileNotFoundError``).
- **heartbeat re-read-before-renew**: a holder re-reads the payload before
  renewing: if its lease went stale during a host pause and another process
  took over, renewing would keep the taker's lease fresh while two
  processes run the same work. Ownership loss means stand down, never
  renew. (:func:`read` is the primitive; the stand-down policy lives with
  each caller.)
- **holder-checked release**: a releasing holder that was taken over must
  not delete the taker's live lease; :func:`release` with ``host`` given
  only removes while the payload still names that host.
- **stale takeover**: :func:`claim` on a stale lease reports the previous
  holder's identity and staleness, so the takeover is attributable in the
  event log.

The TTL must exceed a few heartbeats plus worst-case shared-FS mtime
propagation and host clock skew. :func:`backdate` is the deterministic test
hook (and fault-injection lever) that makes a lease stale without burning
TTL wall-clock.
"""

from __future__ import annotations

import json
import os
import time

from . import aio


def claim(path: str, host: str, ttl_s: float,
          extra: dict | None = None) -> tuple[bool, dict | None]:
    """Try to claim the lease at ``path`` for ``host``.

    Returns ``(claimed, takeover)``: ``takeover`` carries the previous
    holder's identity and the lease's staleness when the claim displaced a
    stale lease. A fresh (live) lease loses the race: ``(False, None)``.
    ``extra`` fields join the payload (the serve tier stores the whole job
    descriptor there, so a takeover is self-contained)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = json.dumps({"host": host, "pid": os.getpid(),
                          "claimed_t": time.time(),
                          **(extra or {})}).encode()

    def _create() -> bool:
        # a disk that says no (ENOSPC/EIO, real or injected through the
        # ``lease`` fault domain) is as retryable as losing the race: no
        # OSError escapes a claim into a heartbeat or submit thread, and
        # exclusive_create unlinks a torn claim file on failure
        try:
            return aio.exclusive_create(path, payload, domain="lease")
        except OSError:
            return False

    if _create():
        return True, None
    try:
        stale_s = time.time() - os.path.getmtime(path)
    except OSError:
        # the holder released between our create and stat: claim the vacancy
        return _create(), None
    if stale_s <= ttl_s:
        return False, None
    prev = read(path) or {}
    grave = f"{path}.stale.{os.getpid()}"
    try:
        os.replace(path, grave)
    except FileNotFoundError:
        return False, None  # another taker won the replace race
    except OSError:
        return False, None  # the disk refused the takeover rename
    try:
        os.remove(grave)
    except OSError:
        pass
    if not _create():
        return False, None
    return True, {"prev_host": str(prev.get("host", "?")),
                  "stale_s": round(stale_s, 3)}


def read_result(path: str) -> tuple[dict | None, str]:
    """The lease's payload and why it is missing when it is:
    ``(info, "ok")`` | ``(None, "absent" | "torn" | "error")``.

    ``absent``: no file (released or taken over); ``torn``: the payload does
    not parse (a claimer killed mid-create; takeover-eligible once stale);
    ``error``: the read itself failed (EIO-class, where the holder's bounded
    heartbeat grace applies). Demoting on a transient read error would abort
    healthy work every time a shared FS hiccups."""
    try:
        aio.io_gate("lease", op="read")
        with open(path) as fh:
            info = json.load(fh)
    except FileNotFoundError:
        return None, "absent"
    except OSError:
        return None, "error"
    except json.JSONDecodeError:
        return None, "torn"
    if not isinstance(info, dict):
        return None, "torn"
    return info, "ok"


def read(path: str) -> dict | None:
    """The lease's payload, or None when absent or torn (a torn lease from a
    killed claimer is still takeover-able once stale)."""
    return read_result(path)[0]


def renew(path: str) -> bool:
    """Heartbeat: bump the lease's mtime (the staleness clock other
    processes read). Callers :func:`read`-check ownership first. Returns
    False when the bump failed (the lease vanished, or an EIO-class refusal,
    real or injected): the caller's bounded grace counts these before it
    demotes itself."""
    try:
        aio.io_gate("lease", op="renew")
        os.utime(path, None)
        return True
    except OSError:
        return False


def release(path: str, host: str | None = None) -> None:
    """Remove the lease; with ``host`` given, only while the payload still
    names that host (a holder that was taken over must not delete the
    taker's live lease)."""
    if host is not None:
        prev = read(path)
        if prev is not None and prev.get("host") != host:
            return
    try:
        os.remove(path)
    except OSError:
        pass


def backdate(path: str, age_s: float) -> None:
    """Set the lease's mtime ``age_s`` into the past: how tests and fault
    injection make a holder's lease stale without waiting out the TTL."""
    t = time.time() - age_s
    try:
        os.utime(path, (t, t))
    except OSError:
        pass


def stale_s(path: str) -> float | None:
    """Seconds since the lease's last heartbeat, or None when absent."""
    try:
        return time.time() - os.path.getmtime(path)
    except OSError:
        return None
