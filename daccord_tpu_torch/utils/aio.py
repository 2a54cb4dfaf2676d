"""URL-scheme streams and the storage-fault gate.

The port's copy of ``daccord_tpu/utils/aio.py``'s streams and its injected
storage faults: plain paths and ``file:PATH`` map to the filesystem,
``mem:NAME`` to a process-local byte store (:func:`put_mem`; written
``mem:`` files become visible at close).

Every output primitive here (:func:`open_output`, :func:`durable_replace`)
consults the process ``DACCORD_FAULT`` plan's ``io_*`` kinds
(``runtime/faults.py``) first, keyed by an optional path-class domain
(``sidecar`` for the event log, the ledger and the quarantine sidecar).
Injected failures are real :class:`OSError` instances with real errnos
(ENOSPC, EIO); :func:`retrying` is the bounded-backoff wrapper for the
transient class (EIO), and writers with their own file handles consult
:func:`io_gate`. Tests install a plan with :func:`install_faults`; without
one the plan comes from the environment.
"""

from __future__ import annotations

import errno
import io
import os
import threading
import time

_MEM: dict[str, bytes] = {}
_LOCK = threading.Lock()

MEM_SCHEME = "mem:"
FILE_SCHEME = "file:"


def is_mem(url: str) -> bool:
    return isinstance(url, str) and url.startswith(MEM_SCHEME)


def local_path(url: str) -> str:
    """Filesystem path of a non-mem URL (strips a ``file:`` scheme)."""
    return url[len(FILE_SCHEME):] if isinstance(url, str) and \
        url.startswith(FILE_SCHEME) else url


def put_mem(url: str, data: bytes) -> None:
    """Store ``data`` under a ``mem:`` URL."""
    if not is_mem(url):
        raise ValueError(f"{url!r} is not a {MEM_SCHEME} URL")
    with _LOCK:
        _MEM[url] = bytes(data)


_FAULTS = None                     # explicitly installed plan (wins)
_ENV_FAULTS: tuple = (None, None)  # (env text, parsed plan) lazy cache


class InjectedIOFault(OSError):
    """An ``io_*``-injected failure; ``fault_kind`` names the spec so the
    retry policy tells an injected fsync failure (never retried) from an
    injected transient EIO (retried), though both wear real errnos."""

    def __init__(self, err: int, msg: str, fault_kind: str):
        super().__init__(err, msg)
        self.fault_kind = fault_kind


def install_faults(plan) -> None:
    """Install (or with None, clear) the FaultPlan whose ``io_*`` kinds the
    primitives consult."""
    global _FAULTS, _ENV_FAULTS
    _FAULTS = plan
    _ENV_FAULTS = (None, None)


def _io_plan():
    if _FAULTS is not None:
        return _FAULTS if _FAULTS.has_io_faults() else None
    text = os.environ.get("DACCORD_FAULT")
    global _ENV_FAULTS
    if _ENV_FAULTS[0] != text:
        plan = None
        if text:
            try:
                from ..runtime.faults import FaultPlan

                p = FaultPlan.parse(text)
                plan = p if p.has_io_faults() else None
            except ValueError:
                plan = None  # the CLI entry point already rejected it
        _ENV_FAULTS = (text, plan)
    plan = _ENV_FAULTS[1]
    return plan if plan is not None and plan.has_io_faults() else None


#: re-entrancy guard: a primitive composed from other primitives is ONE
#: logical storage op
_NESTED = threading.local()


def _io_prelude(domain: str):
    """One logical storage op: apply any ``io_slow`` delay and return the
    fired error spec (or None)."""
    if getattr(_NESTED, "depth", 0):
        return None
    plan = _io_plan()
    if plan is None:
        return None
    ms = plan.io_slow_ms(domain)
    if ms > 0:
        time.sleep(ms / 1000.0)
    return plan.io_check(domain)


def _io_raise(spec, op: str, domain: str):
    err = errno.ENOSPC if spec.kind in ("io_enospc", "io_short_write") else errno.EIO
    raise InjectedIOFault(err, f"injected {spec.kind}"
                          + (f"@{domain}" if domain else "")
                          + f" at {op} #{spec.at}", spec.kind)


def io_gate(domain: str, op: str = "write") -> None:
    """Consult the storage-fault gate for one logical op made outside the
    primitives: applies any ``io_slow`` delay and raises the injected
    OSError when a spec fires. A no-op without a plan."""
    spec = _io_prelude(domain)
    if spec is not None:
        _io_raise(spec, op, domain)


#: errnos the bounded-retry wrapper treats as transient on real errors
_TRANSIENT_ERRNOS = (errno.EIO, errno.EAGAIN, errno.EINTR)


def _retryable(e: OSError) -> bool:
    kind = getattr(e, "fault_kind", None)
    if kind is not None:
        # injected faults declare their class: only io_eio is transient
        return kind == "io_eio"
    return e.errno in _TRANSIENT_ERRNOS


def retrying(fn, attempts: int = 3, base_s: float = 0.01):
    """Run ``fn()`` with bounded retries and exponential backoff on
    transient OSErrors (EIO, EAGAIN, EINTR); ENOSPC and injected fsync or
    short-write faults propagate at once. ``fn`` must be safe to re-run
    from scratch."""
    i = 0
    while True:
        try:
            return fn()
        except OSError as e:
            if not _retryable(e) or i >= attempts - 1:
                raise
            time.sleep(base_s * (2 ** i))
            i += 1


class _MemWriter(io.BytesIO):
    """Seekable write buffer committed to the store on close."""

    def __init__(self, name: str):
        super().__init__()
        self._name = name

    def close(self) -> None:
        if not self.closed:
            with _LOCK:
                _MEM[self._name] = self.getvalue()
        super().close()


def open_output(url: str, mode: str = "wb", domain: str = ""):
    """Writable stream for a URL (text unless mode contains 'b'). ``mem:``
    content becomes visible at close. A fired storage fault raises at open
    (``io_short_write`` also leaves the empty file behind)."""
    if is_mem(url):
        buf = _MemWriter(url)
        return buf if "b" in mode else io.TextIOWrapper(buf)

    def attempt():
        spec = _io_prelude(domain)
        if spec is not None:
            if spec.kind == "io_short_write":
                open(local_path(url), mode).close()
            _io_raise(spec, "open_output", domain)
        return open(local_path(url), mode)

    return retrying(attempt)


def _fsync_dir_raw(path: str) -> None:
    d = os.path.dirname(os.path.abspath(local_path(path))) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def durable_replace(tmp: str, dst: str, domain: str = "") -> None:
    """``os.replace`` and a directory fsync: the rename that publishes a
    file whose content the caller fsynced survives power loss too. One
    logical storage op: an injected fault fires before the rename, so a
    refused publish never half-lands."""
    def attempt():
        spec = _io_prelude(domain)
        if spec is not None:
            _io_raise(spec, "durable_replace", domain)
        os.replace(local_path(tmp), local_path(dst))
        _fsync_dir_raw(dst)

    retrying(attempt)


def open_input(url: str, mode: str = "rb"):
    """Readable stream for a URL (text unless mode contains 'b', exactly
    like builtin ``open``)."""
    if is_mem(url):
        with _LOCK:
            if url not in _MEM:
                raise FileNotFoundError(url)
            data = _MEM[url]
        buf = io.BytesIO(data)
        return buf if "b" in mode else io.TextIOWrapper(buf)
    return open(local_path(url), mode)


def getsize(url: str) -> int:
    if is_mem(url):
        with _LOCK:
            if url not in _MEM:
                raise FileNotFoundError(url)
            return len(_MEM[url])
    return os.path.getsize(local_path(url))
