"""URL-scheme inputs: the four stream helpers the ingest scan reads through.

The port's copy of ``daccord_tpu/utils/aio.py``'s input side: plain paths and
``file:PATH`` map to the filesystem, ``mem:NAME`` to a process-local byte
store (:func:`put_mem`). The JAX module's outputs, durable commits and
injected storage faults are not copied; the fault gate comes with the fault
plan (ROADMAP Queue 1).
"""

from __future__ import annotations

import io
import os
import threading

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
