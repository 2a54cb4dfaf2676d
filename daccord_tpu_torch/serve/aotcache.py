"""The fleet-shared cache of the port's compiled kernels.

The JAX package's ``serve/aotcache.py`` holds XLA executables, serialized
after a jit compile and pinned to jax and jaxlib, so that a freshly spawned
serve peer loads its programs instead of compiling them. The port has no
jit. What it compiles are the five hand-written CUDA kernels
(``csrc/*.cu``): ``kernels/nvcc.py`` builds each into a shared library in
``_build/``, named by the kernel and its ``source_key`` (a hash of the
source, the headers beside it and the flags). A peer on a host whose
``_build/`` is empty runs nvcc for all five before its first ladder call.
This cache holds those libraries, so that a peer of a fleet installs them
from the shared directory instead:

- an entry is one kernel's library, keyed by the kernel's name; its digest
  is the kernel's ``source_key``, so a changed source is another entry;
- the wire format is the JAX package's: ``DACAOT01``, the sha256 of the
  body, then the body (a pickle of ``{"key", "meta", "payload"}``, the
  payload the library's bytes), published with tmp + fsync + rename;
- ``meta`` pins ``torch.__version__``, ``torch.version.cuda``, nvcc's
  ``--version`` line and the card's compute capability: a library built
  for another toolkit or card is rejected (``aot.reject reason=version``);
- :meth:`AotCache.load` verifies an entry and installs it into the build
  directory with the tmp-and-rename ``nvcc.build_many`` uses, and only when
  the library is not there yet;
- a torn, flipped or mismatched entry is an ``aot.reject`` event, followed
  by the local nvcc build of the same kernel (and the entry's re-publish,
  which heals it). No plain version ever runs in a kernel's place;
- a miss in the shared directory publishes the local library, whether this
  process just built it or found it in ``_build/``;
- :meth:`AotCache.sweep` caps the directory at ``DACCORD_AOT_CAP_MB`` (512),
  oldest first, as the JAX cache does.

CUDA graphs (``kernels/graphs.py``) are not cached: a graph is a capture of
one process's launches on its own context, its buffers' addresses and its
kernels' loaded modules, and CUDA has no way to move one into another
process. A fresh peer captures its own, at its first group's build.

:func:`prepare_kernels` is what a solve group on the card calls at its
build: once a process and cache directory, every kernel of the ladder, the
route's or not (``aot.hit`` / ``aot.miss`` / ``aot.publish`` /
``aot.reject`` in the group's events).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import subprocess
import threading
import time

from ..utils.obs import NullLogger

_MAGIC = b"DACAOT01"
_SHA_LEN = 32

#: every kernel of the ladder: a group prepares them all, whatever its route
KERNELS = ("dp_backtrack", "heaviest_path", "gather_pages", "rescore",
           "position_weights")

_META: dict | None = None
_PREPARED: set = set()
_PREP_LOCK = threading.Lock()


def _versions() -> dict:
    """What a library is pinned to: torch and its CUDA, nvcc's release line,
    and the card's compute capability (asked once a process)."""
    global _META
    if _META is None:
        import torch

        from ..kernels.nvcc import nvcc

        out = subprocess.run([nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
        line = next((ln.strip() for ln in out.splitlines() if "release" in ln),
                    out.strip().splitlines()[-1] if out.strip() else "")
        _META = {"torch": torch.__version__, "cuda": torch.version.cuda,
                 "nvcc": line,
                 "capability": "%d.%d" % torch.cuda.get_device_capability()}
    return _META


class AotCache:
    """Load and publish kernel libraries in a fleet-shared directory.

    Publishes go through tmp + fsync + rename, so peers racing to publish
    one entry both succeed (the last rename wins; both bodies are the same
    library). ``meta`` overrides the pins (the CPU tests' stand-ins)."""

    def __init__(self, cache_dir: str, log=None, cap_mb: float | None = None,
                 meta: dict | None = None):
        self.dir = cache_dir
        self.log = log if log is not None else NullLogger()
        self._meta = meta
        self._lock = threading.Lock()
        self.counters = {"hits": 0, "misses": 0, "publishes": 0,
                         "rejects": 0, "swept": 0, "installed": 0}
        if cap_mb is None:
            try:
                cap_mb = float(os.environ.get("DACCORD_AOT_CAP_MB", 512))
            except ValueError:
                cap_mb = 512.0
        self.cap_mb = cap_mb
        os.makedirs(cache_dir, exist_ok=True)

    def meta(self) -> dict:
        return self._meta if self._meta is not None else _versions()

    def _count(self, name: str) -> None:
        with self._lock:
            self.counters[name] += 1

    # ------------------------------------------------------------------
    # entry IO
    # ------------------------------------------------------------------

    def _path(self, key: str, digest: str) -> str:
        name = hashlib.sha256(f"{key}|{digest}".encode()).hexdigest()[:32]
        return os.path.join(self.dir, name + ".aot")

    def load(self, key: str, digest: str, dest: str) -> bool:
        """Verify the entry of ``(key, digest)`` and install its library at
        ``dest`` (tmp + rename) unless a file is there already; True on a hit.
        A missing entry is False with no event (the caller counts the miss);
        a corrupt or torn entry, or one pinned to another toolkit or card, is
        an ``aot.reject`` and False, the entry left in place (the caller's
        re-publish heals it; removing it would race another publisher)."""
        path = self._path(key, digest)
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
        except OSError:
            return False
        t0 = time.perf_counter()
        if len(raw) < len(_MAGIC) + _SHA_LEN or raw[:len(_MAGIC)] != _MAGIC:
            return self._reject(key, "corrupt")
        body = raw[len(_MAGIC) + _SHA_LEN:]
        if hashlib.sha256(body).digest() != raw[len(_MAGIC):len(_MAGIC) + _SHA_LEN]:
            return self._reject(key, "corrupt")
        try:
            ent = pickle.loads(body)
            payload = ent["payload"]
        except Exception:  # noqa: BLE001 -- any unreadable body is corrupt
            return self._reject(key, "corrupt")
        if ent.get("key") != key or not isinstance(payload, bytes):
            return self._reject(key, "corrupt")
        if ent.get("meta") != self.meta():
            return self._reject(key, "version")
        if not os.path.exists(dest):
            try:
                os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
                tmp = f"{dest}.tmp.{os.getpid()}.{threading.get_ident()}"
                with open(tmp, "wb") as fh:
                    fh.write(payload)
                os.replace(tmp, dest)
            except OSError as e:
                return self._reject(key, f"install:{type(e).__name__}")
            self._count("installed")
        self._count("hits")
        self.log.log("aot.hit", key=key,
                     wall_s=round(time.perf_counter() - t0, 3))
        return True

    def _reject(self, key: str, reason: str) -> bool:
        self._count("rejects")
        self.log.log("aot.reject", key=key, reason=reason)
        return False

    def publish(self, key: str, digest: str, lib_path: str,
                wall_s: float) -> bool:
        """Publish the library at ``lib_path`` as the entry of ``(key,
        digest)``; a failure (an unreadable library, a full shared volume,
        ENOSPC real or injected through the ``@aot`` fault domain) is an
        ``aot.reject`` and the peer goes on with its local library."""
        try:
            from ..utils.aio import durable_write

            with open(lib_path, "rb") as fh:
                payload = fh.read()
            body = pickle.dumps({"key": key, "meta": self.meta(),
                                 "payload": payload})
            blob = _MAGIC + hashlib.sha256(body).digest() + body
            durable_write(self._path(key, digest), lambda fh: fh.write(blob),
                          domain="aot")
        except Exception as e:  # noqa: BLE001 -- the cache never sinks a peer
            self._reject(key, f"publish:{type(e).__name__}")
            return False
        self._count("publishes")
        self.log.log("aot.publish", key=key, bytes=len(blob),
                     wall_s=round(wall_s, 3))
        self.sweep(keep=self._path(key, digest))
        return True

    def sweep(self, keep: str | None = None) -> int:
        """Size-capped sweep of the shared dir: the oldest-mtime ``.aot``
        entries go until the total is back under ``cap_mb``, never ``keep``.
        Wholly OSError-tolerant (peers sweep concurrently and entries vanish
        under us). Returns the number of entries removed."""
        if not self.cap_mb:
            return 0
        try:
            names = [n for n in os.listdir(self.dir) if n.endswith(".aot")]
        except OSError:
            return 0
        ents = []
        for n in names:
            p = os.path.join(self.dir, n)
            try:
                st = os.stat(p)
            except OSError:
                continue
            ents.append((st.st_mtime, st.st_size, p))
        total = sum(sz for _, sz, _ in ents)
        cap = self.cap_mb * (1 << 20)
        if total <= cap:
            return 0
        removed = freed = 0
        for _, sz, p in sorted(ents):
            if total - freed <= cap:
                break
            if keep is not None and os.path.abspath(p) == os.path.abspath(keep):
                continue
            try:
                os.remove(p)
            except OSError:
                continue
            removed += 1
            freed += sz
        if removed:
            with self._lock:
                self.counters["swept"] += removed
            self.log.log("aot.sweep", removed=removed, freed=freed,
                         total=total, cap_mb=self.cap_mb)
        return removed

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters)

    # ------------------------------------------------------------------
    # the kernels of a process
    # ------------------------------------------------------------------

    def prepare(self, names=KERNELS, *, library_path=None, digest_of=None,
                build_many=None) -> dict:
        """Every named kernel's library in place before its first launch:
        a verified entry installs (a hit); a miss or a rejected entry goes
        to the local build (``build_many``, one nvcc a source, all started
        together; a library already in the build directory costs nothing)
        and the local library is published. Returns {name: "hit" | "miss" |
        "reject"}. The three hooks default to ``kernels/nvcc.py``'s (the CPU
        tests pass g++-built stand-ins)."""
        if library_path is None or digest_of is None or build_many is None:
            from ..kernels import nvcc

            library_path = library_path or nvcc.library_path
            digest_of = digest_of or (lambda n: nvcc.source_key(nvcc.source(n)))
            build_many = build_many or nvcc.build_many
        out, local = {}, []
        for name in names:
            before = self.counters["rejects"]
            if self.load(name, digest_of(name), library_path(name)):
                out[name] = "hit"
                continue
            if self.counters["rejects"] == before:
                self._count("misses")
                self.log.log("aot.miss", key=name)
                out[name] = "miss"
            else:
                out[name] = "reject"
            local.append(name)
        if local:
            built = build_many(local)
            for name in local:
                path, secs = built[name]
                self.publish(name, digest_of(name), path, secs)
        return out


def prepare_kernels(cache_dir: str, log=None) -> dict | None:
    """The serve groups' hook (``serve/batcher.py``): prepare the ladder's
    kernels from ``cache_dir`` once a process and directory; a later group
    of the process returns None at once (its kernels are loaded)."""
    with _PREP_LOCK:
        key = os.path.abspath(cache_dir)
        if key in _PREPARED:
            return None
        res = AotCache(cache_dir, log=log).prepare()
        _PREPARED.add(key)
        return res
