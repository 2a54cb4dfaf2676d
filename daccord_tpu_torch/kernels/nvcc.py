"""nvcc builds of the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles for sm_90a into a shared library with a
plain C interface, loaded with ctypes, in ``daccord_tpu_torch/_build/``. The
library's file name carries a hash of the source, the headers beside it
(``csrc/*.cuh``) and the flags, so an unchanged kernel loads at once and a
changed one rebuilds. :func:`build_many` starts one nvcc per source, all at
the same time. A missing toolkit or a failed build raises :class:`KernelError`:
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: nvcc's output (ptxas -v) of each build this process ran, by kernel name
logs: dict[str, str] = {}
_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel failed to build, or its launch failed: the same call fails
    the same way again. The supervisor raises it to the caller; it neither
    retries nor fails over, unless the message names an error that poisoned
    the CUDA context (``runtime.supervisor.is_device_lost_error``)."""


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the port's kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def source_key(path: str) -> str:
    """A hash of a source, the headers (``*.cuh``) beside it and the flags."""
    d = os.path.dirname(os.path.abspath(path))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [path] + sorted(os.path.join(d, x) for x in os.listdir(d)
                             if x.endswith(".cuh")):
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to, keyed by the source, its headers
    and the flags."""
    return os.path.join(BUILD_DIR, f"{name}-{source_key(source(name))}.so")


def build_many(names) -> dict[str, tuple[str, float]]:
    """Build every named kernel that is not built yet, one nvcc each, all
    started together; returns {name: (library path, seconds spent compiling
    -- 0 when it was already built)}."""
    out, procs = {}, {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            out[name] = (path, 0.0)
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        procs[name] = (path, tmp, time.perf_counter(), subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (path, tmp, t0, proc) in procs.items():
        logs[name] = proc.communicate()[0].strip()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {source(name)}:\n{logs[name]}")
            continue
        os.replace(tmp, path)
        out[name] = (path, secs)
    if failed:
        raise KernelError("\n".join(failed))
    return out


def build(name: str) -> tuple[str, float]:
    """Build one kernel; (library path, seconds spent compiling)."""
    return build_many([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built at first use; the caller sets argtypes."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(build(name)[0])
    return _libs[name]
