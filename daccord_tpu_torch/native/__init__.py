"""The port's C++ host library: build with g++ and load with ctypes.

``native/dazz_native.cpp`` (the columnar LAS loader, the pile windowing, the
2-bit decode, the stitch splice, the exact distances, the window-consensus
engine ``solve_windows`` and its homopolymer rescue ``hp_rescue_windows``)
compiles with
``g++ -O3 -march=native`` into ``daccord_tpu_torch/_build/`` at first use.
The file name carries a hash of the source, the flags and the host CPU (the
``model name`` and ``flags`` lines of ``/proc/cpuinfo``): a library built
with ``-march=native`` on another host can die of an illegal instruction, so
a build from another CPU is never loaded. A missing compiler or a failed
build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "dazz_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def cpu_key() -> str:
    """The ``model name`` and ``flags`` lines of ``/proc/cpuinfo`` (first
    processor): what ``-march=native`` compiles for."""
    want = {"model name": None, "flags": None}
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            k, _, v = line.partition(":")
            k = k.strip()
            if k in want and want[k] is None:
                want[k] = v.strip()
            if all(x is not None for x in want.values()):
                break
    return f"{want['model name']}\n{want['flags']}"


def library_path(build_dir: str = BUILD_DIR) -> str:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    h.update(cpu_key().encode())
    return os.path.join(build_dir, f"dazz_native-{h.hexdigest()[:16]}.so")


def build(compiler: str = CXX, build_dir: str = BUILD_DIR) -> tuple[str, float]:
    """Build the library unless this source, these flags and this CPU have
    built it already; returns (library path, seconds g++ took). Processes
    that build at once (test workers, say) take turns on a lock file; the
    library appears under its final name only once complete."""
    path = library_path(build_dir)
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "dazz_native.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path, 0.0
        tmp = f"{path}.tmp.{os.getpid()}"
        t0 = time.perf_counter()
        try:
            res = subprocess.run([compiler, *CXX_FLAGS, SOURCE, "-o", tmp],
                                 capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the C++ compiler {compiler!r} to "
                               f"build {SOURCE}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"{compiler} failed to build {SOURCE}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, path)
        return path, time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The library, built at first use, with every entry point's argtypes."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build()[0])
        c = ctypes
        p = c.c_void_p
        lib.las_scan.restype = c.c_int
        lib.las_scan.argtypes = [c.c_char_p, c.c_int64, c.c_int64,
                                 c.POINTER(c.c_int64), c.POINTER(c.c_int32),
                                 c.POINTER(c.c_int64)]
        lib.las_load.restype = c.c_int
        lib.las_load.argtypes = [c.c_char_p, c.c_int64, c.c_int64, c.c_int64] + [p] * 10
        lib.process_pile.restype = c.c_int
        lib.process_pile.argtypes = (
            [p, c.c_int32, c.c_int32]        # a, alen, novl
            + [p] * 5                        # abpos, aepos, bbpos, bepos, comp
            + [p] * 3                        # b_concat, b_off, b_len
            + [p] * 2                        # trace_flat, trace_off
            + [c.c_int32] * 6                # tspace, w, adv, D, L, include_a
            + [p] * 3 + [c.c_int32])         # seqs, lens, nsegs, nwin
        lib.suffix_prefix.restype = c.c_int
        lib.suffix_prefix.argtypes = [p, c.c_int32, p, c.c_int32,
                                      c.POINTER(c.c_int32), c.POINTER(c.c_int32),
                                      c.POINTER(c.c_int32)]
        lib.decode_reads.restype = c.c_int
        lib.decode_reads.argtypes = [p, p, p, c.c_int32, p, p]
        lib.edit_distance_sum.restype = c.c_int64
        lib.edit_distance_sum.argtypes = [p, c.c_int32, p, p, p, c.c_int32]
        lib.align_map.restype = c.c_int64
        lib.align_map.argtypes = [p, c.c_int32, p, c.c_int32, p]
        lib.infix_distance.restype = c.c_int64
        lib.infix_distance.argtypes = [p, c.c_int32, p, c.c_int32]
        lib.solve_windows.restype = c.c_int
        lib.solve_windows.argtypes = (
            [p] * 3 + [c.c_int32] * 3        # seqs, lens, nsegs, B, D, L
            + [p] * 8 + [c.c_int32] * 7      # tables .. tier_M, n_tiers .. min_depth
            + [c.c_float] * 2 + [c.c_int32]  # max_err, count_frac, n_threads
            + [p] * 5)                       # cons, cons_len, errs, tiers, movf
        d = c.c_double
        lib.hp_rescue_windows.restype = c.c_int64
        lib.hp_rescue_windows.argtypes = (
            [p] * 3 + [c.c_int32] * 3        # seqs, lens, nsegs, B, D, L
            + [p] + [c.c_int32] * 5          # table0, P0, O0, k0, minc0, eminc0
            + [c.c_int32] * 6                # wlen .. min_depth
            + [d, c.c_float]                 # max_err, count_frac
            + [d, c.c_int32, d, c.c_int32]   # hp_err, hp_min_run, hp_margin, threads
            + [p, c.c_int32, p, c.c_int32]   # cons_in, CL, hp_cons, CLH
            + [p] * 3                        # cons_lens, errs, tiers_io
            + [p] + [c.c_int32] * 3          # post_tabs, n_mult, Lmax, Omax
            + [d] * 3                        # p_err_prof, mult_lo, mult_step
            + [c.c_int32, d])                # accept_likelihood, lambda_c
        _lib = lib
        return lib
