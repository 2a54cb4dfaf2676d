"""Paged-pool page gather: pool [N, PL] int8, table [B, PPW] i32 ->
[B, PPW, PL] int8.

``gather_pages`` is the port of the Pallas TPU kernel
``daccord_tpu/kernels/pallas_window.py:gather_pages``. On a CUDA tensor it
launches the hand-written Hopper kernel ``csrc/gather_pages.cu`` (built with
nvcc for sm_90a at first use, bound through ctypes) or raises; on a CPU
tensor it runs :func:`gather_pages_plain`, ``pool[table]``.

Page indices are trusted by neither version: the plain version's indexing
raises on an index outside the pool, and the kernel traps on one. Callers
that hold the table as host numpy check it with :func:`check_table` before
the upload, so a bad table raises a ``ValueError`` before any device work.

``launches`` counts the kernel's launches, ``launches_by_shape`` splits them
by the pool rows and table width (N, PPW), which tell the paged
batches of one shape family apart at a fixed batch width.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import nvcc as _nvcc

#: kernel launches since the count was last set to 0, in all and by (N, PPW)
launches = 0
launches_by_shape: dict[tuple[int, int], int] = {}
_count_lock = threading.Lock()   # launches may come from the dispatcher thread

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _nvcc.load("gather_pages")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gather_pages_launch.argtypes = [vp] * 3 + [ci] * 5 + [vp]
        lib.gather_pages_launch.restype = ci
        lib.gather_pages_error_string.argtypes = [ci]
        lib.gather_pages_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_table(table: np.ndarray, n_pages: int) -> None:
    """Raise unless every page index of the host table lies in [0, n_pages)."""
    table = np.asarray(table)
    if table.size and (int(table.min()) < 0 or int(table.max()) >= n_pages):
        raise ValueError(f"page table indexes [{int(table.min())}, "
                         f"{int(table.max())}] outside the pool's {n_pages} pages")


def gather_pages_plain(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain torch version: ``pool[table]`` (raises on an index outside the
    pool)."""
    return pool[table.long()]


def _width(PL: int, *ptrs: int) -> int:
    """Widest vector (bytes) that divides the page and every address."""
    for w in (16, 8, 4, 2):
        if PL % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return 1


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool [N, PL] int8, table [B, PPW] i32 -> [B, PPW, PL] int8.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream, without synchronising, or raise."""
    global launches
    if pool.dim() != 2 or table.dim() != 2:
        raise ValueError(f"gather_pages: pool {tuple(pool.shape)} must be "
                         f"[N, PL] and table {tuple(table.shape)} [B, PPW]")
    if pool.dtype != torch.int8 or table.dtype != torch.int32:
        raise TypeError(f"gather_pages: pool is {pool.dtype} (int8 expected), "
                        f"table is {table.dtype} (int32 expected)")
    if pool.device != table.device:
        raise ValueError(f"gather_pages: pool on {pool.device}, table on {table.device}")
    dev = pool.device
    if dev.type == "cpu":
        return gather_pages_plain(pool, table)
    if dev.type != "cuda":
        raise ValueError(f"gather_pages: no kernel for device {dev}")
    if not (pool.is_contiguous() and table.is_contiguous()):
        raise ValueError("gather_pages: inputs must be contiguous")
    N, PL = pool.shape
    B, PPW = table.shape
    lib = _load()
    out = torch.empty((B, PPW, PL), dtype=torch.int8, device=dev)
    width = _width(PL, pool.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gather_pages_launch(pool.data_ptr(), table.data_ptr(), out.data_ptr(),
                                 B, PPW, N, PL, width, stream)
    if rc != 0:
        msg = lib.gather_pages_error_string(rc).decode()
        raise _nvcc.KernelError(f"gather_pages launch failed (B={B}, PPW={PPW}, "
                           f"PL={PL}): {msg} ({rc})")
    with _count_lock:
        launches += 1
        launches_by_shape[(N, PPW)] = launches_by_shape.get((N, PPW), 0) + 1
    return out
