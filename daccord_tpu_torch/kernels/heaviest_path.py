"""Heaviest-path max-plus DP alone, for a batch of windows (the scan route).

``heaviest_path_batch`` is the port of the Pallas TPU kernel
``daccord_tpu/kernels/pallas_dp.py:heaviest_path_batch``, which is
bit-identical to the DP of the JAX package's default (scan) solve route.
On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/heaviest_path.cu`` (built with nvcc for sm_90a at first use, bound
through ctypes) or raises; it never falls back to the plain version there.
On a CPU tensor it runs :func:`dp_backtrack.heaviest_path_plain`, the DP half
of the fused kernel's plain version.

``launches`` counts the kernel's launches, ``launches_by_shape`` splits them
by (M, P), ``windows_by_shape`` counts the windows of those launches.

Like ``dp_backtrack``'s kernel, it reads the adjacency as bits: any value
of ``adjW`` other than +0.0 and -1e30 traps it. It takes M up to
``dp_backtrack.MAX_M``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import nvcc as _nvcc
from .dp_backtrack import check_width, heaviest_path_plain

#: kernel launches since the count was last set to 0, in all and by (M, P),
#: and the windows those launches took, by (M, P)
launches = 0
launches_by_shape: dict[tuple[int, int], int] = {}
windows_by_shape: dict[tuple[int, int], int] = {}
_count_lock = threading.Lock()   # launches may come from the dispatcher thread

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _nvcc.load("heaviest_path")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.heaviest_path_launch.argtypes = [vp] * 5 + [ci] * 3 + [vp]
        lib.heaviest_path_launch.restype = ci
        lib.heaviest_path_error_string.argtypes = [ci]
        lib.heaviest_path_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def heaviest_path_batch(adjW: torch.Tensor, wt: torch.Tensor, s0: torch.Tensor):
    """adjW [B,M,M] f32 (0 or -1e30), wt [B,P,M] f32, s0 [B,M] f32 ->
    (scores [B,P,M] f32, ptrs [B,P,M] i32).

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream, without synchronising, or raise."""
    global launches
    B, M, M2 = adjW.shape
    P = wt.shape[1]
    if M2 != M or tuple(wt.shape) != (B, P, M) or tuple(s0.shape) != (B, M):
        raise ValueError(f"heaviest_path: shapes adjW {tuple(adjW.shape)} wt "
                         f"{tuple(wt.shape)} s0 {tuple(s0.shape)} disagree")
    for name, t in (("adjW", adjW), ("wt", wt), ("s0", s0)):
        if t.dtype != torch.float32:
            raise TypeError(f"heaviest_path: {name} is {t.dtype}, expected float32")
        if t.device != adjW.device:
            raise ValueError(f"heaviest_path: {name} on {t.device}, adjW on {adjW.device}")
    dev = adjW.device
    if dev.type == "cpu":
        return heaviest_path_plain(adjW, wt, s0)
    if dev.type != "cuda":
        raise ValueError(f"heaviest_path: no kernel for device {dev}")
    check_width(M, P, 1, "scan")
    if not all(t.is_contiguous() for t in (adjW, wt, s0)):
        raise ValueError("heaviest_path: inputs must be contiguous")
    lib = _load()
    scores = torch.empty((B, P, M), dtype=torch.float32, device=dev)
    ptrs = torch.empty((B, P, M), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.heaviest_path_launch(adjW.data_ptr(), wt.data_ptr(), s0.data_ptr(),
                                  scores.data_ptr(), ptrs.data_ptr(), B, M, P,
                                  stream)
    if rc != 0:
        msg = lib.heaviest_path_error_string(rc).decode()
        raise _nvcc.KernelError(f"heaviest_path launch failed (B={B}, M={M}, P={P}): "
                           f"{msg} ({rc})")
    with _count_lock:
        launches += 1
        launches_by_shape[(M, P)] = launches_by_shape.get((M, P), 0) + 1
        windows_by_shape[(M, P)] = windows_by_shape.get((M, P), 0) + B
    return scores, ptrs
