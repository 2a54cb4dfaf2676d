"""The OffsetLikely position weights ``W = occ @ ol.T`` in one fixed order.

``W[b, m, p]`` is the sum over o = 0..O-1, ascending, of ``occ[b, m, o] *
ol[p, o]``, each product rounded to f32 before it is added. On a CUDA tensor
:func:`position_weights` launches the hand-written Hopper kernel
``csrc/position_weights.cu`` (built with nvcc for sm_90a at first use, bound
through ctypes) or raises; on a CPU tensor it runs
:func:`position_weights_plain`, the same loop as separate torch multiply and
add ops. Both give the same bits, so a ladder call gives the same bytes on
the card and on the CPU; ``torch.matmul`` sums in cuBLAS's order on the card
and in another on the CPU, and the two ladders then differed on a few
windows in a thousand (a last-bit change of W can move a DP tie).

``launches`` counts the kernel's launches, ``launches_by_shape`` splits them
by (M, P) and ``windows_by_shape`` counts the windows of those launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import nvcc as _nvcc

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
        lib = _nvcc.load("position_weights")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.position_weights_launch.argtypes = [vp] * 3 + [ci] * 3 + [vp]
        lib.position_weights_launch.restype = ci
        lib.position_weights_error_string.argtypes = [ci]
        lib.position_weights_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def position_weights_plain(occ: torch.Tensor, ol: torch.Tensor) -> torch.Tensor:
    """occ [B, M, O] f32, ol [P, O] f32 -> W [B, M, P] f32, summed over o in
    ascending order, one rounded product and one rounded add a term."""
    B, M, O = occ.shape
    P = ol.shape[0]
    # offset-major copies, so each term is one contiguous multiply and add
    occ_t = occ.permute(2, 0, 1).reshape(O, B * M, 1).contiguous()
    ol_t = ol.t().contiguous()
    W = torch.zeros((B * M, P), dtype=torch.float32, device=occ.device)
    term = torch.empty_like(W)
    for o in range(O):
        torch.mul(occ_t[o], ol_t[o], out=term)
        W.add_(term)
    return W.view(B, M, P)


def position_weights(occ: torch.Tensor, ol: torch.Tensor) -> torch.Tensor:
    """:func:`position_weights_plain`'s contract. CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream, without
    synchronising, or raise."""
    global launches
    B, M, O = occ.shape
    P = ol.shape[0]
    if ol.dim() != 2 or ol.shape[1] != O:
        raise ValueError(f"position_weights: occ {tuple(occ.shape)} and ol "
                         f"{tuple(ol.shape)} disagree")
    for name, t in (("occ", occ), ("ol", ol)):
        if t.dtype != torch.float32:
            raise TypeError(f"position_weights: {name} is {t.dtype}, expected float32")
    dev = occ.device
    if ol.device != dev:
        raise ValueError(f"position_weights: ol on {ol.device}, occ on {dev}")
    if dev.type == "cpu":
        return position_weights_plain(occ, ol)
    if dev.type != "cuda":
        raise ValueError(f"position_weights: no kernel for device {dev}")
    occ, ol = occ.contiguous(), ol.contiguous()
    lib = _load()
    W = torch.empty((B, M, P), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.position_weights_launch(occ.data_ptr(), ol.data_ptr(), W.data_ptr(),
                                     B * M, P, O, stream)
    if rc != 0:
        msg = lib.position_weights_error_string(rc).decode()
        raise _nvcc.KernelError(f"position_weights launch failed (B={B}, M={M}, P={P}, "
                           f"O={O}): {msg} ({rc})")
    with _count_lock:
        launches += 1
        launches_by_shape[(M, P)] = launches_by_shape.get((M, P), 0) + 1
        windows_by_shape[(M, P)] = windows_by_shape.get((M, P), 0) + B
    return W
