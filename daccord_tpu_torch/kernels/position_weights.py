"""The OffsetLikely position weights ``W = occ @ ol.T`` in one fixed order.

``occ[b, m, o]`` counts the positions i of window b's segments whose k-mer
is the window's kept k-mer m (``kid[b, d, i] == m``, prep_batch's kept
index, -1 for none) at offset ``o = min(i, O - 1)``; ``W[b, m, p]`` is the
sum over o = 0..O-1, ascending, of ``occ[b, m, o] * ol[p, o]``, each product
rounded to f32 before it is added. On a CUDA tensor :func:`position_weights`
launches the hand-written Hopper kernel ``csrc/position_weights.cu`` (built
with nvcc for sm_90a at first use, bound through ctypes) or raises; on a
CPU tensor it runs :func:`position_weights_plain`: the counts
(:func:`occurrence_counts`) and the dense ascending loop as separate torch
multiply and add ops. Both give the same bits (the kernel skips the zero
counts, which needs every ``ol`` entry finite: ``TierLadder`` checks it), so
a ladder call gives the same bytes on the card and on the CPU;
``torch.matmul`` sums in cuBLAS's order on the card and in another on the
CPU, and the two ladders then differed on a few windows in a thousand (a
last-bit change of W can move a DP tie).

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
        lib.position_weights_launch.argtypes = [vp] * 3 + [ci] * 6 + [vp]
        lib.position_weights_launch.restype = ci
        lib.position_weights_error_string.argtypes = [ci]
        lib.position_weights_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


COUNT_MAX = 65535   # the kernel counts in 16 bits


def check_shape(D: int, npos: int, O: int) -> None:
    """Raise ``ValueError`` when a count of a window of D segments of
    ``npos`` k-mer positions could pass :data:`COUNT_MAX`: offset O-1 takes
    every position from O-1 on, so a count is at most D * max(1, npos - O
    + 1)."""
    most = D * max(1, npos - O + 1)
    if most > COUNT_MAX:
        raise ValueError(f"position_weights: {D} segments of {npos} k-mer positions "
                         f"could count {most} occurrences at one offset, above the "
                         f"kernel's {COUNT_MAX}")


def occurrence_counts(kid: torch.Tensor, M: int, O: int) -> torch.Tensor:
    """kid [B, D, NPOS] int32 (-1 = no kept k-mer) -> occ [B, M, O] f32, the
    count of positions of each kept k-mer at each offset (positions from
    O-1 on count at O-1)."""
    B, D, npos = kid.shape
    dev = kid.device
    m_hit = kid >= 0
    row = torch.arange(B, device=dev).view(B, 1, 1).expand(B, D, npos)[m_hit]
    pos = torch.arange(npos, device=dev).view(1, 1, npos).expand(B, D, npos)[m_hit]
    occ = torch.zeros((B * M * O,), dtype=torch.float32, device=dev)
    occ.index_add_(0, (row * M + kid[m_hit]) * O + pos.clamp(max=O - 1),
                   torch.ones_like(pos, dtype=torch.float32))
    return occ.view(B, M, O)


def position_weights_plain(kid: torch.Tensor, ol: torch.Tensor, M: int) -> torch.Tensor:
    """kid [B, D, NPOS] int32, ol [P, O] f32 -> W [B, M, P] f32: the counts of
    :func:`occurrence_counts` summed over o in ascending order against ol,
    one rounded product and one rounded add a term, zero counts included."""
    P, O = ol.shape
    occ = occurrence_counts(kid, M, O)
    B = occ.shape[0]
    # offset-major copies, so each term is one contiguous multiply and add
    occ_t = occ.permute(2, 0, 1).reshape(O, B * M, 1).contiguous()
    ol_t = ol.t().contiguous()
    W = torch.zeros((B * M, P), dtype=torch.float32, device=kid.device)
    term = torch.empty_like(W)
    for o in range(O):
        torch.mul(occ_t[o], ol_t[o], out=term)
        W.add_(term)
    return W.view(B, M, P)


def position_weights(kid: torch.Tensor, ol: torch.Tensor, M: int) -> torch.Tensor:
    """:func:`position_weights_plain`'s contract. CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream, without
    synchronising, or raise."""
    global launches
    if kid.dim() != 3 or ol.dim() != 2:
        raise ValueError(f"position_weights: kid {tuple(kid.shape)} must be [B, D, NPOS] "
                         f"and ol {tuple(ol.shape)} [P, O]")
    B, D, npos = kid.shape
    P, O = ol.shape
    if kid.dtype != torch.int32:
        raise TypeError(f"position_weights: kid is {kid.dtype}, expected int32")
    if ol.dtype != torch.float32:
        raise TypeError(f"position_weights: ol is {ol.dtype}, expected float32")
    dev = kid.device
    if ol.device != dev:
        raise ValueError(f"position_weights: ol on {ol.device}, kid on {dev}")
    if dev.type == "cpu":
        return position_weights_plain(kid, ol, M)
    if dev.type != "cuda":
        raise ValueError(f"position_weights: no kernel for device {dev}")
    check_shape(D, npos, O)
    kid, ol = kid.contiguous(), ol.contiguous()
    lib = _load()
    W = torch.empty((B, M, P), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.position_weights_launch(kid.data_ptr(), ol.data_ptr(), W.data_ptr(),
                                     B, D, npos, M, P, O, stream)
    if rc != 0:
        msg = lib.position_weights_error_string(rc).decode()
        raise _nvcc.KernelError(f"position_weights launch failed (B={B}, D={D}, "
                                f"NPOS={npos}, M={M}, P={P}, O={O}): {msg} ({rc})")
    with _count_lock:
        launches += 1
        launches_by_shape[(M, P)] = launches_by_shape.get((M, P), 0) + 1
        windows_by_shape[(M, P)] = windows_by_shape.get((M, P), 0) + B
    return W
