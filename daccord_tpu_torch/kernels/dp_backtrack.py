"""Fused heaviest-path DP + candidate choice + backtrack, for a batch of windows.

``dp_backtrack_batch`` is the port of the Pallas TPU kernel
``daccord_tpu/kernels/pallas_window.py:dp_backtrack_batch``. On a CUDA tensor
it launches the hand-written Hopper kernel ``csrc/dp_backtrack.cu`` (built
with nvcc for sm_90a at first use, bound through ctypes) or raises; it never
falls back to the plain version there. On a CPU tensor it runs
:func:`dp_backtrack_plain`, a line-by-line torch transcription of the Pallas
body that the CPU tests hold bit-equal to the Pallas kernel in interpret mode.

``launches`` counts the kernel's launches (not the plain version's calls),
``launches_by_shape`` splits them by (M, P), so a run can show that its main
path went through the kernel at every ladder shape it reached, and
``windows_by_shape`` counts the windows of those launches (their mean is the
batch the path gives each shape).

The kernel reads the adjacency as bits: ``adjW`` must hold only +0.0 and
-1e30 (what ``prep_batch`` makes), and any other value traps the kernel,
which leaves the CUDA context unusable. It takes M up to ``MAX_M`` where
its shared memory (:func:`fused_smem`) fits a block.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import nvcc as _nvcc

NEG = -1e30
PAD = 4
MAX_M = 1024         # the kernels' widest window: one thread a column
SMEM_MAX = 232_448   # shared memory one block may take on sm_90 (227 KB)

#: kernel launches since the count was last set to 0, in all and by (M, P),
#: and the windows those launches took, by (M, P)
launches = 0
launches_by_shape: dict[tuple[int, int], int] = {}
windows_by_shape: dict[tuple[int, int], int] = {}
_count_lock = threading.Lock()   # launches may come from the dispatcher thread

_lib = None
build_log = ""       # nvcc's output of the build this process ran (ptxas -v)


def build() -> tuple[str, float]:
    """Compile ``csrc/dp_backtrack.cu`` for sm_90a into the build directory
    (``kernels/nvcc.py``); returns (library path, seconds spent compiling --
    0 when the library was already built)."""
    global build_log
    path, secs = _nvcc.build("dp_backtrack")
    build_log = _nvcc.logs.get("dp_backtrack", build_log)
    return path, secs


def _load():
    global _lib
    if _lib is None:
        build()
        lib = _nvcc.load("dp_backtrack")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dp_backtrack_launch.argtypes = [vp] * 8 + [ci] * 8 + [vp]
        lib.dp_backtrack_launch.restype = ci
        lib.dp_backtrack_error_string.argtypes = [ci]
        lib.dp_backtrack_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _split(M: int) -> tuple[int, int]:
    """(S, U) of the kernels' launch for width M (``dp_*_launch`` in the
    sources): S threads a column, U predecessors a thread."""
    for top, su in ((64, (2, 32)), (256, (2, 128)), (512, (2, 256)), (1024, (1, 1024))):
        if M <= top:
            return su
    raise ValueError(f"M={M} exceeds the kernels' {MAX_M}")


def _bits_words(n_el: int) -> int:
    q = max((n_el + 31) // 32 - 1, 0)
    return q + (q >> 6) + 1


def fused_smem(M: int, P: int, T: int) -> int:
    """Bytes of shared memory a block of ``csrc/dp_backtrack.cu`` takes
    (its ``fused_layout``): the term buffers, the adjacency bits, the T
    admissible score rows and the uint16 pointer stack (the bits sharing
    their bytes with the last two above M=256), the codes and the walk."""
    S, U = _split(M)
    zs = 4 * 2 * 2 * S * (U + 4)
    bits = 4 * _bits_words(M * M)
    rows = 4 * T * M + 2 * P * M
    big = (max(bits, rows) + 3) & ~3 if S * U > 256 else bits + rows
    return zs + big + 4 * M + 4 * P + 4 * 32 * 2 + 4 + 2 * M


def scan_smem(M: int) -> int:
    """Bytes of shared memory a block of ``csrc/heaviest_path.cu`` takes."""
    S, U = _split(M)
    return 4 * 4 * S * (U + 4) + 4 * _bits_words(M * M)


def check_width(M: int, P: int, T: int, route: str = "fused") -> None:
    """Raise when the route's kernel cannot take a window of top-M ``M`` and
    P DP steps (T admissible end steps): M above ``MAX_M``, or shared
    memory above ``SMEM_MAX``."""
    if M > MAX_M:
        raise ValueError(f"top-M {M} exceeds the kernels' {MAX_M}")
    need = fused_smem(M, P, T) if route == "fused" else scan_smem(M)
    if need > SMEM_MAX:
        raise ValueError(f"top-M {M} with {P} DP steps needs {need} bytes of shared "
                         f"memory a block, above the card's {SMEM_MAX}")


def _check(adjW, wt, s0, snk_ok, sel, cons_len, t_lo, t_hi):
    B, M, M2 = adjW.shape
    P = wt.shape[1]
    if M2 != M or tuple(wt.shape) != (B, P, M) or tuple(s0.shape) != (B, M) \
            or tuple(snk_ok.shape) != (B, M) or tuple(sel.shape) != (B, M):
        raise ValueError(f"dp_backtrack: shapes adjW {tuple(adjW.shape)} wt "
                         f"{tuple(wt.shape)} s0 {tuple(s0.shape)} snk_ok "
                         f"{tuple(snk_ok.shape)} sel {tuple(sel.shape)} disagree")
    for name, t, dt in (("adjW", adjW, torch.float32), ("wt", wt, torch.float32),
                        ("s0", s0, torch.float32), ("snk_ok", snk_ok, torch.bool),
                        ("sel", sel, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"dp_backtrack: {name} is {t.dtype}, expected {dt}")
        if t.device != adjW.device:
            raise ValueError(f"dp_backtrack: {name} on {t.device}, adjW on {adjW.device}")
    if not (0 <= t_lo <= t_hi <= P - 1):
        raise ValueError(f"dp_backtrack: t range [{t_lo}, {t_hi}] outside [0, {P - 1}]")
    return B, M, P


def dp_backtrack_batch(adjW: torch.Tensor, wt: torch.Tensor, s0: torch.Tensor,
                       snk_ok: torch.Tensor, sel: torch.Tensor, *, k: int,
                       cons_len: int, n_candidates: int, t_lo: int, t_hi: int):
    """adjW [B,M,M] f32 (0 or -1e30), wt [B,P,M] f32, s0 [B,M] f32,
    snk_ok [B,M] bool, sel [B,M] i32 k-mer codes ->
    (cand [B,C,CL] i32, clen [B,C] i32, ok [B,C] bool).

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream, without synchronising, or raise."""
    global launches
    B, M, P = _check(adjW, wt, s0, snk_ok, sel, cons_len, t_lo, t_hi)
    dev = adjW.device
    if dev.type == "cpu":
        return dp_backtrack_plain(adjW, wt, s0, snk_ok, sel, k=k,
                                  cons_len=cons_len, n_candidates=n_candidates,
                                  t_lo=t_lo, t_hi=t_hi)
    if dev.type != "cuda":
        raise ValueError(f"dp_backtrack: no kernel for device {dev}")
    check_width(M, P, t_hi - t_lo + 1, "fused")
    if not all(t.is_contiguous() for t in (adjW, wt, s0, snk_ok, sel)):
        raise ValueError("dp_backtrack: inputs must be contiguous")
    C, CL = n_candidates, cons_len
    lib = _load()
    cand = torch.empty((B, C, CL), dtype=torch.int32, device=dev)
    clen = torch.empty((B, C), dtype=torch.int32, device=dev)
    ok = torch.empty((B, C), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.dp_backtrack_launch(
        adjW.data_ptr(), wt.data_ptr(), s0.data_ptr(), snk_ok.data_ptr(),
        sel.data_ptr(), cand.data_ptr(), clen.data_ptr(), ok.data_ptr(),
        B, M, P, C, CL, k, t_lo, t_hi, stream)
    if rc != 0:
        msg = lib.dp_backtrack_error_string(rc).decode()
        raise _nvcc.KernelError(f"dp_backtrack launch failed (B={B}, M={M}, P={P}): "
                           f"{msg} ({rc})")
    with _count_lock:
        launches += 1
        launches_by_shape[(M, P)] = launches_by_shape.get((M, P), 0) + 1
        windows_by_shape[(M, P)] = windows_by_shape.get((M, P), 0) + B
    return cand, clen, ok


def dp_backtrack_plain(adjW: torch.Tensor, wt: torch.Tensor, s0: torch.Tensor,
                       snk_ok: torch.Tensor, sel: torch.Tensor, *, k: int,
                       cons_len: int, n_candidates: int, t_lo: int, t_hi: int,
                       chunk: int = 1 << 24):
    """Plain torch version of the kernel: the Pallas body ``_fused_kernel``
    transcribed op for op over a batch axis (on any device), as its two
    halves: :func:`heaviest_path_plain` then :func:`candidates_backtrack`."""
    _check(adjW, wt, s0, snk_ok, sel, cons_len, t_lo, t_hi)
    scores, ptrs = heaviest_path_plain(adjW, wt, s0, chunk=chunk)
    return candidates_backtrack(scores, ptrs, snk_ok, sel, k=k,
                                cons_len=cons_len, n_candidates=n_candidates,
                                t_lo=t_lo, t_hi=t_hi)


def heaviest_path_plain(adjW: torch.Tensor, wt: torch.Tensor, s0: torch.Tensor,
                        chunk: int = 1 << 24):
    """The max-plus DP alone: adjW [B,M,M] f32, wt [B,P,M] f32, s0 [B,M] f32
    -> (scores [B,P,M] f32, ptrs [B,P,M] i32), the first u reaching the max
    on ties and NEG where the best predecessor is NEG -- the Pallas
    ``pallas_dp._dp_kernel`` (and the JAX scan route's ``_dp_scan_one``) op
    for op. Windows are processed in chunks of at most ``chunk`` [u, v]
    cells."""
    B, M, _ = adjW.shape
    P = wt.shape[1]
    step = max(1, chunk // max(M * M, 1))
    if B > step:
        parts = [heaviest_path_plain(adjW[i:i + step], wt[i:i + step],
                                     s0[i:i + step])
                 for i in range(0, B, step)]
        return tuple(torch.cat(x) for x in zip(*parts))
    dev = adjW.device
    s = s0
    scores = [s]
    ptrs = [torch.zeros((B, M), dtype=torch.int32, device=dev)]
    neg = NEG    # a Python scalar: no host-to-device copy
    for t in range(1, P):
        # the max over u and the lowest u reaching it (torch.max returns the
        # first maximal index; no value is NaN)
        best, best_u = (s[:, :, None] + adjW).max(dim=1)    # [B, v]
        s = torch.where(best > NEG / 2, best + wt[:, t, :], neg)
        scores.append(s)
        ptrs.append(best_u.to(torch.int32))
    return torch.stack(scores, dim=1), torch.stack(ptrs, dim=1)


def candidates_backtrack(scores: torch.Tensor, ptrs: torch.Tensor,
                         snk_ok: torch.Tensor, sel: torch.Tensor, *, k: int,
                         cons_len: int, n_candidates: int, t_lo: int, t_hi: int):
    """C end states with distinct final k-mers and their backtrack, from the
    DP's stacks: scores [B,P,M] f32, ptrs [B,P,M] i32, snk_ok [B,M] bool,
    sel [B,M] i32 -> (cand [B,C,CL] i32, clen [B,C] i32, ok [B,C] bool).
    The candidate half of the JAX ``_finish_one`` (the argmax over the flat
    t-major index, the lowest index on ties; an all-masked round gives index
    0 and ok False), in torch on any device."""
    B, P, M = scores.shape
    if tuple(ptrs.shape) != (B, P, M) or tuple(snk_ok.shape) != (B, M) \
            or tuple(sel.shape) != (B, M):
        raise ValueError(f"candidates_backtrack: shapes scores {tuple(scores.shape)} "
                         f"ptrs {tuple(ptrs.shape)} snk_ok {tuple(snk_ok.shape)} "
                         f"sel {tuple(sel.shape)} disagree")
    if not (0 <= t_lo <= t_hi <= P - 1):
        raise ValueError(f"candidates_backtrack: t range [{t_lo}, {t_hi}] "
                         f"outside [0, {P - 1}]")
    dev = scores.device
    C, CL = n_candidates, cons_len
    i32 = torch.int32
    neg = NEG    # a Python scalar: no host-to-device copy

    # ---- admissible end states -------------------------------------------
    iota_t = torch.arange(P, device=dev).view(1, P, 1)
    iota_v = torch.arange(M, device=dev).view(1, 1, M)
    t_ok = (iota_t >= t_lo) & (iota_t <= t_hi)
    final = torch.where(t_ok & snk_ok[:, None, :], scores, neg)
    flat_idx = (iota_t * M + iota_v).expand(B, P, M)

    iota_cl = torch.arange(CL, device=dev)
    shifts = torch.clamp(2 * (k - 1 - iota_cl), 0, 30)
    tail_t = torch.clamp(iota_cl - k + 1, 0, P - 1)
    chosen = torch.zeros((B, M), dtype=torch.bool, device=dev)
    tbs, vbs, mxs = [], [], []
    for _ in range(C):
        fmask = torch.where(chosen[:, None, :], neg, final)
        mx = fmask.amax(dim=(1, 2))                          # [B]
        idx = torch.where(fmask == mx[:, None, None], flat_idx,
                          torch.full_like(flat_idx, P * M)).amin(dim=(1, 2))
        tbs.append(idx // M)
        vbs.append(idx % M)
        mxs.append(mx)
        chosen = chosen | (iota_v[0] == vbs[-1][:, None])
    t_best = torch.stack(tbs, dim=1)                         # [B, C]
    v_best = torch.stack(vbs, dim=1)

    # ---- backtrack of all C candidates at once: walk the pointer stack from
    # t = P-1 down to 0 ---------------------------------------------------
    kpath = torch.empty((B, C, P), dtype=sel.dtype, device=dev)
    node = torch.zeros_like(v_best)
    for i in range(P):
        t = P - 1 - i
        forced = torch.where(t_best == t, v_best, node).clamp(0, M - 1)
        kpath[:, :, t] = torch.gather(sel, 1, forced)
        ptr_val = torch.gather(ptrs[:, t, :], 1, forced).to(forced.dtype)
        node = torch.where((t <= t_best) & (t > 0), ptr_val, forced)

    first = kpath[:, :, :1]
    head = torch.bitwise_right_shift(first, shifts) & 3      # codes are >= 0
    tail = kpath[:, :, tail_t] & 3
    base = torch.where(iota_cl < k, head, tail)
    cand = torch.where(iota_cl < (t_best + k)[:, :, None], base, torch.full_like(base, PAD))
    return cand.to(i32), (t_best + k).to(i32), torch.stack(mxs, dim=1) > NEG / 2
