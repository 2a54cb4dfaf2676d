"""The rescore: each window's C candidates against its segments, and the
acceptance rule.

:func:`rescore_pick` is the tail of every tier's solve. On a CUDA tensor it
launches the hand-written Hopper kernel ``csrc/rescore.cu`` (one launch a
call, built with nvcc for sm_90a at first use, bound through ctypes) or
raises; it never falls back to the plain version there. On a CPU tensor it
runs :func:`rescore_pick_plain`, the torch version: the Myers bit-parallel
edit distance of every (candidate, segment) pair
(:func:`edit_distance_myers`), the exact integer sum per candidate and one
f32 division by the window's segment bases, the argmin (the lowest index on
ties) and the accept test. The kernel is not a port of a Pallas kernel: the
JAX package leaves this step to XLA. It exists because the plain version is
about 1,900 launches a call (L steps of ~30 torch ops), which made the
ladder launch-bound on the card.

``launches`` counts the kernel's launches, ``launches_by_shape`` splits them
by (C, CL) and ``windows_by_shape`` counts the windows of those launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import nvcc as _nvcc

PAD = 4
WORD = 62            # bits of the DP column an int64 word holds in the plain
                     # version: the sum of two 62-bit words never overflows
MAX_CL = 512         # the kernel's longest candidate (eight 64-bit words)

#: kernel launches since the count was last set to 0, in all and by (C, CL),
#: and the windows those launches took, by (C, CL)
launches = 0
launches_by_shape: dict[tuple[int, int], int] = {}
windows_by_shape: dict[tuple[int, int], int] = {}
_count_lock = threading.Lock()   # launches may come from the dispatcher thread

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _nvcc.load("rescore")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rescore_launch.argtypes = [vp] * 10 + [ci] * 6 + [ctypes.c_float, vp]
        lib.rescore_launch.restype = ci
        lib.rescore_error_string.argtypes = [ci]
        lib.rescore_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_shape(D: int, L: int, C: int, CL: int) -> None:
    """Raise ``ValueError`` naming the limit when the kernel cannot take a
    window of D segments of L bases and C candidates of CL bases: CL up to
    ``MAX_CL`` and any C >= 1 (the window's tile stays in global memory and
    registers, so D and L are free)."""
    if not 1 <= CL <= MAX_CL:
        raise ValueError(f"rescore: consensus length {CL} outside 1..{MAX_CL}")
    if C < 1:
        raise ValueError(f"rescore: {C} candidates; at least 1")


def _broadcast(a: torch.Size, b: torch.Size) -> torch.Size:
    """The broadcast of two shapes, as ``torch.broadcast_shapes`` gives it;
    that one imports ``torch.fx``'s symbolic shapes (sympy) at its first
    call, which took seconds of the audit worker's start."""
    n = max(len(a), len(b))
    out = []
    for x, y in zip((1,) * (n - len(a)) + tuple(a), (1,) * (n - len(b)) + tuple(b)):
        if x != y and 1 not in (x, y):
            raise ValueError(f"shapes {tuple(a)} and {tuple(b)} do not broadcast")
        out.append(y if x == 1 else x)
    return torch.Size(out)


def edit_distance_myers(cand: torch.Tensor, cand_len: torch.Tensor,
                        seg: torch.Tensor, seg_len: torch.Tensor) -> torch.Tensor:
    """Exact unit-cost edit distance of cand[..., :cand_len] vs
    seg[..., :seg_len], batched over the leading axes (they broadcast).

    Myers/Hyyrö bit-parallel DP with the DP column in ceil(CL / 62) int64
    words of 62 bits, the addition's carry and the left shifts crossing
    words upward. Carries and shifts only move bits upward, so every bit at
    or below cand_len-1 is exact; each word is masked to its 62 bits after
    each step so no addition overflows. One step per segment base; PAD (4)
    matches nothing. Any CL: the JAX package's two-word form up to 64 and
    its anti-diagonal form above give the same distances."""
    CL = cand.shape[-1]
    NW = max(1, -(-CL // WORD))
    L = seg.shape[-1]
    dev = cand.device
    shape = _broadcast(cand.shape[:-1], seg.shape[:-1])
    i64 = torch.int64
    mask = (1 << WORD) - 1
    top = WORD - 1
    pos = torch.arange(CL, device=dev)
    valid = pos < cand_len[..., None]
    bit = torch.bitwise_left_shift(torch.ones((), dtype=i64, device=dev), pos % WORD)
    c64 = cand.to(i64)
    zero = torch.zeros((), dtype=i64, device=dev)
    n = cand_len.to(i64)
    nz = torch.zeros_like(n)
    one = torch.ones((), dtype=i64, device=dev)
    peq, vp, vn, hb = [], [], [], []
    for w in range(NW):
        in_w = valid & (pos // WORD == w)
        # [..., 5]; PAD -> 0
        peq.append(torch.stack([torch.where(in_w & (c64 == c), bit, zero).sum(-1)
                                for c in range(4)] + [nz], dim=-1)
                   .expand(shape + (5,)))
        nbits = (n - w * WORD).clamp(0, WORD)
        vp.append((torch.bitwise_left_shift(one, nbits) - 1).expand(shape).clone())
        vn.append(torch.zeros(shape, dtype=i64, device=dev))
        hw = torch.where(n > 0, (n - 1) // WORD, -1)
        hb.append(torch.where(hw == w,
                              torch.bitwise_left_shift(one, ((n - 1) % WORD).clamp(min=0)),
                              zero).expand(shape))
    score = n.expand(shape).clone()
    sl = seg_len.expand(shape)
    s64 = seg.to(i64).expand(shape + (L,))
    # every step's match masks at once; PAD (4) gathers the zero mask
    eq = [torch.gather(peq[w], -1, s64).unbind(-1) for w in range(NW)]
    scores = [score]                                        # after 0, 1, .. L bases
    for i in range(L):
        carry = None
        hp_in, hn_in = one, zero                            # D[0, j] = j carry-in
        delta = None
        for w in range(NW):
            last = w == NW - 1
            x = eq[w][i] | vn[w]
            a = x & vp[w]
            s = vp[w] + a if carry is None else vp[w] + a + carry
            if not last:
                carry = s >> WORD
                s = s & mask
            # on the last word the sum's carry-out (bit 62) reaches only
            # bits every use below masks off
            d0 = (s ^ vp[w]) | x
            hn = vp[w] & d0
            hp = (vn[w] | ~(vp[w] | d0)) & mask
            # hb holds the last row's bit (or none): +hb, -hb or 0
            dw = (hp & hb[w]) - (hn & hb[w])
            delta = dw if delta is None else delta + dw
            x2 = ((hp << 1) & mask) | hp_in
            h2 = (hn << 1) | hn_in
            if not last:
                hp_in, hn_in = hp >> top, hn >> top
            vn[w] = x2 & d0
            vp[w] = (h2 | ~(x2 | d0)) & mask
        score = score + torch.sign(delta)
        scores.append(score)
    res = torch.gather(torch.stack(scores, dim=-1), -1,
                       sl.to(i64).clamp(0, L)[..., None])[..., 0]
    return torch.where(n == 0, sl.to(i64), res)


def rescore_pick_plain(seqs: torch.Tensor, lens: torch.Tensor, nsegs: torch.Tensor,
                       cand: torch.Tensor, clen: torch.Tensor, ok: torch.Tensor,
                       p) -> dict:
    """Myers-rescore the C candidates of each window against its segments and
    accept the argmin (the first on ties), in torch.

    seqs [B, D, L] int8, lens [B, D], nsegs [B], cand [B, C, CL] int8,
    clen [B, C] i32, ok [B, C] bool; ``p`` gives ``max_err`` and
    ``min_depth``."""
    B, C, CL = cand.shape
    dev = cand.device
    seg_total = lens.sum(dim=1).clamp(min=1).to(torch.float32)       # [B]
    dists = edit_distance_myers(cand[:, :, None, :], clen[:, :, None],
                                seqs[:, None, :, :], lens[:, None, :])  # [B,C,D]
    dists = torch.where(lens[:, None, :] > 0, dists, torch.zeros_like(dists))
    errs = dists.sum(dim=2).to(torch.int32).to(torch.float32) / seg_total[:, None]
    inf = float("inf")
    errs = torch.where(ok, errs, inf)
    # argmin, the lowest index among equal errors (an all-inf row gives 0)
    ar_c = torch.arange(C, device=dev)
    ci = torch.where(errs == errs.amin(dim=1, keepdim=True), ar_c,
                     torch.full_like(ar_c, C)).amin(dim=1)
    rows = torch.arange(B, device=dev)
    best_err = errs[rows, ci]
    best_cons = cand[rows, ci]
    best_len = torch.where(ok[rows, ci], clen[rows, ci], torch.zeros_like(ci, dtype=clen.dtype))
    any_path = ok.any(dim=1)
    # a Python scalar compares with an f32 tensor as an f32 operand
    solved = any_path & (best_err <= p.max_err) & (nsegs >= p.min_depth)
    return dict(cons=torch.where(solved[:, None], best_cons,
                                 torch.full_like(best_cons, PAD)).to(torch.int8),
                cons_len=torch.where(solved, best_len, torch.zeros_like(best_len)),
                err=torch.where(any_path, best_err, inf),
                solved=solved)


def rescore_pick(seqs: torch.Tensor, lens: torch.Tensor, nsegs: torch.Tensor,
                 cand: torch.Tensor, clen: torch.Tensor, ok: torch.Tensor,
                 p) -> dict:
    """:func:`rescore_pick_plain`'s contract: cons [B, CL] int8, cons_len
    [B] i32, err [B] f32, solved [B] bool.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream, without synchronising, or raise."""
    global launches
    B, C, CL = cand.shape
    D, L = seqs.shape[1], seqs.shape[2]
    if tuple(lens.shape) != (B, D) or tuple(nsegs.shape) != (B,) \
            or tuple(clen.shape) != (B, C) or tuple(ok.shape) != (B, C) \
            or seqs.shape[0] != B:
        raise ValueError(f"rescore: shapes seqs {tuple(seqs.shape)} lens "
                         f"{tuple(lens.shape)} nsegs {tuple(nsegs.shape)} cand "
                         f"{tuple(cand.shape)} clen {tuple(clen.shape)} ok "
                         f"{tuple(ok.shape)} disagree")
    dev = cand.device
    for name, t in (("seqs", seqs), ("lens", lens), ("nsegs", nsegs),
                    ("clen", clen), ("ok", ok)):
        if t.device != dev:
            raise ValueError(f"rescore: {name} on {t.device}, cand on {dev}")
    if dev.type == "cpu":
        return rescore_pick_plain(seqs, lens, nsegs, cand, clen, ok, p)
    if dev.type != "cuda":
        raise ValueError(f"rescore: no kernel for device {dev}")
    for name, t, dt in (("seqs", seqs, torch.int8), ("lens", lens, torch.int32),
                        ("nsegs", nsegs, torch.int32), ("cand", cand, torch.int8),
                        ("clen", clen, torch.int32), ("ok", ok, torch.bool)):
        if t.dtype != dt:
            raise TypeError(f"rescore: {name} is {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"rescore: {name} must be contiguous")
    check_shape(D, L, C, CL)
    lib = _load()
    cons = torch.empty((B, CL), dtype=torch.int8, device=dev)
    cons_len = torch.empty((B,), dtype=torch.int32, device=dev)
    err = torch.empty((B,), dtype=torch.float32, device=dev)
    solved = torch.empty((B,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rescore_launch(
        seqs.data_ptr(), lens.data_ptr(), nsegs.data_ptr(), cand.data_ptr(),
        clen.data_ptr(), ok.data_ptr(), cons.data_ptr(), cons_len.data_ptr(),
        err.data_ptr(), solved.data_ptr(), B, D, L, C, CL, int(p.min_depth),
        ctypes.c_float(p.max_err), stream)
    if rc != 0:
        msg = lib.rescore_error_string(rc).decode()
        raise _nvcc.KernelError(f"rescore launch failed (B={B}, D={D}, L={L}, C={C}, "
                           f"CL={CL}): {msg} ({rc})")
    with _count_lock:
        launches += 1
        launches_by_shape[(C, CL)] = launches_by_shape.get((C, CL), 0) + 1
        windows_by_shape[(C, CL)] = windows_by_shape.get((C, CL), 0) + B
    return dict(cons=cons, cons_len=cons_len, err=err, solved=solved)
