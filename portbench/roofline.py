"""The least time a kernel launch could take on one H100, from its shapes.

Each input byte read once and each output byte written once, at the HBM
rate, against the operations the inputs need, at the float32 rate outside
the tensor cores; the larger of the two bounds the launch. The peaks are
NVIDIA's data sheet for the H100 SXM part at its 700 W limit; a card set
below it reads lower shares (the run prints its ``power.limit``). Frozen
copies of ``chip_smoke.py``'s counts (PERF.md's kernel table gives their
bound column), with the shapes as arguments: B windows, D segments of L
bases, top-M k-mers, P positions, C candidates of CL bases, O offsets.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12        # H100 SXM HBM3
F32_FLOP_S = 67e12           # H100 SXM float32, outside the tensor cores


def least_s(n_bytes: float, ops: float) -> float:
    return max(n_bytes / HBM_BYTES_S, ops / F32_FLOP_S)


def t_range(k: int, wlen: int, len_slack: int) -> tuple[int, int]:
    """The DP's admissible end steps (``KernelParams.t_range``)."""
    P = wlen - k + 1 + len_slack
    return max(0, wlen - k - len_slack), min(P - 1, wlen - k + len_slack)


def dp_backtrack(B: int, M: int, P: int, C: int, CL: int, T: int) -> tuple[int, int]:
    """(bytes, ops) of one fused DP + backtrack launch: adjW [B,M,M] f32,
    wt [B,P,M] f32, s0 [B,M] f32, snk_ok [B,M] bool and sel [B,M] i32 read;
    cand [B,C,CL] i32, clen [B,C] i32 and ok [B,C] bool written; the DP's
    (P-1) M^2 add and compare pairs and the C scans of T end steps."""
    n_bytes = B * (4 * M * M + 4 * P * M + 4 * M + M + 4 * M + 4 * C * CL + 4 * C + C)
    return n_bytes, B * (2 * (P - 1) * M * M + C * T * M)


def position_weights(B: int, D: int, L: int, k: int, M: int, P: int, O: int) -> tuple[int, int]:
    """(bytes, ops) of one W launch: the kept k-mer index of each position
    read once at 2 bytes (what an index below M <= 1024 needs), the OL table
    [P, O] f32 read once, W [B, M, P] f32 written once. Its operations (two
    a nonzero count and column, at most 2 D (L-k+1) P a window) never bound
    it at the ladder's shapes, so they are not counted."""
    npos = L - k + 1
    return 2 * B * D * npos + 4 * P * O + 4 * B * M * P, 0


def rescore_bytes(B: int, D: int, L: int, C: int, CL: int) -> int:
    """Bytes of one rescore launch: the tiles [B,D,L] i8, lens [B,D] i32,
    nsegs [B] i32, candidates [B,C,CL] i8, their lengths i32 and flags read;
    cons [B,CL] i8, cons_len i32, err f32 and solved written."""
    return B * (D * L + 4 * D + 4 + C * CL + 4 * C + C + CL + 4 + 4 + 1)


def rescore_ops(C: int, CL: int, seg_bases: int) -> int:
    """Operations of the Myers rescore: about 17 word operations a
    (candidate, segment base, 64-bit word of the candidate)."""
    return C * seg_bases * 17 * (-(-CL // 64))


def share(launches: list | None, kernel: str, M: int | None = None) -> float | None:
    """A kernel's share of its roofline over the traced launches
    (``trace.launches``), in percent: their least seconds over the seconds
    the profiler timed them. None when the slice ran none."""
    ls = [x for x in launches or () if x["kernel"] == kernel and (M is None or x["M"] == M)]
    dur = sum(x["dur_s"] for x in ls)
    if dur <= 0:
        return None
    return 100.0 * sum(x["least_s"] for x in ls) / dur
