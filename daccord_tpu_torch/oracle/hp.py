"""Homopolymer-robust consensus rescue (a run-length-compressed DBG tier).

The port's copy of ``daccord_tpu.oracle.hp``, byte for byte in what it
computes. Indels whose rate grows with the homopolymer run length push
in-run error far past the rest of a read; a run of k or more bases repeats
itself in k-mer space, so the graph cannot count its length and the
heaviest path picks an arbitrary one. In run-length-compressed space that
indel process is invisible: changing a run's length does not change the
compressed sequence. So:

  1. run-length-compress every segment (keeping each position's run length);
  2. solve the ordinary DBG consensus in compressed space, where only
     substitutions and inter-run indels remain;
  3. re-expand the compressed consensus: each position's run length is a
     vote over the run lengths of the segment positions aligned to it with
     the same base (the median, or the profile-calibrated length posterior);
  4. accept the expansion only if its rescored error against the ORIGINAL
     segments beats the direct result (or clears ``max_err`` where the
     direct solve failed), or, with the likelihood acceptance, if it
     explains the segments better under the observation model.

The pipeline runs this pass on the host after any engine returns its
per-window ``err`` (``hp_candidate`` a window, or the host library's
``hp_rescue_windows`` a batch, which gives the same bytes); only windows
that failed or solved badly AND hold a long run are routed.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from .align import align_path, edit_distance_sum
from .dbg import DBGParams, WindowResult, window_consensus

HP_TIER = 29  # tier code of hp-rescued windows (ConsensusConfig rejects
              # ladders deep enough to collide with it)


def hp_compress(seg: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Run-length encode: returns (compressed int8 bases, int32 run lengths)."""
    seg = np.asarray(seg, dtype=np.int8)
    n = len(seg)
    if n == 0:
        return seg, np.zeros(0, dtype=np.int32)
    starts = np.concatenate(([0], np.flatnonzero(seg[1:] != seg[:-1]) + 1))
    runs = np.diff(np.concatenate((starts, [n]))).astype(np.int32)
    return seg[starts], runs


def hp_expand(cseq: np.ndarray, runs: np.ndarray) -> np.ndarray:
    return np.repeat(cseq, np.maximum(runs, 1)).astype(np.int8)


def max_run(seg: np.ndarray) -> int:
    """Length of the longest homopolymer run (0 for empty input)."""
    if len(seg) == 0:
        return 0
    return int(hp_compress(seg)[1].max())


_LTAB_CACHE: dict = {}

# heat-multiplier grid for the posterior vote: per-window intensity
# multipliers quantized to [LO, HI] in STEP increments. The one definition:
# the python vote, the native table build (native/api.py) and the C++ index
# map (dazz_native.cpp, passed these values) must agree, or votes would
# silently read the wrong table.
HP_HEAT_LO = 1.0
HP_HEAT_HI = 3.0
HP_HEAT_STEP = 0.25
HP_HEAT_N = int(round((HP_HEAT_HI - HP_HEAT_LO) / HP_HEAT_STEP)) + 1


def hp_heat(direct_err: float, p_err: float) -> float:
    """Quantized per-window heat multiplier (shared by python + native)."""
    m = (direct_err / max(p_err, 1e-3)) if np.isfinite(direct_err) else 1.5
    return float(np.clip(round(m / HP_HEAT_STEP) * HP_HEAT_STEP,
                         HP_HEAT_LO, HP_HEAT_HI))


def hp_length_tables(profile, Lmax: int = 20, Omax: int = 56,
                     mult: float = 1.0) -> np.ndarray:
    """``T[L, o] = log P(observed same-base length o | true run length L)``.

    Observation model (matches the fit in profile_vs_consensus): each of the
    L true bases survives with prob (1-qd)(1-psub) and is followed by
    Geom(qi) same-base insertions, with the indel intensity length-scaled:
    q(L) = hp_base * (1 + hp_slope * min(L-1, hp_cap)), split del:ins by the
    global ratio, clipped at 0.45. P(o|L) is the L-fold convolution of the
    per-base contribution. Rows L=1..Lmax; row 0 is unused (-inf).
    An unfit profile (hp_base == 0) falls back to the global rates with
    slope 0 — a flat-rate posterior, still split-robust vs the median.
    """
    key = (round(profile.p_del, 5), round(profile.p_ins, 5),
           round(profile.p_sub, 5), round(profile.hp_slope, 3),
           round(profile.hp_base, 4), profile.hp_cap, Lmax, Omax,
           round(mult, 2))
    hit = _LTAB_CACHE.get(key)
    if hit is not None:
        return hit
    tot = profile.p_del + profile.p_ins
    fd = profile.p_del / tot if tot > 0 else 0.33
    base, slope = profile.hp_base, profile.hp_slope
    if base <= 0.0:
        base, slope = max(tot, 1e-4), 0.0
    # per-window intensity multiplier: the profile's hp fit comes from
    # tier-0-SOLVED sample windows (biased clean on damaged regimes), so a
    # routed window's own direct error rate, relative to the profile, says
    # how much hotter its indel process runs than the fit assumed
    base = base * mult
    T = np.full((Lmax + 1, Omax + 1), -np.inf)
    for L in range(1, Lmax + 1):
        x = min(L - 1, profile.hp_cap)
        qd = min(base * fd * (1.0 + slope * x), 0.45)
        qi = min(base * (1.0 - fd) * (1.0 + slope * x), 0.45)
        q0 = 1.0 - (1.0 - qd) * (1.0 - profile.p_sub)   # contributes no
        # same-base symbol (deleted or substituted); insertions still follow
        gi = (1.0 - qi) * np.power(qi, np.arange(Omax + 1))
        contrib = q0 * gi
        contrib[1:] += (1.0 - q0) * gi[:-1]
        dist = contrib
        for _ in range(L - 1):
            dist = np.convolve(dist, contrib)[: Omax + 1]
        # renormalize the truncation tail so long-L rows stay comparable
        s = dist.sum()
        if s > 0:
            dist = dist / s
        with np.errstate(divide="ignore"):
            T[L] = np.log(dist)
    _LTAB_CACHE[key] = T
    if len(_LTAB_CACHE) > 64:
        _LTAB_CACHE.pop(next(iter(_LTAB_CACHE)))
    return T


def vote_runs_posterior(cons_c: np.ndarray,
                        comp: list[tuple[np.ndarray, np.ndarray]],
                        ltab: np.ndarray) -> np.ndarray:
    """Calibrated per-position run lengths: length-posterior argmax.

    Per segment the observation is the SUM of same-base run lengths over the
    aligned span (split pieces from in-run substitutions are merged — the
    bias the flat median inherits), with one-position greedy extension when
    the optimal path attributed a boundary piece to the neighbor. The vote
    is argmax_L sum_s log P(o_s | L) under the profile-calibrated
    observation model (hp_length_tables); ties break to the smaller L.
    Positions with no evidence keep run length 1.
    """
    n = len(cons_c)
    Lmax = ltab.shape[0] - 1
    Omax = ltab.shape[1] - 1
    ll = np.zeros((n, Lmax + 1))
    nvotes = np.zeros(n, dtype=np.int64)
    for cseg, runs in comp:
        if len(cseg) == 0:
            continue
        m = len(cseg)
        _, a2b = align_path(cons_c, cseg)
        claimed = [0, 0, 0, 0]   # per base: end of the last counted span
        for i in range(n):
            c = cons_c[i]
            lo = max(int(a2b[i]), claimed[c])
            hi = max(int(a2b[i + 1]), lo)
            # greedy one-position extension: a boundary same-base piece the
            # path gave to the neighbor belongs to this run (cons_c runs
            # are maximal, so the immediate neighbor never claims base c).
            # The per-base `claimed` cursor keeps same-base counted spans
            # disjoint — a merged piece (deleted spacer between two
            # same-base runs) is counted by exactly one position.
            if hi < m and cseg[hi] == c:
                hi += 1
            if lo > claimed[c] and cseg[lo - 1] == c:
                lo -= 1
            if hi <= lo:
                continue
            claimed[c] = hi
            o = 0
            for j in range(lo, hi):
                if cseg[j] == c:
                    o += int(runs[j])
            ll[i] += ltab[:, min(o, Omax)]
            nvotes[i] += 1
    out = np.ones(n, dtype=np.int32)
    voted = nvotes > 0
    if voted.any():
        out[voted] = np.argmax(ll[voted, 1:], axis=1).astype(np.int32) + 1
    return out


def hp_loglik(cand: np.ndarray,
              comp: list[tuple[np.ndarray, np.ndarray]],
              ltab: np.ndarray, lam_c: float) -> float:
    """Log-likelihood of the segment data under a candidate sequence.

    The calibrated ACCEPTANCE objective (cfg.hp_accept="likelihood"): the
    candidate is run-length-compressed; each segment contributes its
    run-length observations' log P(o_s | L_i) (the same claim-cursor walk
    as the posterior vote) plus a compressed-space edit penalty
    ``-lam_c * d_c`` (substitutions/inter-run indels are NOT part of the
    length model; lam_c ~ -log(compressed-space per-base error rate)).
    Comparing J across candidates compares how well each explains the SAME
    data — unlike the raw unit-cost rescore, a true-length candidate is not
    charged for fixing the data's own drift.
    """
    cc, cruns = hp_compress(cand)
    n = len(cc)
    if n == 0:
        return -np.inf
    Lmax = ltab.shape[0] - 1
    Omax = ltab.shape[1] - 1
    L_idx = np.clip(cruns, 1, Lmax)
    J = 0.0
    for cseg, runs in comp:
        if len(cseg) == 0:
            continue
        m = len(cseg)
        d_c, a2b = align_path(cc, cseg)
        J -= lam_c * float(d_c)
        claimed = [0, 0, 0, 0]
        for i in range(n):
            c = cc[i]
            lo = max(int(a2b[i]), claimed[c])
            hi = max(int(a2b[i + 1]), lo)
            if hi < m and cseg[hi] == c:
                hi += 1
            if lo > claimed[c] and cseg[lo - 1] == c:
                lo -= 1
            if hi <= lo:
                continue
            claimed[c] = hi
            o = 0
            for j in range(lo, hi):
                if cseg[j] == c:
                    o += int(runs[j])
            v = ltab[int(L_idx[i]), min(o, Omax)]
            if np.isfinite(v):
                J += float(v)
            else:
                J -= 60.0   # impossible-under-model observation: a finite
                #             but crushing penalty (log ~ e-26) so one
                #             outlier cannot veto via -inf
    return J


def vote_runs(cons_c: np.ndarray,
              comp: list[tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
    """Per-position run lengths for the compressed consensus by aligned vote.

    For each compressed segment, the edit-distance traceback maps every
    consensus position to a span of segment positions; run lengths of
    same-base matches are collected and the (rounded) median wins — depth
    ~20 independent noisy run-length observations beat any single read's
    hp-inflated indels. Positions with no evidence keep run length 1.
    """
    n = len(cons_c)
    votes: list[list[int]] = [[] for _ in range(n)]
    for cseg, runs in comp:
        if len(cseg) == 0:
            continue
        _, a2b = align_path(cons_c, cseg)
        for i in range(n):
            lo, hi = int(a2b[i]), int(a2b[i + 1])
            for j in range(lo, hi):
                if cseg[j] == cons_c[i]:
                    votes[i].append(int(runs[j]))
    out = np.ones(n, dtype=np.int32)
    for i, v in enumerate(votes):
        if v:
            out[i] = max(1, int(round(float(np.median(v)))))
    return out


def solve_window_hp(segments: list[np.ndarray], ol, dbg: DBGParams,
                    wlen: int, vote: str = "median",
                    direct_err: float = float("inf")) -> WindowResult | None:
    """Solve one window in run-length-compressed space and re-expand.

    ``ol`` is the tier's OffsetLikely table (compressed-space offsets are a
    subset of its domain — the compressed window is strictly shorter, so the
    table's P/O cover it; the analytic shape is approximate there, which the
    rescoring acceptance rule absorbs). Returns None when the compressed
    subproblem is degenerate or unsolved; the caller keeps the direct result.
    """
    comp = [hp_compress(s) for s in segments]
    clens = [len(c) for c, _ in comp]
    if not clens:
        return None
    wlen_c = int(np.median(clens))
    if wlen_c < dbg.k + 4:
        return None
    res = window_consensus([c for c, _ in comp], ol, dbg, wlen=wlen_c)
    if res.seq is None:
        return None
    prof = ol.profile
    if vote == "posterior" and prof.hp_slope >= 0.1:
        # the calibrated posterior only engages when the PROFILE shows
        # length-dependent indel structure (fitted slope >= 0.1): on clean
        # data the fit is ~0 and the asymmetric observation model (plus the
        # heat multiplier below) over-corrects runs the median gets right
        # (the JAX package measured -0.42 Q on its clean control without
        # this gate)
        # quantized per-window heat (hp_heat): direct_err / profile rate;
        # unsolved windows (no direct err) get a middling boost — they are
        # at least as damaged as the routing threshold implies
        m = hp_heat(direct_err, prof.p_ins + prof.p_del + prof.p_sub)
        runs = vote_runs_posterior(res.seq, comp,
                                   hp_length_tables(prof, mult=m))
    else:
        runs = vote_runs(res.seq, comp)
    seq = hp_expand(res.seq, runs)
    # pathological expansions (a mis-voted giant run) never beat the direct
    # result anyway; bound them before paying the rescore
    if not (wlen // 2 <= len(seq) <= 2 * wlen):
        return None
    tot = sum(len(s) for s in segments)
    err = edit_distance_sum(seq, segments) / max(tot, 1)
    return WindowResult(seq, err=float(err), k=dbg.k, reason="hp")


def hp_candidate(segments: list[np.ndarray], direct_seq, direct_err: float,
                 ol_tables: dict, cfg) -> WindowResult | None:
    """Route + solve + accept gate for one window; None = keep direct result.

    ``cfg`` is a ConsensusConfig. Routing: the window failed or solved with
    err > ``hp_err``, and a run >= ``hp_min_run`` is present (in the direct
    consensus if solved, else in any segment) — without a long run there is
    nothing an hp vote could fix. Acceptance: the expanded candidate must
    beat the direct err by ``hp_margin`` (or clear max_err where the direct
    solver failed).
    """
    solved = direct_seq is not None
    if solved and direct_err <= cfg.hp_err:
        return None
    probe = [direct_seq] if solved else segments
    if max(max_run(s) for s in probe) < cfg.hp_min_run:
        return None
    k, mc, emc = cfg.tiers[0]
    dbg = replace(cfg.dbg, k=k, min_count=mc, edge_min_count=emc)
    res = solve_window_hp(segments, ol_tables[k], dbg, cfg.w,
                          vote=cfg.hp_vote, direct_err=direct_err)
    if res is None:
        return None
    prof = ol_tables[k].profile
    if (cfg.hp_accept == "likelihood" and solved
            and cfg.hp_vote == "posterior" and prof.hp_slope >= 0.1):
        # likelihood-ratio acceptance (hp_loglik): accept the candidate
        # that better EXPLAINS the segments under the calibrated model,
        # instead of the raw unit-cost rescore (which charges a true-length
        # candidate for fixing the data's own drift). Same slope gate as
        # the vote;
        # failed-direct windows keep the raw max_err bar below. A loose
        # raw-error sanity bound keeps pathological likelihood wins out.
        ltab = hp_length_tables(
            prof, mult=hp_heat(direct_err,
                               prof.p_ins + prof.p_del + prof.p_sub))
        comp = [hp_compress(s) for s in segments]
        lam_c = cfg.hp_lambda_c
        if (hp_loglik(res.seq, comp, ltab, lam_c)
                > hp_loglik(direct_seq, comp, ltab, lam_c)
                and res.err <= direct_err + 0.10):
            return res
        return None
    bar = (direct_err - cfg.hp_margin) if solved else cfg.dbg.max_err
    if res.err >= bar:
        return None
    return res
