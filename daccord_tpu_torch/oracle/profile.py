"""Error-profile estimation and OffsetLikely position-weight tables.

The port's copy of ``daccord_tpu.oracle.profile``: the error-profile
estimation pass and the ``OffsetLikely`` tables (algorithmic role per the
daccord paper, Tischler & Myers bioRxiv 106252). ``ErrorProfile.save``/``load``
read and write the same JSON as the JAX package, so a profile made by either
package drives the other.

``OffsetLikely`` answers: for a consensus position ``p`` inside a window, what
is the probability that the segment base realizing it sits at segment offset
``o``? Indels shift offsets; the distribution of the offset of consensus
position ``p`` is the p-fold convolution of the per-base length-increment
distribution

    P(0)      = p_del                      (base missing from the segment)
    P(1 + i)  = (1 - p_del) (1-p_ins) p_ins^i   (base + i following insertions)

The table ``OL[p, o]`` is consumed as a matmul against per-k-mer offset
occurrence counts to produce per-k-mer position weights (BASELINE.json:
"OffsetLikely position-weight scoring runs as a batched matmul").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .windows import RefinedOverlap


@dataclass
class ErrorProfile:
    p_ins: float
    p_del: float
    p_sub: float
    # homopolymer observation model, fit from the same consensus-vs-segment
    # alignments as the base rates (profile_vs_consensus): the per-base
    # indel intensity inside a run of true length L is
    #     q(L) = hp_base * (1 + hp_slope * min(L-1, hp_cap)),
    # split del:ins by the global p_del:p_ins ratio. hp_base is the L=1
    # anchor — it must be fit jointly with the slope because the GLOBAL
    # p_ins/p_del average over all positions and already absorb run
    # inflation on hp-damaged data. hp_base == 0 means "not fit" (thin
    # data); consumers fall back to the global rates with slope 0. Clean
    # data fits hp_slope ~ 0. Consumed by the hp rescue's calibrated
    # run-length vote (oracle/hp.py).
    hp_slope: float = 0.0
    hp_base: float = 0.0
    hp_cap: int = 8

    def save(self, path: str) -> None:
        """Write the profile as JSON (the reference caches its error profile
        in a sidecar file so repeat runs skip the estimation pass).

        Atomic (write + rename): concurrent runs racing on the same path
        each leave a complete file, never a torn one."""
        import json
        import os

        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wt") as fh:
            json.dump({"format": "daccord-tpu-eprof-v1", "p_ins": self.p_ins,
                       "p_del": self.p_del, "p_sub": self.p_sub,
                       "hp_slope": self.hp_slope, "hp_base": self.hp_base,
                       "hp_cap": self.hp_cap}, fh)
            fh.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ErrorProfile":
        """Read an eprof file. v2 files (the retired empirical-OL format,
        which also carried offset counts) still load — the counts are
        ignored; see the retirement note on :class:`OffsetLikely`."""
        import json

        with open(path, "rt") as fh:
            d = json.load(fh)
        if d.get("format") not in ("daccord-tpu-eprof-v1", "daccord-tpu-eprof-v2"):
            raise ValueError(f"{path}: not a daccord-tpu error-profile file")
        return cls(p_ins=float(d["p_ins"]), p_del=float(d["p_del"]),
                   p_sub=float(d["p_sub"]),
                   # pre-r5 files carry no hp fields -> slope 0 (no length
                   # dependence), matching their era's behavior exactly
                   hp_slope=float(d.get("hp_slope", 0.0)),
                   hp_base=float(d.get("hp_base", 0.0)),
                   hp_cap=int(d.get("hp_cap", 8)))


def rough_profile(refined: list[RefinedOverlap]) -> ErrorProfile:
    """First-pass profile from trace diffs alone.

    Pair alignments cannot identify per-read insertion/deletion rates (A and B
    drifts cancel), so the total error rate comes from per-tile diff counts
    (halved: a pair alignment sees both reads' errors) and is split by typical
    long-read proportions. Refined by :func:`profile_vs_consensus` in pass two.
    """
    n_diffs = sum(r.diffs for r in refined)
    n_bases = sum(len(r.a2b) - 1 for r in refined)
    e = 0.5 * n_diffs / max(n_bases, 1)
    e = min(max(e, 0.01), 0.35)
    return ErrorProfile(p_ins=0.55 * e, p_del=0.30 * e, p_sub=0.15 * e)


def profile_vs_consensus(
        pairs: list[tuple[np.ndarray, np.ndarray]]) -> ErrorProfile:
    """Second-pass profile: ops of (segment vs consensus) alignments.

    Each pair is (consensus, segment); the consensus stands in for the truth,
    so op counts give the *single-read* error process directly: a consensus
    base consuming 0 segment bases is a deletion, 2+ an insertion run, and a
    mismatching 1-step a substitution.
    """
    from .align import align_path  # local import to avoid cycle at module load

    HP_CAP = 8   # runlen-1 cap on the slope model (matches the clip regime
    #              where per-base rates saturate; rates above it are pooled)
    n_del = n_ins = n_sub = n_pos = 0
    # run-level hp observations for the slope fit: for each INTERIOR
    # consensus run (length L, base b), the observed same-base length o in
    # the aligned segment span. Per-position indel attribution is unusable
    # here — an optimal path may blame a run's indels on any same-base
    # position or a boundary neighbor — but the run-total o is attribution-
    # free. Edge runs are skipped (truncated by the window cut).
    hp_n = np.zeros(HP_CAP + 1, dtype=np.int64)        # runs per bucket
    hp_ratio = np.zeros(HP_CAP + 1, dtype=np.float64)  # sum of o / L
    hp_sq = np.zeros(HP_CAP + 1, dtype=np.float64)     # sum of (o / L)^2
    hp_L = np.zeros(HP_CAP + 1, dtype=np.float64)      # sum of L (top
    #                                                    bucket pools L>cap)
    for cons, seg in pairs:
        if len(cons) == 0:
            continue
        _, c2s = align_path(cons, seg)
        steps = np.diff(c2s)
        n_del += int(np.sum(steps == 0))
        n_ins += int(np.sum(np.maximum(steps - 1, 0)))
        one = steps == 1
        if np.any(one):
            idx = np.nonzero(one)[0]
            n_sub += int(np.sum(cons[idx] != seg[c2s[idx]]))
        n_pos += len(steps)
        starts = np.concatenate(([0], np.flatnonzero(cons[1:] != cons[:-1]) + 1))
        rl = np.diff(np.concatenate((starts, [len(cons)])))
        ns = len(seg)
        claimed = [0, 0, 0, 0]   # per base: end of the last counted span
        for ri in range(1, len(starts) - 1):   # interior runs only
            s0, L = int(starts[ri]), int(rl[ri])
            b = cons[s0]
            lo = max(int(c2s[s0]), claimed[b])
            hi = max(int(c2s[s0 + L]), lo)
            # greedy same-base span extension: an optimal path may attribute
            # a run-adjacent same-base insertion block to the NEIGHBORING
            # consensus position (identical cost), which would silently drop
            # it from o — absorb contiguous same-base bases on both sides.
            # The per-base `claimed` cursor keeps same-base counted spans
            # disjoint, so a merged piece (deleted spacer between two
            # same-base runs) is counted once, never double-claimed; claims
            # on OTHER bases never block (a different-base neighbor's span
            # routinely covers this run's boundary insertions).
            while hi < ns and seg[hi] == b:
                hi += 1
            while lo > claimed[b] and seg[lo - 1] == b:
                lo -= 1
            claimed[b] = hi
            o = int(np.sum(seg[lo:hi] == b))
            x = min(L - 1, HP_CAP)
            hp_n[x] += 1
            hp_ratio[x] += o / L
            hp_sq[x] += (o / L) ** 2
            hp_L[x] += L
    if n_pos == 0:
        return ErrorProfile(0.08, 0.04, 0.015)
    i_o, d_o, s_o = n_ins / n_pos, n_del / n_pos, n_sub / n_pos

    # De-collapse correction: a unit-cost optimal path represents a deletion
    # with an insertion within ~W positions as one substitution (cost 1 beats
    # del+ins at 2), systematically deflating both indel rates and inflating
    # the sub rate. Invert that mapping to first order: the collapsed mass x
    # satisfies x = d * P(insertion within the +-W collapse window), with
    # d = d_o + x and i = i_o + x the true rates. W=2 from alignment geometry
    # (beyond ~2 positions the intervening bases must match by chance, so
    # collapses die off). Verified on simulated reads with known rates:
    # uncorrected (6.7, 2.8, 3.4)% vs true (8, 4, 1.5)% -> corrected
    # (~8.0, ~4.1, ~2.1)%.
    W = 2
    x = 0.0
    for _ in range(12):
        p_near = 1.0 - (1.0 - min(i_o + x, 0.5)) ** (2 * W + 1)
        x = min((d_o + x) * p_near, s_o)
    p_ins, p_del = i_o + x, d_o + x
    p_sub = max(s_o - x, 0.0)

    # hp observation-model fit: 2-D grid over (q1, s) matching the measured
    # per-bucket mean AND standard deviation of o/L against the vote's
    # generative model (the JAX package's oracle/hp.py hp_length_tables): per-base indel
    # intensity q(x) = q1*(1+s*x), split del:ins by the global ratio, each
    # clipped at 0.45. Per-base same-base contribution is
    # Bern((1-qd)(1-psub)) + Geom(qi), so
    #   E[o/L]  = (1-qd)(1-psub) + qi/(1-qi)
    #   Var[o/L] = (p1(1-p1) + qi/(1-qi)^2) / L          (p1 = surviving)
    # The variance term is essential: a near-symmetric indel process moves
    # the mean hardly at all, and intensity then lives in the spread. Both
    # parameters must come from these curves — the global p_ins/p_del
    # average over all positions and already absorb run inflation, so they
    # cannot anchor x=0. Clean data fits s ~ 0; thin buckets (< 30 runs)
    # are dropped.
    hp_slope = 0.0
    hp_base = 0.0
    got = hp_n >= 30
    if got.sum() >= 3:
        xs = np.arange(HP_CAP + 1, dtype=np.float64)[got]
        nb = hp_n[got].astype(np.float64)
        mean_m = hp_ratio[got] / nb
        sd_m = np.sqrt(np.maximum(hp_sq[got] / nb - mean_m ** 2, 0.0))
        Lb = hp_L[got] / nb
        wts = nb
        tot = p_del + p_ins
        fd = p_del / tot if tot > 0 else 0.33
        fi = 1.0 - fd
        best = None
        for q1 in np.arange(0.01, 0.301, 0.01):
            for s in np.arange(0.0, 6.01, 0.1):
                qd = np.minimum(q1 * fd * (1.0 + s * xs), 0.45)
                qi = np.minimum(q1 * fi * (1.0 + s * xs), 0.45)
                p1 = (1.0 - qd) * (1.0 - p_sub)
                mu = p1 + qi / (1.0 - qi)
                var = (p1 * (1.0 - p1) + qi / (1.0 - qi) ** 2) / Lb
                sd = np.sqrt(var)
                sse = float(np.sum(wts * ((mean_m - mu) ** 2
                                          + (sd_m - sd) ** 2)))
                if best is None or sse < best[0]:
                    best = (sse, float(q1), float(s))
        _, hp_base, hp_slope = best
    return ErrorProfile(p_ins=p_ins, p_del=p_del, p_sub=p_sub,
                        hp_slope=hp_slope, hp_base=hp_base, hp_cap=HP_CAP)


class OffsetLikely:
    """OL[p, o] tables for p in [0, P) and o in [0, O), analytic convolution.

    RETIRED (r4): the empirical-OL blend — mixing measured offset counts
    from the estimation pass into these tables as a pseudo-count prior —
    was measured slightly NEGATIVE in 7/8 mismatch regimes at the
    production sample (r3) and still <= the analytic tables at 4/48/256
    piles (r4 eolprobe: −0.08/−0.32/−0.22 Q vs off). The sampling noise
    hypothesis did not hold at large samples, so the blend and its
    plumbing (offset-count collection, eprof-v2 counts, per-config
    offset_counts threading) were deleted per VERDICT r3 item 9; this
    docstring and BASELINE.md r3/r4 are the record.
    """

    def __init__(self, profile: ErrorProfile, positions: int, max_offset: int,
                 ins_tail: int = 6):
        self.profile = profile
        self.P = positions
        self.O = max_offset
        # per-base length increment distribution, truncated at 1 + ins_tail
        p_del, p_ins = profile.p_del, profile.p_ins
        inc = np.zeros(2 + ins_tail)
        inc[0] = p_del
        rem = 1.0 - p_del
        for i in range(ins_tail + 1):
            inc[1 + i] = rem * (1 - p_ins) * (p_ins ** i)
        inc /= inc.sum()
        self.inc = inc

        ol = np.zeros((positions, max_offset), dtype=np.float64)
        cur = np.zeros(max_offset)
        cur[0] = 1.0  # position 0 sits at offset 0 by construction of the cut
        ol[0] = cur
        for p in range(1, positions):
            cur = np.convolve(cur, inc)[:max_offset]
            s = cur.sum()
            if s > 0:
                cur = cur / s
            ol[p] = cur
        self.table = ol.astype(np.float32)

    def weights(self, occ: np.ndarray) -> np.ndarray:
        """occ: [n_kmers, O] offset occurrence counts -> [n_kmers, P] weights."""
        return occ.astype(np.float32) @ self.table.T
