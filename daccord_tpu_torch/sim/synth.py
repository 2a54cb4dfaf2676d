"""Synthetic long-read dataset generator: genome -> noisy reads -> true LAS.

The port's copy of ``daccord_tpu.sim.synth`` (same seeds, same datasets): it
fabricates a genome, samples strand-aware noisy reads with PacBio-like error
profiles, and emits

  - a Dazzler DB of the reads,
  - a .las of all true pairwise overlaps (both (A,B) and (B,A) records, sorted
    by aread, with exact per-tile trace points derived from the generative
    alignment — no aligner needed),
  - per-read truth (genome interval, strand, clean sequence) for Q-score
    evaluation.

Coordinate conventions follow DALIGNER: the A read is used as stored; when the
B read's orientation differs, the overlap carries OVL_COMP and bbpos/bepos are
coordinates in the *complemented* B read.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass

import numpy as np

from ..formats.dazzdb import DazzDB, write_db
from ..formats.fasta import read_fasta
from ..formats.las import Overlap, write_las, OVL_COMP
from ..utils.bases import revcomp_ints


@dataclass
class SimConfig:
    genome_len: int = 20_000
    coverage: float = 25.0
    read_len_mean: float = 2_000.0
    read_len_sigma: float = 0.3       # lognormal sigma on length
    p_ins: float = 0.08
    p_del: float = 0.04
    p_sub: float = 0.015
    min_overlap: int = 500
    tspace: int = 100
    repeat_fraction: float = 0.0      # fraction of genome covered by a planted repeat
    repeat_divergence: float = 0.0    # substitution rate between the two repeat
                                      # copies (0 = exact copies). Diverged
                                      # copies are what make repeat-induced
                                      # piles damaging: cross-copy B segments
                                      # pull window consensus toward the OTHER
                                      # copy, the failure mode the paper's
                                      # local-consistency filtering targets
    seed: int = 0
    # --- model-mismatch stress knobs (all default OFF; BASELINE.md round-3
    # mismatch table). The base model above is the iid ins/del/sub family the
    # error-profile estimator and OffsetLikely assume; these knobs generate
    # error processes the estimator does NOT model, as the sealed-environment
    # substitute for real sequencer data. All extra errors flow through the
    # same err/dels bookkeeping, so trace-point diffs stay truthful.
    hp_indel_slope: float = 0.0   # indel prob scaled by 1+slope*(runlen-1) in
                                  # homopolymer runs; insertions duplicate the
                                  # run base instead of being uniform random
    hp_run_cap: int = 8           # runlen-1 capped here (prob clip at 0.45)
    burst_rate: float = 0.0       # expected error bursts per base (e.g. 2e-4)
    burst_len_mean: float = 30.0  # geometric mean burst length (bases)
    burst_mult: float = 6.0       # ins/del/sub multiplier inside a burst
    read_rate_sigma: float = 0.0  # lognormal sigma of a per-read error-rate
                                  # multiplier (mean 1): rate dispersion
    p_chimera: float = 0.0        # per-read prob of a foreign insert replacing
                                  # an interior span (bridged chimera junction)
    chimera_frac: float = 0.2     # replaced span, as a fraction of read length
    dropout_frac: float = 0.0     # genome fraction with thinned coverage
    dropout_factor: float = 4.0   # coverage divisor inside the dropout region

    @classmethod
    def pacbio_clr(cls, **kw) -> "SimConfig":
        """PacBio CLR-like: ~13.5% error, insertion-heavy (the defaults)."""
        return cls(**kw)

    @classmethod
    def ont_r10(cls, **kw) -> "SimConfig":
        """ONT R10-like: much longer reads at a few percent error,
        deletion-leaning; the per-window work is the PacBio preset's, the
        windows a read about 25x as many."""
        kw.setdefault("read_len_mean", 20_000.0)
        kw.setdefault("read_len_sigma", 0.5)
        kw.setdefault("p_ins", 0.008)
        kw.setdefault("p_del", 0.018)
        kw.setdefault("p_sub", 0.01)
        kw.setdefault("coverage", 30.0)
        kw.setdefault("min_overlap", 2_000)
        return cls(**kw)

    @classmethod
    def pacbio_mismatch(cls, **kw) -> "SimConfig":
        """The PacBio CLR shape with every mismatch process on: everything
        the error-profile estimator does not model, at once."""
        kw.setdefault("hp_indel_slope", 0.5)
        kw.setdefault("burst_rate", 2e-4)
        kw.setdefault("read_rate_sigma", 0.4)
        kw.setdefault("p_chimera", 0.03)
        kw.setdefault("dropout_frac", 0.15)
        return cls(**kw)

    @classmethod
    def ont_r10_mismatch(cls, **kw) -> "SimConfig":
        """The ONT R10 shape with homopolymer-dominated indels and rate
        dispersion: the characteristic ONT failure modes."""
        kw.setdefault("hp_indel_slope", 1.0)
        kw.setdefault("read_rate_sigma", 0.5)
        kw.setdefault("burst_rate", 1e-4)
        return cls.ont_r10(**kw)


@dataclass
class SimRead:
    """One sampled read plus its generative alignment to the genome.

    ``g_of_r`` maps stored-read position -> genome position (non-strictly
    monotone; inserted bases repeat the previous base's genome position).
    Direction is increasing for strand 0, decreasing for strand 1.
    ``err`` marks stored-read positions that are insertions or substitutions.
    ``dels`` lists genome positions deleted from this read (sorted ascending).
    """

    start: int
    end: int
    strand: int
    seq: np.ndarray
    g_of_r: np.ndarray
    err: np.ndarray
    dels: np.ndarray
    # lazy per-orientation cache for the overlap-construction hot path (r5):
    # {comp: (gB, err_cum, neg_gB)} — recomputing cumsums/negations per
    # overlap PAIR was the sim's top cost at scale. Values only, never
    # semantics; built on first use by _omaps().
    _oc: dict | None = None

    def omaps(self, comp: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._oc is None:
            self._oc = {}
        hit = self._oc.get(comp)
        if hit is None:
            gB, errB = _oriented_maps(self, comp)
            gB = np.ascontiguousarray(gB)
            hit = (gB, np.concatenate(([0], np.cumsum(errB, dtype=np.int64))),
                   -gB)
            self._oc[comp] = hit
        return hit


@dataclass
class SimResult:
    genome: np.ndarray
    reads: list[SimRead]
    overlaps: list[Overlap]
    config: SimConfig


def _sample_noisy(genome: np.ndarray, start: int, end: int, cfg: SimConfig,
                  rng: np.random.Generator, rmult: float = 1.0
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Apply sub/ins/del noise to genome[start:end] (forward orientation).

    Returns (read_fwd, g_of_r_fwd, err_fwd, dels) where g_of_r is monotone
    non-decreasing over genome positions start..end-1. ``rmult`` is the
    per-read rate multiplier (rate dispersion); the mismatch knobs
    (homopolymer slope, bursts) modulate the per-position probabilities.
    The knobs-off scalar path is kept verbatim so existing seeds reproduce
    their datasets bit-for-bit (cached fixtures, parity tests).
    """
    seg = genome[start:end]
    n = len(seg)
    mismatch = (cfg.hp_indel_slope > 0 or cfg.burst_rate > 0 or rmult != 1.0)
    in_run = None
    if not mismatch:
        u = rng.random(n)
        is_del = u < cfg.p_del
        is_sub = (~is_del) & (u < cfg.p_del + cfg.p_sub)
        n_ins = rng.geometric(1.0 - cfg.p_ins, size=n) - 1  # insertions after each base
    else:
        m = np.full(n, float(rmult))
        if cfg.burst_rate > 0 and n:
            # error bursts: Poisson-placed starts, geometric lengths, all
            # three channels multiplied inside — the polymerase-stall /
            # signal-dropout process the iid estimator does not model
            nb = int(rng.poisson(cfg.burst_rate * n))
            if nb:
                bs = rng.integers(0, n, size=nb)
                bl = rng.geometric(1.0 / max(cfg.burst_len_mean, 1.0), size=nb)
                for s, ln_ in zip(bs, bl):
                    m[s:s + ln_] *= cfg.burst_mult
        hp = np.ones(n)
        if cfg.hp_indel_slope > 0 and n:
            change = np.nonzero(np.diff(seg))[0] + 1
            bounds = np.concatenate([[0], change, [n]])
            rl = np.diff(bounds)
            runlen = np.repeat(rl, rl)
            hp = 1.0 + cfg.hp_indel_slope * np.minimum(runlen - 1,
                                                       cfg.hp_run_cap)
            in_run = runlen > 1
        pd = np.clip(cfg.p_del * m * hp, 0.0, 0.45)
        ps = np.clip(cfg.p_sub * m, 0.0, 0.45)
        pi = np.clip(cfg.p_ins * m * hp, 0.0, 0.45)
        u = rng.random(n)
        is_del = u < pd
        is_sub = (~is_del) & (u < pd + ps)
        n_ins = rng.geometric(1.0 - pi) - 1 if n else np.zeros(0, np.int64)

    # Assembly is vectorized (r5: the per-base python loop was ~40% of sim
    # wall at scale), but the rng draws MUST keep the original per-position
    # call sequence — sub draw, then that position's insertion draw — so
    # every existing seed reproduces its dataset bit-for-bit (cached
    # fixtures, parity tests). The event loop below touches only positions
    # that actually draw (~10% at typical rates); in-run insertions draw
    # nothing (np.full in the original).
    keep = ~is_del
    sub_vals = np.zeros(0, dtype=np.int8)
    ins_vals_parts: list[np.ndarray] = []
    if n:
        draw_sub = is_sub
        draw_ins = n_ins > 0
        if in_run is not None:
            rand_ins = draw_ins & ~in_run
        else:
            rand_ins = draw_ins
        sub_list = []
        ev = np.nonzero(draw_sub | draw_ins)[0]
        for i in ev:
            if draw_sub[i]:
                sub_list.append(rng.integers(1, 4))
            k = int(n_ins[i])
            if k:
                if in_run is not None and in_run[i]:
                    ins_vals_parts.append(np.full(k, seg[i], dtype=np.int8))
                else:
                    ins_vals_parts.append(rng.integers(0, 4, size=k,
                                                       dtype=np.int8))
        sub_vals = np.asarray(sub_list, dtype=np.int8)
        del rand_ins
    counts = keep.astype(np.int64) + n_ins
    total = int(counts.sum()) if n else 0
    read = np.empty(total, dtype=np.int8)
    err = np.empty(total, dtype=np.int8)
    g_of_r = np.repeat(start + np.arange(n, dtype=np.int64), counts)
    if n:
        offs = np.zeros(n, dtype=np.int64)
        np.cumsum(counts[:-1], out=offs[1:])
        base_pos = offs[keep]
        bases = seg.copy()
        if len(sub_vals):
            si = np.nonzero(is_sub)[0]
            bases[si] = (bases[si] + sub_vals) % 4
        read[base_pos] = bases[keep]
        err[base_pos] = is_sub[keep].astype(np.int8)
        # insertion slots: for position i they follow its surviving base
        ins_idx = np.nonzero(n_ins > 0)[0]
        if len(ins_idx):
            k_arr = n_ins[ins_idx]
            starts_i = offs[ins_idx] + keep[ins_idx]
            K = int(k_arr.sum())
            flat = (np.repeat(starts_i, k_arr)
                    + np.arange(K, dtype=np.int64)
                    - np.repeat(np.concatenate(([0], np.cumsum(k_arr[:-1]))),
                                k_arr))
            read[flat] = (np.concatenate(ins_vals_parts)
                          if ins_vals_parts else np.zeros(0, np.int8))
            err[flat] = 1
    dels = (start + np.nonzero(is_del)[0]).astype(np.int64)
    return read, g_of_r, err, dels


def _chimerize(fwd: np.ndarray, g_of_r: np.ndarray, err: np.ndarray,
               dels: np.ndarray, cfg: SimConfig, rng: np.random.Generator
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Replace an interior span of a (forward-orientation) read with foreign
    sequence — a bridged chimera junction. The replaced genome positions
    become deletions and the foreign bases insertion-like errors pinned at
    the junction, so per-tile trace diffs remain truthful: an overlap tile
    crossing the junction really carries that much divergence."""
    n = len(fwd)
    lf = max(50, int(n * cfg.chimera_frac))
    lf = min(lf, n - n // 4 - 2)
    if lf <= 0:
        return fwd, g_of_r, err, dels
    j = int(rng.integers(n // 4, n - lf - 1))
    g_prev = int(g_of_r[j - 1]) if j else int(g_of_r[0])
    g_next = int(g_of_r[j + lf])
    span = np.arange(g_prev + 1, g_next, dtype=np.int64)
    if len(span):
        span = span[~np.isin(span, dels)]
        dels = np.sort(np.concatenate([dels, span]))
    fwd = fwd.copy()
    fwd[j:j + lf] = rng.integers(0, 4, size=lf, dtype=np.int8)
    g_of_r = g_of_r.copy()
    g_of_r[j:j + lf] = g_prev
    err = err.copy()
    err[j:j + lf] = 1
    return fwd, g_of_r, err, dels


def _make_genome(cfg: SimConfig, rng: np.random.Generator) -> tuple[np.ndarray, tuple | None]:
    """Returns (genome, repeat) where repeat = (src, dst, rep_len, div_off)
    or None; ``div_off`` holds the copy-local offsets where the two copies
    differ (empty for an exact repeat)."""
    g = rng.integers(0, 4, size=cfg.genome_len, dtype=np.int8)
    rep = None
    if cfg.repeat_fraction > 0:
        # plant a two-copy repeat: copy one segment to another location,
        # then diverge the second copy by repeat_divergence substitutions
        rep_len = int(cfg.genome_len * cfg.repeat_fraction / 2)
        if rep_len > 100:
            src = int(rng.integers(0, cfg.genome_len // 2 - rep_len))
            dst = int(rng.integers(cfg.genome_len // 2, cfg.genome_len - rep_len))
            g[dst : dst + rep_len] = g[src : src + rep_len]
            ndiv = int(round(rep_len * cfg.repeat_divergence))
            div_off = np.sort(rng.choice(rep_len, size=ndiv, replace=False)) \
                if ndiv else np.zeros(0, np.int64)
            if ndiv:
                g[dst + div_off] = (g[dst + div_off]
                                    + rng.integers(1, 4, ndiv, dtype=np.int8)) % 4
            rep = (src, dst, rep_len, div_off.astype(np.int64))
    return g, rep


def _oriented_maps(r: SimRead, comp: bool) -> tuple[np.ndarray, np.ndarray]:
    """(g_of_r, err) in the requested orientation of the stored read."""
    if not comp:
        return r.g_of_r, r.err
    return r.g_of_r[::-1], r.err[::-1]


def _positions_in(g_of_r: np.ndarray, neg_g: np.ndarray, glo: int, ghi: int,
                  ascending: bool) -> tuple[int, int]:
    """Half-open index range of read positions whose genome pos is in [glo, ghi)."""
    if ascending:
        lo = int(np.searchsorted(g_of_r, glo, side="left"))
        hi = int(np.searchsorted(g_of_r, ghi, side="left"))
    else:
        # descending: search the (cached) negation
        lo = int(np.searchsorted(neg_g, -(ghi - 1), side="left"))
        hi = int(np.searchsorted(neg_g, -(glo - 1), side="left"))
    return lo, hi


def _true_overlap(a: SimRead, b: SimRead, ai: int, bi: int, cfg: SimConfig,
                  shift: int = 0, clamp: tuple[int, int] | None = None,
                  div_sites: np.ndarray | None = None) -> Overlap | None:
    """Construct the true overlap record (A as stored; B possibly complemented).

    ``shift`` maps B's genome coordinates into A's frame (used for overlaps
    induced by a planted repeat copy: B positions g map to A positions
    g - shift). ``clamp`` restricts the overlap to an A-frame interval (the
    repeat body — flanks beyond the copy do not match). ``div_sites`` are
    A-frame genome positions where the two copies differ; each one inside a
    tile adds a pair diff (cross-copy alignments really see that mismatch).
    """
    glo = max(a.start, b.start - shift)
    ghi = min(a.end, b.end - shift)
    if clamp is not None:
        glo = max(glo, clamp[0])
        ghi = min(ghi, clamp[1])
    if ghi - glo < cfg.min_overlap:
        return None
    comp = a.strand != b.strand
    # orientation chosen so B traverses the genome in the same direction as A
    gA, a_err_cum, negA = a.omaps(False)
    gB, b_err_cum, negB = b.omaps(comp)
    a_asc = a.strand == 0
    abpos, aepos = _positions_in(gA, negA, glo, ghi, a_asc)
    bbpos, bepos = _positions_in(gB, negB, glo + shift, ghi + shift, a_asc)
    if aepos - abpos < cfg.min_overlap // 2 or bepos - bbpos < cfg.min_overlap // 2:
        return None

    # trace points: cut A range at multiples of tspace, map each boundary to B
    ovl = Overlap(aread=ai, bread=bi, abpos=abpos, aepos=aepos,
                  bbpos=bbpos, bepos=bepos, flags=OVL_COMP if comp else 0)
    bounds = ovl.tile_bounds(cfg.tspace)
    # genome coordinate of each A boundary position
    gb = np.empty(len(bounds), dtype=np.int64)
    gb[:-1] = a.g_of_r[bounds[:-1]]
    gb[-1] = ghi  # end boundary maps to overlap end
    # map genome coords to B positions (vectorized r5: this function is the
    # sim's hot spot at scale; identical arithmetic to the scalar loops)
    if a_asc:
        bpos = np.searchsorted(gB, gb + shift, side="left").astype(np.int64)
    else:
        bpos = np.searchsorted(negB, -(gb + shift), side="left").astype(np.int64)
    bpos[0] = bbpos
    bpos[-1] = bepos
    bpos = np.maximum.accumulate(np.clip(bpos, bbpos, bepos))

    # per-tile diffs (approximation: A-edits + B-edits vs genome in the tile;
    # exact pair diffs are not needed — consumers use these only for error-rate
    # estimation, mirroring the trace-point diff semantics)
    ntiles = len(bounds) - 1
    trace = np.zeros((ntiles, 2), dtype=np.int32)
    a_ed = a_err_cum[bounds[1:]] - a_err_cum[bounds[:-1]]
    b_ed = b_err_cum[bpos[1:]] - b_err_cum[bpos[:-1]]
    gmin = np.minimum(gb[:-1], gb[1:])
    gmax = np.maximum(gb[:-1], gb[1:])
    a_dl = np.searchsorted(a.dels, gmax) - np.searchsorted(a.dels, gmin)
    b_dl = (np.searchsorted(b.dels, gmax + shift)
            - np.searchsorted(b.dels, gmin + shift))
    tot = a_ed + a_dl + b_ed + b_dl
    if div_sites is not None:
        tot += np.searchsorted(div_sites, gmax) - np.searchsorted(div_sites, gmin)
    trace[:, 0] = np.minimum(tot, 255 if cfg.tspace <= 125 else 65535)
    trace[:, 1] = bpos[1:] - bpos[:-1]
    ovl.trace = trace
    ovl.diffs = int(trace[:, 0].sum())
    return ovl


def simulate(cfg: SimConfig) -> SimResult:
    rng = np.random.default_rng(cfg.seed)
    genome, rep = _make_genome(cfg, rng)

    nbases_target = cfg.genome_len * cfg.coverage
    reads: list[SimRead] = []
    total = 0
    drop = None
    if cfg.dropout_frac > 0:
        dlen = int(cfg.genome_len * cfg.dropout_frac)
        if dlen:
            d0 = int(rng.integers(0, cfg.genome_len - dlen + 1))
            drop = (d0, d0 + dlen)
    while total < nbases_target:
        ln = int(rng.lognormal(np.log(cfg.read_len_mean), cfg.read_len_sigma))
        ln = max(300, min(ln, cfg.genome_len))
        start = int(rng.integers(0, cfg.genome_len - ln + 1))
        if drop is not None:
            # thin reads proportionally to their overlap with the dropout
            # region: coverage inside tends to depth/dropout_factor
            ov = min(start + ln, drop[1]) - max(start, drop[0])
            if ov > 0 and rng.random() < (ov / ln) * (1.0 - 1.0 / cfg.dropout_factor):
                continue
        strand = int(rng.integers(0, 2))
        rmult = 1.0
        if cfg.read_rate_sigma > 0:
            # mean-1 lognormal: a fat right tail of junk reads, the per-read
            # dispersion real instruments show
            s = cfg.read_rate_sigma
            rmult = float(rng.lognormal(-0.5 * s * s, s))
        fwd, g_of_r, err, dels = _sample_noisy(genome, start, start + ln, cfg,
                                               rng, rmult)
        if len(fwd) < 100:
            continue
        if cfg.p_chimera > 0 and len(fwd) > 600 and rng.random() < cfg.p_chimera:
            fwd, g_of_r, err, dels = _chimerize(fwd, g_of_r, err, dels, cfg, rng)
        if strand == 1:
            seq = revcomp_ints(fwd)
            g_of_r = g_of_r[::-1].copy()
            err = err[::-1].copy()
        else:
            seq = fwd
        reads.append(SimRead(start=start, end=start + ln, strand=strand,
                             seq=seq, g_of_r=g_of_r, err=err, dels=dels))
        total += len(fwd)

    # all true pairwise overlaps, both directions, sorted by aread
    overlaps: list[Overlap] = []
    order = np.argsort([r.start for r in reads], kind="stable")
    starts = np.array([r.start for r in reads])[order]
    for ai in range(len(reads)):
        a = reads[ai]
        # candidate B reads: start before a.end (and end after a.start)
        hi = int(np.searchsorted(starts, a.end))
        for oj in range(hi):
            bi = int(order[oj])
            if bi == ai:
                continue
            b = reads[bi]
            if b.end <= a.start:
                continue
            ovl = _true_overlap(a, b, ai, bi, cfg)
            if ovl is not None:
                overlaps.append(ovl)

    # repeat-induced overlaps: reads over the two copies align to each other
    # within the copy body (what daligner would report on a repeat); with
    # repeat_divergence > 0 every divergent site inside the overlap adds a
    # real pair diff
    if rep is not None:
        src, dst, rep_len, div_off = rep
        shift = dst - src
        in_src = [i for i, r in enumerate(reads) if r.start < src + rep_len and r.end > src]
        in_dst = [i for i, r in enumerate(reads) if r.start < dst + rep_len and r.end > dst]
        for ai in range(len(reads)):
            a = reads[ai]
            if a.start < src + rep_len and a.end > src:
                # A over copy 1, B over copy 2: B coords map down by shift
                for bi in in_dst:
                    if bi == ai:
                        continue
                    ovl = _true_overlap(a, reads[bi], ai, bi, cfg, shift=shift,
                                        clamp=(src, src + rep_len),
                                        div_sites=src + div_off)
                    if ovl is not None:
                        overlaps.append(ovl)
            if a.start < dst + rep_len and a.end > dst:
                # A over copy 2, B over copy 1: B coords map up by -shift
                for bi in in_src:
                    if bi == ai:
                        continue
                    ovl = _true_overlap(a, reads[bi], ai, bi, cfg, shift=-shift,
                                        clamp=(dst, dst + rep_len),
                                        div_sites=dst + div_off)
                    if ovl is not None:
                        overlaps.append(ovl)

    overlaps.sort(key=lambda o: (o.aread, o.bread))
    return SimResult(genome=genome, reads=reads, overlaps=overlaps, config=cfg)


def make_dataset(outdir: str, cfg: SimConfig, name: str = "sim") -> dict:
    """Materialize a SimResult as DB + LAS + truth files; returns paths."""
    os.makedirs(outdir, exist_ok=True)
    res = simulate(cfg)
    db_path = os.path.join(outdir, f"{name}.db")
    las_path = os.path.join(outdir, f"{name}.las")
    truth_path = os.path.join(outdir, f"{name}.truth.npz")

    write_db(db_path, [r.seq for r in res.reads])
    write_las(las_path, cfg.tspace, res.overlaps)
    np.savez_compressed(
        truth_path,
        genome=res.genome,
        starts=np.array([r.start for r in res.reads], dtype=np.int64),
        ends=np.array([r.end for r in res.reads], dtype=np.int64),
        strands=np.array([r.strand for r in res.reads], dtype=np.int8),
    )
    with open(os.path.join(outdir, f"{name}.config.json"), "wt") as fh:
        json.dump(asdict(cfg), fh, indent=2)
    return {"db": db_path, "las": las_path, "truth": truth_path, "result": res}


def score_vs_truth(fasta: str, truth: str, db: DazzDB) -> tuple[float, float]:
    """(corrected, raw) error rates of corrected fragments against the
    simulation's truth (the ``truth`` file of :func:`make_dataset`): each
    fragment's best infix edit distance to its read's true sequence, and the
    raw reads' edit distance to the same, over the reads with a fragment.
    Records are named ``read<id>/<fragment>``."""
    from ..oracle.align import edit_distance, infix_distance
    from ..utils.bases import seq_to_ints

    t = np.load(truth)
    genome, starts, ends, strands = t["genome"], t["starts"], t["ends"], t["strands"]

    def truth_of(rid: int) -> np.ndarray:
        tr = genome[starts[rid]:ends[rid]]
        return revcomp_ints(tr) if strands[rid] == 1 else tr

    e = n = 0
    rids = set()
    for rec in read_fasta(fasta):
        rid = int(rec.name.split()[0].removeprefix("read").split("/")[0])
        f = seq_to_ints(rec.seq)
        e += infix_distance(f, truth_of(rid))
        n += len(f)
        rids.add(rid)
    re = rn = 0
    for rid in sorted(rids):
        raw = db.read_bases(rid)
        re += edit_distance(raw, truth_of(rid))
        rn += len(raw)
    return e / max(n, 1), re / max(rn, 1)
