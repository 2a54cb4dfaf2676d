"""The cell's inputs from ``--seed``: a pool of windows, cut into dense
depth buckets, and the error profile a user would pass with ``-E``.

Frozen copies, so that a change to the program cannot change the yardstick:
the read sampler is ``daccord_tpu_torch/sim/synth.py``'s (``_sample_noisy``
and the read loop of ``simulate``: the same error model, its per-base draws
made in bulk), the
window cut is ``oracle/windows.py cut_windows``'s (windows ``[j*adv,
j*adv+w)`` of the A read, the A read's own bases first, then one segment of
each overlap that spans the window), and the packing is
``kernels/tensorize.py tensorize_windows``'s (``[n, D, L]`` int8 padded
with 4, segments cut at L). The B segments come from the simulation's own
truth map (stored-read position -> genome position) instead of an aligner:
the segment of B over A's window is B's bases over the same genome
positions. Overlaps rank by their truth error rate, lowest first (the
pipeline ranks by the trace-diff rate, ``pipeline._depth_order``), so the
best fill the D depth slots. A window with fewer than ``min_depth``
segments stays out (the pipeline's skip-shallow rule); each other window
goes to the smallest depth bucket that holds its segments
(``pipeline.route_dense``).

Imports numpy only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

PAD = 4


@dataclass
class Bucket:
    """The pool's windows of one depth bucket."""

    depth: int
    seqs: np.ndarray       # int8 [n, D, L]
    lens: np.ndarray       # int32 [n, D]
    nsegs: np.ndarray      # int32 [n]
    read_ids: np.ndarray   # int64 [n]
    wstarts: np.ndarray    # int64 [n]

    @property
    def size(self) -> int:
        return len(self.nsegs)


@dataclass
class Pool:
    buckets: dict          # depth -> Bucket
    profile: dict          # p_ins, p_del, p_sub of the sampled reads
    reads: int             # reads simulated
    piles: int             # A reads windowed

    @property
    def size(self) -> int:
        return sum(b.size for b in self.buckets.values())


def revcomp(arr: np.ndarray) -> np.ndarray:
    return (3 - np.asarray(arr))[::-1].astype(np.int8)


def sample_noisy(genome: np.ndarray, start: int, end: int, sim: dict,
                 rng: np.random.Generator, rmult: float = 1.0):
    """``sim/synth.py _sample_noisy``: sub/ins/del noise on
    ``genome[start:end]``, forward orientation. Returns (read, g_of_r, err,
    dels); ``err`` marks inserted and substituted bases."""
    seg = genome[start:end]
    n = len(seg)
    hp_slope = sim.get("hp_indel_slope", 0.0)
    burst_rate = sim.get("burst_rate", 0.0)
    mismatch = hp_slope > 0 or burst_rate > 0 or rmult != 1.0
    in_run = None
    if not mismatch:
        u = rng.random(n)
        is_del = u < sim["p_del"]
        is_sub = (~is_del) & (u < sim["p_del"] + sim["p_sub"])
        n_ins = rng.geometric(1.0 - sim["p_ins"], size=n) - 1
    else:
        m = np.full(n, float(rmult))
        if burst_rate > 0 and n:
            nb = int(rng.poisson(burst_rate * n))
            if nb:
                bs = rng.integers(0, n, size=nb)
                bl = rng.geometric(1.0 / max(sim.get("burst_len_mean", 30.0), 1.0), size=nb)
                for s, ln_ in zip(bs, bl):
                    m[s:s + ln_] *= sim.get("burst_mult", 6.0)
        hp = np.ones(n)
        if hp_slope > 0 and n:
            change = np.nonzero(np.diff(seg))[0] + 1
            bounds = np.concatenate([[0], change, [n]])
            rl = np.diff(bounds)
            runlen = np.repeat(rl, rl)
            hp = 1.0 + hp_slope * np.minimum(runlen - 1, sim.get("hp_run_cap", 8))
            in_run = runlen > 1
        pd = np.clip(sim["p_del"] * m * hp, 0.0, 0.45)
        ps = np.clip(sim["p_sub"] * m, 0.0, 0.45)
        pi = np.clip(sim["p_ins"] * m * hp, 0.0, 0.45)
        u = rng.random(n)
        is_del = u < pd
        is_sub = (~is_del) & (u < pd + ps)
        n_ins = rng.geometric(1.0 - pi) - 1 if n else np.zeros(0, np.int64)
    keep = ~is_del
    # the model's draws in bulk (the simulator draws them base by base): a
    # substitution's shift, then the inserted bases, uniform, or the run's
    # own base inside a homopolymer run
    sub_vals = rng.integers(1, 4, size=int(is_sub.sum())).astype(np.int8)
    ins_idx = np.nonzero(n_ins > 0)[0]
    k_arr = n_ins[ins_idx]
    ins_vals = rng.integers(0, 4, size=int(k_arr.sum()), dtype=np.int8)
    if in_run is not None and len(ins_idx):
        run_ins = np.repeat(in_run[ins_idx], k_arr)
        ins_vals[run_ins] = np.repeat(seg[ins_idx], k_arr)[run_ins]
    counts = keep.astype(np.int64) + n_ins
    total = int(counts.sum()) if n else 0
    read = np.empty(total, dtype=np.int8)
    err = np.empty(total, dtype=np.int8)
    g_of_r = np.repeat(start + np.arange(n, dtype=np.int64), counts)
    if n:
        offs = np.zeros(n, dtype=np.int64)
        np.cumsum(counts[:-1], out=offs[1:])
        bases = seg.copy()
        if len(sub_vals):
            si = np.nonzero(is_sub)[0]
            bases[si] = (bases[si] + sub_vals) % 4
        read[offs[keep]] = bases[keep]
        err[offs[keep]] = is_sub[keep].astype(np.int8)
        if len(ins_idx):
            starts_i = offs[ins_idx] + keep[ins_idx]
            K = int(k_arr.sum())
            flat = (np.repeat(starts_i, k_arr) + np.arange(K, dtype=np.int64)
                    - np.repeat(np.concatenate(([0], np.cumsum(k_arr[:-1]))), k_arr))
            read[flat] = ins_vals
            err[flat] = 1
    dels = (start + np.nonzero(is_del)[0]).astype(np.int64)
    return read, g_of_r, err, dels


@dataclass
class Read:
    start: int
    end: int
    strand: int
    seq: np.ndarray        # as stored (reverse complement on strand 1)
    g_of_r: np.ndarray     # stored position -> genome position
    err_cum: np.ndarray    # [len + 1] running count of inserted/substituted bases
    dels: np.ndarray       # genome positions deleted from this read, ascending


def simulate_reads(sim: dict, rng: np.random.Generator) -> tuple[np.ndarray, list, dict]:
    """The genome and the reads of ``simulate``'s read loop, to
    ``coverage`` x (genome - mean read length) bases, so that the interior
    of the genome, where the A reads lie, holds the stated coverage. Returns
    (genome, reads, the reads' measured ins/del/sub rates per genome base)."""
    G = int(sim["genome_len"])
    genome = rng.integers(0, 4, size=G, dtype=np.int8)
    target = sim["coverage"] * (G - sim["read_len_mean"])
    reads: list[Read] = []
    total = 0
    n_ins = n_del = n_sub = n_gen = 0
    while total < target:
        ln = int(rng.lognormal(np.log(sim["read_len_mean"]), sim["read_len_sigma"]))
        ln = max(300, min(ln, G))
        start = int(rng.integers(0, G - ln + 1))
        strand = int(rng.integers(0, 2))
        rmult = 1.0
        if sim.get("read_rate_sigma", 0.0) > 0:
            s = sim["read_rate_sigma"]
            rmult = float(rng.lognormal(-0.5 * s * s, s))
        fwd, g_of_r, err, dels = sample_noisy(genome, start, start + ln, sim, rng, rmult)
        if len(fwd) < 100:
            continue
        ins = len(fwd) - (ln - len(dels))
        n_ins += ins
        n_sub += int(err.sum()) - ins
        n_del += len(dels)
        n_gen += ln
        if strand == 1:
            fwd, g_of_r, err = revcomp(fwd), g_of_r[::-1].copy(), err[::-1].copy()
        reads.append(Read(start=start, end=start + ln, strand=strand, seq=fwd,
                          g_of_r=g_of_r,
                          err_cum=np.concatenate(([0], np.cumsum(err, dtype=np.int64))),
                          dels=dels))
        total += len(fwd)
    rates = dict(p_ins=n_ins / n_gen, p_del=n_del / n_gen, p_sub=n_sub / n_gen)
    return genome, reads, rates


def _oriented(r: Read, comp: bool) -> np.ndarray:
    """Genome position of each base of ``r`` in the orientation that runs
    with the A read (reversed when the two lie on different strands)."""
    return r.g_of_r[::-1] if comp else r.g_of_r


def _first_at(g: np.ndarray, x: np.ndarray, ascending: bool) -> np.ndarray:
    """Index of the first base of ``g`` at or past genome position ``x`` in
    the direction ``g`` runs."""
    return np.searchsorted(g, x, side="left") if ascending else \
        np.searchsorted(-g, -x, side="left")


def pile_windows(a_id: int, reads: list, cand: np.ndarray, rc_off: np.ndarray,
                 fw_off: np.ndarray, cfg: dict) -> tuple:
    """One A read's windows: (nsegs [n], lens [n, D], wstarts [n], and the
    flat segment list (window, slot, buffer offset, length))."""
    w, adv, D, L = cfg["w"], cfg["adv"], cfg["depth"], cfg["seg_len"]
    a = reads[a_id]
    asc = a.strand == 0
    rlen = len(a.seq)
    nwin = 0 if rlen < w else (rlen - w) // adv + 1
    if nwin == 0:
        return None
    ws = np.arange(nwin, dtype=np.int64) * adv
    g_ext = np.concatenate([a.g_of_r, [a.end if asc else a.start - 1]])
    gs, ge = g_ext[ws], g_ext[ws + w]
    # the window's genome interval [lo, hi)
    w_lo, w_hi = (gs, ge) if asc else (ge + 1, gs + 1)
    # rank the overlaps by their truth error rate over the overlap, lowest
    # first (stable): the errors of both reads there per A base
    rows = []
    for b_id in cand:
        b = reads[b_id]
        glo, ghi = max(a.start, b.start), min(a.end, b.end)
        if ghi - glo < cfg["min_overlap"]:
            continue
        comp = a.strand != b.strand
        gB = _oriented(b, comp)
        a0, a1 = sorted(int(x) for x in _first_at(a.g_of_r, np.array([glo, ghi - 1]), asc))
        b0, b1 = sorted(int(x) for x in _first_at(gB, np.array([glo, ghi - 1]), asc))
        bc = b.err_cum if not comp else (b.err_cum[-1] - b.err_cum[::-1])
        errs = (a.err_cum[a1] - a.err_cum[a0] + bc[b1] - bc[b0]
                + np.searchsorted(a.dels, ghi) - np.searchsorted(a.dels, glo)
                + np.searchsorted(b.dels, ghi) - np.searchsorted(b.dels, glo))
        rows.append((errs / max(a1 - a0, 1), b_id, comp, glo, ghi))
    rows.sort(key=lambda t: t[0])
    nb = len(rows)
    span = np.zeros((nb, nwin), bool)
    s0 = np.zeros((nb, nwin), np.int64)
    s1 = np.zeros((nb, nwin), np.int64)
    off = np.zeros(nb, np.int64)
    for i, (_, b_id, comp, glo, ghi) in enumerate(rows):
        gB = _oriented(reads[b_id], comp)
        span[i] = (w_lo >= glo) & (w_hi <= ghi)
        s0[i] = _first_at(gB, gs, asc)
        s1[i] = _first_at(gB, ge, asc)
        off[i] = rc_off[b_id] if comp else fw_off[b_id]
    span &= s1 > s0
    # the first D-1 spanning overlaps of each window, best first
    rank = np.cumsum(span, axis=0)
    used = span & (rank <= D - 1)
    nsegs = 1 + used.sum(axis=0).astype(np.int32)
    bi, wi = np.nonzero(used)
    slot = rank[bi, wi]
    seg_off = off[bi] + s0[bi, wi]
    seg_len = np.minimum(s1[bi, wi] - s0[bi, wi], L)
    # the A read's own bases lead each window
    win = np.concatenate([np.arange(nwin), wi])
    slots = np.concatenate([np.zeros(nwin, np.int64), slot])
    offs = np.concatenate([fw_off[a_id] + ws, seg_off])
    lens = np.concatenate([np.full(nwin, min(w, L), np.int64), seg_len])
    return nsegs, ws, win, slots, offs, lens


def make_pool(cfg: dict, seed: int) -> Pool:
    """The cell's window pool for ``seed``: ``cfg["pool_windows"]`` windows
    of whole piles (A reads drawn from the genome's interior in a seeded
    order), in depth buckets."""
    sim = cfg
    rng = np.random.default_rng(int(seed))
    genome, reads, rates = simulate_reads(sim, rng)
    G = len(genome)
    # reads whose every base lies where the coverage is flat
    margin = int(sim["read_len_mean"] * math.exp(3 * sim["read_len_sigma"]))
    starts = np.array([r.start for r in reads])
    ends = np.array([r.end for r in reads])
    interior = np.nonzero((starts >= margin) & (ends <= G - margin))[0]
    if len(interior) == 0:
        raise ValueError("no read lies in the genome's interior: raise genome_len")
    order = rng.permutation(interior)
    # every read in both orientations, in one buffer
    lens_r = np.array([len(r.seq) for r in reads], np.int64)
    fw_off = np.concatenate(([0], np.cumsum(lens_r)[:-1]))
    rc_off = fw_off + int(lens_r.sum())
    buf = np.concatenate([r.seq for r in reads] + [revcomp(r.seq) for r in reads])
    want = int(cfg["pool_windows"])
    D, L, min_depth = cfg["depth"], cfg["seg_len"], cfg["dbg"]["min_depth"]
    parts = []
    got = 0
    piles = 0
    for a_id in order:
        if got >= want:
            break
        a = reads[a_id]
        cand = np.nonzero((starts < a.end) & (ends > a.start))[0]
        cand = cand[cand != a_id]
        res = pile_windows(int(a_id), reads, cand, rc_off, fw_off, cfg)
        if res is None:
            continue
        nsegs, ws, win, slots, offs, lens = res
        keep = nsegs >= min_depth
        parts.append((int(a_id), nsegs, ws, win, slots, offs, lens, keep))
        got += int(keep.sum())
        piles += 1
    if got < want:
        raise ValueError(f"the genome's interior gave {got} windows of {want}: "
                         "raise genome_len")
    # pack every kept window into [n, D, L], then cut to the pool's size
    n_all = sum(len(p[1]) for p in parts)
    seqs = np.full((n_all, D, L), PAD, np.int8)
    lens_a = np.zeros((n_all, D), np.int32)
    nsegs_a = np.zeros(n_all, np.int32)
    rid = np.zeros(n_all, np.int64)
    wst = np.zeros(n_all, np.int64)
    keep_a = np.zeros(n_all, bool)
    base = 0
    ar = np.arange(L)
    for a_id, nsegs, ws, win, slots, offs, lens, keep in parts:
        n = len(nsegs)
        nsegs_a[base:base + n] = nsegs
        rid[base:base + n] = a_id
        wst[base:base + n] = ws
        keep_a[base:base + n] = keep
        rows = base + win
        lens_a[rows, slots] = lens
        for lo in range(0, len(rows), 1 << 16):
            sl = slice(lo, lo + (1 << 16))
            idx = offs[sl, None] + ar
            ok = ar < lens[sl, None]
            seqs[rows[sl], slots[sl]] = np.where(ok, buf[np.where(ok, idx, 0)], PAD)
        base += n
    kept = np.nonzero(keep_a)[0][:want]
    depths = sorted({int(d) for d in cfg["depth_buckets"] if 0 < d < D} | {D})
    which = np.searchsorted(np.asarray(depths), nsegs_a[kept], side="left")
    buckets = {}
    for bi, d in enumerate(depths):
        sel = kept[which == bi]
        if len(sel) == 0:
            continue
        buckets[d] = Bucket(depth=d, seqs=np.ascontiguousarray(seqs[sel, :d]),
                            lens=np.ascontiguousarray(lens_a[sel, :d]),
                            nsegs=nsegs_a[sel].copy(), read_ids=rid[sel].copy(),
                            wstarts=wst[sel].copy())
    return Pool(buckets=buckets, profile=rates, reads=len(reads), piles=piles)
