"""End-to-end correction pipeline: DB + LAS piles -> window batches -> FASTA.

The lean main path of ``daccord_tpu/runtime/pipeline.py``, in this order:

- the profile pass: a strided sample of piles, windowed on the host, gives
  the two-pass error profile (skipped when a profile is passed in);
- the host windowing of every pile (numpy: realign each overlap's trace
  tiles, rank the overlaps by trace-diff rate so the best fill the depth
  slots, cut windows, pack them into [D, L] rows);
- skip-shallow: windows with fewer than ``min_depth`` segments never reach
  the device (the solver would mark them unsolved);
- dense ``batch_size`` x D x L batches, one ladder call each (the last batch
  is padded with empty rows so every call has one shape);
- end-trim: prefix/suffix runs of windows solved only by a low-confidence
  rescue tier (min_count <= 1) count as unsolved, because read ends have
  thin piles and such windows carry near-raw error rates;
- stitching, and FASTA records in input order.

Windows are solved independently, so how rows are grouped into batches never
changes a window's result.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from ..formats.dazzdb import DazzDB, read_db
from ..formats.fasta import FastaRecord, write_fasta
from ..formats.las import _HDR_SIZE, LasFile, index_las
from ..kernels.tensorize import BatchShape, WindowBatch, pad_batch, tensorize_windows
from ..kernels.tiers import TierLadder, solve_ladder
from ..oracle.consensus import ConsensusConfig, estimate_profile_two_pass, stitch_results
from ..oracle.profile import ErrorProfile
from ..oracle.windows import cut_windows, refine_overlap
from ..utils.bases import ints_to_seq
from ..utils.device import resolve_device


#: piles sampled (strided across the input) by the error-profile pass
PROFILE_SAMPLE_PILES = 4


@dataclass
class PipelineConfig:
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    batch_size: int = 2048       # windows per ladder call
    depth: int = 32              # D: segments per window row (depth cap)
    seg_len: int = 64            # L: bases per segment
    device: str = "cuda"         # "cuda" or "cpu"; no silent fallback


@dataclass
class PipelineStats:
    n_reads: int = 0
    n_windows: int = 0
    n_solved: int = 0
    n_skipped_shallow: int = 0
    n_topm_overflow: int = 0
    n_end_trimmed: int = 0
    n_fragments: int = 0
    n_batches: int = 0
    bases_in: int = 0
    bases_out: int = 0
    tier_histogram: dict = field(default_factory=dict)
    profile_s: float = 0.0       # profile pass (host)
    windowing_s: float = 0.0     # host pile windowing
    ladder_s: float = 0.0        # ladder calls, device results on the host
    wall_s: float = 0.0

    def bases_per_sec(self) -> float:
        return self.bases_out / self.wall_s if self.wall_s else 0.0

    def windows_per_sec(self) -> float:
        return self.n_windows / self.wall_s if self.wall_s else 0.0


def _rank_scores(diffs: np.ndarray, spans: np.ndarray) -> np.ndarray:
    """Depth-ranking score per overlap: the pair trace-diff rate (lower
    ranks first)."""
    return diffs.astype(np.float64) / spans


def _stride_take(n_items: int, n: int, offset: int = 0) -> np.ndarray:
    """Indices of ``n`` items spread evenly across ``n_items``."""
    if n_items == 0 or n == 0:
        return np.zeros(0, np.int64)
    return np.unique((np.linspace(0, n_items - 1, min(n, n_items)).astype(int)
                      + offset) % n_items)


def _strided_pile_ranges(las: LasFile, n: int) -> list[tuple[int, int]]:
    """Byte ranges of ``n`` piles spread evenly across the LAS file."""
    idx = index_las(las.path)
    lo, hi = _HDR_SIZE, os.path.getsize(las.path)
    if len(idx) == 0:
        return [(lo, hi)]
    sel = np.nonzero((idx[:, 1] >= lo) & (idx[:, 1] < hi))[0]
    if len(sel) == 0:
        return [(lo, hi)]
    out = []
    for t in _stride_take(len(sel), n):
        j = int(sel[t])
        s = int(idx[j, 1])
        e = int(idx[j + 1, 1]) if j + 1 < len(idx) else hi
        out.append((s, min(e, hi)))
    return out


def estimate_profile_for_shard(db: DazzDB, las: LasFile,
                               cfg: PipelineConfig) -> ErrorProfile:
    """Profile pass over ``PROFILE_SAMPLE_PILES`` piles strided across the
    LAS file (one pile per strided range)."""
    refined_all, windows_all = [], []
    for s, e in _strided_pile_ranges(las, PROFILE_SAMPLE_PILES):
        for aread, pile in las.iter_piles(s, e):
            a_bases = db.read_bases(aread)
            refined = [refine_overlap(o, a_bases, db.read_bases(o.bread), las.tspace)
                       for o in pile]
            refined_all.extend(refined)
            windows_all.extend(cut_windows(a_bases, refined, w=cfg.consensus.w,
                                           adv=cfg.consensus.adv))
            break   # one pile per strided range
    return estimate_profile_two_pass(refined_all, windows_all, cfg.consensus,
                                     sample=32)


def iter_pile_blocks(db: DazzDB, las: LasFile, cfg: PipelineConfig):
    """Yield (aread, a_bases, seqs [nwin,D,L], lens [nwin,D], nsegs [nwin])
    per pile, windowed on the host."""
    w, adv = cfg.consensus.w, cfg.consensus.adv
    shape = BatchShape(depth=cfg.depth, seg_len=cfg.seg_len, wlen=w)
    for aread, pile in las.iter_piles():
        a = db.read_bases(aread)
        if pile:
            # quality-ranked depth capping: the best alignments (lowest
            # trace-diff rate) fill the depth slots
            diffs = np.asarray([o.diffs for o in pile])
            span = np.maximum(np.asarray([o.aepos - o.abpos for o in pile]), 1)
            order = np.argsort(_rank_scores(diffs, span), kind="stable")
            pile = [pile[i] for i in order]
        refined = [refine_overlap(o, a, db.read_bases(o.bread), las.tspace)
                   for o in pile]
        windows = cut_windows(a, refined, w=w, adv=adv)
        b = tensorize_windows([(aread, ws) for ws in windows], shape)
        yield aread, a, b.seqs, b.lens, b.nsegs


class _PendingRead:
    __slots__ = ("aread", "n_windows", "results", "n_done", "tiers")

    def __init__(self, aread: int, n_windows: int):
        self.aread = aread
        self.n_windows = n_windows
        self.results: list = [None] * n_windows
        self.n_done = 0
        self.tiers = np.full(n_windows, -1, dtype=np.int32)


def _trim_rescue_ends(pr: _PendingRead, rescue_tiers: set, stats: PipelineStats) -> None:
    """Null out prefix/suffix runs of rescue-tier-solved windows (the
    end-trim of the module docstring). Scanning skips over already-unsolved windows
    and stops at the first window solved by a confident tier."""
    res = pr.results

    def sweep(idxs) -> None:
        for j in idxs:
            ws, wl, seq = res[j]
            if seq is None:
                continue
            t = int(pr.tiers[j])
            if t not in rescue_tiers:
                return
            res[j] = (ws, wl, None)
            stats.n_solved -= 1
            stats.n_end_trimmed += 1
            stats.tier_histogram[t] = stats.tier_histogram.get(t, 0) - 1

    sweep(range(pr.n_windows))
    sweep(range(pr.n_windows - 1, -1, -1))


def correct_shard(db: DazzDB, las: LasFile, cfg: PipelineConfig,
                  profile: ErrorProfile | None = None):
    """Correct every pile; yields (aread, fragments, stats) in input order."""
    dev = resolve_device(cfg.device)
    stats = PipelineStats()
    t_start = time.perf_counter()
    if profile is None:
        t0 = time.perf_counter()
        profile = estimate_profile_for_shard(db, las, cfg)
        stats.profile_s = time.perf_counter() - t0
    ladder = TierLadder.from_config(profile, cfg.consensus, device=dev)
    w, adv = cfg.consensus.w, cfg.consensus.adv
    shape = BatchShape(depth=cfg.depth, seg_len=cfg.seg_len, wlen=w)
    min_depth = cfg.consensus.dbg.min_depth
    rescue_tiers = {i for i, t in enumerate(cfg.consensus.tiers) if t[1] <= 1}

    pending: dict[int, _PendingRead] = {}
    order: list[int] = []
    ready: dict[int, list[np.ndarray]] = {}
    rows: list[tuple] = []          # buffered (seqs, lens, nsegs, rid, widx) blocks
    n_rows = 0

    def finalize_read(r: int, pr: _PendingRead) -> None:
        _trim_rescue_ends(pr, rescue_tiers, stats)
        ready[r] = stitch_results([x for x in pr.results if x is not None],
                                  cfg.consensus)
        del pending[r]

    def run_batch(take: int) -> None:
        nonlocal rows, n_rows
        cat = [np.concatenate([blk[i] for blk in rows]) for i in range(5)]
        seqs, lens, nsg, rid, widx = (a[:take] for a in cat)
        rows = [tuple(a[take:] for a in cat)] if n_rows > take else []
        n_rows -= take
        batch = pad_batch(WindowBatch(seqs=seqs, lens=lens, nsegs=nsg, shape=shape,
                                      read_ids=rid, wstarts=widx * adv),
                          cfg.batch_size)
        t0 = time.perf_counter()
        out = solve_ladder(batch, ladder)
        stats.ladder_s += time.perf_counter() - t0
        stats.n_batches += 1
        stats.n_topm_overflow += int(out["m_ovf"][:take].sum())
        for i in range(take):
            r, wj = int(rid[i]), int(widx[i])
            pr = pending[r]
            solved = bool(out["solved"][i])
            seq = (np.asarray(out["cons"][i][: out["cons_len"][i]], dtype=np.int8)
                   if solved else None)
            pr.results[wj] = (wj * adv, w, seq)
            pr.n_done += 1
            if solved:
                t = int(out["tier"][i])
                stats.n_solved += 1
                pr.tiers[wj] = t
                stats.tier_histogram[t] = stats.tier_histogram.get(t, 0) + 1
            if pr.n_done == pr.n_windows:
                finalize_read(r, pr)

    emit_idx = 0

    def emit_ready():
        nonlocal emit_idx
        while emit_idx < len(order) and order[emit_idx] in ready:
            r = order[emit_idx]
            frags = ready.pop(r)
            stats.n_fragments += len(frags)
            stats.bases_out += sum(len(f) for f in frags)
            stats.wall_s = time.perf_counter() - t_start
            yield r, frags, stats
            emit_idx += 1

    blocks = iter_pile_blocks(db, las, cfg)
    while True:
        t0 = time.perf_counter()
        blk = next(blocks, None)
        stats.windowing_s += time.perf_counter() - t0
        if blk is None:
            break
        aread, a_bases, seqs, lens, nsegs = blk
        stats.n_reads += 1
        stats.bases_in += len(a_bases)
        nwin = len(nsegs)
        stats.n_windows += nwin
        order.append(aread)
        if nwin == 0:
            ready[aread] = []
        else:
            pr = pending[aread] = _PendingRead(aread, nwin)
            widx = np.arange(nwin, dtype=np.int64)
            shallow = nsegs < min_depth
            for wj in np.nonzero(shallow)[0]:
                pr.results[int(wj)] = (int(wj) * adv, w, None)
            pr.n_done += int(shallow.sum())
            stats.n_skipped_shallow += int(shallow.sum())
            keep = ~shallow
            seqs, lens, nsegs, widx = seqs[keep], lens[keep], nsegs[keep], widx[keep]
            if len(nsegs):
                rows.append((seqs, lens, nsegs,
                             np.full(len(nsegs), aread, dtype=np.int64), widx))
                n_rows += len(nsegs)
            elif pr.n_done == pr.n_windows:
                finalize_read(aread, pr)
        while n_rows >= cfg.batch_size:
            run_batch(cfg.batch_size)
        yield from emit_ready()
    if n_rows:
        run_batch(n_rows)
    yield from emit_ready()
    stats.wall_s = time.perf_counter() - t_start


def correct_to_fasta(db_path: str, las_path: str, out_path,
                     cfg: PipelineConfig | None = None,
                     profile: ErrorProfile | None = None) -> PipelineStats:
    """Run the pipeline and write the corrected fragments as FASTA
    (``-`` = stdout); records are named ``read<id>/<fragment>``."""
    cfg = cfg or PipelineConfig()
    t0 = time.perf_counter()
    db = read_db(db_path)
    las = LasFile(las_path)
    stats = PipelineStats()
    recs = []
    for rid, frags, st in correct_shard(db, las, cfg, profile=profile):
        stats = st
        for fi, f in enumerate(frags):
            recs.append(FastaRecord(f"read{rid}/{fi}", ints_to_seq(f)))
    write_fasta(sys.stdout if out_path == "-" else out_path, recs)
    stats.wall_s = time.perf_counter() - t0
    return stats
