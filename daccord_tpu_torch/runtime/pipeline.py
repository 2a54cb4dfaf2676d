"""End-to-end correction pipeline: DB + LAS piles -> window batches -> FASTA.

The lean main path of ``daccord_tpu/runtime/pipeline.py``, in this order:

- the profile pass: a strided sample of piles, windowed on the host, gives
  the two-pass error profile (skipped when a profile is passed in);
- the host windowing of every pile: rank the pile's overlaps (trace-diff
  rate, plus the B read's intrinsic QV when the DB has an ``inqual`` track)
  so the best fill the depth slots, then realign each overlap's trace tiles,
  cut windows and pack them into [D, L] rows. By default one call of the
  host library per pile does the last three (``native/dazz_native.cpp
  process_pile``), on ``feeder_threads`` threads ahead of the batching loop
  when that is above 0; ``use_native=False`` runs the numpy feeder
  (``oracle/windows.py``, ``kernels/tensorize.py``), which writes the same
  bytes;
- skip-shallow: windows with fewer than ``min_depth`` segments never reach
  the device (the solver would mark them unsolved);
- batching, one ladder call per batch of ``batch_size`` rows (a partial
  batch is padded with empty rows so every call of a bucket has one shape).
  Dense (``paged="off"``), every window goes to one D x L bucket. Paged
  (``kernels/paging.py``), a family router sends each window to the
  smallest corpus-derived (depth, pages) shape family that holds it, and a
  batch ships as a page pool and a page table instead of the dense tile.
  A bucket flushes when it holds ``batch_size`` rows, when its pages fill
  one pool, when its oldest row has waited ``bucket_flush_reads`` reads, or
  at the end of the run;
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
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..formats.dazzdb import DazzDB, read_db, read_track
from ..formats.fasta import FastaRecord, write_fasta
from ..formats.las import _HDR_SIZE, LasFile, index_las
from ..kernels import paging
from ..kernels.tensorize import BatchShape, WindowBatch, pad_batch, tensorize_windows
from ..kernels.tiers import TierLadder, solve_ladder, upload_arrays
from ..native.api import ColumnarLas, process_pile_native
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
    paged: str = "off"           # "on" | "off" | "auto" (on for cuda, off
                                 # for cpu): ship batches as page pool +
                                 # page table (kernels/paging.py)
    page_len: int = 16           # paged page length; must divide seg_len
    paged_families: int = 4      # most shape families the router derives
    bucket_flush_reads: int = 128    # flush a partial bucket once its oldest
                                 # row has waited this many reads
    dp_route: str = "fused"      # heaviest-path route: "fused" (DP +
                                 # backtrack kernel) or "scan" (DP kernel,
                                 # torch backtrack); bit-identical
    use_native: bool = True      # window piles in the host library; False:
                                 # the numpy feeder (same bytes, slower)
    feeder_threads: int = 0      # piles windowed by this many threads ahead
                                 # of the batching loop (0 = in the loop);
                                 # the library releases the GIL. Needs
                                 # use_native
    depth_rank: bool = True      # best-ranked overlaps fill the depth slots
    qv_track: str | None = "inqual"  # intrinsic-QV track whose B-read tile
                                 # QVs join the depth-ranking score (absent
                                 # track: trace-diff rate only)


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
    paged: bool = False          # batches shipped as page pool + table
    native_host: bool = False    # piles windowed by the host library
    qv_ranked: bool = False      # a QV track joined the depth ranking
    pad_cells: int = 0           # payload cells shipped: dense seqs, or the
    used_cells: int = 0          # paged pool; used = real bases
    h2d_bytes: int = 0           # bytes of the arrays handed to the ladder
                                 # (copied host -> device on cuda)
    profile_s: float = 0.0       # profile pass and paged family sample (host)
    windowing_s: float = 0.0     # wall the pile loop blocked on the
                                 # feeder; with feeder threads, less than
                                 # the feeder's CPU time, which they spend
                                 # ahead of the loop (under the ladder)
    ladder_s: float = 0.0        # ladder calls, device results on the host
    wall_s: float = 0.0

    @property
    def pad_waste(self) -> float:
        return 1.0 - self.used_cells / self.pad_cells if self.pad_cells else 0.0

    def bases_per_sec(self) -> float:
        return self.bases_out / self.wall_s if self.wall_s else 0.0

    def windows_per_sec(self) -> float:
        return self.n_windows / self.wall_s if self.wall_s else 0.0


#: the QV track's byte for a tile without coverage, and its QV -> error rate
#: scale (``daccord_tpu/tools/lastools.py``, which writes the track)
QV_NOCOV = 255
QV_SCALE = 200.0


class QvRanker:
    """Per-overlap B-read quality from an intrinsic-QV track.

    The track holds one QV byte per tspace tile per read; :meth:`rates`
    averages each B read's tiles under its aligned interval and returns
    error-rate units (QV / QV_SCALE), NaN when no covered tile has coverage.
    The per-read prefix sums are one global cumsum built here, differenced
    inside each read's tile span, so ranking a pile is vectorized numpy
    (it runs in the feeder threads, which only read this state).
    """

    def __init__(self, qv_payloads: list, tspace: int, db: DazzDB):
        self.tspace = tspace
        nt = np.fromiter((len(p) for p in qv_payloads), np.int64,
                         len(qv_payloads))
        self.tile_base = np.zeros(len(nt) + 1, np.int64)
        np.cumsum(nt, out=self.tile_base[1:])
        flat = (np.concatenate(qv_payloads) if len(qv_payloads)
                else np.zeros(0, np.uint8))
        valid = flat != QV_NOCOV
        self.cv = np.zeros(len(flat) + 1, np.float64)
        np.cumsum(np.where(valid, flat, 0), out=self.cv[1:])
        self.cc = np.zeros(len(flat) + 1, np.int64)
        np.cumsum(valid, out=self.cc[1:])
        self.rlens = np.fromiter((db.read_length(i)
                                  for i in range(len(qv_payloads))),
                                 np.int64, len(qv_payloads))

    def rates(self, bread, bbpos, bepos, comp) -> np.ndarray:
        """Per-overlap mean QV rate; NaN = no QV information."""
        bread = np.asarray(bread, np.int64)
        bb = np.asarray(bbpos, np.int64)
        be = np.asarray(bepos, np.int64)
        comp = np.asarray(comp).astype(bool)
        inb = (bread >= 0) & (bread < len(self.rlens))
        br = np.where(inb, bread, 0)
        blen = self.rlens[br]
        # LAS B coordinates of complemented overlaps live in complement
        # space; the track indexes forward-strand tiles
        fb = np.where(comp, blen - be, bb)
        fe = np.where(comp, blen - bb, be)
        nt = self.tile_base[br + 1] - self.tile_base[br]
        g0 = np.maximum(fb // self.tspace, 0)
        g1 = np.minimum((np.maximum(fe, fb + 1) - 1) // self.tspace, nt - 1)
        ok = inb & (nt > 0) & (g1 >= g0)
        lo = np.where(ok, self.tile_base[br] + g0, 0)
        hi = np.where(ok, self.tile_base[br] + g1 + 1, 0)
        cnt = self.cc[hi] - self.cc[lo]
        sums = self.cv[hi] - self.cv[lo]
        return np.where(ok & (cnt > 0),
                        sums / np.maximum(cnt, 1) / QV_SCALE, np.nan)


#: weight of the B read's intrinsic QV rate in the depth-ranking score. The
#: pair trace rate already holds B's errors, and it alone separates
#: alignments across repeat copies, so the QV term enters small: enough to
#: sink intrinsically noisy B reads without diluting the pair signal.
QV_RANK_WEIGHT = 0.25


def _rank_scores(diffs: np.ndarray, spans: np.ndarray,
                 bq: np.ndarray | None) -> np.ndarray:
    """Depth-ranking score per overlap (lower ranks first): the pair
    trace-diff rate plus, when a QV track is loaded, the down-weighted
    intrinsic error rate of the B read. Overlaps whose B tiles have no QV
    coverage take the pile median, so unknown quality ranks neutral, not
    best. One function for both feeders, whose orders must agree."""
    score = diffs.astype(np.float64) / spans
    if bq is not None:
        valid = ~np.isnan(bq)
        fill = float(np.median(bq[valid])) if valid.any() else 0.0
        score = score + QV_RANK_WEIGHT * np.where(valid, bq, fill)
    return score


def _depth_order(diffs, abpos, aepos, bread, bbpos, bepos, comp,
                 qvr: QvRanker | None) -> np.ndarray:
    """The pile's overlaps best first (lowest :func:`_rank_scores`, stable),
    so the best alignments fill the depth slots: one rule for both feeders."""
    span = np.maximum(np.asarray(aepos) - np.asarray(abpos), 1)
    bq = None if qvr is None else qvr.rates(bread, bbpos, bepos, comp)
    return np.argsort(_rank_scores(np.asarray(diffs), span, bq), kind="stable")


def load_qv_ranker(db: DazzDB, las: LasFile, cfg: PipelineConfig) -> QvRanker | None:
    """The run's QV ranker, or None when ranking or the track is off, the
    track is absent, or its tile geometry does not match this LAS's tspace
    (a track written under another tspace would map the wrong tiles)."""
    if not cfg.qv_track or not cfg.depth_rank:
        return None
    try:
        payloads = read_track(db.path, cfg.qv_track)
    except FileNotFoundError:
        return None
    tspace = las.tspace
    if any(len(p) != (db.read_length(i) + tspace - 1) // tspace
           for i, p in enumerate(payloads)):
        return None
    return QvRanker(payloads, tspace, db)


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


def _sample_windows(db: DazzDB, las: LasFile, cfg: PipelineConfig):
    """The one strided pile sample (refined overlaps and cut windows of
    ``PROFILE_SAMPLE_PILES`` piles, one per strided range), shared by the
    profile pass and the paged family derivation."""
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
    return refined_all, windows_all


def estimate_profile_for_shard(db: DazzDB, las: LasFile, cfg: PipelineConfig,
                               return_windows: bool = False):
    """Profile pass over the strided pile sample. ``return_windows`` also
    returns the sampled windows, so a paged run derives its shape families
    from the same sample instead of sampling twice."""
    refined_all, windows_all = _sample_windows(db, las, cfg)
    prof = estimate_profile_two_pass(refined_all, windows_all, cfg.consensus,
                                     sample=32)
    return (prof, windows_all) if return_windows else prof


def families_from_windows(windows: list, cfg: PipelineConfig) -> list:
    """Shape families for the paged router from a window sample (its
    length x depth histogram). The sample only shifts family budgets, never
    correctness: the full-coverage family routes any window the sample did
    not predict."""
    shape = BatchShape(depth=cfg.depth, seg_len=cfg.seg_len, wlen=cfg.consensus.w)
    if windows:
        b = tensorize_windows([(0, ws) for ws in windows], shape)
        ns = b.nsegs
        pg = paging.window_pages(b.lens, cfg.page_len)
    else:
        ns = pg = np.zeros(0, np.int64)
    return paging.derive_families(
        ns, pg, max_depth=cfg.depth,
        max_pages=-(-cfg.depth * cfg.seg_len // cfg.page_len),
        budget=cfg.paged_families, page_len=cfg.page_len)


def derive_families_for_shard(db: DazzDB, las: LasFile, cfg: PipelineConfig) -> list:
    """:func:`families_from_windows` over a fresh pile sample, for a run whose
    profile was passed in (no profile-pass sample to reuse)."""
    _, windows_all = _sample_windows(db, las, cfg)
    return families_from_windows(windows_all, cfg)


def run_families(db: DazzDB, las: LasFile, cfg: PipelineConfig,
                 sample: list | None = None) -> list:
    """The shape families a paged run routes to: derived from the profile
    pass's ``sample`` when there is one (else from a fresh sample), each
    pool budget raised where needed so that one ``batch_size``-row pool
    holds at least one worst-case window of its family (or the router's
    budget cut could never make progress)."""
    fams = (families_from_windows(sample, cfg) if sample is not None
            else derive_families_for_shard(db, las, cfg))
    B = cfg.batch_size
    return [f if B * f.budget >= f.pages else
            paging.ShapeFamily(depth=f.depth, pages=f.pages, page_len=f.page_len,
                               pool_pages=-(-f.pages // B))
            for f in fams]


def paged_enabled(cfg: PipelineConfig, device) -> bool:
    """Whether a run ships paged batches: ``on``, or ``auto`` on cuda."""
    if cfg.paged not in ("on", "off", "auto"):
        raise ValueError(f"paged={cfg.paged!r}: expected on|off|auto")
    on = cfg.paged == "on" or (cfg.paged == "auto" and device.type == "cuda")
    if on and (cfg.page_len <= 0 or cfg.seg_len % cfg.page_len):
        raise ValueError(f"page_len {cfg.page_len} must be positive and divide "
                         f"seg_len {cfg.seg_len}")
    return on


def _window_one_pile(db: DazzDB, col: ColumnarLas, cfg: PipelineConfig,
                     aread: int, s: int, e: int, qvr: QvRanker | None):
    """Window one pile (records ``s:e`` of ``col``) through the host library;
    the one body of the synchronous and the threaded native feeder, so they
    write the same bytes. Runs in the feeder threads."""
    a = db.read_bases(aread)
    order = None
    if cfg.depth_rank:
        order = _depth_order(col.diffs[s:e], col.abpos[s:e], col.aepos[s:e],
                             col.bread[s:e], col.bbpos[s:e], col.bepos[s:e],
                             col.comp[s:e], qvr)
    idxs = np.arange(s, e) if order is None else s + order
    b_reads = db.read_bases_batch(col.bread[idxs])
    seqs, lens, nsegs = process_pile_native(a, col, s, e, b_reads, cfg.consensus.w,
                                            cfg.consensus.adv, cfg.depth,
                                            cfg.seg_len, order=order)
    return aread, a, seqs, lens, nsegs


def iter_pile_blocks(db: DazzDB, las: LasFile, cfg: PipelineConfig,
                     qvr: QvRanker | None = None):
    """Yield (aread, a_bases, seqs [nwin,D,L], lens [nwin,D], nsegs [nwin])
    per pile, windowed on the host: by the host library (``use_native``),
    else by the numpy feeder. Both write the same bytes."""
    if cfg.use_native:
        col = ColumnarLas(las.path)
        for aread, s, e in col.piles():
            yield _window_one_pile(db, col, cfg, aread, s, e, qvr)
        return
    w, adv = cfg.consensus.w, cfg.consensus.adv
    shape = BatchShape(depth=cfg.depth, seg_len=cfg.seg_len, wlen=w)
    for aread, pile in las.iter_piles():
        a = db.read_bases(aread)
        if cfg.depth_rank and pile:
            cols = [[getattr(o, f) for o in pile] for f in (
                "diffs", "abpos", "aepos", "bread", "bbpos", "bepos", "is_comp")]
            pile = [pile[i] for i in _depth_order(*cols, qvr)]
        refined = [refine_overlap(o, a, db.read_bases(o.bread), las.tspace)
                   for o in pile]
        windows = cut_windows(a, refined, w=w, adv=adv)
        b = tensorize_windows([(aread, ws) for ws in windows], shape)
        yield aread, a, b.seqs, b.lens, b.nsegs


def iter_pile_blocks_threaded(db: DazzDB, las: LasFile, cfg: PipelineConfig,
                              nthreads: int, qvr: QvRanker | None = None):
    """The native stream of :func:`iter_pile_blocks`, windowed by
    ``nthreads`` threads with a bounded in-order prefetch of ``nthreads + 2``
    piles: the same blocks in the same order, so every downstream byte is
    the same; only the wall changes."""
    col = ColumnarLas(las.path)
    piles = iter(col.piles())
    with ThreadPoolExecutor(max_workers=nthreads) as ex:
        inflight: deque = deque()
        for item in piles:
            inflight.append(ex.submit(_window_one_pile, db, col, cfg, *item, qvr))
            if len(inflight) >= nthreads + 2:
                break
        while inflight:
            yield inflight.popleft().result()
            for item in piles:
                inflight.append(ex.submit(_window_one_pile, db, col, cfg, *item, qvr))
                break


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
    paged_on = paged_enabled(cfg, dev)
    if cfg.feeder_threads < 0 or (cfg.feeder_threads and not cfg.use_native):
        raise ValueError(f"feeder_threads={cfg.feeder_threads}: threads window "
                         "piles through the host library (use_native), 0 in the loop")
    qvr = load_qv_ranker(db, las, cfg)
    stats = PipelineStats(paged=paged_on, native_host=cfg.use_native,
                          qv_ranked=qvr is not None)
    t_start = time.perf_counter()
    sample = None
    if profile is None:
        t0 = time.perf_counter()
        if paged_on:
            profile, sample = estimate_profile_for_shard(db, las, cfg,
                                                         return_windows=True)
        else:
            profile = estimate_profile_for_shard(db, las, cfg)
        stats.profile_s = time.perf_counter() - t0
    ladder = TierLadder.from_config(profile, cfg.consensus, device=dev,
                                    route=cfg.dp_route)
    w, adv = cfg.consensus.w, cfg.consensus.adv
    B = cfg.batch_size
    min_depth = cfg.consensus.dbg.min_depth
    rescue_tiers = {i for i, t in enumerate(cfg.consensus.tiers) if t[1] <= 1}
    if paged_on:
        t0 = time.perf_counter()
        families = run_families(db, las, cfg, sample)
        stats.profile_s += time.perf_counter() - t0
        shapes = [BatchShape(depth=f.depth, seg_len=cfg.seg_len, wlen=w)
                  for f in families]
        cap_pages = [B * f.budget for f in families]
    else:
        families = None
        shapes = [BatchShape(depth=cfg.depth, seg_len=cfg.seg_len, wlen=w)]
    nb = len(shapes)

    pending: dict[int, _PendingRead] = {}
    order: list[int] = []
    ready: dict[int, list[np.ndarray]] = {}
    # per-bucket row buffers: blocks of (seqs, lens, nsegs, rid, widx, pages)
    blocks_of: list[list[tuple]] = [[] for _ in range(nb)]
    nrows = [0] * nb
    npages = [0] * nb
    first_seen: list[int | None] = [None] * nb   # n_reads at the oldest row

    def finalize_read(r: int, pr: _PendingRead) -> None:
        _trim_rescue_ends(pr, rescue_tiers, stats)
        ready[r] = stitch_results([x for x in pr.results if x is not None],
                                  cfg.consensus)
        del pending[r]

    def push(bi: int, cols: tuple) -> None:
        blocks_of[bi].append(cols)
        nrows[bi] += len(cols[2])
        npages[bi] += int(cols[5].sum())
        if first_seen[bi] is None:
            first_seen[bi] = stats.n_reads

    def pop_rows(bi: int, take: int) -> list[np.ndarray]:
        """Bucket ``bi``'s first ``take`` rows; the rest stay buffered and
        keep the oldest row's stamp."""
        cat = [np.concatenate([blk[i] for blk in blocks_of[bi]]) for i in range(6)]
        blocks_of[bi] = [tuple(a[take:] for a in cat)] if nrows[bi] > take else []
        nrows[bi] -= take
        if not nrows[bi]:
            first_seen[bi] = None
        rows = [a[:take] for a in cat]
        npages[bi] -= int(rows[5].sum())
        return rows

    def paged_take(bi: int, take: int) -> int:
        """The largest prefix of bucket ``bi`` (never zero rows) whose pages
        fit one pool: the guarantee behind pack_paged's budget check."""
        pages = np.concatenate([blk[5] for blk in blocks_of[bi]])[:take]
        fit = int(np.searchsorted(np.cumsum(pages), cap_pages[bi], side="right"))
        return max(min(take, fit), 1)

    def run_batch(bi: int, take: int) -> None:
        seqs, lens, nsg, rid, widx, _ = pop_rows(bi, take)
        batch = WindowBatch(seqs=seqs, lens=lens, nsegs=nsg, shape=shapes[bi],
                            read_ids=rid, wstarts=widx * adv)
        if paged_on:
            batch = paging.pack_paged(batch, families[bi], target_rows=B)
            stats.pad_cells += int(batch.pool.size)
        else:
            batch = pad_batch(batch, B)
            stats.pad_cells += int(batch.seqs.size)
        stats.used_cells += int(lens.sum())
        stats.h2d_bytes += sum(int(a.nbytes) for a in upload_arrays(batch))
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

    def run_batches(final: bool) -> None:
        for bi in range(nb):
            # a partial flush once the bucket's oldest row has waited too
            # long bounds the in-order emission lag under bucket skew
            stale = (first_seen[bi] is not None
                     and stats.n_reads - first_seen[bi] >= cfg.bucket_flush_reads)
            while (nrows[bi] >= B
                   or (paged_on and npages[bi] >= cap_pages[bi])
                   or ((final or stale) and nrows[bi] > 0)):
                stale = False
                take = min(B, nrows[bi])
                if paged_on:
                    take = paged_take(bi, take)
                run_batch(bi, take)

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

    blocks = (iter_pile_blocks_threaded(db, las, cfg, cfg.feeder_threads, qvr)
              if cfg.feeder_threads else iter_pile_blocks(db, las, cfg, qvr))
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
            rid = np.full(len(nsegs), aread, dtype=np.int64)
            if not len(nsegs):
                if pr.n_done == pr.n_windows:
                    finalize_read(aread, pr)
            elif paged_on:
                # family router: the smallest (depth, pages) family that
                # holds each window; rows keep only the family's depth
                pgs = paging.window_pages(lens, cfg.page_len)
                assign = paging.assign_family(families, nsegs, pgs)
                for bi in range(nb):
                    sel = np.nonzero(assign == bi)[0]
                    if len(sel):
                        Df = families[bi].depth
                        push(bi, (seqs[sel, :Df], lens[sel, :Df], nsegs[sel],
                                  rid[sel], widx[sel], pgs[sel]))
            else:
                push(0, (seqs, lens, nsegs, rid, widx,
                         np.zeros(len(nsegs), np.int64)))
        run_batches(final=False)
        yield from emit_ready()
    run_batches(final=True)
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
