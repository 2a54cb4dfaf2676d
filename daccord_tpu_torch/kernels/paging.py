"""Ragged paged window batching: shape-family pages instead of dense rectangles.

The port of ``daccord_tpu/kernels/paging.py``. A dense batch ships every
dead cell between a segment's real length and the global (D, L) maxima.
Paged, segment bases live in a flat **page pool** ``[n_pages, page_len]``
(int8) addressed by a per-window **page table** ``[B, pages_per_window]``,
and batches are bucketed into a few **shape families** ``(depth,
pages_per_window)`` quantized to powers of two, derived from the corpus
length x depth histogram.

Layout: each segment starts on a page boundary and occupies
``ceil(len/page_len)`` consecutive table slots of its window, in segment
order, so the device-side gather derives every offset from ``lens`` and the
host pack moves whole pages (one page-granular ``np.take``). Each family
carries a fixed per-window pool budget (``pool_pages``, the sample mean with
slack): the pool ships at ``1 + B * pool_pages`` rows, and the pipeline's
router cuts a batch early when its windows' pages would overflow it.

Paging changes which cells cross the bus, never any window's bytes: the
device-side gather (:func:`gather_windows`, through the hand-written kernel
``kernels/gather_pages.py`` on CUDA) rebuilds the exact dense ``[B, D, L]``
tile ``tensorize_windows`` would have produced, and the ladder runs
unchanged on it.

Page 0 of every pool is an all-PAD sentinel; unused table slots (windows
with fewer pages than the family width, pad rows) point there, so slicing
and padding a paged batch are table operations (:func:`slice_paged`,
:func:`pad_paged`, dispatched from ``tensorize.slice_batch``/``pad_batch``).

Pad-waste accounting: ``pad_waste()`` counts base-payload cells (the pool),
as the dense metric counts ``seqs`` only; the page table's bytes are real
transfer cost and are counted in ``shipped_cells``.

The host side is numpy; only :func:`gather_windows` touches torch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.bases import PAD
from ..utils.pages import page_counts, unpack_pages
from .gather_pages import gather_pages
from .tensorize import BatchShape, WindowBatch

#: default page length (bases). Segments are page-aligned, so rounding
#: waste averages PAGE_LEN/2 per segment — 16 keeps that under ~20% of a
#: typical w=40 window segment while the page stays a useful DMA/table
#: granule (4-byte table entry per 16-byte page). Must divide seg_len.
PAGE_LEN = 16

#: pool-budget slack over the sample mean pages/window (derive_families):
#: the corpus histogram drifts along a shard, and a budget cut exactly at
#: the mean would split every second batch.
POOL_SLACK = 1.15


@dataclass(frozen=True)
class ShapeFamily:
    """One paged batch shape: ``depth`` rows in the lens table, ``pages``
    table slots per window (drawn from a power-of-two grid capped at the
    structural maxima, which keeps the number of shapes bounded) and the
    fixed per-window ``pool_pages`` budget the shipped pool is sized by."""

    depth: int
    pages: int
    page_len: int = PAGE_LEN
    pool_pages: int = 0     # per-window pool budget; 0 = structural (pages)

    @property
    def budget(self) -> int:
        """Effective per-window pool budget in pages."""
        return self.pool_pages if self.pool_pages > 0 else self.pages

    def pool_rows(self, batch_size: int) -> int:
        """Static pool row count for a ``batch_size``-wide dispatch."""
        return 1 + batch_size * self.budget

    def describe(self) -> str:
        return f"D{self.depth}xP{self.pages}x{self.page_len}b{self.budget}"


@dataclass
class PagedWindowBatch:
    """Paged wire format of one window batch.

    ``pool`` is shared (never row-sliced): ``table`` rows index into it, and
    row 0 is the all-PAD sentinel every unused slot points at. ``lens``/
    ``nsegs`` are exactly the dense batch's — the gather derives every page
    offset from ``lens`` alone (page-aligned segments in segment order per
    window). Pool cells past a segment's last base are undefined (never
    PAD-scrubbed): every consumer masks by ``lens``, and scrubbing would put
    a full-pool memset back on the feeder hot path.
    """

    pool: np.ndarray       # int8 [n_pages, page_len]; row 0 = PAD sentinel
    table: np.ndarray      # int32 [B, pages]; 0 = sentinel/unused slot
    lens: np.ndarray       # int32 [B, D]
    nsegs: np.ndarray      # int32 [B]
    family: ShapeFamily
    shape: BatchShape      # dense-equivalent shape (gather target [B, D, L])
    read_ids: np.ndarray   # int64 [B]
    wstarts: np.ndarray    # int64 [B]
    stream: str = "full"   # as WindowBatch.stream
    job: str = ""          # as WindowBatch.job

    @property
    def size(self) -> int:
        return len(self.nsegs)

    @property
    def shipped_cells(self) -> int:
        """Total cells this batch ships: payload pool plus the page table in
        cell units (int32 = 4 cells each) — the honest transfer cost."""
        return int(self.pool.size) + int(self.table.size) * 4

    def pad_waste(self) -> float:
        """Fraction of shipped PAYLOAD cells that are dead (dense-comparable
        form of the dense pad waste; see the module docstring)."""
        used = int(self.lens.sum())
        return 1.0 - used / max(int(self.pool.size), 1)

    def to_dense(self) -> WindowBatch:
        """Host-side unpack to the exact dense batch that was packed (the
        round-trip inverse of :func:`pack_paged`)."""
        seqs = unpack_pages(self.pool, self.table, self.lens, self.shape.depth,
                            self.shape.seg_len, self.family.page_len)
        return WindowBatch(seqs=seqs, lens=np.asarray(self.lens).copy(),
                           nsegs=self.nsegs.copy(), shape=self.shape,
                           read_ids=self.read_ids.copy(),
                           wstarts=self.wstarts.copy(), stream=self.stream,
                           job=self.job)


def window_pages(lens: np.ndarray, page_len: int = PAGE_LEN) -> np.ndarray:
    """Pages per window ([B] from lens [B, D]): page-aligned segments, so
    the sum of per-segment page counts — the family router's second
    coordinate next to nsegs, and the pool-budget unit."""
    return page_counts(lens, page_len).sum(axis=1).astype(np.int64)


def pack_paged(batch: WindowBatch, family: ShapeFamily,
               target_rows: int | None = None) -> PagedWindowBatch:
    """Pack a dense batch into ``family``'s paged wire format.

    ``target_rows`` pads the TABLE side to the dispatch width with sentinel
    rows (cheap — no dense pad tile is ever materialized); the pool is sized
    at ``family.pool_rows(target_rows)``. Every window must fit the family
    (``nsegs <= depth``, pages <= ``pages``) and the batch must fit the pool
    budget — the router guarantees both; violated invariants raise, because
    a silently truncated window would break byte identity.

    The copy is PAGE-granular (one ``np.take`` of whole pool rows out of the
    dense tile viewed as pages, plus one table scatter): index arrays scale
    with page count, not byte count — this runs on the feeder hot path per
    dispatch, where per-byte index math measured ~10x the feeder-wall budget.
    Pool cells past a segment's last base are deliberately left undefined
    (see PagedWindowBatch); only the sentinel page is scrubbed.
    """
    B = batch.size
    rows = B if target_rows is None else int(target_rows)
    assert rows >= B
    D, L = batch.shape.depth, batch.shape.seg_len
    PL = family.page_len
    if L % PL:
        raise ValueError(f"page_len {PL} must divide seg_len {L}")
    if D > family.depth:
        raise ValueError(f"batch depth {D} exceeds family depth {family.depth}")
    lens = np.asarray(batch.lens)
    pps = page_counts(lens, PL)                              # [B, D]
    wp = pps.sum(axis=1)                                     # [B]
    if B and int(wp.max(initial=0)) > family.pages:
        raise ValueError("window exceeds family page budget "
                         f"({int(wp.max())} > {family.pages})")
    n_rows = family.pool_rows(rows)
    n_used = int(wp.sum())
    if n_used > n_rows - 1:
        raise ValueError(f"batch needs {n_used} pages; pool budget is "
                         f"{n_rows - 1} (router must cut the batch)")
    pool = np.empty((n_rows, PL), dtype=np.int8)
    pool[0] = PAD                                            # sentinel page
    if n_used:
        # dense pages of live segments, in (window, segment, page) order —
        # exactly the pool order, so one page-granular take fills the body.
        # Index arrays are built per live SEGMENT (repeat + ragged arange),
        # never by scanning the [B, D, L/PL] grid
        pps_f = pps.reshape(-1)
        rnz = np.nonzero(pps_f)[0].astype(np.int32)
        pc = pps_f[rnz]
        ra = np.arange(n_used, dtype=np.int32) - np.repeat(
            (np.cumsum(pc, dtype=np.int32) - pc), pc)
        np.take(batch.seqs.reshape(B * D * (L // PL), PL),
                np.repeat(rnz * np.int32(L // PL), pc) + ra, axis=0,
                out=pool[1 : 1 + n_used])
    table = np.zeros((rows, family.pages), dtype=np.int32)
    if n_used:
        # window b's wp[b] slots hold consecutive pool pages; same
        # repeat + ragged-arange construction at window granularity
        wnz = np.nonzero(wp)[0].astype(np.int32)
        wc = wp[wnz].astype(np.int32)
        wa = np.arange(n_used, dtype=np.int32) - np.repeat(
            np.cumsum(wc, dtype=np.int32) - wc, wc)
        table.reshape(-1)[np.repeat(wnz * np.int32(family.pages), wc) + wa] = \
            np.arange(1, n_used + 1, dtype=np.int32)

    def _pad_rows(a, fill=0):
        if rows == B:
            return a
        out = np.full((rows,) + a.shape[1:], fill, dtype=a.dtype)
        out[:B] = a
        return out

    return PagedWindowBatch(
        pool=pool, table=table, lens=_pad_rows(lens),
        nsegs=_pad_rows(batch.nsegs), family=family,
        shape=BatchShape(depth=D, seg_len=L, wlen=batch.shape.wlen),
        read_ids=_pad_rows(batch.read_ids, fill=-1),
        wstarts=_pad_rows(batch.wstarts), stream=batch.stream, job=batch.job)


def unpack_paged(pb: PagedWindowBatch) -> WindowBatch:
    """Alias of :meth:`PagedWindowBatch.to_dense` (the property-test name)."""
    return pb.to_dense()


def slice_paged(pb: PagedWindowBatch, lo: int, hi: int) -> PagedWindowBatch:
    """Row slice [lo, hi) — table/lens/nsegs/ids views; the pool is SHARED
    (page indices stay valid), so a slice costs O(rows), not a pool copy.
    Mirrors tensorize.slice_batch's field semantics."""
    return dataclasses.replace(
        pb, table=pb.table[lo:hi], lens=pb.lens[lo:hi], nsegs=pb.nsegs[lo:hi],
        read_ids=pb.read_ids[lo:hi], wstarts=pb.wstarts[lo:hi])


def pad_paged(pb: PagedWindowBatch, target: int) -> PagedWindowBatch:
    """Pad to ``target`` windows: appended rows carry zero lens/nsegs and a
    sentinel-page table row, so they gather to all-PAD tiles exactly like
    dense pad rows (and can never be rescue candidates). The pool keeps its
    shape, so a slice+pad round trip keeps the pool operand."""
    B = pb.size
    if B == target:
        return pb
    assert B < target
    table = np.zeros((target, pb.table.shape[1]), dtype=np.int32)
    table[:B] = pb.table
    lens = np.zeros((target, pb.lens.shape[1]), dtype=np.int32)
    lens[:B] = pb.lens
    nsegs = np.zeros(target, dtype=np.int32)
    nsegs[:B] = pb.nsegs
    read_ids = np.full(target, -1, dtype=np.int64)
    read_ids[:B] = pb.read_ids
    wstarts = np.zeros(target, dtype=np.int64)
    wstarts[:B] = pb.wstarts
    return dataclasses.replace(pb, table=table, lens=lens, nsegs=nsegs,
                               read_ids=read_ids, wstarts=wstarts)


# ---------------------------------------------------------------------------
# device-side gather: paged wire -> the exact dense [B, D, L] tile
# ---------------------------------------------------------------------------

def gather_windows(pool: torch.Tensor, table: torch.Tensor, lens: torch.Tensor,
                   *, page_len: int, seg_len: int) -> torch.Tensor:
    """Rebuild the dense ``[B, D, L]`` int8 tile on the tensors' device.

    Segment ``d`` of a window starts at table slot ``cumsum(ceil(lens /
    page_len))[d]`` (page-aligned segments), so position ``j`` lives in slot
    ``start + j // page_len`` at cell ``j % page_len``, derived from ``lens``
    alone. The page gather (the bytes-heavy half) is
    :func:`gather_pages.gather_pages`: the kernel on CUDA, ``pool[table]`` on
    the CPU. The index math after it and the PAD mask are torch, as they are
    XLA in the JAX package (its ``use_pallas`` branch)."""
    B, PPW = table.shape
    D = lens.shape[1]
    L, PL = seg_len, page_len
    dev = lens.device
    pps = (lens.to(torch.int64) + (PL - 1)) // PL                # [B, D] pages/seg
    off = torch.cumsum(pps, dim=1) - pps                          # excl slot index
    j = torch.arange(L, dtype=torch.int64, device=dev)
    flat = gather_pages(pool, table).reshape(B, PPW * PL)
    idx = (off[:, :, None] * PL + j).clamp(0, PPW * PL - 1).reshape(B, D * L)
    dense = torch.gather(flat, 1, idx).reshape(B, D, L)
    return torch.where(j < lens[:, :, None], dense,
                       torch.full((), PAD, dtype=torch.int8, device=dev))


# ---------------------------------------------------------------------------
# shape families: derived from the corpus length x depth histogram
# ---------------------------------------------------------------------------

def derive_families(nsegs: np.ndarray, pages: np.ndarray, *, max_depth: int,
                    max_pages: int, budget: int = 4,
                    page_len: int = PAGE_LEN) -> list[ShapeFamily]:
    """Pick <= ``budget`` shape families from a window sample.

    Candidate grid = power-of-two (depth, pages) cells up to the structural
    maxima; the full-coverage family is always included (every window must
    route somewhere). The rest are chosen greedily: each step adds the
    candidate that most reduces the sample's total table-slot cost (every
    window costs the CHEAPEST fitting family's page width — the pool is
    usage-sized, so family choice governs table width and budget fit) until
    the budget is exhausted or nothing saves. Each family then gets its
    ``pool_pages`` budget from the mean pages of the windows it would serve
    (x ``POOL_SLACK``). Replaces the hand-tuned ``depth_buckets=(8,16)`` /
    empty ``seg_len_buckets`` defaults with families grounded in the corpus
    itself; deterministic for a given sample. Returns families sorted by
    (pages, depth) — router order.
    """
    nsegs = np.asarray(nsegs, dtype=np.int64)
    pages = np.asarray(pages, dtype=np.int64)
    # pow2 candidate grid BELOW the structural maxima, plus the exact maxima
    # themselves: rounding the full-coverage family UP past max_depth would
    # hand the router a family deeper than the feeder's tensors (a non-pow2
    # --depth then crashes at the first pack)
    d_top = max(int(max_depth), 1)
    p_top = max(int(max_pages), 1)
    d_grid = sorted({1 << i for i in range(d_top.bit_length())
                     if (1 << i) <= d_top} | {d_top})
    p_grid = sorted({1 << i for i in range(p_top.bit_length())
                     if (1 << i) <= p_top} | {p_top})
    full = (d_top, p_top)
    chosen: list[tuple[int, int]] = [full]

    def cost(fams: list[tuple[int, int]]) -> int:
        c = np.full(len(nsegs), np.iinfo(np.int64).max, dtype=np.int64)
        for d, p in fams:
            fits = (nsegs <= d) & (pages <= p)
            c = np.where(fits, np.minimum(c, p), c)
        return int(c.sum())

    if len(nsegs):
        cur = cost(chosen)
        cands = [(d, p) for d in d_grid for p in p_grid if (d, p) != full]
        while len(chosen) < max(budget, 1) and cands:
            best, best_cost = None, cur
            for c in cands:
                cc = cost(chosen + [c])
                if cc < best_cost:
                    best, best_cost = c, cc
            if best is None:
                break
            chosen.append(best)
            cands.remove(best)
            cur = best_cost
    chosen.sort(key=lambda dp: (dp[1], dp[0]))
    fams = [ShapeFamily(depth=d, pages=p, page_len=page_len)
            for d, p in chosen]
    if len(nsegs) == 0:
        return fams
    # pool budgets from the windows each family would actually serve
    assign = assign_family(fams, nsegs, pages)
    out = []
    for fi, f in enumerate(fams):
        mine = pages[assign == fi]
        if len(mine):
            bud = min(max(int(np.ceil(float(mine.mean()) * POOL_SLACK)), 1),
                      f.pages)
        else:
            bud = f.pages
        out.append(ShapeFamily(depth=f.depth, pages=f.pages,
                               page_len=page_len, pool_pages=bud))
    return out


def assign_family(families: list[ShapeFamily], nsegs: np.ndarray,
                  pages: np.ndarray) -> np.ndarray:
    """Index of the cheapest family fitting each window ([B] int64).

    Families are in router order (sorted by pages then depth), so the first
    fit is the cheapest table width; the mandatory full-coverage family
    guarantees every window lands. Raises if one doesn't (a window deeper/
    longer than the structural maxima would otherwise truncate silently).
    """
    nsegs = np.asarray(nsegs)
    pages = np.asarray(pages)
    out = np.full(len(nsegs), -1, dtype=np.int64)
    for fi in reversed(range(len(families))):
        f = families[fi]
        fits = (nsegs <= f.depth) & (pages <= f.pages)
        out = np.where(fits, fi, out)
    if len(out) and out.min() < 0:
        bad = int(np.nonzero(out < 0)[0][0])
        raise ValueError(
            f"window (nsegs={int(nsegs[bad])}, pages={int(pages[bad])}) fits "
            f"no family; largest is {families[-1].describe()}")
    return out
