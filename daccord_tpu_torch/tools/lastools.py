"""The LAS tools: intrinsic QV, repeat detection, alignment filtering.

The port's copy of ``daccord_tpu/tools/lastools.py``, the passes of the
upstream daccord workflow that run before ``daccord``:

- ``computeintrinsicqv`` -> :func:`compute_intrinsic_qv` (track ``inqual``:
  one QV byte per tspace tile per read, which the pipeline's depth ranking
  reads)
- ``lasdetectsimplerepeats`` -> :func:`detect_repeats` (interval track
  ``rep``: int64 start/end pairs per read)
- ``lasfilteralignments`` -> :func:`filter_alignments` (drops alignments
  whose error profile is inconsistent with the unique-region profile)
- ``filtersym`` -> :func:`filter_symmetric` (keep A->B iff B->A)

Each is a streaming pass over the LAS piles, run as its own process and
composed through the filesystem, so each restarts on its own.

The first three run on the host library's columnar LAS load with numpy
vector math, and require it: no build raises, nothing falls back. Their
per-pile python bodies stay as ``*_plain`` (byte-equal, for the tests); a
``mem:`` LAS, which the C++ loader cannot open, takes them.

QV convention: ``qv = clip(round(QV_SCALE * rate), 0, 250)``, ``rate`` the
per-tile error rate of the depth-d quantile alignment; 251..255 reserved
(``QV_NOCOV`` = 255: no coverage).
"""

from __future__ import annotations

import numpy as np

from ..formats.dazzdb import DazzDB, read_track, write_track
from ..formats.las import LasFile, Overlap, write_las
from ..utils.aio import is_mem

QV_NOCOV = 255
QV_SCALE = 200.0


def _pile_tile_rates(db: DazzDB, aread: int, pile: list[Overlap], tspace: int):
    """Per-tile lists of alignment error rates for one A read."""
    rlen = db.read_length(aread)
    ntiles = (rlen + tspace - 1) // tspace
    rates: list[list[float]] = [[] for _ in range(ntiles)]
    for o in pile:
        bounds = o.tile_bounds(tspace)
        for t in range(len(bounds) - 1):
            a0, a1 = int(bounds[t]), int(bounds[t + 1])
            tl = a1 - a0
            if tl <= 0:
                continue
            g = a0 // tspace
            # pair diffs count both reads' errors; halve for a per-read rate
            rates[g].append(0.5 * float(o.trace[t, 0]) / tl)
    return rates


def _read_lengths(db: DazzDB, lo: int = 0, hi: int | None = None) -> np.ndarray:
    hi = db.nreads if hi is None else hi
    return np.fromiter((db.reads[i].rlen for i in range(lo, hi)), np.int64, hi - lo)


def _tile_table(db: DazzDB, tspace: int, lo: int = 0, hi: int | None = None) -> np.ndarray:
    """Tile offsets over reads [lo, hi): tile_base[i] .. tile_base[i+1] are
    read lo+i's tiles. Block jobs pass their read range so every flat array
    downstream is O(block), not O(whole DB)."""
    ntiles = (_read_lengths(db, lo, hi) + tspace - 1) // tspace
    tile_base = np.zeros(len(ntiles) + 1, np.int64)
    np.cumsum(ntiles, out=tile_base[1:])
    return tile_base


def _block_range(db: DazzDB, las: LasFile, block: int | None) -> tuple[int, int, int | None, int | None]:
    """(lo, hi, byte_start, byte_end) of DB block ``block`` (1-based);
    ``block=None`` is the whole run (all reads, the whole file)."""
    if block is None:
        return 0, db.nreads, None, None
    from ..formats.dazzdb import db_blocks
    from ..formats.las import range_for_areads

    blocks = db_blocks(db.path)
    if not (1 <= block <= len(blocks)):
        raise ValueError(f"block {block}: DB has {len(blocks)} blocks")
    lo, hi = blocks[block - 1]
    start, end = range_for_areads(las.path, lo, hi)
    return lo, hi, start, end


def _intrinsic_qv_native(db: DazzDB, las: LasFile, depth: int,
                         rlo: int = 0, rhi: int | None = None,
                         byte_range=(None, None)) -> list[np.ndarray]:
    """The QV pass over the host library's columnar LAS load, vectorized;
    byte-equal to the per-pile python of :func:`compute_intrinsic_qv_plain`.
    Every flat array covers reads [rlo, rhi) alone, so block jobs stay
    O(block)."""
    from ..native.api import ColumnarLas

    rhi = db.nreads if rhi is None else rhi
    col = ColumnarLas(las.path, *byte_range)
    tspace = col.tspace
    tile_base = _tile_table(db, tspace, rlo, rhi)
    qv_flat = np.full(int(tile_base[-1]), QV_NOCOV, dtype=np.uint8)

    if col.novl:
        T = (np.diff(col.trace_off) // 2).astype(np.int64)   # tiles per overlap
        n = col.novl
        total = int(T.sum())
        ov = np.repeat(np.arange(n), T)
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(T, out=starts[1:])
        tloc = np.arange(total, dtype=np.int64) - np.repeat(starts[:-1], T)
        g = col.abpos.astype(np.int64)[ov] // tspace + tloc  # per-read tile id
        lo = np.maximum(col.abpos[ov], g * tspace)
        hi = np.minimum(col.aepos[ov], (g + 1) * tspace)
        tl = hi - lo
        dif = col.trace_flat[np.repeat(col.trace_off[:-1], T) + 2 * tloc]
        ok = tl > 0
        gid = (tile_base[col.aread.astype(np.int64)[ov] - rlo] + g)[ok]
        # the expression of the per-pile pass: (0.5 * diff) / tile_len
        rate = 0.5 * dif[ok].astype(np.float64) / tl[ok]
        order = np.lexsort((rate, gid))
        gid_s, rate_s = gid[order], rate[order]
        uniq, gstart, gcount = np.unique(gid_s, return_index=True, return_counts=True)
        sel = gstart + np.minimum(max(depth // 2, 1), gcount) - 1
        q = np.minimum(np.round(QV_SCALE * rate_s[sel]), 250).astype(np.uint8)
        qv_flat[uniq] = q
    return [qv_flat[tile_base[i] : tile_base[i + 1]] for i in range(rhi - rlo)]


def compute_intrinsic_qv(db: DazzDB, las: LasFile, depth: int = 20,
                         track: str = "inqual", block: int | None = None
                         ) -> list[np.ndarray]:
    """Per-read per-tile intrinsic QVs from the piles' error statistics,
    written as ``track``; returns the payloads.

    The depth-d quantile (the d-th lowest rate) is robust to repeat-induced
    piles: repeats add *worse* alignments and leave the best d mostly intact
    (``computeintrinsicqv -d``). With ``block``, only that DB block's reads
    are processed (through the LAS aread index) and a per-block track is
    written; merge the block tracks with ``formats.dazzdb.catrack``.
    """
    if is_mem(las.path):
        return compute_intrinsic_qv_plain(db, las, depth, track, block)
    lo, hi, start, end = _block_range(db, las, block)
    payloads = _intrinsic_qv_native(db, las, depth, lo, hi, byte_range=(start, end))
    write_track(db.path, track, payloads, block=block)
    return payloads


def compute_intrinsic_qv_plain(db: DazzDB, las: LasFile, depth: int = 20,
                               track: str = "inqual", block: int | None = None
                               ) -> list[np.ndarray]:
    """:func:`compute_intrinsic_qv` in per-pile python (the same track)."""
    tspace = las.tspace
    lo, hi, start, end = _block_range(db, las, block)
    payloads = [np.zeros(0, dtype=np.uint8)] * (hi - lo)
    for aread, pile in las.iter_piles(start, end):
        rates = _pile_tile_rates(db, aread, pile, tspace)
        qv = np.full(len(rates), QV_NOCOV, dtype=np.uint8)
        for t, rl in enumerate(rates):
            if not rl:
                continue
            rl = sorted(rl)
            q = rl[min(max(depth // 2, 1), len(rl)) - 1]
            qv[t] = min(int(round(QV_SCALE * q)), 250)
        payloads[aread - lo] = qv
    # reads with no pile get all-NOCOV tracks of the right length
    for i in range(hi - lo):
        if len(payloads[i]) == 0:
            nt = (db.read_length(lo + i) + tspace - 1) // tspace
            payloads[i] = np.full(nt, QV_NOCOV, dtype=np.uint8)
    write_track(db.path, track, payloads, block=block)
    return payloads


def _tile_coverage_native(db: DazzDB, las: LasFile, rlo: int = 0, rhi: int | None = None,
                          byte_range=(None, None)) -> tuple[np.ndarray, np.ndarray]:
    """(tile_base, cov_flat): per-tile alignment coverage over reads
    [rlo, rhi) from the host library's columnar load and a difference-array
    sweep. Interval deltas cancel within each read, so one global cumsum
    gives every read's coverage."""
    from ..native.api import ColumnarLas

    rhi = db.nreads if rhi is None else rhi
    col = ColumnarLas(las.path, *byte_range)
    tspace = col.tspace
    tile_base = _tile_table(db, tspace, rlo, rhi)
    delta = np.zeros(int(tile_base[-1]) + 1, dtype=np.int64)
    if col.novl:
        ar = col.aread.astype(np.int64) - rlo
        g0 = col.abpos.astype(np.int64) // tspace
        g1 = np.maximum(col.aepos.astype(np.int64) - 1, col.abpos) // tspace
        np.add.at(delta, tile_base[ar] + g0, 1)
        np.add.at(delta, tile_base[ar] + g1 + 1, -1)
    return tile_base, np.cumsum(delta[:-1])


def _load_qv_gate(db: DazzDB, qv_track: str | None, qv_max: int,
                  lo: int, hi: int, tspace: int, block: int | None = None):
    """Per-read boolean tile masks from an intrinsic-QV track: True = the
    tile is trustworthy enough to repeat-annotate. None when the track is
    absent or disabled, or its tile geometry does not match ``tspace``. In
    block mode the per-block track (from ``inqual --block``) comes first,
    then the merged whole-DB track."""
    if not qv_track:
        return None
    qv, base = None, 0
    if block is not None:
        try:
            qv, base = read_track(db.path, qv_track, block=block), lo
        except (FileNotFoundError, OSError):
            qv = None
    if qv is None:
        try:
            qv = read_track(db.path, qv_track)
        except (FileNotFoundError, OSError):
            return None
    gates = []
    for i in range(lo, hi):
        j = i - base
        q = qv[j] if 0 <= j < len(qv) else np.zeros(0, np.uint8)
        nt = (db.read_length(i) + tspace - 1) // tspace
        if len(q) != nt:   # track written under a different tspace
            return None
        gates.append(q <= qv_max)   # QV_NOCOV (255) masks automatically
    return gates


def _grow_intervals(iv: np.ndarray, grow_bases: int, rlen: int) -> np.ndarray:
    """Dilate [n,2] intervals by ``grow_bases`` on each side and merge.

    Coverage decays toward a repeat copy's edges (shorter overlaps don't
    qualify there), so thresholded tiles under-call the interval by a tile
    or two per side; an alignment confined to the repeat then shows a fake
    "unique" overhang that defeats the span test in ``filter_alignments``.
    """
    if len(iv) == 0 or grow_bases <= 0:
        return iv
    lo = np.maximum(iv[:, 0] - grow_bases, 0)
    hi = np.minimum(iv[:, 1] + grow_bases, rlen)
    out = [[int(lo[0]), int(hi[0])]]
    for s, e in zip(lo[1:], hi[1:]):
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], int(e))
        else:
            out.append([int(s), int(e)])
    return np.asarray(out, dtype=np.int64)


def _repeats_native(db, las, depth, cov_factor, lo, hi, start, end, qv_gate, grow):
    tspace = las.tspace
    tile_base, cov_flat = _tile_coverage_native(db, las, lo, hi,
                                                byte_range=(start, end))
    hot_flat = cov_flat > cov_factor * depth
    if qv_gate:
        # empty gate list == no reads in range: nothing to mask
        hot_flat &= np.concatenate(qv_gate)
    # global run extraction: a zero separator at every read boundary
    # keeps runs from merging across reads; one diff finds all runs
    seps = tile_base[1:-1]
    ext = np.insert(hot_flat.astype(np.int8), seps, 0)
    d = np.diff(np.concatenate([[0], ext, [0]]))
    p0 = np.nonzero(d == 1)[0]          # run starts, separator space
    p1 = np.nonzero(d == -1)[0]         # run ends (exclusive)
    # map back: subtract the number of separators inserted before p
    sep_pos = seps + np.arange(len(seps))   # separator indices in ext
    t0 = p0 - np.searchsorted(sep_pos, p0)
    t1 = p1 - np.searchsorted(sep_pos, p1)
    rid = np.searchsorted(tile_base, t0, side="right") - 1  # block-local ids
    rlens = _read_lengths(db, lo, hi)
    iv = np.empty((len(t0), 2), dtype=np.int64)
    iv[:, 0] = (t0 - tile_base[rid]) * tspace
    iv[:, 1] = np.minimum((t1 - tile_base[rid]) * tspace, rlens[rid])
    counts = np.bincount(rid, minlength=hi - lo)
    splits = np.split(iv, np.cumsum(counts)[:-1])
    payloads = [np.ascontiguousarray(
                    _grow_intervals(s, grow * tspace, int(rlens[i]))
                ).reshape(-1).view(np.uint8)
                for i, s in enumerate(splits)]
    return payloads


def _repeats_plain(db, las, depth, cov_factor, lo, hi, start, end, qv_gate, grow):
    tspace = las.tspace
    payloads = [np.zeros(0, dtype=np.uint8)] * (hi - lo)
    for aread, pile in las.iter_piles(start, end):
        rlen = db.read_length(aread)
        ntiles = (rlen + tspace - 1) // tspace
        cov = np.zeros(ntiles, dtype=np.int64)
        for o in pile:
            g0 = o.abpos // tspace
            g1 = (max(o.aepos - 1, o.abpos)) // tspace
            cov[g0 : g1 + 1] += 1
        hot = cov > cov_factor * depth
        if qv_gate is not None:
            hot &= qv_gate[aread - lo]
        ivals: list[int] = []
        t = 0
        while t < ntiles:
            if hot[t]:
                t0 = t
                while t < ntiles and hot[t]:
                    t += 1
                ivals.extend([t0 * tspace, min(t * tspace, rlen)])
            else:
                t += 1
        iv = np.asarray(ivals, dtype=np.int64).reshape(-1, 2)
        payloads[aread - lo] = np.ascontiguousarray(
            _grow_intervals(iv, grow * tspace, rlen)).reshape(-1).view(np.uint8)
    return payloads


def detect_repeats(db: DazzDB, las: LasFile, depth: int = 20,
                   cov_factor: float = 2.0, track: str = "rep",
                   block: int | None = None, qv_track: str | None = "inqual",
                   qv_max: int = 100, grow: int = 2) -> list[np.ndarray]:
    """Detect simple-repeat intervals from pile over-coverage.

    A tile whose alignment coverage exceeds ``cov_factor * depth`` is repeat-
    annotated; adjacent repeat tiles merge into intervals (int64 start/end
    pairs per read, written as track ``rep``), dilated by ``grow`` tiles a
    side (:func:`_grow_intervals`: undoes the edge erosion of tile-granular
    thresholding).

    With the intrinsic-QV track (``lasdetectsimplerepeats`` reads the
    output of ``computeintrinsicqv``), tiles whose QV is worse than
    ``qv_max`` are excluded: over-coverage where even the depth-d best
    alignment is junk is a low-quality pile-up, not a simple repeat, and
    annotating it would knock real alignments out in
    :func:`filter_alignments`. A missing or mismatched track leaves the
    detection to coverage alone.

    With ``block``, only that DB block is processed (a per-block track;
    merge with ``catrack``).
    """
    return _detect_repeats(db, las, depth, cov_factor, track, block, qv_track,
                           qv_max, grow, plain=is_mem(las.path))


def detect_repeats_plain(db: DazzDB, las: LasFile, depth: int = 20,
                         cov_factor: float = 2.0, track: str = "rep",
                         block: int | None = None, qv_track: str | None = "inqual",
                         qv_max: int = 100, grow: int = 2) -> list[np.ndarray]:
    """:func:`detect_repeats` in per-pile python (the same track)."""
    return _detect_repeats(db, las, depth, cov_factor, track, block, qv_track,
                           qv_max, grow, plain=True)


def _detect_repeats(db, las, depth, cov_factor, track, block, qv_track, qv_max,
                    grow, plain: bool) -> list[np.ndarray]:
    lo, hi, start, end = _block_range(db, las, block)
    qv_gate = _load_qv_gate(db, qv_track, qv_max, lo, hi, las.tspace, block)
    solve = _repeats_plain if plain else _repeats_native
    payloads = solve(db, las, depth, cov_factor, lo, hi, start, end, qv_gate, grow)
    write_track(db.path, track, payloads, block=block)
    return payloads


def read_repeat_track(db: DazzDB, track: str = "rep") -> list[np.ndarray]:
    """Interval track back as [n, 2] int64 arrays."""
    raw = read_track(db.path, track)
    return [r.view(np.int64).reshape(-1, 2) if len(r) else np.zeros((0, 2), dtype=np.int64)
            for r in raw]


_MBINS = 1 << 20   # rate-histogram resolution for the streaming exact median


def _rate_bins(r: np.ndarray) -> np.ndarray:
    # rates live in [0, ~0.5]; anything >= 1 (pathological traces) shares the
    # overflow bin. Binning is pure float64 multiply+floor, so every pass
    # maps a given record to the same bin deterministically.
    return np.minimum((r * _MBINS).astype(np.int64), _MBINS)


class _StreamMedian:
    """Exact ``np.median`` over a streamed sequence in O(bins) memory.

    Pass 1 (:meth:`add`) histograms the values; :meth:`plan` locates the
    bins holding the middle order statistics; pass 2 (:meth:`collect`)
    gathers only the values in those bins (bins strictly between the two
    middle bins are provably empty); :meth:`result` reproduces ``np.median``
    exactly — same middle elements, same float mean of the two."""

    def __init__(self):
        self.hist = np.zeros(_MBINS + 1, dtype=np.int64)
        self.n = 0
        self._bins: np.ndarray | None = None
        self._vals: list[np.ndarray] = []

    def add(self, vals: np.ndarray) -> None:
        if len(vals):
            # touch only the bins present: a minlength=_MBINS bincount would
            # allocate 8 MB per call, paid once per pile in the python pass
            u, c = np.unique(_rate_bins(vals), return_counts=True)
            self.hist[u] += c
            self.n += len(vals)

    def plan(self) -> None:
        if self.n == 0:
            raise ValueError("_StreamMedian.plan() on an empty stream "
                             "(no values added)")
        k1, k2 = (self.n - 1) // 2, self.n // 2
        cum = np.cumsum(self.hist)
        b1 = int(np.searchsorted(cum, k1 + 1))
        b2 = int(np.searchsorted(cum, k2 + 1))
        self._k1, self._k2 = k1, k2
        self._below = int(cum[b1 - 1]) if b1 else 0
        self._bins = np.unique([b1, b2])

    def collect(self, vals: np.ndarray) -> None:
        if len(vals):
            m = np.isin(_rate_bins(vals), self._bins)
            if m.any():
                self._vals.append(np.asarray(vals[m], dtype=np.float64))

    def result(self) -> float:
        v = np.sort(np.concatenate(self._vals))
        v1 = v[self._k1 - self._below]
        v2 = v[self._k2 - self._below]
        return float(v1) if self._k1 == self._k2 else float((v1 + v2) / 2.0)


def _chunk_filter_stats(col, reps):
    """(prates, uspan, alen) of one columnar chunk: the per-record math of
    the whole-file and the bounded-memory passes, shared so they cannot
    diverge."""
    n = col.novl
    alen = np.maximum(col.aepos.astype(np.int64) - col.abpos, 1)
    pairs = col.trace_flat[::2]
    if len(pairs):
        # a zero sentinel keeps trailing empty-trace groups in range
        # without clipping into the previous group's last element;
        # zero-length groups (which alias the next group's first
        # element under reduceat) are masked after
        pairs_s = np.concatenate([pairs, [0]])
        dsum = np.add.reduceat(pairs_s, col.trace_off[:-1] // 2)
        dsum = np.where(np.diff(col.trace_off) > 0, dsum, 0)
    else:
        dsum = np.zeros(n, np.int64)
    prates = dsum / alen
    rep_reads = ({i for i in range(len(reps)) if len(reps[i])}
                 if reps is not None else set())
    uspan = (col.aepos.astype(np.int64) - col.abpos).copy()
    if rep_reads:
        # repeat-bearing reads dominate exactly the piles this tool
        # targets, so the subtraction is grouped by read and done with
        # searchsorted against the read's interval boundaries instead
        # of a per-record Python loop
        sel = np.nonzero(np.isin(
            col.aread, np.fromiter(rep_reads, np.int64)))[0]
        sel = sel[np.argsort(col.aread[sel], kind="stable")]
        grp = np.split(sel, np.nonzero(np.diff(col.aread[sel]))[0] + 1)
        for g in grp:
            if not len(g):
                continue
            a = int(col.aread[g[0]])
            iv = np.asarray(reps[a], dtype=np.int64).reshape(-1, 2)
            st, en = iv[:, 0], iv[:, 1]
            ab = col.abpos[g].astype(np.int64)
            ae = col.aepos[g].astype(np.int64)
            if len(iv) and np.all(st[1:] >= en[:-1]):
                # sorted disjoint intervals (the track writer's
                # invariant): covered length via prefix sums minus
                # the two end overhangs
                cum = np.concatenate([[0], np.cumsum(en - st)])
                i0 = np.searchsorted(en, ab, side="right")
                i1 = np.searchsorted(st, ae, side="left")
                has = i1 > i0
                cov = cum[i1] - cum[i0]
                cov -= np.where(has, np.maximum(
                    0, ab - st[np.minimum(i0, len(iv) - 1)]), 0)
                cov -= np.where(has, np.maximum(
                    0, en[np.maximum(i1, 1) - 1] - ae), 0)
                uspan[g] = (ae - ab) - cov
            else:
                for j, i in enumerate(g):
                    span = int(ae[j] - ab[j])
                    for s, e in reps[a]:
                        span -= max(0, min(int(ae[j]), int(e))
                                    - max(int(ab[j]), int(s)))
                    uspan[i] = span
    return prates, uspan, alen


def _pile_keep(prates, uspan, alen, pile_starts, gmed: float,
               max_err: float | None, min_unique_span: int,
               rep_margin: float) -> np.ndarray:
    """The per-pile consistency rule (of the whole-file and the chunked
    passes)."""
    is_uniq = uspan >= min_unique_span
    span_ok = alen >= min_unique_span
    keep = np.zeros(len(prates), dtype=bool)
    for p in range(len(pile_starts) - 1):
        s, e = int(pile_starts[p]), int(pile_starts[p + 1])
        u = is_uniq[s:e]
        med = float(np.median(prates[s:e][u])) if u.sum() >= 5 else gmed
        cut = max_err if max_err is not None else max(2.0 * med, med + 0.15)
        keep[s:e] = np.where(
            u, prates[s:e] <= cut,
            prates[s:e] <= med + rep_margin) & span_ok[s:e]
    return keep


def filter_alignments(db: DazzDB, las: LasFile, out_path: str,
                      max_err: float | None = None,
                      repeat_track: str | None = "rep",
                      min_unique_span: int = 100,
                      rep_margin: float = 0.015,
                      mem_records: int | None = None) -> int:
    """Drop alignments inconsistent with the unique-region error profile.

    The paper's "local genomic consistency analysis" at the file level
    (``lasfilteralignments``: it drops alignments inconsistent with the
    unique-region error profile):

    - alignments with >= ``min_unique_span`` bases outside repeat intervals
      ("unique" alignments) are kept unless their error rate is far above
      the pile median (2x / +0.15, or the explicit ``max_err``);
    - alignments confined to repeat intervals are kept ONLY while their
      error rate stays within ``rep_margin`` of the unique-region rate
      profile. Same-copy alignments inside a repeat match the unique
      profile; cross-copy alignments carry the copies' divergence on top of
      it — the consistency test separates them where a blanket confined-
      alignment drop would starve every repeat-interior pile of its true
      alignments (a blanket drop cost 2.3 Q on a simulated two-copy repeat of 3%
      divergence in the JAX package).

    The unique-rate reference is the pile's median over its own unique
    alignments when it has >= 5 of them, else the file-wide median.

    ``mem_records``: bound peak memory to ~that many records at a time (the
    pre-filter LAS is by design the largest file of the workflow; at
    CHM-scale 1e9 records the whole-file columnar load would need 40+ GB).
    The streaming variant makes pile-aligned chunked passes — histogram +
    exact-median-collect + apply — and writes kept records as it goes;
    the output is byte-identical to the whole-file pass.

    It runs on the host library's columnar load (a ``mem:`` LAS takes
    :func:`filter_alignments_plain`).
    """
    if is_mem(las.path):
        return filter_alignments_plain(db, las, out_path, max_err, repeat_track,
                                       min_unique_span, rep_margin, mem_records)
    tspace = las.tspace
    reps = _repeat_intervals(db, repeat_track)
    if mem_records is not None and mem_records <= 0:
        mem_records = None   # 0 / negative: "no bound", not a chunk size
    # columnar passes: per-overlap rates and per-pile medians vectorized;
    # only overlaps on repeat-annotated reads pay the interval check
    from ..formats.las import shard_ranges
    from ..native.api import ColumnarLas

    if mem_records is not None and las.novl > mem_records:
        ranges = [r for r in shard_ranges(
            las.path, max(1, -(-las.novl // mem_records))) if r[0] < r[1]]
    else:
        ranges = None

    rec_iter = iter(las)

    def stream_write(keep_per_chunk):
        def kept_iter():
            for keep in keep_per_chunk:
                for flag in keep:
                    o = next(rec_iter)
                    if flag:
                        yield o
        return write_las(out_path, tspace, kept_iter())

    if ranges is None:
        # whole-file: one parse, one stats computation, direct median
        col = ColumnarLas(las.path)
        if not col.novl:
            return write_las(out_path, tspace, iter(()))
        pr, uspan, alen = _chunk_filter_stats(col, reps)
        uq = uspan >= min_unique_span
        gmed = float(np.median(pr[uq])) if uq.any() \
            else float(np.median(pr))
        keep = _pile_keep(pr, uspan, alen, col.pile_starts, gmed,
                          max_err, min_unique_span, rep_margin)
        return stream_write([keep])

    def chunks():
        for b0, b1 in ranges:
            col = ColumnarLas(las.path, b0, b1)
            if col.novl:
                yield col

    # pass 1: global unique-rate median (exact, O(bins) memory)
    med_u, med_a = _StreamMedian(), _StreamMedian()
    for col in chunks():
        pr, uspan, _ = _chunk_filter_stats(col, reps)
        med_u.add(pr[uspan >= min_unique_span])
        med_a.add(pr)
    sel = med_u if med_u.n else med_a
    gmed = 0.0
    if sel.n:
        sel.plan()
        for col in chunks():
            pr, uspan, _ = _chunk_filter_stats(col, reps)
            sel.collect(pr[uspan >= min_unique_span]
                        if sel is med_u else pr)
        gmed = sel.result()

    # pass 2: per-pile rule, records streamed straight into the writer
    def keeps():
        for col in chunks():
            pr, uspan, alen = _chunk_filter_stats(col, reps)
            yield _pile_keep(pr, uspan, alen, col.pile_starts, gmed,
                             max_err, min_unique_span, rep_margin)

    return stream_write(keeps())


def filter_alignments_plain(db: DazzDB, las: LasFile, out_path: str,
                            max_err: float | None = None,
                            repeat_track: str | None = "rep",
                            min_unique_span: int = 100,
                            rep_margin: float = 0.015,
                            mem_records: int | None = None) -> int:
    """:func:`filter_alignments` in python, one pile in memory at a time
    (the same records kept)."""
    tspace = las.tspace
    reps = _repeat_intervals(db, repeat_track)
    if mem_records is not None and mem_records <= 0:
        mem_records = None

    def unique_span(aread: int, abpos: int, aepos: int) -> int:
        span = aepos - abpos
        if reps is None or aread >= len(reps):
            return span
        for s, e in reps[aread]:
            span -= max(0, min(aepos, int(e)) - max(abpos, int(s)))
        return span

    def pile_stats(aread, pile):
        r = np.asarray([float(o.trace[:, 0].sum())
                        / max(o.aepos - o.abpos, 1) for o in pile])
        u = np.asarray([unique_span(aread, o.abpos, o.aepos)
                        >= min_unique_span for o in pile], dtype=bool)
        return r, u

    bounded = mem_records is not None and las.novl > mem_records
    if not bounded:
        # two passes: per-record rates kept in memory, direct np.median
        ra, ua = [], []
        for aread, pile in las.iter_piles():
            r, u = pile_stats(aread, pile)
            ra.append(r)
            ua.append(u)
        ra = np.concatenate(ra) if ra else np.zeros(0)
        ua = np.concatenate(ua) if ua else np.zeros(0, bool)
        gmed = float(np.median(ra[ua])) if ua.any() else \
            (float(np.median(ra)) if len(ra) else 0.0)
    else:
        # three streaming passes (rates recomputed per pass; the python
        # record parse dominates either way); exact-median machinery
        med_u, med_a = _StreamMedian(), _StreamMedian()
        for aread, pile in las.iter_piles():
            r, u = pile_stats(aread, pile)
            med_u.add(r[u])
            med_a.add(r)
        sel = med_u if med_u.n else med_a
        gmed = 0.0
        if sel.n:
            sel.plan()
            for aread, pile in las.iter_piles():
                r, u = pile_stats(aread, pile)
                sel.collect(r[u] if sel is med_u else r)
            gmed = sel.result()

    i0 = 0

    def kept_iter():
        nonlocal i0
        for aread, pile in las.iter_piles():
            if bounded:
                r, u = pile_stats(aread, pile)
            else:
                r, u = ra[i0 : i0 + len(pile)], ua[i0 : i0 + len(pile)]
                i0 += len(pile)
            med = float(np.median(r[u])) if u.sum() >= 5 else gmed
            cut = max_err if max_err is not None \
                else max(2.0 * med, med + 0.15)
            for j, o in enumerate(pile):
                if o.aepos - o.abpos < min_unique_span:
                    continue
                if (r[j] <= cut) if u[j] else (r[j] <= med + rep_margin):
                    yield o

    return write_las(out_path, tspace, kept_iter())


def _repeat_intervals(db: DazzDB, repeat_track: str | None):
    if repeat_track is None:
        return None
    try:
        return read_repeat_track(db, repeat_track)
    except FileNotFoundError:
        return None


def filter_symmetric(las_path: str, out_path: str, db: DazzDB | None = None) -> int:
    """Keep A->B overlaps iff a matching B->A record exists (``filtersym``).

    With a DB (read lengths known) the match is exact: for plain overlaps the
    mirror of (a,b,[ab,ae),[bb,be)) is (b,a,[bb,be),[ab,ae)); for complemented
    overlaps both sides' coordinates flip through their read length
    (DALIGNER complement-space symmetry). Without a DB, the match is by
    per-(a,b,comp) record counts.
    """
    las = LasFile(las_path)

    if db is not None:
        keys: set = set()
        for o in las:
            keys.add((o.aread, o.bread, o.is_comp, o.abpos, o.aepos, o.bbpos, o.bepos))

        def mirror_key(o: Overlap):
            if not o.is_comp:
                return (o.bread, o.aread, False, o.bbpos, o.bepos, o.abpos, o.aepos)
            alen = db.read_length(o.aread)
            blen = db.read_length(o.bread)
            return (o.bread, o.aread, True,
                    blen - o.bepos, blen - o.bbpos,
                    alen - o.aepos, alen - o.abpos)

        kept = [o for o in las if mirror_key(o) in keys]
    else:
        from collections import Counter

        counts: Counter = Counter()
        for o in las:
            counts[(o.aread, o.bread, o.is_comp)] += 1
        budget: Counter = Counter()
        kept = []
        for o in las:
            key = (o.aread, o.bread, o.is_comp)
            quota = min(counts[key], counts[(o.bread, o.aread, o.is_comp)])
            if budget[key] < quota:
                budget[key] += 1
                kept.append(o)
    return write_las(out_path, las.tspace, kept)
