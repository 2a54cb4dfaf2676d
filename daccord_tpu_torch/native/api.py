"""Numpy-facing wrappers over the port's host library (ctypes marshalling)."""

from __future__ import annotations

import ctypes

import numpy as np

from . import load


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class ColumnarLas:
    """The records of a LAS byte range ``[start, end)`` (default: the whole
    file) as columns: one array per record field, the trace points flattened
    (``trace_flat[trace_off[i]:trace_off[i + 1]]`` holds record ``i``'s
    (diffs, b bases) pairs), and the pile boundaries. The library trusts
    every record header, so a range from an unvalidated file goes through
    the ingest scan (``formats/ingest.py``) first."""

    __slots__ = ("tspace", "novl", "aread", "bread", "abpos", "aepos", "bbpos",
                 "bepos", "comp", "diffs", "trace_off", "trace_flat", "pile_starts")

    def __init__(self, path: str, start: int | None = None, end: int | None = None):
        lib = load()
        b0 = 0 if start is None else int(start)
        b1 = 0 if end is None else int(end)
        novl = ctypes.c_int64()
        tspace = ctypes.c_int32()
        telems = ctypes.c_int64()
        rc = lib.las_scan(path.encode(), b0, b1, ctypes.byref(novl),
                          ctypes.byref(tspace), ctypes.byref(telems))
        if rc != 0:
            raise IOError(f"las_scan({path}) failed: {rc}")
        n, te = novl.value, telems.value
        self.novl, self.tspace = n, tspace.value
        self.aread = np.empty(n, np.int32)
        self.bread = np.empty(n, np.int32)
        self.abpos = np.empty(n, np.int32)
        self.aepos = np.empty(n, np.int32)
        self.bbpos = np.empty(n, np.int32)
        self.bepos = np.empty(n, np.int32)
        self.comp = np.empty(n, np.uint8)
        self.diffs = np.empty(n, np.int32)
        self.trace_off = np.empty(n + 1, np.int64)
        self.trace_flat = np.empty(te, np.int32)
        rc = lib.las_load(path.encode(), b0, b1, n, _ptr(self.aread), _ptr(self.bread),
                          _ptr(self.abpos), _ptr(self.aepos), _ptr(self.bbpos),
                          _ptr(self.bepos), _ptr(self.comp), _ptr(self.diffs),
                          _ptr(self.trace_off), _ptr(self.trace_flat))
        if rc != 0:
            raise IOError(f"las_load({path}) failed: {rc}")
        # pile boundaries (the file is sorted by aread)
        if n:
            change = np.nonzero(np.diff(self.aread))[0] + 1
            self.pile_starts = np.concatenate([[0], change, [n]]).astype(np.int64)
        else:
            self.pile_starts = np.zeros(1, np.int64)

    def piles(self):
        """(aread, first record, end record) of every pile, in file order."""
        for p in range(len(self.pile_starts) - 1):
            s, e = int(self.pile_starts[p]), int(self.pile_starts[p + 1])
            yield int(self.aread[s]), s, e


def decode_reads_batch(bps: np.ndarray, boffs: np.ndarray,
                       rlens: np.ndarray) -> list[np.ndarray]:
    """Decode a batch of 2-bit packed reads into views over one buffer."""
    lib = load()
    n = len(rlens)
    boffs = np.ascontiguousarray(boffs, dtype=np.int64)
    rlens = np.ascontiguousarray(rlens, dtype=np.int32)
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(rlens, out=out_off[1:])
    out = np.empty(int(out_off[-1]), np.int8)
    bps = np.ascontiguousarray(bps, dtype=np.uint8)
    if n and int(out_off[-1]) and (boffs.min() < 0 or int(
            (boffs + (rlens.astype(np.int64) + 3) // 4).max()) > len(bps)):
        raise ValueError("a read lies outside the base store")
    rc = lib.decode_reads(_ptr(bps), _ptr(boffs), _ptr(rlens), n,
                          _ptr(out), _ptr(out_off))
    if rc != 0:
        raise RuntimeError(f"decode_reads failed: {rc}")
    return [out[out_off[i] : out_off[i + 1]] for i in range(n)]


def process_pile_native(a_bases: np.ndarray, col: ColumnarLas, s: int, e: int,
                        b_reads: list[np.ndarray],
                        w: int, adv: int, D: int, L: int,
                        include_a: bool = True,
                        order: np.ndarray | None = None):
    """Windows of one pile (records ``s:e`` of ``col``) as batch tensors.

    ``b_reads``: decoded stored-orientation B bases per overlap, already in
    ``order`` if one is given. ``order`` permutes the pile (indices into
    [0, e-s)), so the first overlaps in it fill the depth slots first.
    Returns (seqs [nwin,D,L] int8, lens [nwin,D] i32, nsegs [nwin] i32).
    """
    lib = load()
    novl = e - s
    alen = len(a_bases)
    nwin = 0 if alen < w else (alen - w) // adv + 1
    # process_pile writes only the filled cells: PAD and zeros elsewhere
    seqs = np.full((nwin, D, L), 4, dtype=np.int8)
    lens = np.zeros((nwin, D), dtype=np.int32)
    nsegs = np.zeros(nwin, dtype=np.int32)
    if nwin == 0:
        return seqs, lens, nsegs
    if len(b_reads) != novl:
        raise ValueError(f"{len(b_reads)} B reads for a pile of {novl} overlaps")

    b_len = np.fromiter((len(b) for b in b_reads), np.int32, novl)
    b_off = np.zeros(novl + 1, np.int64)
    np.cumsum(b_len, out=b_off[1:])
    b_concat = (np.concatenate(b_reads) if novl else np.zeros(0, np.int8)).astype(
        np.int8, copy=False)
    a_c = np.ascontiguousarray(a_bases, dtype=np.int8)

    gi = (np.arange(s, e, dtype=np.int64) if order is None
          else s + np.asarray(order, dtype=np.int64))
    if len(gi) != novl or (novl and (gi.min() < s or gi.max() >= e)):
        raise ValueError("order must index the pile's own overlaps")
    abpos = col.abpos[gi]
    aepos = col.aepos[gi]
    bbpos = col.bbpos[gi]
    bepos = col.bepos[gi]
    comp = col.comp[gi]
    # each overlap's trace slice, gathered in pile order: one index array
    # (the slices' starts repeated over their lengths, plus a running count)
    tlens = col.trace_off[gi + 1] - col.trace_off[gi]
    toff = np.zeros(novl + 1, np.int64)
    np.cumsum(tlens, out=toff[1:])
    tflat = col.trace_flat[np.repeat(col.trace_off[gi] - toff[:-1], tlens)
                           + np.arange(toff[-1], dtype=np.int64)]
    # the C side trusts every coordinate: each overlap's A span lies in the
    # A read, its trace has a pair for every tile of that span, and the
    # trace's B bases lie in its B read
    if novl:
        cb = np.zeros(len(tflat) // 2 + 1, np.int64)
        np.cumsum(tflat[1::2], out=cb[1:])
        bsum = cb[toff[1:] // 2] - cb[toff[:-1] // 2]
        if (abpos.min() < 0 or aepos.max() > alen or (aepos < abpos).any()
                or (bbpos < 0).any() or (bbpos + bsum > b_len).any()
                or (tlens // 2 < _n_tiles(abpos, aepos, col.tspace)).any()):
            raise ValueError("an overlap of the pile lies outside its reads "
                             "or its trace does not cover it")

    rc = lib.process_pile(_ptr(a_c), alen, novl,
                          _ptr(abpos), _ptr(aepos), _ptr(bbpos), _ptr(bepos),
                          _ptr(comp),
                          _ptr(b_concat), _ptr(b_off), _ptr(b_len),
                          _ptr(tflat), _ptr(toff),
                          col.tspace, w, adv, D, L, 1 if include_a else 0,
                          _ptr(seqs), _ptr(lens), _ptr(nsegs), nwin)
    if rc != 0:
        raise RuntimeError(f"process_pile failed: {rc}")
    return seqs, lens, nsegs


def _n_tiles(abpos: np.ndarray, aepos: np.ndarray, tspace: int) -> np.ndarray:
    """Trace tiles of each overlap: [abpos, aepos) cut at multiples of tspace."""
    ab = abpos.astype(np.int64)
    ae = aepos.astype(np.int64)
    return np.where(ae > ab, (ae - 1) // tspace - ab // tspace + 1, 0)


class NativeLadder:
    """Pre-packed tier tables and parameters for the host library's window
    consensus engine (``solve_windows``) and its homopolymer rescue
    (``hp_rescue_windows``): the port's copy of ``daccord_tpu/native/api.py
    NativeLadder``. Build once a run, call :meth:`solve` a batch.

    ``max_kmers=0`` is the full-graph oracle semantics (no truncation,
    ``m_ovf`` all False); ``max_kmers > 0`` mirrors the device ladder's top-M
    compaction, the min_count <= 1 rescue tiers at ``rescue_max_kmers``.
    ``ol_tables``: k -> ``OffsetLikely``; ``cfg``: ``ConsensusConfig``."""

    def __init__(self, ol_tables: dict, cfg, max_kmers: int = 0,
                 rescue_max_kmers: int = 256, _share=None):
        self.cfg = cfg
        # the hp posterior vote needs the error profile (every table carries
        # the same one)
        self.profile = (_share.profile if _share is not None else
                        next(iter(ol_tables.values())).profile if ol_tables else None)
        self._post_tabs = None
        d = cfg.dbg
        tiers = list(cfg.tiers)
        if _share is not None:
            # caps-only variant: the packed tables are shared with the donor
            for f in ("tables", "table_off", "tier_k", "tier_minc",
                      "tier_eminc", "tier_P", "tier_O"):
                setattr(self, f, getattr(_share, f))
        else:
            tabs, offs = [], [0]
            for k, _, _ in tiers:
                t = np.ascontiguousarray(ol_tables[k].table, dtype=np.float32)
                tabs.append(t.reshape(-1))
                offs.append(offs[-1] + t.size)
            self.tables = np.concatenate(tabs)
            self.table_off = np.asarray(offs[:-1], dtype=np.int64)
            self.tier_k = np.asarray([t[0] for t in tiers], dtype=np.int32)
            self.tier_minc = np.asarray([t[1] for t in tiers], dtype=np.int32)
            self.tier_eminc = np.asarray([t[2] for t in tiers], dtype=np.int32)
            self.tier_P = np.asarray([ol_tables[t[0]].P for t in tiers], dtype=np.int32)
            self.tier_O = np.asarray([ol_tables[t[0]].O for t in tiers], dtype=np.int32)
        self.tier_M = np.asarray(
            [0 if max_kmers <= 0 else (rescue_max_kmers if t[1] <= 1 else max_kmers)
             for t in tiers], dtype=np.int32)
        self.n_tiers = len(tiers)
        self.CL = cfg.w + d.len_slack
        self._d = d

    def hp_rescue(self, batch, out: dict, n_threads: int = 1) -> int:
        """The homopolymer rescue of :meth:`solve`'s result ``out``, in
        place (``oracle/hp.py`` semantics in C++: byte-equal to the python
        ``hp_candidate`` loop). A rescued row may be longer than CL, so
        ``out['cons']`` is re-allocated at the hp width (2 w) with the
        rescued rows written; ``cons_len``, ``err`` and ``tier`` update in
        place (tier ``HP_TIER``). Returns the rescued count. Runs after any
        overflow rescue, as the python pass does."""
        from ..oracle.hp import HP_HEAT_LO, HP_HEAT_N, HP_HEAT_STEP, HP_TIER, hp_length_tables

        lib = load()
        cfg, d = self.cfg, self._d
        k0, minc0, eminc0 = cfg.tiers[0]
        seqs = np.ascontiguousarray(batch.seqs, dtype=np.int8)
        lens = np.ascontiguousarray(batch.lens, dtype=np.int32)
        nsegs = np.ascontiguousarray(batch.nsegs, dtype=np.int32)
        B, D, L = seqs.shape
        CLH = 2 * cfg.w
        hp_cons = np.full((B, CLH), 4, dtype=np.int8)
        cons_in = np.ascontiguousarray(out["cons"], dtype=np.int8)
        # the posterior vote's tables, one per quantized heat multiplier,
        # built once by the python code (so the likelihoods are the python
        # pass's to the bit), under the same slope gate as oracle/hp.py;
        # the C++ side walks the vote
        prof = self.profile
        if (self._post_tabs is None and cfg.hp_vote == "posterior"
                and prof is not None and prof.hp_slope >= 0.1):
            self._post_tabs = np.ascontiguousarray(np.stack(
                [hp_length_tables(prof, mult=HP_HEAT_LO + HP_HEAT_STEP * i)
                 for i in range(HP_HEAT_N)]), dtype=np.float64)
        tabs = self._post_tabs
        p_err = (prof.p_ins + prof.p_del + prof.p_sub) if prof is not None else 0.0
        for key, dt in (("cons_len", np.int32), ("err", np.float32), ("tier", np.int32)):
            if not (out[key].dtype == dt and out[key].flags.c_contiguous
                    and out[key].flags.writeable):
                raise ValueError(f"hp_rescue: out[{key!r}] must be a writeable "
                                 f"contiguous {np.dtype(dt).name} array")
        n = int(lib.hp_rescue_windows(
            _ptr(seqs), _ptr(lens), _ptr(nsegs), B, D, L,
            _ptr(self.tables), int(self.tier_P[0]), int(self.tier_O[0]),
            int(k0), int(minc0), int(eminc0),
            cfg.w, d.anchor_slack, d.end_slack, d.len_slack,
            d.n_candidates, d.min_depth, d.max_err, d.count_frac,
            cfg.hp_err, int(cfg.hp_min_run), cfg.hp_margin, int(n_threads),
            _ptr(cons_in), int(cons_in.shape[1]), _ptr(hp_cons), CLH,
            _ptr(out["cons_len"]), _ptr(out["err"]), _ptr(out["tier"]),
            _ptr(tabs) if tabs is not None else None,
            HP_HEAT_N if tabs is not None else 0,
            int(tabs.shape[1] - 1) if tabs is not None else 0,
            int(tabs.shape[2] - 1) if tabs is not None else 0,
            p_err, HP_HEAT_LO, HP_HEAT_STEP,
            int(cfg.hp_accept == "likelihood"), cfg.hp_lambda_c))
        if n < 0:
            raise RuntimeError(f"hp_rescue_windows failed: {n}")
        if n:
            rescued = out["tier"] == HP_TIER
            merged = np.full((B, max(CLH, cons_in.shape[1])), 4, dtype=np.int8)
            merged[:, :cons_in.shape[1]] = cons_in
            merged[rescued, :CLH] = hp_cons[rescued]
            out["cons"] = merged
            out["solved"] = out["tier"] >= 0
        return n

    def with_caps(self, max_kmers: int, rescue_max_kmers: int = 256) -> "NativeLadder":
        """Caps-only variant sharing this ladder's packed tables."""
        return NativeLadder(None, self.cfg, max_kmers, rescue_max_kmers, _share=self)

    def solve(self, batch, n_threads: int = 1) -> dict:
        """The tier ladder over a dense batch: cons [B, CL] int8, cons_len,
        err, solved, tier, m_ovf (the ``solve_ladder`` dict)."""
        lib = load()
        d = self._d
        seqs = np.ascontiguousarray(batch.seqs, dtype=np.int8)
        lens = np.ascontiguousarray(batch.lens, dtype=np.int32)
        nsegs = np.ascontiguousarray(batch.nsegs, dtype=np.int32)
        B, D, L = seqs.shape
        cons = np.empty((B, self.CL), dtype=np.int8)
        cons_len = np.empty(B, dtype=np.int32)
        errs = np.empty(B, dtype=np.float32)
        tiers_out = np.empty(B, dtype=np.int32)
        movf = np.empty(B, dtype=np.uint8)
        rc = lib.solve_windows(
            _ptr(seqs), _ptr(lens), _ptr(nsegs), B, D, L,
            _ptr(self.tables), _ptr(self.table_off), _ptr(self.tier_k),
            _ptr(self.tier_minc), _ptr(self.tier_eminc), _ptr(self.tier_P),
            _ptr(self.tier_O), _ptr(self.tier_M), self.n_tiers,
            self.cfg.w, d.anchor_slack, d.end_slack, d.len_slack,
            d.n_candidates, d.min_depth, d.max_err, d.count_frac, int(n_threads),
            _ptr(cons), _ptr(cons_len), _ptr(errs), _ptr(tiers_out), _ptr(movf))
        if rc != 0:
            raise RuntimeError(f"solve_windows failed: {rc}")
        return dict(cons=cons, cons_len=cons_len, err=errs, solved=tiers_out >= 0,
                    tier=tiers_out, m_ovf=movf.astype(bool))


def solve_windows_native(batch, ol_tables: dict, cfg, n_threads: int = 1,
                         max_kmers: int = 0, rescue_max_kmers: int = 256) -> dict:
    """The host library's tier ladder over one dense batch; a one-shot
    :class:`NativeLadder` (callers making many calls hold one instead)."""
    return NativeLadder(ol_tables, cfg, max_kmers, rescue_max_kmers).solve(batch, n_threads)
