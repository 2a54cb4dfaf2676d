"""Pile assembly and windowing: LAS piles -> base-accurate window segments.

The port's copy of ``daccord_tpu.oracle.windows``: refine trace-point tiles
to base-level correspondences and cut fixed windows along the A read.

Window convention (daccord defaults): windows of length ``w`` (40) advancing by
``a`` (10) along the A read; window ``j`` covers ``[j*a, j*a + w)``. Only
overlaps spanning the whole window contribute a segment.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..formats.las import Overlap
from ..utils.bases import revcomp_ints
from .align import align_path


@dataclass
class RefinedOverlap:
    """An overlap with a base-accurate A->B prefix map over its span."""

    ovl: Overlap
    b_oriented: np.ndarray   # B bases in A-colinear orientation (int8)
    a2b: np.ndarray          # len aepos-abpos+1; b_oriented index per A boundary
    diffs: int


def refine_overlap(ovl: Overlap, a_bases: np.ndarray, b_bases: np.ndarray,
                   tspace: int) -> RefinedOverlap:
    """Refine per-tile trace points to a base-level A->B map.

    ``b_bases`` is the stored B read; it is complemented here when the overlap
    says so (DALIGNER convention: bbpos/bepos are complement-space coords).
    """
    b_or = revcomp_ints(b_bases) if ovl.is_comp else np.asarray(b_bases, dtype=np.int8)
    bounds = ovl.tile_bounds(tspace)
    ntiles = len(bounds) - 1
    trace = ovl.trace
    assert trace.shape[0] == ntiles, (trace.shape, ntiles)

    a2b = np.zeros(ovl.aepos - ovl.abpos + 1, dtype=np.int64)
    bpos = ovl.bbpos
    total_d = 0
    for t in range(ntiles):
        a0, a1 = int(bounds[t]), int(bounds[t + 1])
        blen = int(trace[t, 1])
        atile = a_bases[a0:a1]
        btile = b_or[bpos : bpos + blen]
        d, tile_a2b = align_path(atile, btile)
        total_d += d
        a2b[a0 - ovl.abpos : a1 - ovl.abpos] = bpos + tile_a2b[:-1]
        bpos += blen
    a2b[-1] = bpos
    return RefinedOverlap(ovl=ovl, b_oriented=b_or, a2b=a2b, diffs=total_d)


@dataclass
class WindowSegments:
    """All B segments covering one window of the A read."""

    wstart: int
    wlen: int
    segments: list[np.ndarray]     # int8 arrays, variable length
    breads: list[int]              # source B read ids (for depth caps / QV)


def cut_windows(a_bases: np.ndarray, refined: list[RefinedOverlap],
                w: int = 40, adv: int = 10,
                include_a: bool = True) -> list[WindowSegments]:
    """Cut windows [j*adv, j*adv+w) and collect spanning B segments.

    ``include_a``: the A read's own bases also pile into each window (the
    reference counts the read itself as evidence).
    """
    rlen = len(a_bases)
    out: list[WindowSegments] = []
    nwin = 0 if rlen < w else (rlen - w) // adv + 1
    for j in range(nwin):
        ws, we = j * adv, j * adv + w
        segs: list[np.ndarray] = []
        breads: list[int] = []
        if include_a:
            segs.append(np.asarray(a_bases[ws:we], dtype=np.int8))
            breads.append(-1)
        for r in refined:
            o = r.ovl
            if o.abpos <= ws and o.aepos >= we:
                b0 = int(r.a2b[ws - o.abpos])
                b1 = int(r.a2b[we - o.abpos])
                if b1 > b0:
                    segs.append(r.b_oriented[b0:b1])
                    breads.append(o.bread)
        out.append(WindowSegments(wstart=ws, wlen=w, segments=segs, breads=breads))
    return out
