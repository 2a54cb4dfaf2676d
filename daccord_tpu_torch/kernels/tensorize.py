"""Window batch tensorization: ragged piles -> fixed-shape batch arrays.

Windows are packed as W windows x D segments x L bases into padded int8
arrays (PAD=4) with explicit lengths, the shape the batched solver consumes.
Depth above ``depth`` is capped (the A-read segment, placed first, always
survives the cap). The arrays are host numpy; the ladder moves them to the
device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..oracle.windows import WindowSegments
from ..utils.bases import PAD


@dataclass
class BatchShape:
    depth: int = 32       # D: max segments per window
    seg_len: int = 64     # L: max segment length
    wlen: int = 40        # w: window length


@dataclass
class WindowBatch:
    """Fixed-shape batch of windows (host numpy arrays)."""

    seqs: np.ndarray      # int8 [B, D, L], PAD=4 beyond lens
    lens: np.ndarray      # int32 [B, D], 0 for absent segments
    nsegs: np.ndarray     # int32 [B]
    shape: BatchShape
    # bookkeeping for scatter-back (parallel arrays, length B)
    read_ids: np.ndarray  # int64 [B]
    wstarts: np.ndarray   # int64 [B]
    stream: str = "full"  # the ladder program that solves it: "full" (the
                          # whole ladder), "tier0" (Stream A of the
                          # two-stream ladder) or "rescue" (Stream B, the
                          # whole ladder over pooled rows)

    @property
    def size(self) -> int:
        return len(self.nsegs)

    def pad_waste(self) -> float:
        """Fraction of seq cells that are padding."""
        return 1.0 - int(self.lens.sum()) / max(self.seqs.size, 1)


def tensorize_windows(items: list[tuple[int, WindowSegments]],
                      shape: BatchShape) -> WindowBatch:
    """Pack (read_id, WindowSegments) pairs into one WindowBatch.

    The segment copies run as ONE concatenated buffer + flat-index scatter
    instead of O(B*D) single-row numpy assignments."""
    B = len(items)
    D, L = shape.depth, shape.seg_len
    seqs = np.full((B, D, L), PAD, dtype=np.int8)
    lens = np.zeros((B, D), dtype=np.int32)
    nsegs = np.zeros(B, dtype=np.int32)
    read_ids = np.zeros(B, dtype=np.int64)
    wstarts = np.zeros(B, dtype=np.int64)
    segs: list[np.ndarray] = []
    rows: list[int] = []          # flat (b * D + d) row of each segment
    for b, (rid, ws) in enumerate(items):
        read_ids[b] = rid
        wstarts[b] = ws.wstart
        d = min(len(ws.segments), D)
        nsegs[b] = d
        for di in range(d):
            s = np.asarray(ws.segments[di], dtype=np.int8)
            segs.append(s[:L] if len(s) > L else s)
            rows.append(b * D + di)
    if segs:
        slens = np.fromiter(map(len, segs), np.int64, len(segs))
        rows_a = np.asarray(rows, dtype=np.int64)
        lens.reshape(-1)[rows_a] = slens
        flat = np.concatenate(segs) if len(segs) > 1 else segs[0]
        # ragged arange: position of every base within its own segment
        pos = np.arange(len(flat), dtype=np.int64) - np.repeat(
            np.cumsum(slens) - slens, slens)
        seqs.reshape(-1)[np.repeat(rows_a * L, slens) + pos] = flat
    return WindowBatch(seqs=seqs, lens=lens, nsegs=nsegs, shape=shape,
                       read_ids=read_ids, wstarts=wstarts)


def slice_batch(batch, lo: int, hi: int):
    """Row slice [lo, hi) of a batch, as views. Paged batches
    (``kernels/paging.py``) slice by table rows; the page pool is shared."""
    if getattr(batch, "pool", None) is not None:
        from .paging import slice_paged

        return slice_paged(batch, lo, hi)
    return dataclasses.replace(
        batch, seqs=batch.seqs[lo:hi], lens=batch.lens[lo:hi],
        nsegs=batch.nsegs[lo:hi], read_ids=batch.read_ids[lo:hi],
        wstarts=batch.wstarts[lo:hi])


def slice_rows(batch, idx: np.ndarray):
    """The rows ``idx`` of a batch, copied (a paged batch keeps its pool:
    only its table rows are taken)."""
    common = dict(lens=batch.lens[idx], nsegs=batch.nsegs[idx],
                  read_ids=batch.read_ids[idx], wstarts=batch.wstarts[idx])
    if getattr(batch, "pool", None) is not None:
        return dataclasses.replace(batch, table=batch.table[idx], **common)
    return dataclasses.replace(batch, seqs=batch.seqs[idx], **common)


def pad_batch(batch, target: int):
    """Pad a batch to ``target`` windows with empty rows (nsegs 0, which the
    solver marks unsolved), so every launch of a run has one shape. Paged
    batches pad by sentinel table rows (``paging.pad_paged``)."""
    B = batch.size
    if B == target:
        return batch
    assert B < target, (B, target)
    if getattr(batch, "pool", None) is not None:
        from .paging import pad_paged

        return pad_paged(batch, target)
    D, L = batch.shape.depth, batch.shape.seg_len
    seqs = np.full((target, D, L), PAD, dtype=np.int8)
    seqs[:B] = batch.seqs
    lens = np.zeros((target, D), dtype=np.int32)
    lens[:B] = batch.lens
    nsegs = np.zeros(target, dtype=np.int32)
    nsegs[:B] = batch.nsegs
    read_ids = np.full(target, -1, dtype=np.int64)
    read_ids[:B] = batch.read_ids
    wstarts = np.zeros(target, dtype=np.int64)
    wstarts[:B] = batch.wstarts
    return WindowBatch(seqs=seqs, lens=lens, nsegs=nsegs, shape=batch.shape,
                       read_ids=read_ids, wstarts=wstarts, stream=batch.stream)
