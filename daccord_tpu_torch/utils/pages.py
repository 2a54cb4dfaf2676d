"""Page arithmetic of the paged wire format, in numpy alone.

``kernels/paging.py`` packs and unpacks paged batches with these; the audit
workers (``audit/worker.py``), which never import torch, unpack the paged
samples they are sent with the same :func:`unpack_pages`.
"""

from __future__ import annotations

import numpy as np

from .bases import PAD


def page_counts(lens: np.ndarray, page_len: int) -> np.ndarray:
    """Pages each segment occupies: ceil(lens / page_len), elementwise."""
    lens = np.asarray(lens)
    if page_len & (page_len - 1) == 0:
        # pow2 fast path (the default): shift beats two negations + floordiv
        # on the feeder hot path
        return (lens + (page_len - 1)) >> (page_len.bit_length() - 1)
    return -(-lens // page_len)


def unpack_pages(pool: np.ndarray, table: np.ndarray, lens: np.ndarray,
                 depth: int, seg_len: int, page_len: int) -> np.ndarray:
    """The dense ``[B, depth, seg_len]`` int8 tile of a paged batch: each
    segment's pages in order (a segment's pages follow the previous
    segment's in its table row), cells past its length PAD."""
    lens = np.asarray(lens)
    B = len(lens)
    seqs = np.full((B, depth, seg_len), PAD, dtype=np.int8)
    pps = page_counts(lens, page_len)                       # [B, D]
    off = np.cumsum(pps, axis=1) - pps                      # excl page slot
    b_idx, d_idx, p_idx = np.nonzero(
        np.arange(seg_len // page_len)[None, None, :] < pps[:, :, None])
    pages = pool[table[b_idx, off[b_idx, d_idx] + p_idx]]
    seqs.reshape(B, depth, seg_len // page_len, page_len)[b_idx, d_idx, p_idx] = pages
    # page tails past a segment's length hold undefined pool bytes;
    # re-mask so the round-trip reproduces tensorize's PAD cells exactly
    j = np.arange(seg_len, dtype=np.int32)
    np.copyto(seqs, PAD, where=j[None, None, :] >= lens[:, :, None])
    return seqs
