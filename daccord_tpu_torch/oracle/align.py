"""Pairwise alignment primitives (numpy edit-distance DP).

Used to

  (a) refine LAS trace-point tiles to base-accurate A->B correspondence when
      cutting windows (``align_path``),
  (b) rescore consensus candidates against window segments in the oracle
      (``edit_distance_sum``),
  (c) splice overlapping window consensi when stitching
      (``overlap_suffix_prefix``), and
  (d) score corrected reads against the truth (``infix_distance``).

The DP is plain unit-cost Levenshtein. These are the numpy forms of
``daccord_tpu.oracle.align``; they give the same distances and the same
backtrack tie order as that module (whose C++ host library is not part of the
port).
"""

from __future__ import annotations

import numpy as np

_BIG = 1 << 30


def pack_segments(segs: list[np.ndarray]) -> list[np.ndarray]:
    """Segment list in the form :func:`edit_distance_sum` takes."""
    return list(segs)


def edit_distance_sum(cand: np.ndarray, segs) -> int:
    """Sum of exact edit distances of ``cand`` vs each segment."""
    return sum(edit_distance(cand, s) for s in segs)


def edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Exact unit-cost edit distance between int8 base arrays.

    Verify-retry banding: a result below the band slack proves every optimal
    path stayed inside the band, so the banded value equals the full DP's;
    otherwise the band doubles."""
    a = np.asarray(a)
    b = np.asarray(b)
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    band = abs(n - m) + max(16, (max(n, m) >> 2))
    while True:
        d = _edit_distance_banded(a, b, n, m, band)
        if d < band or band > n + m:
            return d
        band *= 2


def _edit_distance_banded(a, b, n: int, m: int, band: int) -> int:
    prev = np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        lo = max(1, i - band)
        hi = min(m, i + band)
        cur = np.full(m + 1, _BIG, dtype=np.int32)
        if lo == 1:
            cur[0] = i
        seg = b[lo - 1 : hi]
        sub = prev[lo - 1 : hi] + (seg != a[i - 1])
        dele = prev[lo : hi + 1] + 1
        best = np.minimum(sub, dele)
        # insertion scan cur[j] = min(best[j], cur[j-1]+1) as a prefix-min:
        # cur[j] = min_{j0<=j} vals[j0] + (j - j0)
        vals = np.concatenate(([cur[lo - 1]], best))
        ar = np.arange(len(vals), dtype=np.int32)
        cur[lo - 1 + 1 : hi + 1] = (np.minimum.accumulate(vals - ar) + ar)[1:]
        prev = cur
    return int(prev[m])


def align_path(a: np.ndarray, b: np.ndarray) -> tuple[int, np.ndarray]:
    """Full DP with backtrack.

    Returns (distance, a2b) where ``a2b`` has length ``len(a)+1`` and maps every
    A prefix boundary to the aligned B prefix boundary (monotone). This is the
    shape consumed by window cutting: B position of A position ``i`` is
    ``a2b[i]``.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    n, m = len(a), len(b)
    D = np.empty((n + 1, m + 1), dtype=np.int32)
    D[0] = np.arange(m + 1)
    D[:, 0] = np.arange(n + 1)
    ar = np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        sub = D[i - 1, :m] + (b != a[i - 1])
        dele = D[i - 1, 1:] + 1
        best = np.minimum(sub, dele)
        vals = np.concatenate(([D[i, 0]], best + 0))
        vals[1:] -= ar[1:]
        D[i, 1:] = (np.minimum.accumulate(vals) + ar)[1:]
    # backtrack, preferring diagonal moves
    a2b = np.zeros(n + 1, dtype=np.int64)
    i, j = n, m
    a2b[n] = m
    while i > 0:
        if j > 0 and D[i, j] == D[i - 1, j - 1] + (a[i - 1] != b[j - 1]):
            i -= 1
            j -= 1
        elif D[i, j] == D[i - 1, j] + 1:
            i -= 1
        else:
            j -= 1
            continue
        a2b[i] = j
    a2b[0] = 0  # global alignment: boundary 0 maps to boundary 0
    return int(D[n, m]), a2b


def infix_distance(needle: np.ndarray, haystack: np.ndarray) -> int:
    """Best edit distance of ``needle`` against any infix of ``haystack``
    (free start/end gaps in the haystack); scores corrected reads against
    the truth."""
    a = np.asarray(needle)
    b = np.asarray(haystack)
    n, m = len(a), len(b)
    if n == 0:
        return 0
    prev = np.zeros(m + 1, dtype=np.int32)  # free start in haystack
    ar = np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        sub = prev[:m] + (b != a[i - 1])
        dele = prev[1:] + 1
        best = np.minimum(sub, dele)
        vals = np.concatenate(([np.int32(i)], best))
        vals[1:] -= ar[1:]
        prev = np.minimum.accumulate(vals) + ar
    return int(prev.min())


def overlap_suffix_prefix(a: np.ndarray, b: np.ndarray) -> tuple[int, int, int]:
    """Best alignment of a suffix of ``a`` against a prefix of ``b``.

    Used by window stitching: returns (cost, a_start, b_end) minimizing
    edit cost of a[a_start:] vs b[:b_end], normalized against trivial empty
    overlaps by requiring the aligned span to score better than its length.
    """
    a = np.ascontiguousarray(a, dtype=np.int8)
    b = np.ascontiguousarray(b, dtype=np.int8)
    n, m = len(a), len(b)
    # semi-global formulation: free start in a (first column 0), free end in b
    D = np.empty((n + 1, m + 1), dtype=np.int32)
    D[:, 0] = 0  # suffix start is free
    D[0, :] = np.arange(m + 1)  # b prefix must be consumed from 0
    ar = np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        sub = D[i - 1, :m] + (b != a[i - 1])
        dele = D[i - 1, 1:] + 1
        best = np.minimum(sub, dele)
        vals = np.concatenate(([D[i, 0]], best))
        vals[1:] -= ar[1:]
        D[i, 1:] = (np.minimum.accumulate(vals) + ar)[1:]
    # choose b_end minimizing cost - 0.5 * matched_len  (favor long overlaps)
    costs = D[n, :].astype(np.float64) - 0.5 * np.arange(m + 1)
    b_end = int(np.argmin(costs))
    cost = int(D[n, b_end])
    # backtrack for the a-suffix start, with the tie order of the fill
    # (substitution, then deletion, then insertion)
    i, j = n, b_end
    while j > 0:
        if i > 0 and D[i, j] == D[i - 1, j - 1] + (a[i - 1] != b[j - 1]):
            i -= 1
            j -= 1
        elif i > 0 and D[i, j] == D[i - 1, j] + 1:
            i -= 1
        else:
            j -= 1
    return cost, i, b_end
