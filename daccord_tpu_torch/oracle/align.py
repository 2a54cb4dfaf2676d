"""Pairwise alignment primitives: exact unit-cost edit distance.

Used to

  (a) refine LAS trace-point tiles to base-accurate A->B correspondence when
      cutting windows (``align_path``),
  (b) rescore consensus candidates against window segments in the oracle
      (``edit_distance_sum``),
  (c) splice overlapping window consensi when stitching
      (``overlap_suffix_prefix``), and
  (d) score corrected reads against the truth (``infix_distance``).

Each runs in the port's host library (``native/dazz_native.cpp``: Myers
bit-parallel DP, verify-retry banded fills). Beside each stands its numpy
form, ``*_plain``: the same distances and the same backtrack tie order, which
the tests hold the library to. Both give what ``daccord_tpu.oracle.align``
gives.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import load

_BIG = 1 << 30


def _i8(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.int8)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def pack_segments(segs: list[np.ndarray]) -> tuple:
    """Flatten a segment list once for repeated :func:`edit_distance_sum`
    calls: (flat bases, offsets, lengths)."""
    lens = np.fromiter((len(s) for s in segs), np.int32, len(segs))
    offs = np.zeros(len(segs), dtype=np.int64)
    if len(lens):
        np.cumsum(lens[:-1], out=offs[1:])
    flat = (np.concatenate([_i8(s) for s in segs]) if lens.sum()
            else np.zeros(1, np.int8))
    return flat, offs, lens


def edit_distance_sum(cand: np.ndarray, segs) -> int:
    """Sum of exact edit distances of ``cand`` vs each segment; ``segs`` is a
    segment list or a :func:`pack_segments` result."""
    flat, offs, lens = segs if isinstance(segs, tuple) else pack_segments(segs)
    if not len(lens):
        return 0
    cand = _i8(cand)
    return int(load().edit_distance_sum(_ptr(cand), len(cand), _ptr(flat),
                                        _ptr(offs), _ptr(lens), len(lens)))


def edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Exact unit-cost edit distance between int8 base arrays."""
    return edit_distance_sum(a, [b])


def align_path(a: np.ndarray, b: np.ndarray) -> tuple[int, np.ndarray]:
    """Full DP with backtrack.

    Returns (distance, a2b) where ``a2b`` has length ``len(a)+1`` and maps every
    A prefix boundary to the aligned B prefix boundary (monotone). This is the
    shape consumed by window cutting: B position of A position ``i`` is
    ``a2b[i]``.
    """
    a, b = _i8(a), _i8(b)
    a2b = np.zeros(len(a) + 1, dtype=np.int64)
    d = load().align_map(_ptr(a), len(a), _ptr(b), len(b), _ptr(a2b))
    return int(d), a2b


def infix_distance(needle: np.ndarray, haystack: np.ndarray) -> int:
    """Best edit distance of ``needle`` against any infix of ``haystack``
    (free start/end gaps in the haystack); scores corrected reads against
    the truth."""
    a, b = _i8(needle), _i8(haystack)
    return int(load().infix_distance(_ptr(a), len(a), _ptr(b), len(b)))


def overlap_suffix_prefix(a: np.ndarray, b: np.ndarray) -> tuple[int, int, int]:
    """Best alignment of a suffix of ``a`` against a prefix of ``b``.

    Used by window stitching: returns (cost, a_start, b_end) minimizing
    edit cost of a[a_start:] vs b[:b_end], normalized against trivial empty
    overlaps by requiring the aligned span to score better than its length.
    """
    a, b = _i8(a), _i8(b)
    cost, a_start, b_end = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    load().suffix_prefix(_ptr(a), len(a), _ptr(b), len(b), ctypes.byref(cost),
                         ctypes.byref(a_start), ctypes.byref(b_end))
    return cost.value, a_start.value, b_end.value


# ---------------------------------------------------------------------------
# numpy forms (the tests' reference)
# ---------------------------------------------------------------------------

def edit_distance_sum_plain(cand: np.ndarray, segs: list[np.ndarray]) -> int:
    """numpy form of :func:`edit_distance_sum` (a segment list)."""
    return sum(edit_distance_plain(cand, s) for s in segs)


def edit_distance_plain(a: np.ndarray, b: np.ndarray) -> int:
    """numpy form of :func:`edit_distance`.

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


def align_path_plain(a: np.ndarray, b: np.ndarray) -> tuple[int, np.ndarray]:
    """numpy form of :func:`align_path` (full DP, backtrack preferring the
    diagonal, then deletion, then insertion)."""
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


def infix_distance_plain(needle: np.ndarray, haystack: np.ndarray) -> int:
    """numpy form of :func:`infix_distance`."""
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


def overlap_suffix_prefix_plain(a: np.ndarray, b: np.ndarray) -> tuple[int, int, int]:
    """numpy form of :func:`overlap_suffix_prefix`."""
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
