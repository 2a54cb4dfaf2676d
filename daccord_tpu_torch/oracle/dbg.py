"""Per-window local de Bruijn graph consensus — the ``handleWindow`` spec.

The port's copy of ``daccord_tpu.oracle.dbg``, the numpy executable
specification of the per-window consensus core. The profile pass solves its
sample windows with it. Pipeline per window:

  1. pack k-mers from all segments, with their segment offsets;
  2. frequency filter (errors produce low-count k-mers) plus (k+1)-mer support
     for edges ((k,k+1)-mer consistency);
  3. per-k-mer position weights = offset-occurrence counts x OffsetLikely;
  4. bounded-length heaviest-path DP from a window-start anchor k-mer to a
     window-end anchor k-mer (the reference escalates k until the graph is
     workable; bounded path length additionally makes cycles harmless);
  5. top candidates rescored by edit distance against all segments; argmin
     wins; windows whose best candidate still disagrees with the pile are
     reported unsolved.

The batched torch implementation (``kernels.window_kernel``) follows the same
semantics under its top-M cap.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .align import edit_distance_sum, pack_segments
from .profile import OffsetLikely

NEG = np.float32(-1e30)


@dataclass
class DBGParams:
    k: int = 8
    min_count: int = 2           # k-mer frequency filter floor
    count_frac: float = 0.0      # additional adaptive floor: frac * depth
    edge_min_count: int = 2      # (k+1)-mer support needed for an edge
    anchor_slack: int = 2        # offsets <= slack qualify as window-start anchors
    end_slack: int = 3           # offsets >= seglen-k-end_slack qualify as end anchors
    len_slack: int = 8           # accepted consensus length deviation from w
    n_candidates: int = 3
    min_depth: int = 3
    max_err: float = 0.3         # reject consensus if mean edit rate above this


@dataclass
class WindowResult:
    seq: np.ndarray | None       # int8 consensus bases, or None if unsolved
    err: float = 1.0             # mean per-base edit rate of winner vs segments
    k: int = 0
    n_candidates: int = 0
    reason: str = ""


def _pack_kmers(seg: np.ndarray, k: int) -> np.ndarray:
    """All k-mer codes of one segment (base-4 big-endian packing)."""
    n = len(seg) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    codes = np.zeros(n, dtype=np.int64)
    s = seg.astype(np.int64)
    for j in range(k):
        codes = codes * 4 + s[j : j + n]
    return codes


def window_consensus(segments: list[np.ndarray], ol: OffsetLikely,
                     params: DBGParams, wlen: int = 40) -> WindowResult:
    k = params.k
    D = len(segments)
    if D < params.min_depth:
        return WindowResult(None, reason="depth")

    # ---- 1. k-mers + offsets, (k+1)-mers --------------------------------
    codes_list, offs_list, endflag_list, startflag_list = [], [], [], []
    codes1_list = []
    for seg in segments:
        c = _pack_kmers(seg, k)
        if len(c) == 0:
            continue
        o = np.arange(len(c))
        codes_list.append(c)
        offs_list.append(o)
        startflag_list.append(o <= params.anchor_slack)
        endflag_list.append(o >= len(c) - 1 - params.end_slack)
        codes1_list.append(_pack_kmers(seg, k + 1))
    if not codes_list:
        return WindowResult(None, reason="empty")
    codes = np.concatenate(codes_list)
    offs = np.concatenate(offs_list)
    is_start = np.concatenate(startflag_list)
    is_end = np.concatenate(endflag_list)
    codes1 = np.concatenate(codes1_list) if codes1_list else np.zeros(0, dtype=np.int64)

    # ---- 2. frequency filter -------------------------------------------
    uniq, inv, cnt = np.unique(codes, return_inverse=True, return_counts=True)
    thresh = max(params.min_count, int(np.ceil(params.count_frac * D)))
    keep = cnt >= thresh
    if not np.any(keep):
        return WindowResult(None, reason="allfiltered")
    kept = uniq[keep]                       # sorted kmer codes
    nk = len(kept)
    remap = np.full(len(uniq), -1, dtype=np.int64)
    remap[keep] = np.arange(nk)
    kid = remap[inv]                        # per-occurrence kept-index or -1
    ok = kid >= 0

    # occurrence-offset matrix and anchor masks
    O = ol.O
    occ = np.zeros((nk, O), dtype=np.float32)
    oo = np.clip(offs[ok], 0, O - 1)
    np.add.at(occ, (kid[ok], oo), 1.0)
    src_ok = np.zeros(nk, dtype=bool)
    snk_ok = np.zeros(nk, dtype=bool)
    np.logical_or.at(src_ok, kid[ok], is_start[ok])
    np.logical_or.at(snk_ok, kid[ok], is_end[ok])

    # ---- 2b. edges from (k+1)-mer support ------------------------------
    u1, c1 = np.unique(codes1, return_counts=True)
    sup = c1 >= params.edge_min_count
    u1s = u1[sup]
    # (k+1)-mer = prefix kmer * 4 + last base; suffix kmer = code % 4**k
    pref = u1s >> 2  # == u1s // 4
    last = u1s & 3
    mask_k = (1 << (2 * k)) - 1
    suff = ((pref << 2) | last) & mask_k
    # map prefix/suffix codes into kept indices
    pi = np.searchsorted(kept, pref)
    si = np.searchsorted(kept, suff)
    valid = (pi < nk) & (si < nk)
    valid[valid] &= (kept[pi[valid]] == pref[valid]) & (kept[si[valid]] == suff[valid])
    adj = np.zeros((nk, nk), dtype=bool)
    adj[pi[valid], si[valid]] = True
    if not adj.any():
        return WindowResult(None, reason="noedges")

    # ---- 3. position weights -------------------------------------------
    W = ol.weights(occ)                     # [nk, P]
    P = min(ol.P, wlen - k + 1 + params.len_slack)

    # ---- 4. heaviest path DP -------------------------------------------
    score = np.full((P, nk), NEG, dtype=np.float32)
    ptr = np.full((P, nk), -1, dtype=np.int32)
    score[0, src_ok] = W[src_ok, 0]
    adjW = np.where(adj, np.float32(0), NEG)  # [u, v]
    for t in range(1, P):
        prev = score[t - 1][:, None] + adjW   # [u, v]
        best_u = np.argmax(prev, axis=0)
        best = prev[best_u, np.arange(nk)]
        score[t] = np.where(best > NEG / 2, best + W[:, t], NEG)
        ptr[t] = np.where(best > NEG / 2, best_u, -1)

    # admissible ends: sink-anchored kmers at plausible consensus lengths
    t_lo = max(0, wlen - k - params.len_slack)
    t_hi = min(P - 1, wlen - k + params.len_slack)
    end_scores = score[t_lo : t_hi + 1].copy()
    end_scores[:, ~snk_ok] = NEG
    flat = end_scores.reshape(-1)
    # stable: ties resolve to the lowest flat index — a defined order; the
    # default introsort's tie order is implementation-specific
    order = np.argsort(-flat, kind="stable")

    # ---- 5. candidates + rescore ---------------------------------------
    best_err = np.inf
    best_seq = None
    n_cand = 0
    seg_total = sum(len(s) for s in segments)
    packed_segs = pack_segments(segments)   # flattened once for all candidates
    seen_final: set[int] = set()
    for idx in order[: 4 * params.n_candidates]:
        s = flat[idx]
        if s <= NEG / 2 or n_cand >= params.n_candidates:
            break
        t = t_lo + int(idx) // nk
        v = int(idx) % nk
        if v in seen_final:
            continue
        seen_final.add(v)
        # backtrack
        path = np.empty(t + 1, dtype=np.int64)
        cur = v
        for tt in range(t, -1, -1):
            path[tt] = cur
            cur = ptr[tt, cur] if tt > 0 else cur
        # expand k-mer path to bases
        first = kept[path[0]]
        bases = [(first >> (2 * (k - 1 - j))) & 3 for j in range(k)]
        for tt in range(1, t + 1):
            bases.append(int(kept[path[tt]] & 3))
        cand = np.asarray(bases, dtype=np.int8)
        n_cand += 1
        tot = edit_distance_sum(cand, packed_segs)
        err = tot / max(seg_total, 1)
        if err < best_err:
            best_err = err
            best_seq = cand

    if best_seq is None:
        return WindowResult(None, k=k, reason="nopath")
    if best_err > params.max_err:
        return WindowResult(None, err=best_err, k=k, n_candidates=n_cand, reason="badscore")
    return WindowResult(best_seq, err=best_err, k=k, n_candidates=n_cand, reason="ok")
