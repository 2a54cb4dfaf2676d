"""The plain reference: the port's ladder transcribed into numpy.

A frozen copy of ``daccord_tpu_torch/audit/ladder.py`` (the shadow audit's
reference, held bit-equal to the port's CPU ladder), so that no change to
the program can move the yardstick. Each function transcribes its torch
counterpart op for op, on host arrays: :func:`prep` is ``prep_batch`` (W's
products and adds in ascending order, each rounded to f32),
:func:`heaviest_path` and :func:`candidates` the max-plus DP and its
backtrack (first-max ties), :func:`rescore_pick` the Myers rescore and the
pick, and :func:`solve_ladder` the whole tier ladder. Imports numpy only.
"""

from __future__ import annotations

import numpy as np

NEG = np.float32(-1e30)
HALF_NEG = np.float32(-1e30 / 2)   # torch compares with the f32 of -5e29
PAD = 4
WORD = 62            # bits of the Myers column an int64 word holds
F32 = np.float32


def cons_len(p: dict) -> int:
    return p["wlen"] + p["len_slack"]


def positions(p: dict) -> int:
    return p["wlen"] - p["k"] + 1 + p["len_slack"]


def t_range(p: dict) -> tuple[int, int]:
    P = positions(p)
    return (max(0, p["wlen"] - p["k"] - p["len_slack"]),
            min(P - 1, p["wlen"] - p["k"] + p["len_slack"]))


def _kmer_ids(seqs: np.ndarray, lens: np.ndarray, k: int) -> np.ndarray:
    L = seqs.shape[-1]
    npos = L - k + 1
    s = seqs.astype(np.int64)
    ids = np.zeros(seqs.shape[:-1] + (npos,), np.int64)
    for j in range(k):
        ids = ids * 4 + s[..., j:j + npos]
    valid = (np.arange(npos) + k) <= lens[..., None]
    return np.where(valid, ids, np.int64(4 ** k))


def prep(seqs: np.ndarray, lens: np.ndarray, nsegs: np.ndarray, ol: np.ndarray,
         p: dict) -> dict:
    """``prep_batch``: sel [B, M] int32, adjW [B, M, M] f32, W [B, M, P]
    f32, score0 [B, M] f32, snk_ok [B, M] bool, m_overflow [B] bool."""
    k, M = p["k"], p["max_kmers"]
    B, D, L = seqs.shape
    npos = L - k + 1
    SENT = 4 ** k
    N = D * npos
    if N < M:
        raise ValueError(f"prep: {N} k-mer positions cannot fill the top-{M} active set")
    ids = _kmer_ids(seqs, lens, k)
    flat_ids = ids.reshape(B, N)
    sorted_ids = np.sort(flat_ids, axis=1)
    newrun = np.ones((B, N), bool)
    newrun[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    is_start = newrun & (sorted_ids < SENT)
    ar_n = np.arange(N)
    starts = np.where(newrun, ar_n, N)
    nxt = np.concatenate([starts[:, 1:], np.full((B, 1), N)], axis=1)
    nxt = np.minimum.accumulate(nxt[:, ::-1], axis=1)[:, ::-1]
    start_counts = np.where(is_start, nxt - ar_n, 0)
    thresh = np.maximum(np.ceil(F32(p["count_frac"]) * nsegs.astype(F32)).astype(np.int64),
                        p["min_count"])
    start_counts = np.where(start_counts >= thresh[:, None], start_counts, 0)
    # the M largest of distinct keys: topk's set; sel is sorted after, so
    # their order does not matter
    key = start_counts * N + (N - 1 - ar_n)
    top = np.argpartition(key, N - M, axis=1)[:, N - M:]
    topv = np.take_along_axis(key, top, 1) // N
    sel = np.where(topv > 0, np.take_along_axis(sorted_ids, top, 1), SENT)
    sel = np.sort(sel, axis=1)
    sel_valid = sel < SENT
    m_overflow = (start_counts > 0).sum(axis=1) > M

    # searchsorted row by row, as one search over rows offset apart
    off = (SENT + 1) * np.arange(B, dtype=np.int64)[:, None]
    j = (np.searchsorted((sel + off).ravel(), (flat_ids + off).ravel()).reshape(B, N)
         - M * np.arange(B)[:, None])
    j = np.minimum(j, M - 1)
    hit = (np.take_along_axis(sel, j, 1) == flat_ids) & (flat_ids < SENT)
    kid = np.where(hit, j, -1).reshape(B, D, npos)

    m_hit = kid >= 0
    hb, hd, hp = np.nonzero(m_hit)
    slot = hb * M + kid[m_hit]
    src_ok = np.bincount(slot, weights=hp <= p["anchor_slack"], minlength=B * M) > 0
    end_lo = (lens.astype(np.int64) - k - p["end_slack"])[hb, hd]
    snk_ok = np.bincount(slot, weights=hp >= end_lo, minlength=B * M) > 0
    src_ok, snk_ok = src_ok.reshape(B, M), snk_ok.reshape(B, M)

    pair = (kid[:, :, :-1] >= 0) & (kid[:, :, 1:] >= 0)
    pb = np.nonzero(pair)[0]
    support = np.bincount((pb * M + kid[:, :, :-1][pair]) * M + kid[:, :, 1:][pair],
                          minlength=B * M * M).reshape(B, M, M)
    mask_km1 = 4 ** (k - 1) - 1
    compat = (sel[:, :, None] & mask_km1) == (sel[:, None, :] >> 2)
    adj = (compat & (support >= p["edge_min_count"])
           & sel_valid[:, :, None] & sel_valid[:, None, :])

    W = position_weights(slot, np.minimum(hp, ol.shape[1] - 1), ol, B * M).reshape(B, M, -1)
    adjW = np.where(adj, F32(0), NEG)
    score0 = np.where(src_ok & sel_valid, W[:, :, 0], NEG)
    return dict(sel=sel.astype(np.int32), adjW=adjW, W=W, score0=score0,
                snk_ok=snk_ok, m_overflow=m_overflow)


def position_weights(slot: np.ndarray, off: np.ndarray, ol: np.ndarray,
                     rows: int) -> np.ndarray:
    """``position_weights_plain`` of the occurrences (row ``slot``, offset
    ``off``) against ol [P, O]: W [rows, P] f32, each row's sum over its
    offsets ascending, one f32 product and one f32 add a term.

    Zero counts are skipped, as the CUDA kernel skips them: with every ol
    entry finite (``TierLadder`` checks it) a zero count's product is +-0,
    which leaves a nonzero sum unchanged and keeps +0 as +0, so the bits
    are the dense loop's. Terms are added by rank: the j-th nonzero offset
    of every row that has one, in one vector op a rank."""
    P, O = ol.shape
    occ = np.bincount(slot * O + off, minlength=rows * O).reshape(rows, O)
    r, o = np.nonzero(occ)                       # row-major: offsets ascending
    first = np.searchsorted(r, r)                # each row's first nonzero
    rank = np.arange(r.size) - first
    W = np.zeros((rows, P), F32)
    olT = np.ascontiguousarray(ol.T, dtype=F32)
    for j in range(int(rank.max()) + 1 if r.size else 0):
        at = rank == j
        rj = r[at]
        W[rj] += occ[rj, o[at]].astype(F32)[:, None] * olT[o[at]]
    return W


def heaviest_path(adjW: np.ndarray, wt: np.ndarray, s0: np.ndarray):
    """``heaviest_path_plain``: scores [B, P, M] f32 and ptrs [B, P, M]
    int32, the first u reaching each max."""
    B, M, _ = adjW.shape
    P = wt.shape[1]
    adjT = np.ascontiguousarray(adjW.transpose(0, 2, 1))   # [B, v, u]
    s = s0
    scores = [s]
    ptrs = [np.zeros((B, M), np.int32)]
    flat = (np.arange(B * M) * M).reshape(B, M)       # x's [b, v, 0]
    for t in range(1, P):
        x = s[:, None, :] + adjT
        best_u = x.argmax(axis=2)
        best = np.take(x.reshape(-1), flat + best_u)
        s = np.where(best > HALF_NEG, best + wt[:, t, :], NEG)
        scores.append(s)
        ptrs.append(best_u.astype(np.int32))
    return np.stack(scores, axis=1), np.stack(ptrs, axis=1)


def candidates(scores: np.ndarray, ptrs: np.ndarray, snk_ok: np.ndarray,
               sel: np.ndarray, *, k: int, CL: int, C: int, t_lo: int, t_hi: int):
    """``candidates_backtrack``: cand [B, C, CL] int32, clen [B, C] int32,
    ok [B, C] bool."""
    B, P, M = scores.shape
    iota_t = np.arange(P).reshape(1, P, 1)
    iota_v = np.arange(M).reshape(1, 1, M)
    t_ok = (iota_t >= t_lo) & (iota_t <= t_hi)
    final = np.where(t_ok & snk_ok[:, None, :], scores, NEG)
    flat_idx = iota_t * M + iota_v
    iota_cl = np.arange(CL)
    shifts = np.clip(2 * (k - 1 - iota_cl), 0, 30)
    tail_t = np.clip(iota_cl - k + 1, 0, P - 1)
    chosen = np.zeros((B, M), bool)
    tbs, vbs, mxs = [], [], []
    for _ in range(C):
        fmask = np.where(chosen[:, None, :], NEG, final)
        mx = fmask.max(axis=(1, 2))
        idx = np.where(fmask == mx[:, None, None], flat_idx, P * M).min(axis=(1, 2))
        tbs.append(idx // M)
        vbs.append(idx % M)
        mxs.append(mx)
        chosen = chosen | (iota_v[0] == vbs[-1][:, None])
    t_best = np.stack(tbs, axis=1)
    v_best = np.stack(vbs, axis=1)
    kpath = np.empty((B, C, P), sel.dtype)
    node = np.zeros_like(v_best)
    for i in range(P):
        t = P - 1 - i
        forced = np.clip(np.where(t_best == t, v_best, node), 0, M - 1)
        kpath[:, :, t] = np.take_along_axis(sel, forced, 1)
        ptr_val = np.take_along_axis(ptrs[:, t, :], forced, 1).astype(forced.dtype)
        node = np.where((t <= t_best) & (t > 0), ptr_val, forced)
    head = (kpath[:, :, :1] >> shifts) & 3
    tail = kpath[:, :, tail_t] & 3
    base = np.where(iota_cl < k, head, tail)
    cand = np.where(iota_cl < (t_best + k)[:, :, None], base, PAD)
    return (cand.astype(np.int32), (t_best + k).astype(np.int32),
            np.stack(mxs, axis=1) > HALF_NEG)


def edit_distance_myers(cand: np.ndarray, cand_len: np.ndarray, seg: np.ndarray,
                        seg_len: np.ndarray) -> np.ndarray:
    """``edit_distance_myers``: the exact edit distance of cand[..., :n]
    against seg[..., :m], batched over the broadcast leading axes, the DP
    column in ceil(CL / 62) int64 words."""
    CL = cand.shape[-1]
    NW = max(1, -(-CL // WORD))
    L = seg.shape[-1]
    shape = np.broadcast_shapes(cand.shape[:-1], seg.shape[:-1])
    mask = np.int64((1 << WORD) - 1)
    top = WORD - 1
    pos = np.arange(CL)
    valid = pos < cand_len[..., None]
    bit = np.left_shift(np.int64(1), (pos % WORD).astype(np.int64))
    c64 = cand.astype(np.int64)
    n = cand_len.astype(np.int64)
    one, zero = np.int64(1), np.int64(0)
    s64 = np.moveaxis(np.broadcast_to(seg.astype(np.int64), shape + (L,)), -1, 0)
    vp, vn, hb, eq = [], [], [], []
    for w in range(NW):
        in_w = valid & (pos // WORD == w)
        peq = np.stack([np.where(in_w & (c64 == c), bit, zero).sum(-1)
                        for c in range(4)] + [np.zeros_like(n)], axis=-1)
        peq = np.broadcast_to(peq, shape + (5,))
        # every step's match mask at once, steps first; PAD takes the 0 mask
        eq.append(np.take_along_axis(peq[None], s64[..., None], -1)[..., 0])
        nbits = np.clip(n - w * WORD, 0, WORD)
        vp.append(np.broadcast_to(np.left_shift(one, nbits) - 1, shape).copy())
        vn.append(np.zeros(shape, np.int64))
        hw = np.where(n > 0, (n - 1) // WORD, -1)
        hb.append(np.broadcast_to(np.where(hw == w, np.left_shift(
            one, np.maximum((n - 1) % WORD, 0)), zero), shape))
    score = np.broadcast_to(n, shape).copy()
    scores = [score]
    sl = np.clip(np.broadcast_to(seg_len.astype(np.int64), shape), 0, L)
    # the steps past the longest segment change no distance that is read
    for i in range(int(sl.max()) if sl.size else 0):
        carry = None
        hp_in, hn_in = one, zero
        delta = None
        for w in range(NW):
            last = w == NW - 1
            x = eq[w][i] | vn[w]
            a = x & vp[w]
            s = vp[w] + a if carry is None else vp[w] + a + carry
            if not last:
                carry = s >> WORD
                s = s & mask
            d0 = (s ^ vp[w]) | x
            hn = vp[w] & d0
            hp = (vn[w] | ~(vp[w] | d0)) & mask
            dw = (hp & hb[w]) - (hn & hb[w])
            delta = dw if delta is None else delta + dw
            x2 = ((hp << 1) & mask) | hp_in
            h2 = (hn << 1) | hn_in
            if not last:
                hp_in, hn_in = hp >> top, hn >> top
            vn[w] = x2 & d0
            vp[w] = (h2 | ~(x2 | d0)) & mask
        score = score + np.sign(delta)
        scores.append(score)
    res = np.take_along_axis(np.stack(scores, axis=-1), sl[..., None], -1)[..., 0]
    return np.where(n == 0, np.broadcast_to(seg_len.astype(np.int64), shape), res)


def rescore_pick(seqs, lens, nsegs, cand, clen, ok, p: dict) -> dict:
    """``rescore_pick_plain``: cons [B, CL] int8, cons_len [B] int32, err
    [B] f32, solved [B] bool."""
    B, C, CL = cand.shape
    seg_total = np.maximum(lens.astype(np.int64).sum(axis=1), 1).astype(F32)
    dists = edit_distance_myers(cand[:, :, None, :], clen[:, :, None],
                                seqs[:, None, :, :], lens[:, None, :])
    dists = np.where(lens[:, None, :] > 0, dists, 0)
    errs = dists.sum(axis=2).astype(np.int32).astype(F32) / seg_total[:, None]
    inf = F32(np.inf)
    errs = np.where(ok, errs, inf)
    ar_c = np.arange(C)
    ci = np.where(errs == errs.min(axis=1, keepdims=True), ar_c, C).min(axis=1)
    rows = np.arange(B)
    best_err = errs[rows, ci]
    best_cons = cand[rows, ci]
    best_len = np.where(ok[rows, ci], clen[rows, ci], 0).astype(clen.dtype)
    any_path = ok.any(axis=1)
    solved = any_path & (best_err <= F32(p["max_err"])) & (nsegs >= p["min_depth"])
    return dict(cons=np.where(solved[:, None], best_cons, PAD).astype(np.int8),
                cons_len=np.where(solved, best_len, 0).astype(np.int32),
                err=np.where(any_path, best_err, inf).astype(F32),
                solved=solved)


def solve_batch(seqs, lens, nsegs, ol: np.ndarray, p: dict) -> dict:
    """``solve_batch_core`` on either route (they give the same bits)."""
    g = prep(seqs, lens, nsegs, ol, p)
    wt = np.ascontiguousarray(g["W"].transpose(0, 2, 1))
    t_lo, t_hi = t_range(p)
    scores, ptrs = heaviest_path(g["adjW"], wt, g["score0"])
    cand, clen, ok = candidates(scores, ptrs, g["snk_ok"], g["sel"], k=p["k"],
                                CL=cons_len(p), C=p["n_candidates"], t_lo=t_lo,
                                t_hi=t_hi)
    out = rescore_pick(seqs, lens, nsegs, cand.astype(np.int8), clen, ok, p)
    out["m_overflow"] = g["m_overflow"]
    return out


def solve_ladder(spec: tuple, seqs: np.ndarray, lens: np.ndarray,
                 nsegs: np.ndarray, tier0_only: bool = False) -> dict:
    """``ladder_core`` of one dense batch (``tier0_core`` with
    ``tier0_only``: the two-stream ladder's Stream A), in the layout of
    ``tiers.unpack_result``: cons [B, CL] int8, cons_len [B] int32, err [B]
    f32, solved [B] bool, tier [B] int32, m_ovf [B] bool, esc_overflow 0.
    ``spec`` is ``(tables, params, wide_p0)`` (``TierLadder.spec``)."""
    tables, params, wide_p0 = spec
    p0 = params[0]
    out0 = solve_batch(seqs, lens, nsegs, tables[p0["k"]], p0)
    solved, cons = out0["solved"].copy(), out0["cons"].copy()
    cons_len_, err = out0["cons_len"].copy(), out0["err"].copy()
    tier = np.where(solved, 0, -1).astype(np.int32)
    m_ovf = out0["m_overflow"].copy()
    if tier0_only:
        params, wide_p0 = params[:1], None
    if wide_p0 is not None:
        idx = np.nonzero(m_ovf & (nsegs >= p0["min_depth"]))[0]
        if idx.size:
            out_w = solve_batch(seqs[idx], lens[idx], nsegs[idx], tables[p0["k"]], wide_p0)
            take = out_w["solved"]
            it = idx[take]
            cons[it] = out_w["cons"][take]
            cons_len_[it] = out_w["cons_len"][take]
            err[it] = out_w["err"][take]
            solved[it] = True
            tier[it] = 0
            m_ovf[idx[take & ~out_w["m_overflow"]]] = False
    if len(params) > 1:
        idx = np.nonzero(~solved & (nsegs >= p0["min_depth"]))[0]
        e_movf = np.zeros(idx.size, bool)
        live = np.arange(idx.size)
        for ti in range(1, len(params)):
            if live.size == 0:
                break
            rows = idx[live]
            p = params[ti]
            out_t = solve_batch(seqs[rows], lens[rows], nsegs[rows], tables[p["k"]], p)
            e_movf[live] |= out_t["m_overflow"]
            take = out_t["solved"]
            rt = rows[take]
            cons[rt] = out_t["cons"][take]
            cons_len_[rt] = out_t["cons_len"][take]
            err[rt] = out_t["err"][take]
            solved[rt] = True
            tier[rt] = ti
            live = live[~take]
        m_ovf[idx] = m_ovf[idx] | e_movf
    return dict(cons=cons, cons_len=cons_len_, err=err, solved=tier >= 0, tier=tier,
                m_ovf=m_ovf, esc_overflow=0)
