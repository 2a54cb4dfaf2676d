"""Batched fixed-shape window consensus in torch.

The port of ``daccord_tpu/kernels/window_kernel.py`` with an explicit batch
axis in place of ``vmap``. One batch solve has three stages:

- graph construction (:func:`prep_batch`): k-mer extraction, frequency
  filtering and top-M compaction, (k+1)-mer edge support, the OffsetLikely
  position weights as one f32 matmul, and the source/sink anchors;
- the heaviest path, C candidate end states and their backtrack: on the
  fused route the hand-written kernel ``kernels.dp_backtrack``, on the scan
  route the hand-written DP kernel ``kernels.heaviest_path`` then the torch
  backtrack (on the CPU, each kernel's plain version);
- the Myers bit-parallel rescore of the candidates against the window's
  segments (:func:`edit_distance_myers`) and the acceptance rule
  (:func:`rescore_pick`).

Semantics follow the JAX package, tie-breaking included: k-mers kept in
code-sorted order, the lowest index among equal counts in the top-M choice,
first-argmax DP ties and t-major end-state order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import dp_backtrack as _dp
from . import heaviest_path as _hp

NEG = -1e30
PAD = 4


@dataclass(frozen=True)
class KernelParams:
    k: int = 8
    min_count: int = 2
    count_frac: float = 0.0
    edge_min_count: int = 2
    anchor_slack: int = 2
    end_slack: int = 3
    len_slack: int = 8
    n_candidates: int = 3
    min_depth: int = 3
    max_err: float = 0.3
    max_kmers: int = 64
    wlen: int = 40

    @property
    def cons_len(self) -> int:
        # P - 1 + k == wlen + len_slack for every k: one uniform output shape
        return self.wlen + self.len_slack

    @property
    def positions(self) -> int:
        return self.wlen - self.k + 1 + self.len_slack

    @property
    def t_range(self) -> tuple[int, int]:
        """Admissible end steps [t_lo, t_hi] of the DP (consensus lengths
        within len_slack of the window length)."""
        P = self.positions
        return (max(0, self.wlen - self.k - self.len_slack),
                min(P - 1, self.wlen - self.k + self.len_slack))


def _kmer_ids(seqs: torch.Tensor, lens: torch.Tensor, k: int) -> torch.Tensor:
    """[B, D, L] int8 -> [B, D, L-k+1] int64 codes; invalid positions = 4**k."""
    L = seqs.shape[-1]
    npos = L - k + 1
    s = seqs.to(torch.int64)
    ids = torch.zeros(seqs.shape[:-1] + (npos,), dtype=torch.int64,
                      device=seqs.device)
    for j in range(k):
        ids = ids * 4 + s[..., j : j + npos]
    pos = torch.arange(npos, device=seqs.device)
    valid = (pos + k) <= lens[..., None]
    return torch.where(valid, ids, torch.full_like(ids, 4**k))


def prep_batch(seqs: torch.Tensor, lens: torch.Tensor, nsegs: torch.Tensor,
               ol: torch.Tensor, p: KernelParams) -> dict:
    """Graph construction for a batch of windows.

    seqs [B, D, L] int8, lens [B, D] i32, nsegs [B] i32, ol [P, O] f32 ->
    dict of sel [B, M] i32 (kept k-mer codes, ascending, 4**k for empty
    slots), adjW [B, M, M] f32 (0 or -1e30), W [B, M, P] f32, score0 [B, M]
    f32, snk_ok [B, M] bool, m_overflow [B] bool.

    Every position holds at most one kept k-mer (the kept codes are
    distinct), so occurrences are carried as one kept-index per position
    instead of the JAX package's [D, npos, M] one-hot; counts, anchors and
    edge support are exact integer reductions either way."""
    k, M = p.k, p.max_kmers
    B, D, L = seqs.shape
    dev = seqs.device
    npos = L - k + 1
    SENT = 4**k
    P, O = ol.shape
    N = D * npos
    if N < M:
        raise ValueError(f"prep_batch: {N} k-mer positions cannot fill the "
                         f"top-{M} active set")

    # ---- k-mer counting + top-M compaction -------------------------------
    ids = _kmer_ids(seqs, lens, k)                          # [B, D, npos]
    sorted_ids = ids.reshape(B, N).sort(dim=1).values
    newrun = torch.ones((B, N), dtype=torch.bool, device=dev)
    newrun[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    is_start = newrun & (sorted_ids < SENT)
    # run length at each run start = next run start - this index, via a
    # reverse cummin of run-start indices (flip, cummin, flip)
    ar_n = torch.arange(N, device=dev)
    starts = torch.where(newrun, ar_n, torch.full_like(ar_n, N))
    nxt = torch.cat([starts[:, 1:], torch.full((B, 1), N, device=dev)], dim=1)
    nxt = nxt.flip(1).cummin(dim=1).values.flip(1)
    start_counts = torch.where(is_start, nxt - ar_n, torch.zeros_like(nxt))
    thresh = torch.clamp(torch.ceil(torch.tensor(p.count_frac, dtype=torch.float32)
                                    * nsegs.to(torch.float32)).to(torch.int64),
                         min=p.min_count)
    start_counts = torch.where(start_counts >= thresh[:, None], start_counts,
                               torch.zeros_like(start_counts))
    # top-M by count with the lowest index first among equal counts (the
    # lax.top_k order): select on the unique key count*N + (N-1-i)
    key = start_counts * N + (N - 1 - ar_n)
    top = key.topk(M, dim=1)
    topv = top.values // N
    sel = torch.where(topv > 0, torch.gather(sorted_ids, 1, top.indices),
                      torch.full_like(topv, SENT))
    sel = sel.sort(dim=1).values                            # code-ascending
    sel_valid = sel < SENT
    m_overflow = (start_counts > 0).sum(dim=1) > M

    # ---- occurrences: kept index of every position (-1 = none) -----------
    flat_ids = ids.reshape(B, N)
    j = torch.searchsorted(sel, flat_ids).clamp(max=M - 1)
    hit = (torch.gather(sel, 1, j) == flat_ids) & (flat_ids < SENT)
    kid = torch.where(hit, j, torch.full_like(j, -1)).view(B, D, npos)

    row = torch.arange(B, device=dev).view(B, 1, 1).expand(B, D, npos)
    pos = torch.arange(npos, device=dev).view(1, 1, npos).expand(B, D, npos)
    m_hit = kid >= 0
    hb, hk, hp = row[m_hit], kid[m_hit], pos[m_hit]
    o_idx = hp.clamp(max=O - 1)
    occ = torch.zeros((B * M * O,), dtype=torch.float32, device=dev)
    occ.index_add_(0, (hb * M + hk) * O + o_idx,
                   torch.ones_like(o_idx, dtype=torch.float32))
    occ = occ.view(B, M, O)

    src_ok = torch.zeros((B * M,), dtype=torch.int32, device=dev)
    src_ok.index_add_(0, hb * M + hk, (hp <= p.anchor_slack).to(torch.int32))
    end_lo = (lens.to(torch.int64) - k - p.end_slack)[:, :, None].expand(B, D, npos)[m_hit]
    snk_ok = torch.zeros((B * M,), dtype=torch.int32, device=dev)
    snk_ok.index_add_(0, hb * M + hk, (hp >= end_lo).to(torch.int32))
    src_ok = src_ok.view(B, M) > 0
    snk_ok = snk_ok.view(B, M) > 0

    # ---- (k+1)-mer edge support ------------------------------------------
    # every occurrence of the (k+1)-mer u.c has kid[i]==u and kid[i+1]==v,
    # so its count is the number of adjacent (kept, kept) position pairs
    pair = (kid[:, :, :-1] >= 0) & (kid[:, :, 1:] >= 0)
    pb = row[:, :, :-1][pair]
    support = torch.zeros((B * M * M,), dtype=torch.int32, device=dev)
    support.index_add_(0, (pb * M + kid[:, :, :-1][pair]) * M + kid[:, :, 1:][pair],
                       torch.ones_like(pb, dtype=torch.int32))
    support = support.view(B, M, M)
    mask_km1 = 4 ** (k - 1) - 1
    compat = (sel[:, :, None] & mask_km1) == (sel[:, None, :] >> 2)
    adj = (compat & (support >= p.edge_min_count)
           & sel_valid[:, :, None] & sel_valid[:, None, :])

    # ---- position weights --------------------------------------------------
    W = torch.matmul(occ, ol.t())                           # [B, M, P] f32
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    adjW = torch.where(adj, torch.zeros((), dtype=torch.float32, device=dev), neg)
    score0 = torch.where(src_ok & sel_valid, W[:, :, 0], neg)
    return dict(sel=sel.to(torch.int32), adjW=adjW, W=W, score0=score0,
                snk_ok=snk_ok, m_overflow=m_overflow)


def edit_distance_myers(cand: torch.Tensor, cand_len: torch.Tensor,
                        seg: torch.Tensor, seg_len: torch.Tensor) -> torch.Tensor:
    """Exact unit-cost edit distance of cand[..., :cand_len] vs
    seg[..., :seg_len], batched over the leading axes (they broadcast).

    Myers/Hyyrö bit-parallel DP with the whole DP column in ONE int64 word.
    Carries and left shifts only move bits upward, so every bit at or below
    cand_len-1 is exact; the word is masked to the low CL bits after each step
    so the addition never overflows, which needs CL <= 62. One step per
    segment base; PAD (4) matches nothing."""
    CL = cand.shape[-1]
    if CL > 62:
        raise ValueError(f"Myers rescore holds one int64 word: CL={CL} > 62")
    L = seg.shape[-1]
    dev = cand.device
    shape = torch.broadcast_shapes(cand.shape[:-1], seg.shape[:-1])
    i64 = torch.int64
    pos = torch.arange(CL, device=dev)
    valid = pos < cand_len[..., None]
    bit = torch.bitwise_left_shift(torch.ones((), dtype=i64, device=dev), pos)
    c64 = cand.to(i64)
    zero = torch.zeros((), dtype=i64, device=dev)
    peq = torch.stack([torch.where(valid & (c64 == c), bit, zero).sum(-1)
                       for c in range(4)] + [torch.zeros_like(cand_len, dtype=i64)],
                      dim=-1)                               # [..., 5]; PAD -> 0
    n = cand_len.to(i64)
    one = torch.ones((), dtype=i64, device=dev)
    full = (1 << CL) - 1
    vp = (torch.bitwise_left_shift(one, n) - 1).expand(shape).clone()
    vn = torch.zeros(shape, dtype=i64, device=dev)
    hb = torch.bitwise_left_shift(one, (n - 1).clamp(min=0)).expand(shape)
    score = n.expand(shape).clone()
    res = score.clone()                                     # seg_len == 0
    peq = peq.expand(shape + (5,))
    sl = seg_len.expand(shape)
    s64 = seg.to(i64).expand(shape + (L,))
    for i in range(L):
        e = torch.gather(peq, -1, s64[..., i : i + 1])[..., 0]
        x = e | vn
        a = x & vp
        d0 = ((vp + a) ^ vp) | x
        hn = vp & d0
        hp = vn | ~(vp | d0)
        up = (hp & hb) != 0
        dn = (hn & hb) != 0
        score = score + up.to(i64) - dn.to(i64)
        x2 = (torch.bitwise_left_shift(hp, 1) | 1) & full
        h2 = torch.bitwise_left_shift(hn, 1) & full
        vn = x2 & d0
        vp = (h2 | ~(x2 | d0)) & full
        res = torch.where(sl == i + 1, score, res)
    return torch.where(n == 0, sl.to(i64), res)


def rescore_pick(seqs: torch.Tensor, lens: torch.Tensor, nsegs: torch.Tensor,
                 cand: torch.Tensor, clen: torch.Tensor, ok: torch.Tensor,
                 p: KernelParams) -> dict:
    """Myers-rescore the C candidates of each window against its segments and
    accept the argmin (the first on ties) — the tail of every solve.

    seqs [B, D, L] int8, lens [B, D], nsegs [B], cand [B, C, CL] int8,
    clen [B, C] i32, ok [B, C] bool."""
    B, C, CL = cand.shape
    dev = cand.device
    seg_total = lens.sum(dim=1).clamp(min=1).to(torch.float32)       # [B]
    dists = edit_distance_myers(cand[:, :, None, :], clen[:, :, None],
                                seqs[:, None, :, :], lens[:, None, :])  # [B,C,D]
    dists = torch.where(lens[:, None, :] > 0, dists, torch.zeros_like(dists))
    errs = dists.sum(dim=2).to(torch.int32).to(torch.float32) / seg_total[:, None]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    errs = torch.where(ok, errs, inf)
    # argmin, the lowest index among equal errors (an all-inf row gives 0)
    ar_c = torch.arange(C, device=dev)
    ci = torch.where(errs == errs.amin(dim=1, keepdim=True), ar_c,
                     torch.full_like(ar_c, C)).amin(dim=1)
    rows = torch.arange(B, device=dev)
    best_err = errs[rows, ci]
    best_cons = cand[rows, ci]
    best_len = torch.where(ok[rows, ci], clen[rows, ci], torch.zeros_like(ci, dtype=clen.dtype))
    any_path = ok.any(dim=1)
    max_err = torch.tensor(p.max_err, dtype=torch.float32, device=dev)
    solved = any_path & (best_err <= max_err) & (nsegs >= p.min_depth)
    return dict(cons=torch.where(solved[:, None], best_cons,
                                 torch.full_like(best_cons, PAD)).to(torch.int8),
                cons_len=torch.where(solved, best_len, torch.zeros_like(best_len)),
                err=torch.where(any_path, best_err, inf),
                solved=solved)


def solve_batch_core(seqs: torch.Tensor, lens: torch.Tensor, nsegs: torch.Tensor,
                     ol: torch.Tensor, p: KernelParams, dp=None,
                     route: str = "fused") -> dict:
    """Solve a batch of windows: prep, the heaviest path and its candidates,
    rescore.

    ``route`` picks how the heaviest path runs, the JAX package's two solve
    routes (bit-identical to each other):

    - ``"fused"`` (its ``--pallas`` route): the DP, the end-state choice and
      the backtrack in one kernel, ``dp_backtrack.dp_backtrack_batch``;
    - ``"scan"`` (its default route): the DP alone,
      ``heaviest_path.heaviest_path_batch``, writes the score and pointer
      stacks, then ``dp_backtrack.candidates_backtrack`` (torch) chooses the
      end states and walks the pointers.

    ``dp`` replaces the route's kernel wrapper with a function of the same
    signature (e.g. its plain version); None is the wrapper (the kernel on
    CUDA, the plain version on the CPU). Returns cons [B, CL] int8,
    cons_len [B] i32, err [B] f32, solved [B] bool, m_overflow [B] bool."""
    g = prep_batch(seqs, lens, nsegs, ol, p)
    wt = g["W"].transpose(1, 2).contiguous()               # [B, P, M]
    t_lo, t_hi = p.t_range
    kw = dict(k=p.k, cons_len=p.cons_len, n_candidates=p.n_candidates,
              t_lo=t_lo, t_hi=t_hi)
    if route == "fused":
        dp = _dp.dp_backtrack_batch if dp is None else dp
        cand, clen, ok = dp(g["adjW"], wt, g["score0"], g["snk_ok"], g["sel"], **kw)
    elif route == "scan":
        dp = _hp.heaviest_path_batch if dp is None else dp
        scores, ptrs = dp(g["adjW"], wt, g["score0"])
        cand, clen, ok = _dp.candidates_backtrack(scores, ptrs, g["snk_ok"],
                                                  g["sel"], **kw)
    else:
        raise ValueError(f"route {route!r}: expected 'fused' or 'scan'")
    out = rescore_pick(seqs, lens, nsegs, cand.to(torch.int8), clen, ok, p)
    out["m_overflow"] = g["m_overflow"]
    return out
