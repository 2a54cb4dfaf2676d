"""Batched fixed-shape window consensus in torch.

The port of ``daccord_tpu/kernels/window_kernel.py`` with an explicit batch
axis in place of ``vmap``. One batch solve has three stages:

- graph construction (:func:`prep_batch`): k-mer extraction, frequency
  filtering and top-M compaction, (k+1)-mer edge support, the OffsetLikely
  position weights summed in one fixed order (``kernels.position_weights``,
  the kernel on CUDA), and the source/sink anchors;
- the heaviest path, C candidate end states and their backtrack: on the
  fused route the hand-written kernel ``kernels.dp_backtrack``, on the scan
  route the hand-written DP kernel ``kernels.heaviest_path`` then the torch
  backtrack (on the CPU, each kernel's plain version);
- the Myers bit-parallel rescore of the candidates against the window's
  segments and the acceptance rule (``kernels.rescore.rescore_pick``, the
  kernel on CUDA).

Semantics follow the JAX package, tie-breaking included: k-mers kept in
code-sorted order, the lowest index among equal counts in the top-M choice,
first-argmax DP ties and t-major end-state order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import dp_backtrack as _dp
from . import heaviest_path as _hp
from .position_weights import position_weights
from .rescore import edit_distance_myers, rescore_pick  # noqa: F401 (re-exported)

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
    # a Python scalar meets an f32 tensor as an f32 operand: the same
    # product as a 0-dim f32 tensor, without a host-to-device copy
    thresh = torch.clamp(torch.ceil(nsegs.to(torch.float32) * p.count_frac
                                    ).to(torch.int64), min=p.min_count)
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
    # kid in int32 (searchsorted's narrow output), what the W kernel reads
    flat_ids = ids.reshape(B, N)
    j = torch.searchsorted(sel, flat_ids, out_int32=True).clamp(max=M - 1)
    hit = (torch.gather(sel, 1, j) == flat_ids) & (flat_ids < SENT)
    kid = torch.where(hit, j, torch.full_like(j, -1)).view(B, D, npos)

    # every position adds to a slot of its own window (a miss adds 0, at a
    # slot spread by its position so the zeros do not pile onto one
    # address), so no count of the hits crosses to the host and each slot's
    # integer sum is the masked one
    row = torch.arange(B, device=dev).view(B, 1, 1)
    pos = torch.arange(npos, device=dev).view(1, 1, npos)
    m_hit = kid >= 0
    kc = torch.where(m_hit, kid, (pos % M).to(kid.dtype)).to(torch.int64)
    slot = (row * M + kc).reshape(-1)
    src_ok = torch.zeros((B * M,), dtype=torch.int32, device=dev)
    src_ok.index_add_(0, slot, (m_hit & (pos <= p.anchor_slack)).to(torch.int32).reshape(-1))
    end_lo = (lens.to(torch.int64) - k - p.end_slack)[:, :, None]
    snk_ok = torch.zeros((B * M,), dtype=torch.int32, device=dev)
    snk_ok.index_add_(0, slot, (m_hit & (pos >= end_lo)).to(torch.int32).reshape(-1))
    src_ok = src_ok.view(B, M) > 0
    snk_ok = snk_ok.view(B, M) > 0

    # ---- (k+1)-mer edge support ------------------------------------------
    # every occurrence of the (k+1)-mer u.c has kid[i]==u and kid[i+1]==v,
    # so its count is the number of adjacent (kept, kept) position pairs
    pair = (kid[:, :, :-1] >= 0) & (kid[:, :, 1:] >= 0)
    support = torch.zeros((B * M * M,), dtype=torch.int32, device=dev)
    support.index_add_(0, ((row * M + kc[:, :, :-1]) * M + kc[:, :, 1:]).reshape(-1),
                       pair.to(torch.int32).reshape(-1))
    support = support.view(B, M, M)
    mask_km1 = 4 ** (k - 1) - 1
    compat = (sel[:, :, None] & mask_km1) == (sel[:, None, :] >> 2)
    adj = (compat & (support >= p.edge_min_count)
           & sel_valid[:, :, None] & sel_valid[:, None, :])

    # ---- position weights --------------------------------------------------
    W = position_weights(kid, ol, M)                        # [B, M, P] f32
    adjW = torch.where(adj, 0.0, NEG).to(torch.float32)
    score0 = torch.where(src_ok & sel_valid, W[:, :, 0], NEG)
    return dict(sel=sel.to(torch.int32), adjW=adjW, W=W, score0=score0,
                snk_ok=snk_ok, m_overflow=m_overflow)


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
