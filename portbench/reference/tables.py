"""The ladder's tables and tier parameters, worked out from the
configuration and the error profile as the program's set-up works them out
(``oracle/profile.py OffsetLikely``, ``oracle/consensus.py
make_offset_likely``, ``kernels/tiers.py TierLadder.from_config`` and
``spec``): frozen copies. Imports numpy only."""

from __future__ import annotations

import numpy as np


def offset_likely(p_ins: float, p_del: float, positions: int, max_offset: int,
                  ins_tail: int = 6) -> np.ndarray:
    """OL[p, o] for p < positions, o < max_offset: the per-base length
    increment distribution (a deletion, or a base and a geometric run of
    insertions truncated at ``ins_tail``) convolved p times, each row
    normalised, as float32."""
    inc = np.zeros(2 + ins_tail)
    inc[0] = p_del
    rem = 1.0 - p_del
    for i in range(ins_tail + 1):
        inc[1 + i] = rem * (1 - p_ins) * (p_ins ** i)
    inc /= inc.sum()
    ol = np.zeros((positions, max_offset), dtype=np.float64)
    cur = np.zeros(max_offset)
    cur[0] = 1.0
    ol[0] = cur
    for p in range(1, positions):
        cur = np.convolve(cur, inc)[:max_offset]
        s = cur.sum()
        if s > 0:
            cur = cur / s
        ol[p] = cur
    return ol.astype(np.float32)


def ladder_spec(cfg: dict, profile: dict) -> tuple:
    """``(tables, params, wide_p0)``: one OffsetLikely table per k of the
    tiers, and each tier's parameters (the min_count <= 1 tiers at the
    rescue active-set size), as ``reference.ladder.solve_ladder`` takes
    them."""
    w, dbg = cfg["w"], cfg["dbg"]
    tables = {}
    for k in sorted({t[0] for t in cfg["tiers"]}):
        tables[k] = offset_likely(profile["p_ins"], profile["p_del"],
                                  positions=w - k + 1 + dbg["len_slack"], max_offset=w + 16)
    params = [dict(k=k, min_count=mc, count_frac=dbg["count_frac"], edge_min_count=emc,
                   anchor_slack=dbg["anchor_slack"], end_slack=dbg["end_slack"],
                   len_slack=dbg["len_slack"], n_candidates=dbg["n_candidates"],
                   min_depth=dbg["min_depth"], max_err=dbg["max_err"],
                   max_kmers=cfg["rescue_max_kmers"] if mc <= 1 else cfg["max_kmers"],
                   wlen=w)
              for k, mc, emc in cfg["tiers"]]
    wide = None
    if cfg["overflow_rescue"] and params[0]["max_kmers"] < cfg["rescue_max_kmers"]:
        wide = dict(params[0], max_kmers=cfg["rescue_max_kmers"])
    return tables, params, wide
