"""Consensus configuration, the two-pass error profile, and window stitching.

The port's copy of the parts of ``daccord_tpu.oracle.consensus`` the pipeline
runs. Stitching: consecutive windows overlap by ``w - adv`` bases; each new
window consensus is spliced onto the accumulated sequence by aligning a suffix
of the accumulator against a prefix of the new consensus. An unsolved window
either splits the read (``mode="split"``, daccord's default: emit corrected
fragments) or, with ``mode="patch"``, keeps the original A bases for its span.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .align import overlap_suffix_prefix
from .dbg import DBGParams, WindowResult, window_consensus
from .profile import ErrorProfile, OffsetLikely, profile_vs_consensus, rough_profile
from .windows import RefinedOverlap, WindowSegments


@dataclass
class ConsensusConfig:
    w: int = 40
    adv: int = 10
    # escalation ladder: (k, min_count, edge_min_count). Larger k resolves
    # in-window repeats (the reference's escalate-k-on-failure); the final
    # low-count tier rescues sparse piles where a true k-mer fell under the
    # frequency filter.
    tiers: tuple[tuple[int, int, int], ...] = ((8, 2, 2), (10, 2, 2), (12, 2, 2), (8, 1, 1))
    dbg: DBGParams = field(default_factory=DBGParams)
    mode: str = "split"          # "split" | "patch"
    min_fragment: int = 40
    # homopolymer rescue (oracle/hp.py): windows that failed or solved badly
    # solve again in run-length-compressed space; a host pass after any
    # engine
    hp_rescue: bool = False
    hp_err: float = 0.12         # route solved windows above this err
    hp_min_run: int = 3          # ...only when a run at least this long exists
    hp_margin: float = 0.005     # the expanded result must beat the direct
                                 # err by this
    hp_vote: str = "median"      # run-length vote: "median" or "posterior"
                                 # (the profile-calibrated length posterior)
    hp_accept: str = "rescore"   # acceptance: "rescore" (raw unit cost) or
                                 # "likelihood" (the likelihood ratio under
                                 # the observation model; engages with the
                                 # posterior's slope gate)
    hp_lambda_c: float = 3.0     # compressed-space edit penalty (log
                                 # units) of the likelihood acceptance

    def __post_init__(self):
        from .hp import HP_TIER

        # tier codes are 0-based indices into ``tiers`` and HP_TIER marks an
        # hp-rescued window: a deeper ladder would alias solved rows as
        # rescued
        if len(self.tiers) > HP_TIER:
            raise ValueError(
                f"ladder depth {len(self.tiers)} collides with the reserved "
                f"hp tier code {HP_TIER}; use fewer tiers")
        if self.hp_vote not in ("median", "posterior"):
            raise ValueError(f"hp_vote={self.hp_vote!r}: must be 'median' "
                             "or 'posterior'")
        if self.hp_accept not in ("rescore", "likelihood"):
            raise ValueError(f"hp_accept={self.hp_accept!r}: must be "
                             "'rescore' or 'likelihood'")

    @property
    def k_values(self) -> tuple[int, ...]:
        return tuple(sorted({t[0] for t in self.tiers}))


def make_offset_likely(profile: ErrorProfile,
                       cfg: ConsensusConfig) -> dict[int, OffsetLikely]:
    """One OL table per k tier (P spans the admissible DP lengths)."""
    tables = {}
    for k in cfg.k_values:
        P = cfg.w - k + 1 + cfg.dbg.len_slack
        O = cfg.w + 16
        tables[k] = OffsetLikely(profile, positions=P, max_offset=O)
    return tables


def estimate_profile_two_pass(refined: list[RefinedOverlap],
                              windows: list[WindowSegments],
                              cfg: ConsensusConfig,
                              sample: int = 48) -> ErrorProfile:
    """Reference-style error-profile pass: rough estimate from trace diffs,
    then true single-read rates from segments aligned to a sample consensus."""
    rough = rough_profile(refined)
    ol1 = make_offset_likely(rough, cfg)
    stride = max(1, len(windows) // sample)
    pairs: list[tuple[np.ndarray, np.ndarray]] = []
    for ws in windows[::stride]:
        res = solve_window(ws, ol1, cfg)
        if res.seq is not None:
            pairs.extend((res.seq, seg) for seg in ws.segments)
    if not pairs:
        return rough
    return profile_vs_consensus(pairs)


def solve_window(ws: WindowSegments, ol_tables: dict[int, OffsetLikely],
                 cfg: ConsensusConfig) -> WindowResult:
    """Try escalation tiers in order until one solves the window; then, with
    ``hp_rescue``, the homopolymer rescue may replace the result."""
    best = WindowResult(None, reason="depth")
    for k, mc, emc in cfg.tiers:
        p = DBGParams(**{**cfg.dbg.__dict__, "k": k,
                         "min_count": mc, "edge_min_count": emc})
        res = window_consensus(ws.segments, ol_tables[k], p, wlen=ws.wlen)
        best = res
        if res.seq is not None:
            break
    if cfg.hp_rescue and len(ws.segments) >= cfg.dbg.min_depth:
        from .hp import hp_candidate

        hp = hp_candidate(ws.segments, best.seq, best.err, ol_tables, cfg)
        if hp is not None:
            return hp
    return best


def stitch_results(a_bases: np.ndarray | None,
                   results: list[tuple[int, int, np.ndarray | None]],
                   cfg: ConsensusConfig) -> list[np.ndarray]:
    """Stitch per-window consensi into corrected fragments.

    ``results`` rows are (wstart, wlen, consensus-or-None) in window order;
    ``a_bases``, the A read, patches unsolved windows in ``patch`` mode (and
    may be None in ``split`` mode).
    The accumulator is a piece list concatenated once per fragment — the
    splice only ever inspects the accumulator's tail, so growth is O(read
    length), not O(read length²).
    """
    frags: list[np.ndarray] = []
    pieces: list[np.ndarray] = []
    plen = 0
    active = False
    acc_end = 0

    def tail(n: int) -> np.ndarray:
        out: list[np.ndarray] = []
        need = n
        for arr in reversed(pieces):
            if need <= 0:
                break
            take = min(len(arr), need)
            out.append(arr[len(arr) - take :])
            need -= take
        if not out:
            return np.zeros(0, dtype=np.int8)
        return out[0] if len(out) == 1 else np.concatenate(out[::-1])

    def drop_tail(n: int) -> None:
        nonlocal plen
        while n > 0 and pieces:
            last = pieces[-1]
            if len(last) <= n:
                n -= len(last)
                plen -= len(last)
                pieces.pop()
            else:
                pieces[-1] = last[: len(last) - n]
                plen -= n
                n = 0

    def append(arr: np.ndarray) -> None:
        nonlocal plen
        if len(arr):
            pieces.append(arr)
            plen += len(arr)

    def restart(arr: np.ndarray) -> None:
        nonlocal pieces, plen, active
        pieces = [arr]
        plen = len(arr)
        active = True

    def flush() -> None:
        nonlocal pieces, plen, active
        if pieces:
            acc = pieces[0] if len(pieces) == 1 else np.concatenate(pieces)
            if len(acc) >= cfg.min_fragment:
                frags.append(acc)
        pieces = []
        plen = 0
        active = False

    for wstart, wlen, seq in results:
        if seq is None:
            if cfg.mode == "patch":
                patch = np.asarray(a_bases[wstart : wstart + wlen], dtype=np.int8)
                if not active:
                    restart(patch)
                else:
                    olap = acc_end - wstart
                    if olap > 0:
                        drop_tail(olap)
                    append(patch)
                acc_end = wstart + wlen
            else:
                flush()
            continue
        if not active:
            restart(seq)
        else:
            # splice the next window consensus onto the accumulator: align
            # acc's tail (~nominal overlap) against seq's head, join at the
            # best correspondence; strong disagreement => stitch failure
            # (flush and restart => the read splits)
            nominal = acc_end - wstart
            t = min(plen, nominal + 10)
            head = min(len(seq), nominal + 10)
            cost, a_start, b_end = overlap_suffix_prefix(tail(t), seq[:head])
            olap_len = max(t - a_start, b_end)
            if olap_len < max(4, nominal // 4) or cost > 0.35 * olap_len:
                flush()
                restart(seq)
            else:
                append(seq[b_end:])
        acc_end = wstart + wlen
    flush()
    return frags
