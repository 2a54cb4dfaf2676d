"""Consensus configuration, the two-pass error profile, and window stitching.

The port's copy of the parts of ``daccord_tpu.oracle.consensus`` the main path
runs. Stitching: consecutive windows overlap by ``w - adv`` bases; each new
window consensus is spliced onto the accumulated sequence by aligning a suffix
of the accumulator against a prefix of the new consensus. An unsolved window
splits the read (daccord's default: emit corrected fragments). The JAX
package's ``patch`` mode, which keeps the original A bases there, is not
ported.
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
    min_fragment: int = 40

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
    """Try escalation tiers in order until one solves the window."""
    best = WindowResult(None, reason="depth")
    for k, mc, emc in cfg.tiers:
        p = DBGParams(**{**cfg.dbg.__dict__, "k": k,
                         "min_count": mc, "edge_min_count": emc})
        res = window_consensus(ws.segments, ol_tables[k], p, wlen=ws.wlen)
        best = res
        if res.seq is not None:
            break
    return best


def stitch_results(results: list[tuple[int, int, np.ndarray | None]],
                   cfg: ConsensusConfig) -> list[np.ndarray]:
    """Stitch per-window consensi into corrected fragments.

    ``results`` rows are (wstart, wlen, consensus-or-None) in window order.
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
