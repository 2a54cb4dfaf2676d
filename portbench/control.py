"""The control of the check: the reference put in the program's place,
computed one precision lower than the configuration states.

The ladder's real-valued work is float32: the OffsetLikely weights W, the
max-plus DP's path scores and the rescore's error rates. The control rounds
each to bfloat16 (to nearest, ties to even) wherever the reference forms
it, and leaves the integer work (k-mer counts, edit distances) as it is. The check compares
the control's rows with the float32 reference's as it compares the
program's, and has to fail (``PERF.md`` gives the readings the limits were
set from).

``python3 -m portbench.control --config NAME --seeds S1,S2,...`` prints,
for each seed, the windows of the pool whose consensus differs and the
widest gap of ``err`` where it agrees.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import sys
import time

import numpy as np

from .reference import check, ladder


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16, as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return r.view(np.float32).reshape(np.shape(x))


def heaviest_path_bf16(adjW, wt, s0):
    """``ladder.heaviest_path`` with every path score rounded to bfloat16."""
    B, M, _ = adjW.shape
    P = wt.shape[1]
    adjT = np.ascontiguousarray(adjW.transpose(0, 2, 1))
    wt = bf16(wt)
    s = bf16(s0)
    scores, ptrs = [s], [np.zeros((B, M), np.int32)]
    flat = (np.arange(B * M) * M).reshape(B, M)
    for t in range(1, P):
        x = bf16(s[:, None, :] + adjT)
        best_u = x.argmax(axis=2)
        best = np.take(x.reshape(-1), flat + best_u)
        s = np.where(best > ladder.HALF_NEG, bf16(best + wt[:, t, :]), ladder.NEG)
        scores.append(s)
        ptrs.append(best_u.astype(np.int32))
    return np.stack(scores, axis=1), np.stack(ptrs, axis=1)


def rescore_pick_bf16(seqs, lens, nsegs, cand, clen, ok, p: dict) -> dict:
    """``ladder.rescore_pick`` with each candidate's error rate rounded to
    bfloat16 before the pick and the threshold."""
    B, C, CL = cand.shape
    seg_total = np.maximum(lens.astype(np.int64).sum(axis=1), 1).astype(np.float32)
    dists = ladder.edit_distance_myers(cand[:, :, None, :], clen[:, :, None],
                                       seqs[:, None, :, :], lens[:, None, :])
    dists = np.where(lens[:, None, :] > 0, dists, 0)
    errs = bf16(dists.sum(axis=2).astype(np.int32).astype(np.float32) / seg_total[:, None])
    errs = np.where(ok, errs, np.float32(np.inf))
    ci = np.where(errs == errs.min(axis=1, keepdims=True), np.arange(C), C).min(axis=1)
    rows = np.arange(B)
    best_err, best_cons = errs[rows, ci], cand[rows, ci]
    best_len = np.where(ok[rows, ci], clen[rows, ci], 0).astype(clen.dtype)
    any_path = ok.any(axis=1)
    solved = any_path & (best_err <= bf16(np.float32(p["max_err"]))) & (nsegs >= p["min_depth"])
    return dict(cons=np.where(solved[:, None], best_cons, ladder.PAD).astype(np.int8),
                cons_len=np.where(solved, best_len, 0).astype(np.int32),
                err=np.where(any_path, best_err, np.float32(np.inf)).astype(np.float32),
                solved=solved)


@contextlib.contextmanager
def lowered():
    """The reference ladder with W, the DP's scores and the error rates in
    bfloat16."""
    saved = ladder.position_weights, ladder.heaviest_path, ladder.rescore_pick
    pw = saved[0]
    ladder.position_weights = lambda *a, **k: bf16(pw(*a, **k))
    ladder.heaviest_path = heaviest_path_bf16
    ladder.rescore_pick = rescore_pick_bf16
    try:
        yield
    finally:
        ladder.position_weights, ladder.heaviest_path, ladder.rescore_pick = saved


def readings(cfg: dict, seed: int, processes: int) -> dict:
    """The control against the float32 reference over the pool of ``cfg``
    for ``seed``, read as the check reads a run that fetched every window
    once: the windows whose consensus differs and the widest ``err`` gap
    where it agrees."""
    from . import gen
    from .reference import tables

    pool = gen.make_pool(cfg, seed)
    spec = tables.ladder_spec(cfg, pool.profile)
    want = check.solve_pool(spec, pool.buckets, processes)
    if processes < 2:
        with lowered():
            got = check.solve_pool(spec, pool.buckets, 1)
    else:
        got = check.solve_pool(spec, pool.buckets, processes, module="portbench.control")
    c = check.compare([(d, 0, len(got[d]["tier"]), got[d]) for d in got], want)
    return {"seed": seed, "rows_compared": c.rows, "windows_differing": c.windows,
            "err_rel_gap": c.err_gap}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the check's control, one seed a line")
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--processes", type=int, default=min(8, os.cpu_count() or 1))
    a = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", f"{a.config}.json")) as fh:
        cfg = json.load(fh)
    for s in a.seeds.split(","):
        t = time.perf_counter()
        r = readings(cfg, int(s), a.processes)
        r["seconds"] = round(time.perf_counter() - t, 2)
        print(json.dumps(dict(config=a.config, **r)), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 1:
        # a worker of readings: the lowered ladder on the chunks sent
        spec_, chunks_ = pickle.loads(sys.stdin.buffer.read())
        with lowered():
            sys.stdout.buffer.write(pickle.dumps(check.solve_chunks(spec_, chunks_)))
    else:
        sys.exit(main())
