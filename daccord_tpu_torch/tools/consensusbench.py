"""Per-core consensus-engine bench: the north-star projection's anchor.

The port of ``daccord_tpu/tools/consensusbench.py``: host only, as the JAX
tool is. It runs no card kernel: the port's host library
(``native/api.py solve_windows_native``) against the numpy oracle
(``oracle/dbg.py window_consensus``) on the same windows.

BASELINE.md's ≥20x north star is defined against a *64-thread reference
binary* that cannot be built (mount empty, BASELINE.md "published: {}").
Round 2 could only anchor the projection on the single-core numpy oracle
with an ASSUMED C++-over-numpy factor. This bench replaces the assumption
with a measurement: the native C++ window-consensus engine
(``dazz_native.cpp solve_windows``) implements the same full-graph tier
ladder as the reference's handleWindow (SURVEY.md §3.3), so its per-core
windows/s IS a measured stand-in for reference-class per-core speed on
identical inputs.

Reports, on one self-similar window population (cfg2-like shape):
  - native C++ engine: windows/s/core (1 thread; --threads N to probe scaling)
  - numpy oracle:      windows/s (subsampled; the executable spec)
  - implied factor and bases/s/core at adv bases emitted per window

Usage: ``python -m daccord_tpu_torch.tools.consensusbench [--windows N] [--threads N]``
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .ladderbench import _dataset

_SHAPE = dict(genome_len=20_000, coverage=30, read_len_mean=4_000, seed=61)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=4096)
    ap.add_argument("--threads", default="1",
                    help="comma list of thread counts to run (e.g. 1,2,4)")
    ap.add_argument("--oracle-sample", type=int, default=128)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from .. import native
    from ..formats.dazzdb import read_db
    from ..formats.las import LasFile
    from ..kernels.tensorize import BatchShape, tensorize_windows
    from ..native.api import solve_windows_native
    from ..oracle import cut_windows, refine_overlap
    from ..oracle.consensus import (ConsensusConfig, estimate_profile_two_pass,
                                    make_offset_likely)
    from ..oracle.dbg import DBGParams, window_consensus

    try:
        native.load()
    except (OSError, RuntimeError) as exc:
        print(json.dumps({"error": f"native library unavailable: {exc}"}))
        return 1
    paths = _dataset("consbench", **_SHAPE)
    db = read_db(paths["db"])
    las = LasFile(paths["las"])
    ccfg = ConsensusConfig()
    windows = []
    refined = []
    for aread, pile in las.iter_piles():
        a = db.read_bases(aread)
        pile_refined = [refine_overlap(o, a, db.read_bases(o.bread),
                                       las.tspace)
                        for o in pile]
        refined.extend(pile_refined)
        windows.extend(cut_windows(a, pile_refined, w=ccfg.w, adv=ccfg.adv))
        if len(windows) >= args.windows:
            windows = windows[: args.windows]
            break
    prof = estimate_profile_two_pass(refined, windows[:48], ccfg, sample=24)
    ols = make_offset_likely(prof, ccfg)
    shape = BatchShape(depth=32, seg_len=64, wlen=ccfg.w)
    batch = tensorize_windows([(0, ws) for ws in windows], shape)

    row: dict = {"windows": len(windows), "adv": ccfg.adv,
                 "depth_cap": shape.depth}
    thread_list = [int(x) for x in args.threads.split(",")]
    base_wps = None
    for nt in thread_list:
        # warm one small run first so the .so build/page-in is outside timing
        solve_windows_native(batch_slice(batch, 64), ols, ccfg, n_threads=nt)
        t0 = time.perf_counter()
        out = solve_windows_native(batch, ols, ccfg, n_threads=nt)
        dt = time.perf_counter() - t0
        wps = len(windows) / dt
        row[f"native_wps_t{nt}"] = round(wps, 1)
        row[f"native_bases_per_s_t{nt}"] = round(wps * ccfg.adv, 1)
        if base_wps is None:
            base_wps = wps / nt   # per-thread rate of the first cell
            row["native_solve_rate"] = round(
                float(out["solved"].sum()) / len(windows), 4)

    n_or = min(args.oracle_sample, len(windows))
    t0 = time.perf_counter()
    solved = 0
    for ws in windows[:n_or]:
        segs = [np.asarray(s[: shape.seg_len], dtype=np.int8)
                for s in ws.segments[: shape.depth]]
        if len(segs) < ccfg.dbg.min_depth:
            continue
        for k, mc, emc in ccfg.tiers:
            p = DBGParams(**{**ccfg.dbg.__dict__, "k": k,
                             "min_count": mc, "edge_min_count": emc})
            if window_consensus(segs, ols[k], p, wlen=ccfg.w).seq is not None:
                solved += 1
                break
    dt = time.perf_counter() - t0
    row["oracle_wps"] = round(n_or / dt, 1)
    row["oracle_bases_per_s"] = round(n_or / dt * ccfg.adv, 1)
    row["native_over_oracle"] = round(base_wps / row["oracle_wps"], 1)
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "at") as fh:
            fh.write(json.dumps(row) + "\n")
    return 0


def batch_slice(batch, n: int):
    """First-n-windows view of a WindowBatch (warmup helper)."""
    from ..kernels.tensorize import slice_batch

    return slice_batch(batch, 0, n)


if __name__ == "__main__":
    sys.exit(main())
