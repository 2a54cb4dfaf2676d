"""Estimator-variance probe: Q sensitivity to the profile sample size.

The port of ``daccord_tpu/tools/profilevar.py``. The error-profile pass
samples ``profile_sample_piles`` piles strided across the shard
(``runtime/pipeline.py _strided_pile_ranges``) and 32 windows per pile for
the second pass (single-read rates vs a sample consensus). The production
default is 4 piles. This probe runs the full pipeline on the tool's device
with the profile estimated from

  - sample sizes ``--piles`` (default 2,4,16,48), and
  - for the probe size, several disjoint sample offsets
    (``profile_sample_offset``) — the across-sample variance there,

and reports consensus Q per cell. Decision rule: if the spread at the
probe size is <= 0.1 Q, that many piles is documented sufficient; otherwise
the default rises.

Usage: ``python -m daccord_tpu_torch.tools.profilevar [--piles 2,4,16] [--offsets 3]
[--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .ladderbench import _dataset, _qveval

_SHAPE = dict(genome_len=25_000, coverage=35, read_len_mean=4_000, seed=81)


def run_cell(paths: dict, n_piles: int, offset: int, device: str = "cuda") -> dict:
    from ..formats.dazzdb import read_db
    from ..formats.las import LasFile
    from ..runtime.pipeline import (PipelineConfig, correct_to_fasta,
                                    estimate_profile_for_shard)
    from ..utils.device import resolve_device
    from ..utils.obs import auto_batch_size

    dev = resolve_device(device).type
    # the production (top-M-capped) ladder, not the native full-graph
    # engine: the verdict governs the production configuration
    cfg = PipelineConfig(batch_size=auto_batch_size(dev), device=dev,
                         profile_sample_piles=n_piles,
                         profile_sample_offset=offset)
    t0 = time.perf_counter()
    prof = estimate_profile_for_shard(read_db(paths["db"]),
                                      LasFile(paths["las"]), cfg)
    est_s = time.perf_counter() - t0
    out_fa = os.path.join(os.path.dirname(paths["db"]),
                          f"pv_{n_piles}_{offset}.fasta")
    stats = correct_to_fasta(paths["db"], paths["las"], out_fa, cfg,
                             profile=prof)
    q = _qveval(out_fa, paths["truth"], None)
    return {"piles": n_piles, "offset": offset,
            "p_ins": round(prof.p_ins, 4), "p_del": round(prof.p_del, 4),
            "p_sub": round(prof.p_sub, 4), "est_s": round(est_s, 1),
            "q": q.get("qscore"), "errors": q.get("errors"),
            "solve": round(stats.n_solved / max(stats.n_windows, 1), 4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--piles", default="2,4,16,48")
    ap.add_argument("--offsets", type=int, default=3,
                    help="disjoint sample offsets probed at the --probe-size")
    ap.add_argument("--probe-size", type=int, default=None,
                    help="sample size whose across-sample spread decides the "
                         "verdict (default: PipelineConfig's production "
                         "default)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ladder runs (default cuda; no fallback)")
    args = ap.parse_args(argv)
    from ..utils.device import resolve_device

    dev = resolve_device(args.device).type
    if args.probe_size is None:
        from ..runtime.pipeline import PipelineConfig

        args.probe_size = PipelineConfig().profile_sample_piles
    paths = _dataset("profilevar", **_SHAPE)
    rows = []
    sizes = [int(x) for x in args.piles.split(",")]
    if args.probe_size not in sizes:
        sizes.append(args.probe_size)
    for sp in sizes:
        n_off = args.offsets if sp == args.probe_size else 1
        for off in range(n_off):
            row = run_cell(paths, sp, off, device=dev)
            rows.append(row)
            print(json.dumps(row), flush=True)
            if args.out:
                with open(args.out, "at") as fh:
                    fh.write(json.dumps(row) + "\n")
    qs = [r["q"] for r in rows
          if r["piles"] == args.probe_size and r["q"] is not None]
    if len(qs) > 1:
        spread = max(qs) - min(qs)
        v = (f"{args.probe_size} piles sufficient" if spread <= 0.1
             else "raise profile_sample_piles")
        print(json.dumps({"probe_size": args.probe_size,
                          "probe_size_q_spread": round(spread, 3),
                          "verdict": v}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
