"""hp-rescue routing-threshold sweep on the mismatchbench hp regime.

The port of ``daccord_tpu/tools/hptune.py``: reuses the cached ``mm_hp``
dataset and one estimation pass, then runs ``correct_to_fasta`` arms over
(hp_err, hp_min_run) on the tool's device and prints Q / errors / rescued /
wall per arm. Each arm's hp pass runs after the ladder's fetches on the
host: the host library's ``hp_rescue_windows`` (every vote and acceptance),
driven by the pipeline's python pass (``runtime/pipeline.py _hp_pass``).

Usage: ``python -m daccord_tpu_torch.tools.hptune [--arms 0.18:3,...]
[--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", default="0.18:3,0.12:3,0.12:2,0.25:3",
                    help="hp_err:hp_min_run[:vote] per arm; vote in "
                         "{median, posterior} (default median)")
    ap.add_argument("--regime", default="hp")
    ap.add_argument("--accept", default="rescore",
                    choices=("rescore", "likelihood"),
                    help="acceptance objective for ALL arms (hp_accept)")
    ap.add_argument("--lambda-c", type=float, default=None,
                    help="hp_lambda_c override for the likelihood arm")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ladder runs (default cuda; no fallback)")
    args = ap.parse_args(argv)
    import os

    from ..formats.dazzdb import read_db
    from ..formats.las import LasFile
    from ..oracle.consensus import ConsensusConfig
    from ..runtime.pipeline import (PipelineConfig, correct_to_fasta,
                                    estimate_profile_for_shard)
    from ..utils.device import resolve_device
    from ..utils.obs import auto_batch_size
    from .ladderbench import _dataset, _qveval
    from .mismatchbench import REGIMES

    dev = resolve_device(args.device).type
    batch = auto_batch_size(dev)
    paths = _dataset(f"mm_{args.regime}", **REGIMES[args.regime])
    d = os.path.dirname(paths["db"])
    prof = estimate_profile_for_shard(read_db(paths["db"]), LasFile(paths["las"]),
                                      PipelineConfig(batch_size=batch, device=dev))
    for arm in args.arms.split(","):
        parts = arm.split(":")
        he, hmr = parts[0], parts[1]
        vote = parts[2] if len(parts) > 2 else "median"
        kw = dict(hp_rescue=True, hp_err=float(he), hp_min_run=int(hmr),
                  hp_vote=vote, hp_accept=args.accept)
        if args.lambda_c is not None:
            kw["hp_lambda_c"] = args.lambda_c
        cfg = PipelineConfig(consensus=ConsensusConfig(**kw), batch_size=batch,
                             device=dev)
        out_fa = os.path.join(
            d, f"corr_hp_{he}_{hmr}_{vote}_{args.accept}.fasta")
        t0 = time.perf_counter()
        stats = correct_to_fasta(paths["db"], paths["las"], out_fa, cfg,
                                 profile=prof)
        q = _qveval(out_fa, paths["truth"], None)
        print(json.dumps({"hp_err": float(he), "hp_min_run": int(hmr),
                          "vote": vote,
                          "q": q.get("qscore"), "errors": q.get("errors"),
                          "solve": round(stats.n_solved
                                         / max(stats.n_windows, 1), 4),
                          "rescued": stats.n_hp_rescued,
                          "wall_s": round(time.perf_counter() - t0, 1)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
