"""Top-M decision sweep: is the active-set cap harmless, and where?

The port of ``daccord_tpu/tools/topmbench.py``. The kernel truncates each
window's surviving k-mer set to the top-M by count (M = ``max_kmers``,
default 64) where the reference builds the full filtered DBG (SURVEY.md:65,
§3.3). The sweep runs M in {48, 64, 96, 128} plus the ``--overflow-rescue``
arm (M=64 with capped windows re-solved at 256) through the whole pipeline
on the tool's device (on the card: the ladder's graphs and kernels at each
M) across four regimes:

  pb25   25x PacBio-like (the original evidence regime)
  pb60   60x PacBio-like (cap binds on most windows)
  ont    ONT R10-like (long reads, low error)
  rep8   8%-diverged two-copy repeat (cross-copy k-mer pollution inflates
         the set exactly where truncation could hide real variants)

Decision rule: if Q(rescue) > Q(64) anywhere, overflow windows carry real
signal and the rescue (or a bigger M) becomes the default for that regime;
if Q stays flat-or-worse as M grows, truncation is a beneficial noise filter
and 64 stays.

Usage: ``python -m daccord_tpu_torch.tools.topmbench [--regimes ...] [--cells ...]
[--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .ladderbench import _dataset, _qveval

REGIMES: dict[str, dict] = {
    "pb25": dict(genome_len=12_000, coverage=25, read_len_mean=2_500, seed=91),
    "pb60": dict(genome_len=10_000, coverage=60, read_len_mean=2_500, seed=92),
    "ont": dict(genome_len=12_000, coverage=15, read_len_mean=6_000,
                read_len_sigma=0.5, p_ins=0.008, p_del=0.018, p_sub=0.01,
                min_overlap=2_000, seed=93),
    "rep8": dict(genome_len=6_000, coverage=24, read_len_mean=800,
                 repeat_fraction=0.35, repeat_divergence=0.08, seed=94),
}

# (label, max_kmers, overflow_rescue)
CELLS = [("M48", 48, False), ("M64", 64, False), ("M96", 96, False),
         ("M128", 128, False), ("M64+rescue", 64, True)]


def cell_config(max_kmers: int, rescue: bool, device: str):
    from ..runtime.pipeline import PipelineConfig
    from ..utils.obs import auto_batch_size

    return PipelineConfig(batch_size=auto_batch_size(device), device=device,
                          max_kmers=max_kmers, overflow_rescue=rescue)


def run_cell(paths: dict, label: str, max_kmers: int, rescue: bool,
             prof=None, device: str = "cuda") -> dict:
    from ..formats.dazzdb import read_db
    from ..formats.las import LasFile
    from ..runtime.pipeline import correct_to_fasta, estimate_profile_for_shard
    from ..utils.device import resolve_device

    cfg = cell_config(max_kmers, rescue, resolve_device(device).type)
    if prof is None:
        # estimation is cap-independent; callers sweeping cells on one
        # dataset estimate once and pass it in
        prof = estimate_profile_for_shard(read_db(paths["db"]),
                                          LasFile(paths["las"]), cfg)
    out_fa = os.path.join(os.path.dirname(paths["db"]),
                          f"tm_{label.replace('+', '_')}.fasta")
    t0 = time.perf_counter()
    stats = correct_to_fasta(paths["db"], paths["las"], out_fa, cfg,
                             profile=prof)
    wall = time.perf_counter() - t0
    q = _qveval(out_fa, paths["truth"], None)
    return {"cell": label, "max_kmers": max_kmers, "rescue": rescue,
            "q": q.get("qscore"), "errors": q.get("errors"),
            "solve": round(stats.n_solved / max(stats.n_windows, 1), 4),
            "topm_overflow": stats.n_topm_overflow,
            "windows": stats.n_windows, "wall_s": round(wall, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--regimes", default=",".join(REGIMES))
    ap.add_argument("--cells", default=",".join(c[0] for c in CELLS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ladder runs (default cuda; no fallback)")
    args = ap.parse_args(argv)
    from ..formats.dazzdb import read_db
    from ..formats.las import LasFile
    from ..runtime.pipeline import estimate_profile_for_shard
    from ..utils.device import resolve_device

    dev = resolve_device(args.device).type
    want = set(args.cells.split(","))
    for name in args.regimes.split(","):
        paths = _dataset(f"tm_{name}", **REGIMES[name])
        prof = estimate_profile_for_shard(
            read_db(paths["db"]), LasFile(paths["las"]), cell_config(64, False, dev))
        for label, mk, rescue in CELLS:
            if label not in want:
                continue
            row = {"regime": name,
                   **run_cell(paths, label, mk, rescue, prof, device=dev)}
            print(json.dumps(row), flush=True)
            if args.out:
                with open(args.out, "at") as fh:
                    fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
