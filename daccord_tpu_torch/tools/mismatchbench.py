"""Model-mismatch stress bench: error processes the estimator does NOT model.

The port of ``daccord_tpu/tools/mismatchbench.py``. ``sim/synth.py``'s base
generative model is the same iid ins/del/sub family the error-profile
estimator and the OffsetLikely tables assume. Without real sequencer data
(SURVEY.md §4 item 5), the strongest robustness evidence is a
*mis-specified* simulator: generate with processes the model does not
contain, then measure how far consensus quality and solve rate degrade.

Regimes (one row each; ``--hp`` adds an ``--hp-rescue`` arm):

  base     clean PacBio-like control (the estimator's own model)
  hp       homopolymer-length-dependent indels (ONT's signature failure)
  burst    Poisson error bursts (polymerase stalls / signal dropouts)
  disp     per-read lognormal rate dispersion (junk-read tail)
  chimera  foreign inserts bridged at a junction (library artifacts)
  dropout  coverage dropout region (depth starvation)
  all      every process at once (pacbio_mismatch preset)
  ont_hp   ONT shape + hp-dominated indels (ont_r10_mismatch preset)

Usage: ``python -m daccord_tpu_torch.tools.mismatchbench [--regimes a,b] [--out F]
[--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .ladderbench import CACHE, _dataset, _qveval

# shapes chosen so every regime has >= ~15x depth outside its own stressor
_SHAPE = dict(genome_len=15_000, coverage=22, read_len_mean=2_500, seed=71)
_ONT_SHAPE = dict(genome_len=15_000, coverage=18, read_len_mean=8_000,
                  read_len_sigma=0.5, p_ins=0.008, p_del=0.018, p_sub=0.01,
                  min_overlap=2_000, seed=72)

REGIMES: dict[str, dict] = {
    "base": dict(**_SHAPE),
    "hp": dict(**_SHAPE, hp_indel_slope=1.0),
    "burst": dict(**_SHAPE, burst_rate=2e-4, burst_len_mean=30.0,
                  burst_mult=6.0),
    "disp": dict(**_SHAPE, read_rate_sigma=0.6),
    "chimera": dict(**_SHAPE, p_chimera=0.05),
    "dropout": dict(**_SHAPE, dropout_frac=0.2, dropout_factor=5.0),
    "all": dict(**_SHAPE, hp_indel_slope=0.5, burst_rate=2e-4,
                read_rate_sigma=0.4, p_chimera=0.03, dropout_frac=0.15),
    "ont_hp": dict(**_ONT_SHAPE, hp_indel_slope=1.0, read_rate_sigma=0.5,
                   burst_rate=1e-4),
}


def run_regime(name: str, sim_kw: dict, hp_arm: bool = False,
               device: str = "cuda") -> dict:
    from ..formats.dazzdb import read_db
    from ..formats.las import LasFile
    from ..oracle.consensus import ConsensusConfig
    from ..runtime.pipeline import (PipelineConfig, correct_to_fasta,
                                    estimate_profile_for_shard)
    from ..utils.device import resolve_device
    from ..utils.obs import auto_batch_size

    dev = resolve_device(device).type
    paths = _dataset(f"mm_{name}", **sim_kw)
    d = os.path.dirname(paths["db"])
    cfg = PipelineConfig(batch_size=auto_batch_size(dev), device=dev)
    prof = estimate_profile_for_shard(read_db(paths["db"]),
                                      LasFile(paths["las"]), cfg)
    row: dict = {"regime": name, "p_ins": round(prof.p_ins, 4),
                 "p_del": round(prof.p_del, 4), "p_sub": round(prof.p_sub, 4)}
    t0 = time.perf_counter()
    arms = [("std", False)]
    if hp_arm:
        arms.append(("hp", True))   # homopolymer rescue arm (oracle/hp.py)
    for arm, use_hp in arms:
        acfg = PipelineConfig(batch_size=cfg.batch_size, device=dev,
                              consensus=ConsensusConfig(hp_rescue=use_hp))
        out_fa = os.path.join(d, f"corr_{arm}.fasta")
        stats = correct_to_fasta(paths["db"], paths["las"], out_fa, acfg,
                                 profile=prof)
        q = _qveval(out_fa, paths["truth"], paths["db"] if arm == "std" else None)
        row[f"q_{arm}"] = q.get("qscore")
        row[f"errors_{arm}"] = q.get("errors")
        row[f"solve_{arm}"] = round(stats.n_solved / max(stats.n_windows, 1), 4)
        if use_hp:
            row["hp_rescued"] = stats.n_hp_rescued
        if arm == "std":
            row["q_raw"] = q.get("raw_qscore")
            row["windows"] = stats.n_windows
    row["wall_s"] = round(time.perf_counter() - t0, 1)
    if hp_arm:
        row["delta_q_hp"] = round((row["q_hp"] or 0) - (row["q_std"] or 0), 2)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--regimes", default=",".join(REGIMES))
    ap.add_argument("--hp", action="store_true",
                    help="add a second arm with --hp-rescue on")
    ap.add_argument("--out", default=None, help="also append rows to this jsonl")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ladder runs (default cuda; no fallback)")
    ap.add_argument("--backend", default="auto", choices=("cpu", "auto"),
                    help="the JAX tool's flag: cpu = --device cpu, auto follows "
                         "--device")
    args = ap.parse_args(argv)
    from ..utils.device import resolve_device

    dev = resolve_device("cpu" if args.backend == "cpu" else args.device).type
    os.makedirs(CACHE, exist_ok=True)
    for name in args.regimes.split(","):
        row = run_regime(name, REGIMES[name], hp_arm=args.hp, device=dev)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "at") as fh:
                fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
