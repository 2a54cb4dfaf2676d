"""A/B of one ``daccord`` run's wall between two checkouts of the port, on one card.

    python -m daccord_tpu_torch.tools.wall_ab A_ROOT B_ROOT \\
        [--paged off|on] [--dp fused|scan] [--turns ABBA]
        [--sim GENOME,COVERAGE,READLEN[,SEED]] [--b-args "-t 8"]
        [--ab-args "-t 8"] [--switch-interval S]

Makes a simulated dataset (by default ``chip_smoke.py``'s: 20 kb genome,
20x, 2 kb reads, seed 42) and its error profile once, then runs the
``daccord`` command line of each checkout (``A_ROOT``, ``B_ROOT``:
directories that hold a ``daccord_tpu_torch`` package) in a fresh process
per turn, in the order of ``--turns``, so that host noise falls on both
sides alike. ``--b-args`` adds flags to B's command line only (flags that
A's does not know, such as ``-t``, or a setting to compare on one tree,
such as ``--max-inflight 1``); ``--ab-args`` adds flags to both, and
``--switch-interval`` sets the interpreter's thread switch interval of
both runs (how long a thread waits before it forces the GIL from another).
Prints the card's name and power limit, one JSON line per turn (wall,
windows/s, host windowing, ladder dispatch and, where the checkout has
them, the ingest scan, the wall blocked in fetch, the ladder calls' own wall
and their thread's CPU time, the shadow audit's walls and the CUDA graph
captures' wall and count) and whether every turn's FASTA equals the
first's.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shlex
import subprocess
import sys
import tempfile

import torch

RUN = """
import json, sys, torch
from daccord_tpu_torch.tools.cli import daccord_run
if float(sys.argv[1]) > 0:
    sys.setswitchinterval(float(sys.argv[1]))
stats, _ = daccord_run(sys.argv[2:])
torch.cuda.synchronize()
print("STATS " + json.dumps(dict(
    wall_s=stats.wall_s, windows_per_s=stats.windows_per_sec(),
    bases_per_s=stats.bases_per_sec(), windowing_s=stats.windowing_s,
    ladder_s=stats.ladder_s, device_s=getattr(stats, "device_s", None),
    solve_s=getattr(stats, "solve_s", None), solve_cpu_s=getattr(stats, "solve_cpu_s", None),
    switch_interval=sys.getswitchinterval(),
    ingest_s=getattr(stats, "ingest_s", None), n_windows=stats.n_windows,
    n_batches=stats.n_batches, profile_s=stats.profile_s,
    audit_s=getattr(stats, "audit_s", None),
    audit_worker_s=getattr(stats, "audit_worker_s", None),
    audit_warm_s=getattr(stats, "audit_warm_s", None),
    graph_capture_s=getattr(stats, "graph_capture_s", None),
    graphs=getattr(stats, "graphs", None),
    else_s=stats.wall_s - (getattr(stats, "ingest_s", 0.0) or 0.0) - stats.windowing_s
    - stats.ladder_s - (getattr(stats, "device_s", 0.0) or 0.0) - stats.profile_s)))
"""


def sim_config(ap: argparse.ArgumentParser, spec: str):
    """The ``SimConfig`` of a ``--sim GENOME,COVERAGE,READLEN[,SEED]`` value
    (seed 42 when left out)."""
    from ..sim import SimConfig

    sim = [float(x) for x in spec.split(",")]
    if len(sim) not in (3, 4):
        ap.error("--sim takes GENOME,COVERAGE,READLEN[,SEED]")
    genome, coverage, read_len, seed = (*sim, 42)[:4]
    return SimConfig(genome_len=int(genome), coverage=coverage,
                     read_len_mean=read_len, seed=int(seed))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="wall_ab", description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--paged", choices=("on", "off"), default="off")
    ap.add_argument("--dp", choices=("fused", "scan"), default="fused")
    ap.add_argument("--turns", default="ABBA")
    ap.add_argument("--sim", default="20000,20,2000,42",
                    metavar="GENOME,COVERAGE,READLEN[,SEED]")
    ap.add_argument("--b-args", default="", metavar="FLAGS",
                    help="flags added to B's daccord command line only")
    ap.add_argument("--ab-args", default="", metavar="FLAGS",
                    help="flags added to both daccord command lines")
    ap.add_argument("--switch-interval", type=float, default=0.0, metavar="S",
                    help="the interpreter's thread switch interval in both "
                         "runs (sys.setswitchinterval; 0 = Python's default)")
    args = ap.parse_args(argv)
    sim_cfg = sim_config(ap, args.sim)
    if not torch.cuda.is_available():
        print("wall_ab: needs a CUDA card", file=sys.stderr)
        return 1
    from ..formats.dazzdb import read_db
    from ..formats.las import LasFile
    from ..runtime.pipeline import PipelineConfig, estimate_profile_for_shard
    from ..sim import make_dataset

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    roots = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    with tempfile.TemporaryDirectory(prefix="wall_ab_") as tmp:
        print(f"dataset: {sim_cfg}", flush=True)
        d = make_dataset(tmp, sim_cfg)
        eprof = os.path.join(tmp, "eprof.json")
        estimate_profile_for_shard(read_db(d["db"]), LasFile(d["las"]),
                                   PipelineConfig(device="cpu")).save(eprof)
        outs = []
        for i, tag in enumerate(args.turns):
            out = os.path.join(tmp, f"out_{i}_{tag}.fasta")
            res = subprocess.run(
                [sys.executable, "-c", RUN, str(args.switch_interval), d["db"],
                 d["las"], "-o", out, "-E", eprof,
                 "-b", "2048", "--device", "cuda", "--paged", args.paged,
                 "--dp", args.dp, *shlex.split(args.ab_args),
                 *(shlex.split(args.b_args) if tag == "B" else [])],
                cwd=roots[tag], env={**os.environ, "PYTHONPATH": roots[tag]},
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"turn {i} ({tag}) failed:\n{res.stdout}{res.stderr}")
            stats = json.loads(res.stdout.split("STATS ", 1)[1].splitlines()[0])
            print(json.dumps({"turn": i, "side": tag, **stats}), flush=True)
            outs.append(out)
        same = all(filecmp.cmp(outs[0], o, shallow=False) for o in outs[1:])
        print(f"FASTA of every turn identical: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
