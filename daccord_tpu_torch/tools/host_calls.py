"""Calls and host time of each entry point of the port's host library in one
``daccord`` run, on one card.

    python -m daccord_tpu_torch.tools.host_calls [--sim GENOME,COVERAGE,READLEN[,SEED]]
        [-t THREADS] [--paged off|on] [--dp fused|scan]

Makes a simulated dataset (by default ``chip_smoke.py``'s 20 kb / 20x set),
then runs three phases, each with its own counts: the profile pass
(``estimate_profile_for_shard``), the correction given that profile
(``correct_to_fasta`` on cuda, batch 2048) and the scoring of its FASTA
against the simulation's truth. Every call of the library goes through a
counter that adds one call and its seconds between two ``perf_counter``
reads (under threads, each call's own wall, so contention is inside it).
Prints the card's name and power limit, the run's statistics, and per phase
one JSON line ``{entry point: [calls, seconds, microseconds per call]}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import torch

from .. import native
from .wall_ab import sim_config


class _Counted:
    """The library with a counter around each entry point."""

    def __init__(self, lib):
        self._lib = lib
        self._lock = threading.Lock()
        self.calls: dict[str, list] = {}
        self._fns = {}

    def __getattr__(self, name: str):
        if name not in self._fns:
            fn = getattr(self._lib, name)

            def call(*args):
                t0 = time.perf_counter()
                res = fn(*args)
                dt = time.perf_counter() - t0
                with self._lock:
                    c = self.calls.setdefault(name, [0, 0.0])
                    c[0] += 1
                    c[1] += dt
                return res

            self._fns[name] = call
        return self._fns[name]

    def take(self) -> dict:
        """The counts since the last take: {name: [calls, s, us per call]}."""
        with self._lock:
            out = {k: [n, round(s, 6), round(s / n * 1e6, 3)]
                   for k, (n, s) in sorted(self.calls.items())}
            self.calls = {}
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="host_calls", description=__doc__.splitlines()[0])
    ap.add_argument("--sim", default="20000,20,2000,42",
                    metavar="GENOME,COVERAGE,READLEN[,SEED]")
    ap.add_argument("-t", "--threads", type=int, default=0)
    ap.add_argument("--paged", choices=("on", "off"), default="off")
    ap.add_argument("--dp", choices=("fused", "scan"), default="fused")
    args = ap.parse_args(argv)
    sim_cfg = sim_config(ap, args.sim)
    if not torch.cuda.is_available():
        print("host_calls: needs a CUDA card", file=sys.stderr)
        return 1
    from ..formats.dazzdb import read_db
    from ..formats.las import LasFile
    from ..runtime.pipeline import PipelineConfig, correct_to_fasta, estimate_profile_for_shard
    from ..sim import make_dataset, score_vs_truth

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; usable CPUs {len(os.sched_getaffinity(0))}", flush=True)
    real = native.load()
    counted = native._lib = _Counted(real)
    try:
        with tempfile.TemporaryDirectory(prefix="host_calls_") as tmp:
            d = make_dataset(tmp, sim_cfg)
            db = read_db(d["db"])
            cfg = PipelineConfig(batch_size=2048, device="cuda", paged=args.paged,
                                 dp_route=args.dp, feeder_threads=args.threads)
            print(f"dataset: {sim_cfg}; {db.nreads} reads; -t {args.threads}, "
                  f"--paged {args.paged}, --dp {args.dp}", flush=True)
            counted.take()
            t0 = time.perf_counter()
            prof = estimate_profile_for_shard(db, LasFile(d["las"]), cfg)
            print("profile pass " + json.dumps(
                {"s": round(time.perf_counter() - t0, 6), "calls": counted.take()}),
                flush=True)
            out = os.path.join(tmp, "out.fasta")
            st = correct_to_fasta(d["db"], d["las"], out, cfg, profile=prof)
            torch.cuda.synchronize()
            print("run " + json.dumps(
                {"wall_s": st.wall_s, "windows": st.n_windows,
                 "windows_per_s": st.windows_per_sec(), "windowing_s": st.windowing_s,
                 "ladder_s": st.ladder_s, "profile_s": st.profile_s,
                 "solved": st.n_solved, "fragments": st.n_fragments,
                 "calls": counted.take()}), flush=True)
            t0 = time.perf_counter()
            err, raw = score_vs_truth(out, d["truth"], db)
            print("scoring " + json.dumps(
                {"s": round(time.perf_counter() - t0, 6), "error": err, "raw_error": raw,
                 "calls": counted.take()}), flush=True)
    finally:
        native._lib = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
