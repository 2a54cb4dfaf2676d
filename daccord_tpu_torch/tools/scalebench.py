"""Order-of-magnitude scale proof: the FULL production path, measured.

The port of ``daccord_tpu/tools/scalebench.py``: every stage is the port's
command line (``python -m daccord_tpu_torch.tools.cli``); the sharded
daccord stage solves on ``--backend`` (default ``cuda``, the card; ``cpu``
the port's CPU ladder; ``native`` the host library's engine).

VERDICT r4 "Next round" #2: every CHM-scale claim so far is arithmetic from
toy runs; nothing proves the framework survives one order of magnitude up
(RSS, disk, sidecar index size, manifest churn). This runs the complete
production chain on a ~1/10-CHM-chr20-scale synthetic dataset —

    sim -> fasta2db -> inqual -> repeats -> filter --mem-records
        -> filtersym -> lassort -> sharded daccord (checkpoints,
        ``--backend``) -> merge -> qveval

— each stage in its own subprocess, its peak RSS read from
``RUSAGE_CHILDREN``, and emits one JSON line per stage: wall seconds, PEAK
RSS (the scale claim), and bytes written. The final summary line
aggregates the table for BASELINE.md.

Default shape: 30 Mb genome, 42x, 4 kb reads -> ~1.2 Gbases of reads and
~1e7 LAS records (sized by VERDICT's floor). ``--genome-mb/--coverage``
scale it; ``--dir`` (default ``$TMPDIR/daccord_scale``) places the dataset
(needs ~15 GB free at the default shape). The dataset is NOT cached —
this tool is a measurement, rerun it end to end.

Run: ``python -m daccord_tpu_torch.tools.scalebench [--genome-mb 30] [--shards 8]
[--backend cuda|cpu|native]``
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def du_bytes(*paths: str) -> int:
    tot = 0
    for p in paths:
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                tot += sum(os.path.getsize(os.path.join(root, f))
                           for f in files)
        elif os.path.exists(p):
            tot += os.path.getsize(p)
    return tot


_RSS_WRAPPER = (
    "import resource, subprocess, sys;"
    "rc = subprocess.run(sys.argv[1:]).returncode;"
    "print('MAX_RSS_KB', resource.getrusage(resource.RUSAGE_CHILDREN)"
    ".ru_maxrss, file=sys.stderr);"
    "sys.exit(rc)")


def timed_stage(name: str, argv: list[str], outputs: tuple[str, ...] = (),
                env: dict | None = None) -> dict:
    """Run one pipeline stage in a subprocess; record wall + peak child RSS
    (ru_maxrss of RUSAGE_CHILDREN: no GNU time binary needed)."""
    cmd = [sys.executable, "-c", _RSS_WRAPPER, sys.executable, "-m",
           "daccord_tpu_torch.tools.cli", *argv]
    t0 = time.time()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       env={**os.environ, **(env or {})})
    wall = time.time() - t0
    if r.returncode != 0:
        raise RuntimeError(f"stage {name} failed (rc={r.returncode}):\n"
                           f"{r.stderr[-2000:]}")
    m = re.search(r"MAX_RSS_KB (\d+)", r.stderr)
    rss_mb = round(int(m.group(1)) / 1024, 1) if m else None
    row = {"stage": name, "wall_s": round(wall, 1), "peak_rss_mb": rss_mb,
           "out_bytes": du_bytes(*outputs)}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-mb", type=float, default=30.0)
    ap.add_argument("--coverage", type=float, default=42.0)
    ap.add_argument("--read-len", type=float, default=4000.0)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(), "daccord_scale"))
    ap.add_argument("--backend", choices=("cuda", "cpu", "native"), default="cuda",
                    help="the shard stage's engine (default cuda: the card, "
                         "no fallback)")
    ap.add_argument("--mem-records", type=int, default=2_000_000,
                    help="filter/lassort bounded-memory record budget")
    ap.add_argument("--out", default=None, help="append stage rows here")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--reuse", action="store_true",
                    help="skip the sim stage when the dataset files already "
                         "exist in --dir (a killed run's --keep leftovers); "
                         "the sim row is then omitted, not re-measured")
    args = ap.parse_args(argv)

    d = args.dir
    os.makedirs(d, exist_ok=True)
    rows = []

    def emit(row: dict) -> None:
        # every row lands on disk IMMEDIATELY: a multi-hour run killed by a
        # wall-clock limit must keep the stages it finished
        rows.append(row)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(row) + "\n")

    # stage 0: synthetic dataset (sim is part of the measurement: it is this
    # environment's only read source at scale)
    gen = int(args.genome_mb * 1e6)
    t0 = time.time()
    paths = {k: os.path.join(d, f"scale.{ext}") for k, ext in
             (("db", "db"), ("las", "las"), ("truth", "truth.npz"))}
    if args.reuse and all(os.path.exists(p) for p in paths.values()):
        out = paths
    else:
        from ..sim import SimConfig, make_dataset

        out = make_dataset(d, SimConfig(genome_len=gen,
                                        coverage=args.coverage,
                                        read_len_mean=args.read_len,
                                        min_overlap=1000, seed=50),
                           name="scale")
        row = {"stage": "sim", "wall_s": round(time.time() - t0, 1),
               "peak_rss_mb": None,
               "out_bytes": du_bytes(out["db"], out["las"],
                                     os.path.join(d, ".scale.bps"))}
        print(json.dumps(row), flush=True)
        emit(row)
    db, las = out["db"], out["las"]
    depth = str(int(args.coverage))
    mem = str(args.mem_records)

    filt = os.path.join(d, "filt.las")
    sym = os.path.join(d, "sym.las")
    srt = os.path.join(d, "sym.sorted.las")
    outdir = os.path.join(d, "shards")
    fa = os.path.join(d, "corrected.fasta")

    emit(timed_stage("inqual", ["inqual", db, las, "-d", depth],
                            outputs=(os.path.join(d, ".scale.inqual.anno"),
                                     os.path.join(d, ".scale.inqual.data"))))
    emit(timed_stage("repeats", ["repeats", db, las, "-d", depth,
                                        "--factor", "1.5"],
                            outputs=(os.path.join(d, ".scale.rep.anno"),
                                     os.path.join(d, ".scale.rep.data"))))
    emit(timed_stage("filter", ["filter", db, las, filt,
                                       "--mem-records", mem],
                            outputs=(filt,)))
    emit(timed_stage("filtersym", ["filtersym", filt, sym,
                                          "--db", db, "--mem-records", mem],
                            outputs=(sym,)))
    emit(timed_stage("lassort", ["lassort", sym, srt,
                                        "--mem-records", mem],
                            outputs=(srt,)))
    for s in range(args.shards):
        emit(timed_stage(
            f"shard{s}", ["shard", db, srt, outdir,
                          "-J", f"{s},{args.shards}",
                          "--backend", args.backend, "--checkpoint-every", "256"],
            outputs=(outdir,)))
    emit(timed_stage("merge", ["merge", outdir, str(args.shards), fa],
                            outputs=(fa,)))
    emit(timed_stage("qveval", ["qveval", fa, out["truth"],
                                       "--raw-db", db]))

    summary = {
        "stage": "TOTAL", "genome_mb": args.genome_mb,
        "coverage": args.coverage,
        "wall_s": round(sum(r["wall_s"] for r in rows), 1),
        "peak_rss_mb": max((r["peak_rss_mb"] or 0) for r in rows),
        "disk_bytes": du_bytes(d),
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(json.dumps(summary) + "\n")
    if not args.keep:
        import shutil

        shutil.rmtree(d, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
