"""Command line of the port.

    python -m daccord_tpu_torch.tools.cli daccord DB LAS -o OUT [-E EPROF]
        [-b BATCH] [-t THREADS] [--no-native] [--qv-track NAME]
        [--device cuda|cpu] [--paged on|off|auto] [--page-len N]
        [--dp fused|scan]

``-E`` reads the error profile from EPROF when the file exists, and otherwise
estimates it and writes it there; the file is the JSON of
``ErrorProfile.save``, the same as the JAX package's ``daccord -E``, so a
profile made by either package drives the other. ``--paged`` ships batches
as a page pool and page table (``kernels/paging.py``) instead of the dense
tile, and ``--dp`` picks the heaviest-path route; neither changes the FASTA.
Piles are windowed by the port's host library (``native/``), on ``-t``
threads ahead of the batching loop when ``-t`` is above 0; ``--no-native``
windows them in numpy instead, with the same FASTA. ``--qv-track`` names the
intrinsic-QV track that joins the depth ranking (``inqual``; ignored when
the DB has none). A JSON line of run statistics goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..formats.dazzdb import read_db
from ..formats.las import LasFile
from ..oracle.profile import ErrorProfile
from ..runtime.pipeline import PipelineConfig, correct_to_fasta, estimate_profile_for_shard


def daccord_run(argv=None):
    """Parse the ``daccord`` arguments and run the correction; returns the
    run's PipelineStats and the parsed arguments."""
    p = argparse.ArgumentParser(prog="daccord",
                                description="Correct long reads: DB + LAS -> FASTA")
    p.add_argument("db")
    p.add_argument("las")
    p.add_argument("-o", "--out", default="-", help="output FASTA ('-' = stdout)")
    p.add_argument("-E", "--eprof", default=None, metavar="PATH",
                   help="error profile JSON: read when it exists, else "
                        "estimated and written here")
    p.add_argument("-b", "--batch", type=int, default=2048,
                   help="windows per ladder call")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="pile windowing threads ahead of the batching loop "
                        "(0 = in the loop)")
    p.add_argument("--no-native", action="store_true",
                   help="window piles in numpy instead of the host library "
                        "(same FASTA, slower)")
    p.add_argument("--qv-track", default="inqual", metavar="NAME",
                   help="intrinsic-QV track whose B-read QVs join the depth "
                        "ranking; '' = trace-diff rate only (default inqual; "
                        "a DB without the track ranks by trace diffs)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the ladder runs (default cuda; no fallback)")
    p.add_argument("--paged", choices=("on", "off", "auto"), default="off",
                   help="ragged paged batches: a page pool + page table per "
                        "corpus-derived (depth, pages) shape family instead "
                        "of dense [B, D, L] tiles, gathered on the device; "
                        "byte-identical FASTA. 'auto' = on for cuda")
    p.add_argument("--page-len", type=int, default=16, metavar="N",
                   help="paged page length in bases (must divide the "
                        "segment length, 64)")
    p.add_argument("--dp", choices=("fused", "scan"), default="fused",
                   help="heaviest-path route: 'fused' (DP + backtrack in one "
                        "kernel) or 'scan' (DP kernel writing the score and "
                        "pointer stacks, backtrack in torch); bit-identical")
    args = p.parse_args(argv)
    if args.threads < 0 or (args.threads and args.no_native):
        raise SystemExit("-t needs the host library: give -t 0 with --no-native")

    cfg = PipelineConfig(batch_size=args.batch, device=args.device,
                         paged=args.paged, page_len=args.page_len,
                         dp_route=args.dp, use_native=not args.no_native,
                         feeder_threads=args.threads,
                         qv_track=args.qv_track or None)
    if args.paged != "off" and (args.page_len <= 0
                                or cfg.seg_len % args.page_len):
        raise SystemExit(f"--page-len {args.page_len} must be positive and "
                         f"divide the segment length {cfg.seg_len}")
    prof = None
    if args.eprof and os.path.exists(args.eprof):
        prof = ErrorProfile.load(args.eprof)
    elif args.eprof:
        prof = estimate_profile_for_shard(read_db(args.db), LasFile(args.las), cfg)
        prof.save(args.eprof)
    return correct_to_fasta(args.db, args.las, args.out, cfg, profile=prof), args


def daccord_main(argv=None) -> int:
    stats, args = daccord_run(argv)
    print(json.dumps({
        "reads": stats.n_reads, "windows": stats.n_windows,
        "solved": stats.n_solved, "skipped_shallow": stats.n_skipped_shallow,
        "topm_overflow": stats.n_topm_overflow,
        "end_trimmed": stats.n_end_trimmed, "fragments": stats.n_fragments,
        "bases_out": stats.bases_out, "batches": stats.n_batches,
        "tiers": {str(k): v for k, v in sorted(stats.tier_histogram.items())},
        "profile_s": round(stats.profile_s, 3),
        "windowing_s": round(stats.windowing_s, 3),
        "ladder_s": round(stats.ladder_s, 3), "wall_s": round(stats.wall_s, 3),
        "paged": stats.paged, "pad_waste": round(stats.pad_waste, 4),
        "h2d_bytes": stats.h2d_bytes, "dp": args.dp,
        "native_host": stats.native_host, "threads": args.threads,
        "qv_ranked": stats.qv_ranked, "device": args.device}), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "daccord":
        print("usage: python -m daccord_tpu_torch.tools.cli daccord DB LAS -o OUT "
              "[-E EPROF] [-b BATCH] [-t THREADS] [--no-native] [--qv-track NAME] "
              "[--device cuda|cpu] [--paged on|off|auto] [--page-len N] "
              "[--dp fused|scan]", file=sys.stderr)
        return 2
    return daccord_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
