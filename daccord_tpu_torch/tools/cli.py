"""Command line of the port.

    python -m daccord_tpu_torch.tools.cli daccord DB LAS -o OUT [-E EPROF]
        [--eprof-only] [-J i,n | --block I] [-w W] [-a ADV] [-k K]
        [--depth D] [--seg-len L] [-M M] [--candidates N] [--max-err F]
        [--overflow-rescue] [--no-end-trim] [--profile-sample N]
        [--ingest-policy strict|quarantine|off] [--quarantine PATH]
        [--max-pile-overlaps N] [--stats PATH] [-b BATCH] [-t THREADS]
        [--no-native] [--qv-track NAME] [--device cuda|cpu]
        [--backend auto|cuda|cpu|native] [--mode split|patch]
        [--hp-rescue | --no-hp-rescue] [--hp-vote median|posterior]
        [--hp-accept rescore|likelihood]
        [--paged on|off|auto] [--page-len N] [--dp fused|scan]
        [--ladder fused|split] [--max-inflight N] [--depth-buckets LIST]
        [--no-supervise]
        [--failover-backend auto|native|cpu] [--failback] [--audit-rate F]
        [--events PATH] [--log PATH] [--ledger PATH] [--native-threads N]

The flags and defaults of the JAX package's ``daccord`` that this port
covers keep their meaning there (``daccord_tpu/tools/cli.py``). ``-E`` reads
the error profile from EPROF when the file exists, and otherwise estimates
it (under the run's ingest policy) and writes it there; the file is the JSON
of ``ErrorProfile.save``, the same as the JAX package's, so a profile made by
either package drives the other. ``-J i,n`` corrects shard i of n
aread-aligned byte ranges of the LAS, ``--block I`` the piles of DB block I.
``--ingest-policy`` validates every LAS record header (and the DB's .idx)
first: ``strict`` exits non-zero with each issue's kind, byte offset and
pile; ``quarantine`` emits each corrupt pile's read uncorrected and records
it in the sidecar (``--quarantine``, default ``OUT.quarantine.jsonl``);
``off`` trusts the input. A pile of more than ``--max-pile-overlaps``
overlaps is contained the same way. ``--ladder split`` runs the JAX
package's two-stream ladder: tier-0 batches (Stream A), their failures and
top-M capped rows pooled on the host and solved again in dense whole-ladder
batches (Stream B); the FASTA is byte-identical to ``--ladder fused``.
``--mode patch`` keeps the read's own bases where a window is unsolved
instead of splitting the read there. ``--hp-rescue`` solves the windows that
failed or solved badly and hold a long homopolymer run again in
run-length-compressed space (``oracle/hp.py``; ``--hp-vote`` and
``--hp-accept`` pick the run-length vote and the acceptance), on the host
after each ladder call: in the host library, or in python under
``--no-native`` (the same FASTA). As in the JAX package it is on by default
for an explicit ``--backend cpu`` or ``native`` and off otherwise.
``--backend native`` solves every window with the host library's tier
ladder (the engine the supervisor fails over to) instead of the card, with
the homopolymer rescue inside the engine; ``-M 0`` is its full graph. Its
FASTA is byte-identical to the JAX package's ``--backend native``.

``--backend``: ``auto`` (the default) and ``cuda`` run on the card (``auto``
follows ``--device``, and never falls back to the CPU or the native engine
when no card is found: it raises, as ``--device cuda`` does); ``cpu`` runs
the port's ladder on the CPU (the JAX package's ``tpu`` is ``cuda`` here).
An explicit ``--device`` that contradicts ``--backend`` is refused.

Port-only flags: ``--device``; ``--paged`` ships batches as a page pool and
page table (``kernels/paging.py``) instead of the dense tile, ``--dp`` picks
the heaviest-path route, ``--max-inflight`` the ladder calls in flight (1 =
solve each batch on the pipeline's thread) and ``--depth-buckets`` the dense
sub-depth buckets ('' = one bucket); none of these changes the FASTA beyond
ROADMAP's drift bound. Piles are windowed by the port's host library
(``native/``), on ``-t`` threads ahead of the batching loop when ``-t`` is
above 0; ``--no-native`` windows them in numpy instead, with the same FASTA.
The supervisor (``runtime/supervisor.py``) wraps every ladder call, as in
the JAX package: deadlines, retries, the capacity governor, failover on
device loss (``--failover-backend``: ``cpu`` is the port's own ladder on the
CPU, byte-equal to the card; ``native`` the host library's ladder; ``auto``
native on cuda) and the shadow audit (``--audit-rate``, default
``DACCORD_AUDIT_RATE`` or 1/64). ``DACCORD_FAULT`` injects the JAX
package's faults (``runtime/faults.py``); ``--events`` records the
supervisor's transitions (lint: ``python -m
daccord_tpu_torch.tools.eventcheck``). A JSON line of run statistics goes to
stderr (and to ``--stats``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..formats.dazzdb import db_blocks, read_db
from ..formats.ingest import IngestError, scan_with_db
from ..formats.las import LasFile, range_for_areads, shard_ranges
from ..oracle.consensus import ConsensusConfig
from ..oracle.dbg import DBGParams
from ..oracle.profile import ErrorProfile
from ..runtime.pipeline import (INGEST_POLICIES, PipelineConfig, correct_to_fasta,
                                estimate_profile_for_shard)

BACKENDS = ("auto", "cuda", "cpu", "native")

USAGE = ("usage: python -m daccord_tpu_torch.tools.cli daccord DB LAS -o OUT "
         "[-E EPROF] [--eprof-only] [-J i,n | --block I] [-w W] [-a ADV] [-k K] "
         "[--depth D] [--seg-len L] [-M M] [--candidates N] [--max-err F] "
         "[--overflow-rescue] [--no-end-trim] [--profile-sample N] "
         "[--ingest-policy strict|quarantine|off] [--quarantine PATH] "
         "[--max-pile-overlaps N] [--stats PATH] [-b BATCH] [-t THREADS] "
         "[--no-native] [--qv-track NAME] [--device cuda|cpu] "
         "[--backend auto|cuda|cpu|native] [--mode split|patch] "
         "[--hp-rescue | --no-hp-rescue] [--hp-vote median|posterior] "
         "[--hp-accept rescore|likelihood] "
         "[--paged on|off|auto] [--page-len N] [--dp fused|scan] "
         "[--ladder fused|split] [--max-inflight N] [--depth-buckets LIST] "
         "[--no-supervise] "
         "[--failover-backend auto|native|cpu] [--failback] [--audit-rate F] "
         "[--events PATH] [--log PATH] [--ledger PATH] [--native-threads N]")


def _parser() -> argparse.ArgumentParser:
    defaults = PipelineConfig()
    p = argparse.ArgumentParser(prog="daccord",
                                description="Correct long reads: DB + LAS -> FASTA")
    p.add_argument("db")
    p.add_argument("las")
    p.add_argument("-o", "--out", default="-", help="output FASTA ('-' = stdout)")
    p.add_argument("-w", type=int, default=40, help="window size")
    p.add_argument("-a", type=int, default=10, help="window advance")
    p.add_argument("-k", type=int, default=8,
                   help="base k-mer size; the escalation ladder becomes "
                        "(k,2,2),(k+2,2,2),(k+4,2,2),(k,1,1)")
    p.add_argument("--depth", type=int, default=defaults.depth,
                   help="max segments per window")
    p.add_argument("--seg-len", type=int, default=defaults.seg_len,
                   help="max segment length")
    p.add_argument("-M", "--max-kmers", type=int, default=defaults.max_kmers,
                   help="tier-0 top-M active set (k-mers per window); 0 = the "
                        "full graph, --backend native only")
    p.add_argument("--candidates", type=int, default=3, metavar="N",
                   help="DBG paths rescored per window")
    p.add_argument("--max-err", type=float, default=0.3,
                   help="reject a window consensus above this mean edit rate "
                        "against its segments")
    p.add_argument("--overflow-rescue", action="store_true",
                   help="re-solve windows whose top-M cap bound at the rescue "
                        "active-set size")
    p.add_argument("--no-end-trim", action="store_true",
                   help="keep rescue-tier solutions at read ends")
    p.add_argument("--profile-sample", type=int,
                   default=defaults.profile_sample_piles, metavar="N",
                   help="piles sampled by the error-profile pass")
    p.add_argument("-E", "--eprof", default=None, metavar="PATH",
                   help="error profile JSON: read when it exists, else "
                        "estimated and written here")
    p.add_argument("--eprof-only", action="store_true",
                   help="estimate the error profile, write it to -E, and exit")
    p.add_argument("--block", type=int, default=None, metavar="I",
                   help="correct only the piles of DB block I (1-based); "
                        "mutually exclusive with -J")
    p.add_argument("-J", default=None, metavar="i,n",
                   help="correct shard i of n (aread-aligned LAS byte ranges)")
    p.add_argument("--ingest-policy", choices=INGEST_POLICIES,
                   default=defaults.ingest_policy,
                   help="strict: exit with the structured report of every "
                        "corrupt record; quarantine: emit each corrupt pile's "
                        "read uncorrected and record it in the sidecar; off: "
                        "trust the input")
    p.add_argument("--quarantine", default=None, metavar="PATH",
                   help="quarantine sidecar jsonl (default OUT.quarantine.jsonl)")
    p.add_argument("--max-pile-overlaps", type=int,
                   default=defaults.max_pile_overlaps, metavar="N",
                   help="contain a pile of more overlaps than this (read "
                        "emitted uncorrected) before windowing it; 0 = off")
    p.add_argument("--stats", default=None, metavar="PATH",
                   help="also write the run statistics JSON here")
    p.add_argument("-b", "--batch", type=int, default=defaults.batch_size,
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
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where the ladder runs (default cuda, or cpu for "
                        "--backend cpu|native; no fallback)")
    p.add_argument("--backend", choices=BACKENDS, default="auto",
                   help="auto and cuda: the ladder on the card (auto follows "
                        "--device; no fallback); cpu: the ladder on the CPU; "
                        "native: the host library's tier ladder (-M 0 = the "
                        "full graph), with the hp rescue on by default")
    p.add_argument("--mode", choices=("split", "patch"), default="split",
                   help="an unsolved window splits the read, or is patched "
                        "with the read's own bases")
    p.add_argument("--hp-rescue", action=argparse.BooleanOptionalAction, default=None,
                   help="homopolymer rescue: solve the windows that failed or "
                        "solved badly and hold a long run again in run-length-"
                        "compressed space, then re-expand the runs by an "
                        "aligned vote (default on for an explicit --backend "
                        "cpu or native, off otherwise)")
    p.add_argument("--hp-vote", choices=("median", "posterior"), default="median",
                   help="hp run-length vote: the median, or the length "
                        "posterior calibrated on the profile's hp slope "
                        "(engages when the fitted slope is at least 0.1)")
    p.add_argument("--hp-accept", choices=("rescore", "likelihood"), default="rescore",
                   help="hp acceptance: the raw rescore, or the likelihood "
                        "ratio under the calibrated observation model (same "
                        "slope gate as --hp-vote posterior)")
    p.add_argument("--paged", choices=("on", "off", "auto"), default="off",
                   help="ragged paged batches: a page pool + page table per "
                        "corpus-derived (depth, pages) shape family instead "
                        "of dense [B, D, L] tiles, gathered on the device; "
                        "byte-identical FASTA. 'auto' = on for cuda")
    p.add_argument("--page-len", type=int, default=16, metavar="N",
                   help="paged page length in bases (must divide --seg-len)")
    p.add_argument("--dp", choices=("fused", "scan"), default="fused",
                   help="heaviest-path route: 'fused' (DP + backtrack in one "
                        "kernel) or 'scan' (DP kernel writing the score and "
                        "pointer stacks, backtrack in torch); bit-identical")
    p.add_argument("--ladder", choices=("fused", "split"), default=defaults.ladder_mode,
                   help="'fused' solves each batch with the whole ladder in "
                        "one call; 'split' is the two-stream ladder: tier-0 "
                        "batches (Stream A), the windows they leave for a "
                        "rescue pooled on the host and solved in dense "
                        "whole-ladder batches (Stream B); byte-identical "
                        "FASTA")
    p.add_argument("--max-inflight", type=int, default=defaults.max_inflight,
                   metavar="N",
                   help="ladder calls in flight on the dispatcher thread; "
                        "1 = solve each batch on the pipeline's thread")
    p.add_argument("--depth-buckets", default=",".join(map(str, defaults.depth_buckets)),
                   metavar="LIST",
                   help="dense sub-depth buckets below --depth, comma-"
                        "separated ('' = one bucket)")
    p.add_argument("--native-threads", type=int, default=0,
                   help="threads of the native engine (the native failover); "
                        "0 = every usable CPU; independent of -t")
    p.add_argument("--log", default=None, help="jsonl event log path ('-' = stderr)")
    p.add_argument("--ledger", default=None, metavar="PATH",
                   help="per-window outcome ledger jsonl (window identity, "
                        "length, depth, tier reached, rescue membership, "
                        "batch turnaround)")
    p.add_argument("--events", default=None, metavar="PATH",
                   help="supervisor events jsonl (state transitions, cold-"
                        "shape heartbeats, retries, failover; schema: "
                        "tools/eventcheck.py). Default: share --log")
    p.add_argument("--no-supervise", action="store_true",
                   help="disable the device supervisor (watchdog deadlines, "
                        "retry, mid-run failover to the degraded engine)")
    p.add_argument("--failover-backend", choices=("auto", "native", "cpu"),
                   default="auto",
                   help="degraded-mode engine on declared device loss (auto: "
                        "the port's own ladder on the CPU for a cpu run, the "
                        "native host-library ladder on cuda; cpu: the port's "
                        "ladder on the CPU, byte-equal to the card)")
    p.add_argument("--failback", action="store_true",
                   help="let a background re-probe route dispatches back to "
                        "a revived card")
    p.add_argument("--audit-rate", type=float, default=None, metavar="F",
                   help="sampled shadow verification: fraction of windows "
                        "per fetched batch re-solved on the trusted host "
                        "ladder and compared byte-for-byte (default: env "
                        "DACCORD_AUDIT_RATE or 1/64; 0 disables). Changes "
                        "detection latency only, never output bytes")
    return p


def _resolve_device(args) -> None:
    """``args.device`` from ``--backend`` and ``--device``; refuses an explicit
    ``--device`` that contradicts an explicit ``--backend``."""
    want = {"cuda": "cuda", "cpu": "cpu", "native": "cpu"}.get(args.backend)
    if args.device is not None and want is not None and args.device != want:
        raise SystemExit(f"--backend {args.backend} contradicts --device "
                         f"{args.device} (drop one of the two flags)")
    args.device = args.device or want or "cuda"


def _check(args) -> None:
    """The argument checks that need no file, before any work."""
    _resolve_device(args)
    native = args.backend == "native"
    if args.block is not None and args.J is not None:
        raise SystemExit("--block and -J are mutually exclusive")
    k = args.k
    if not (4 <= k <= 11):  # k+4 must still pack into int32 k-mer codes
        raise SystemExit(f"-k {k}: supported range is 4..11")
    if k + 4 > min(args.w, args.seg_len - 1):
        raise SystemExit(f"escalated k {k + 4} (from -k {k}) needs window size > "
                         f"{k + 4} and --seg-len > {k + 5}")
    if args.ladder == "split" and native:
        raise SystemExit("--ladder split is a JAX-ladder dispatch strategy; "
                         "--backend native escalates per window on host "
                         "(drop one of the two flags)")
    if args.paged == "on" and native:
        raise SystemExit("--paged on is a JAX-ladder wire format; --backend "
                         "native solves dense rows on host (drop one flag)")
    if args.max_kmers == 0 and not native:
        # on the device ladder M=0 is an empty active set that solves
        # nothing; only the native engine reads 0 as the full graph
        raise SystemExit("-M 0 (full graph) requires --backend native; the "
                         "device ladder needs a positive top-M cap")
    if args.max_kmers < 0:
        raise SystemExit("-M: the device ladder needs a positive top-M cap")
    if args.candidates < 1:
        raise SystemExit(f"--candidates {args.candidates}: at least 1")
    if args.device == "cuda" and not native:
        # the DP kernels' widest window and their shared memory, checked at
        # every tier's shape before any work (tiers with min_count 1 run at
        # the rescue width 256)
        from ..kernels.dp_backtrack import check_width
        from ..kernels.window_kernel import KernelParams

        for kk, mc in ((k, 2), (k + 2, 2), (k + 4, 2), (k, 1)):
            p = KernelParams(k=kk, wlen=args.w, max_kmers=256 if mc <= 1 else args.max_kmers)
            t_lo, t_hi = p.t_range
            try:
                check_width(p.max_kmers, p.positions, t_hi - t_lo + 1, args.dp)
            except ValueError as e:
                raise SystemExit(f"-M {args.max_kmers} -w {args.w}: {e}") from None
        from ..kernels import position_weights
        from ..kernels.rescore import check_shape

        try:
            check_shape(args.depth, args.seg_len, args.candidates,
                        KernelParams(wlen=args.w).cons_len)
            for kk in (k, k + 2, k + 4):
                # the OffsetLikely tables are w + 16 offsets wide
                position_weights.check_shape(args.depth, args.seg_len - kk + 1,
                                             args.w + 16)
        except ValueError as e:
            raise SystemExit(f"-w {args.w} --candidates {args.candidates} --depth "
                             f"{args.depth} --seg-len {args.seg_len}: {e}") from None
    if args.native_threads < 0:
        raise SystemExit("--native-threads must be 0 (all CPUs) or positive")
    if args.audit_rate is not None and not 0.0 <= args.audit_rate <= 1.0:
        raise SystemExit("--audit-rate must be within [0, 1]")
    from ..runtime.faults import FaultPlan

    try:
        FaultPlan.from_env()
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.threads < 0 or (args.threads and args.no_native):
        raise SystemExit("-t needs the host library: give -t 0 with --no-native")
    if args.paged != "off" and (args.page_len <= 0 or args.seg_len % args.page_len):
        raise SystemExit(f"--page-len {args.page_len} must be positive and "
                         f"divide --seg-len {args.seg_len}")
    if args.max_inflight < 1:
        raise SystemExit("--max-inflight must be at least 1")
    if args.eprof_only and not args.eprof:
        raise SystemExit("--eprof-only requires -E/--eprof PATH")


def _byte_range(args) -> tuple[int | None, int | None]:
    """The LAS byte range ``-J`` or ``--block`` selects (None, None: all)."""
    if args.block is not None:
        blocks = db_blocks(args.db)
        if not (1 <= args.block <= len(blocks)):
            raise SystemExit(f"--block {args.block}: DB has {len(blocks)} blocks")
        return range_for_areads(args.las, *blocks[args.block - 1])
    if args.J is None:
        return None, None
    try:
        i, n = (int(x) for x in args.J.split(","))
    except ValueError:
        raise SystemExit(f"bad -J {args.J}: expected i,n") from None
    if not (0 <= i < n):
        raise SystemExit(f"bad -J {args.J}")
    return shard_ranges(args.las, n)[i]


def _estimate_validated(args, cfg: PipelineConfig, start, end) -> ErrorProfile:
    """The ``-E`` pre-estimation under the run's ingest policy: strict raises
    the structured report, quarantine samples clean piles only."""
    db = read_db(args.db, strict=cfg.ingest_policy == "strict")
    las = LasFile(args.las)
    clean = None
    if cfg.ingest_policy != "off":
        rep = scan_with_db(db, las, start, end)
        if rep.issues:
            if cfg.ingest_policy == "strict":
                raise rep.error()
            clean = rep.pile_ranges
    return estimate_profile_for_shard(db, las, cfg, start, end, pile_ranges=clean)


def daccord_run(argv=None):
    """Parse the ``daccord`` arguments and run the correction; returns the
    run's PipelineStats (None after ``--eprof-only``) and the parsed
    arguments. An ingest integrity failure exits with the structured report
    (kind, byte offset and pile of each issue), never a traceback."""
    args = _parser().parse_args(argv)
    _check(args)
    k = args.k
    try:
        buckets = tuple(int(x) for x in args.depth_buckets.split(",") if x.strip())
    except ValueError:
        raise SystemExit(f"bad --depth-buckets {args.depth_buckets!r}") from None
    # the hp rescue's default is the JAX package's: on for an explicit host
    # engine, off on the card (and under auto, so one command writes the
    # same bases wherever it runs)
    hp = (args.hp_rescue if args.hp_rescue is not None
          else args.backend in ("native", "cpu"))
    ccfg = ConsensusConfig(w=args.w, adv=args.a, mode=args.mode,
                           tiers=((k, 2, 2), (k + 2, 2, 2), (k + 4, 2, 2), (k, 1, 1)),
                           dbg=DBGParams(n_candidates=args.candidates,
                                         max_err=args.max_err),
                           hp_rescue=hp, hp_vote=args.hp_vote,
                           hp_accept=args.hp_accept)
    cfg = PipelineConfig(consensus=ccfg, batch_size=args.batch, depth=args.depth,
                         seg_len=args.seg_len, max_kmers=args.max_kmers,
                         overflow_rescue=args.overflow_rescue,
                         profile_sample_piles=args.profile_sample,
                         device=args.device, max_inflight=args.max_inflight,
                         depth_buckets=buckets, paged=args.paged,
                         page_len=args.page_len, dp_route=args.dp,
                         ladder_mode=args.ladder,
                         use_native=not args.no_native,
                         hp_native=not args.no_native,
                         native_solver=args.backend == "native",
                         feeder_threads=args.threads,
                         qv_track=args.qv_track or None,
                         end_trim=not args.no_end_trim,
                         ingest_policy=args.ingest_policy,
                         quarantine_path=args.quarantine,
                         max_pile_overlaps=args.max_pile_overlaps,
                         supervise=not args.no_supervise,
                         events_path=args.events, log_path=args.log,
                         ledger_path=args.ledger,
                         failover_backend=args.failover_backend,
                         failback=args.failback, audit_rate=args.audit_rate,
                         native_threads=args.native_threads)
    try:
        start, end = _byte_range(args)
        prof = None
        if args.eprof and os.path.exists(args.eprof) and not args.eprof_only:
            prof = ErrorProfile.load(args.eprof)
        elif args.eprof:
            prof = _estimate_validated(args, cfg, start, end)
            prof.save(args.eprof)
            if args.eprof_only:
                return None, args
        stats = correct_to_fasta(args.db, args.las, args.out, cfg, start, end,
                                 profile=prof)
    except IngestError as ex:
        # under quarantine a surviving failure comes from a path that needs
        # the aread index (-J/--block), which a corrupt LAS cannot provide
        hint = ("(rerun with --ingest-policy quarantine to contain the corrupt "
                "piles instead)" if args.ingest_policy == "strict" else
                "(byte-range sharding needs the aread index, which cannot be "
                "built over a corrupt LAS: repair the file or run unsharded)")
        raise SystemExit(f"daccord: {ex}\n{hint}") from None
    return stats, args


def stats_record(stats, args) -> dict:
    """The run statistics as one JSON-ready dict."""
    return {
        "reads": stats.n_reads, "windows": stats.n_windows,
        "solved": stats.n_solved, "skipped_shallow": stats.n_skipped_shallow,
        "topm_overflow": stats.n_topm_overflow,
        "end_trimmed": stats.n_end_trimmed, "fragments": stats.n_fragments,
        "bases_in": stats.bases_in, "bases_out": stats.bases_out,
        "batches": stats.n_batches, "batches_by_bucket": stats.batches_by_bucket,
        "tiers": {str(k): v for k, v in sorted(stats.tier_histogram.items())},
        "quarantined": stats.n_quarantined, "ingest_issues": stats.n_ingest_issues,
        "monster_piles": stats.n_monster_piles,
        "ingest_s": round(stats.ingest_s, 3), "profile_s": round(stats.profile_s, 3),
        "windowing_s": round(stats.windowing_s, 3),
        "ladder_s": round(stats.ladder_s, 3), "device_s": round(stats.device_s, 3),
        "solve_s": round(stats.solve_s, 3),
        "wall_s": round(stats.wall_s, 3), "stages": stats.stage_profile,
        "paged": stats.paged, "pad_waste": round(stats.pad_waste, 4),
        "h2d_bytes": stats.h2d_bytes, "dp": args.dp, "ladder": args.ladder,
        "rescue_windows": stats.n_rescue_windows,
        "rescue_slots": stats.rescue_slots_executed,
        "rescue_density": round(stats.rescue_density, 4),
        "dispatch_tier0": stats.n_dispatch_tier0,
        "dispatch_rescue": stats.n_dispatch_rescue,
        "graph_capture_s": round(stats.graph_capture_s, 3), "graphs": stats.graphs,
        "graph_replays": stats.graph_replays,
        "max_inflight": args.max_inflight, "peak_inflight": stats.peak_inflight,
        "native_host": stats.native_host, "threads": args.threads,
        "qv_ranked": stats.qv_ranked, "device": args.device,
        "backend": args.backend,
        "n_hp_rescued": stats.n_hp_rescued, "hp_wall_s": round(stats.hp_wall_s, 4),
        "degraded": stats.degraded, "fallback_reason": stats.fallback_reason,
        "capacity_events": stats.n_capacity_events,
        "backpressure": stats.n_backpressure,
        "batch_effective": stats.batch_effective,
        "governor_ratchet": stats.governor_ratchet,
        "audit_s": round(stats.audit_s, 4), "supervisor": stats.sup_counters}


def daccord_main(argv=None) -> int:
    stats, args = daccord_run(argv)
    if stats is None:
        print(json.dumps({"eprof": args.eprof}), file=sys.stderr)
        return 0
    line = stats_record(stats, args)
    print(json.dumps(line), file=sys.stderr)
    if args.stats:
        with open(args.stats, "wt") as fh:
            json.dump(line, fh, indent=1)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "daccord":
        print(USAGE, file=sys.stderr)
        return 2
    return daccord_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
