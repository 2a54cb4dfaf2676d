"""Command line of the port: ``python -m daccord_tpu_torch.tools.cli TOOL
[args]``, the tools of the JAX package's dispatcher
(``daccord_tpu/tools/cli.py``) with their flags and defaults:

- ``daccord`` (below); ``shard`` (``daccord-shard``: one ``-J i,n`` shard
  into OUTDIR with a manifest and mid-shard checkpoints, the ``daccord``
  flags otherwise), ``merge`` (``daccord-merge``: the validating merge gate)
  and ``audit`` (``daccord-audit``: the sha256 chain of a shard directory);
- the multi-process layer: ``fleet`` (``daccord-fleet``: every shard of a
  run as supervised ``shard`` processes, with lease takeover, retries,
  poison quarantine, the OOM requeue and ``--merge``), ``serve`` (the
  always-on service; ``--peer-dir`` and ``--aot-cache`` join a fleet of
  peers) and ``router`` (``daccord-router``: the front door of such a fleet,
  with its ``--autoscale-*`` autoscaler);
- the workflow before ``daccord``: ``inqual`` (the intrinsic-QV track the
  depth ranking reads), ``repeats``, ``filter``, ``filtersym``;
- LAS tools ``lassort``, ``lasmerge``, ``lasindex``, ``lassplit``,
  ``lasshow``, ``lascheck``; DB tools ``fasta2db``, ``db2fasta``,
  ``dbsplit``, ``catrack``, ``dbstats``, ``dbshow``, ``fillfasta``;
  ``qveval`` (Q against a simulator's truth);
- the readers of a run's telemetry: ``eventcheck`` (the ``--events``
  schema), ``trace`` (span pairing and the wall's split into spans),
  ``prof`` (the feeder's stage table and the bottleneck verdict), ``top``
  (a one-screen snapshot of a run directory) and ``sentinel`` (red flags in
  events, rollups and ``.prom`` files).

The tools that sort, merge, compute the QV track, detect repeats or filter
run in the port's host library and require it (no build raises; nothing
falls back to python), apart from ``mem:`` paths, which the C++ code cannot
open. The upstream workflow on the card, the tools' outputs byte-identical
to the JAX package's::

    python -m daccord_tpu_torch.tools.cli inqual DB LAS
    python -m daccord_tpu_torch.tools.cli repeats DB LAS
    python -m daccord_tpu_torch.tools.cli filter DB LAS F.las
    python -m daccord_tpu_torch.tools.cli filtersym F.las S.las --db DB
    python -m daccord_tpu_torch.tools.cli shard DB S.las OUT -J 0,2  (and 1,2)
    python -m daccord_tpu_torch.tools.cli merge OUT 2 OUT.fasta
    python -m daccord_tpu_torch.tools.cli fleet DB S.las OUT -n 4 --workers 2 --merge OUT.fasta

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
        [--metrics-snapshot-s S] [--profile DIR]

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
package's faults (``runtime/faults.py``). ``--events`` records the run's
telemetry, the JAX package's: the supervisor's transitions, the span tree
(run, scan, profile, ladder.build, paging.derive, pile, feeder, batch,
dispatch, device.fetch, flush, hp; the port's ``ladder.call`` under each
dispatch), the feeder's ``stage.profile``, ``metrics`` snapshots every
``--metrics-snapshot-s`` and ``shard_done`` with the bottleneck verdict.
``--profile DIR`` captures a ``torch.profiler`` trace of the whole run;
``DACCORD_PROFILE_DIR`` one of the ladder calls from the
``DACCORD_PROFILE_DISPATCH``-th dispatch (default 2) to its fetch. A JSON
line of run statistics goes to stderr (and to ``--stats``).
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys

import numpy as np

from ..formats.dazzdb import (catrack, db_blocks, decode_reads_from_bps, read_db,
                              read_lengths, split_db, write_db)
from ..formats.extsort import filter_symmetric_external, merge_las, sort_las_external
from ..formats.fasta import FastaRecord, read_fasta, write_fasta
from ..formats.ingest import IngestError, scan_with_db, sidecar_issues
from ..formats.las import LasFile, index_las, range_for_areads, shard_ranges, write_las
from ..oracle.consensus import ConsensusConfig
from ..oracle.dbg import DBGParams
from ..oracle.profile import ErrorProfile
from ..runtime.pipeline import (INGEST_POLICIES, PipelineConfig, correct_to_fasta,
                                estimate_profile_for_shard)
from ..utils.bases import ints_to_seq, revcomp_ints, seq_to_ints
from . import lastools
from .audit import audit_main
from .eventcheck import eventcheck_main
from .prof import prof_main
from .sentinel import sentinel_main
from .top import top_main
from .trace import trace_main

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
         "[--events PATH] [--log PATH] [--ledger PATH] [--native-threads N] "
         "[--metrics-snapshot-s S] [--profile DIR]")


def _parser(shard: bool = False) -> argparse.ArgumentParser:
    """The ``daccord`` arguments; with ``shard``, those of ``daccord-shard``
    (an OUTDIR and a required ``-J`` in place of ``-o``, ``-E``, ``--block``,
    ``--quarantine`` and ``--stats``; ``--checkpoint-every``, ``--force``)."""
    defaults = PipelineConfig()
    if shard:
        p = argparse.ArgumentParser(prog="daccord-shard", description=shard_main.__doc__)
    else:
        p = argparse.ArgumentParser(prog="daccord",
                                    description="Correct long reads: DB + LAS -> FASTA")
    p.add_argument("db")
    p.add_argument("las")
    if shard:
        p.add_argument("outdir")
        p.add_argument("-J", required=True, metavar="i,n", help="shard i of n")
        p.add_argument("--checkpoint-every", type=int, default=64, metavar="N",
                       help="checkpoint progress every N emitted reads (0 = off)")
        p.add_argument("--force", action="store_true",
                       help="recompute even if the manifest exists")
        p.add_argument("--ledger", default="auto", metavar="PATH",
                       help="per-window outcome ledger jsonl; 'auto' (default) "
                            "= shardNNNN.ledger.jsonl in OUTDIR, 'none' disables")
        p.set_defaults(out=None, eprof=None, eprof_only=False, block=None,
                       quarantine=None, stats=None)
    else:
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
    if not shard:
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
    if not shard:
        p.add_argument("--quarantine", default=None, metavar="PATH",
                       help="quarantine sidecar jsonl (default OUT.quarantine.jsonl)")
    p.add_argument("--max-pile-overlaps", type=int,
                   default=defaults.max_pile_overlaps, metavar="N",
                   help="contain a pile of more overlaps than this (read "
                        "emitted uncorrected) before windowing it; 0 = off")
    if not shard:
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
    if not shard:
        p.add_argument("--ledger", default=None, metavar="PATH",
                       help="per-window outcome ledger jsonl (window identity, "
                            "length, depth, tier reached, rescue membership, "
                            "batch turnaround)")
    p.add_argument("--events", default=None, metavar="PATH",
                   help="supervisor events jsonl (state transitions, cold-"
                        "shape heartbeats, retries, failover; schema: "
                        "tools/eventcheck.py). Default: share --log")
    p.add_argument("--metrics-snapshot-s", type=float,
                   default=defaults.metrics_snapshot_s, metavar="S",
                   help="cadence of the periodic metrics and stage.profile "
                        "events in --events (0 = the end-of-run rollup only)")
    if not shard:
        p.add_argument("--profile", default=None, metavar="DIR",
                       help="capture a torch.profiler trace of the whole run "
                            "(host ops and, on cuda, the card's kernels) into "
                            "DIR as a chrome trace")
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
    if args.metrics_snapshot_s < 0:
        raise SystemExit("--metrics-snapshot-s must be 0 (off) or positive")
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
    cfg = _pipeline_config(args)
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
        if args.profile:
            with _profiled(args.profile, cfg.device):
                stats = correct_to_fasta(args.db, args.las, args.out, cfg, start, end,
                                         profile=prof)
        else:
            stats = correct_to_fasta(args.db, args.las, args.out, cfg, start, end,
                                     profile=prof)
    except IngestError as ex:
        # under quarantine a surviving failure comes from a path that needs
        # the aread index (-J/--block), which a corrupt LAS cannot provide
        raise SystemExit(f"daccord: {ex}\n{_ingest_hint(args)}") from None
    return stats, args


class _profiled:
    """``--profile DIR``: one ``torch.profiler`` capture around the run
    (host ops, and the card's kernels on cuda), written into DIR as a chrome
    trace when the run ends, whether or not it finished."""

    def __init__(self, out_dir: str, device: str):
        import torch

        self.dir = out_dir
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        os.makedirs(self.dir, exist_ok=True)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.prof.__exit__(*exc)
        self.prof.export_chrome_trace(os.path.join(self.dir, f"daccord-{os.getpid()}.trace.json"))
        return False


def _ingest_hint(args) -> str:
    return ("(rerun with --ingest-policy quarantine to contain the corrupt "
            "piles instead)" if args.ingest_policy == "strict" else
            "(byte-range sharding needs the aread index, which cannot be "
            "built over a corrupt LAS: repair the file or run unsharded)")


def _pipeline_config(args) -> PipelineConfig:
    """The run's PipelineConfig from the checked ``daccord`` (or
    ``daccord-shard``) arguments."""
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
    return PipelineConfig(consensus=ccfg, batch_size=args.batch, depth=args.depth,
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
                          metrics_snapshot_s=args.metrics_snapshot_s,
                          failover_backend=args.failover_backend,
                          failback=args.failback, audit_rate=args.audit_rate,
                          native_threads=args.native_threads)


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
        "host_s": round(stats.host_s, 3), "feeder_s": stats.feeder_s,
        "verdict": stats.verdict,
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


def shard_main(argv=None) -> int:
    """daccord-shard: correct one LAS byte-range shard into OUTDIR with a
    manifest and mid-shard checkpoints (rerun the same command to resume)."""
    args = _parser(shard=True).parse_args(argv)
    _check(args)
    try:
        i, n = (int(x) for x in args.J.split(","))
    except ValueError:
        raise SystemExit(f"bad -J {args.J}: expected i,n") from None
    if not (0 <= i < n):
        raise SystemExit(f"bad -J {args.J}")
    from ..parallel.launch import run_shard, shard_paths

    if args.ledger == "auto":
        args.ledger = shard_paths(args.outdir, i)["ledger"]
    elif args.ledger == "none":
        args.ledger = None
    cfg = _pipeline_config(args)
    try:
        m = run_shard(args.db, args.las, args.outdir, i, n, cfg, force=args.force,
                      checkpoint_every=args.checkpoint_every)
    except IngestError as ex:
        raise SystemExit(f"daccord-shard: {ex}\n{_ingest_hint(args)}") from None
    finally:
        if args.device == "cuda":
            _add_launches(os.path.join(args.outdir, f"shard{i:04d}.launches.json"))
    print(json.dumps(m), file=sys.stderr)
    return 0


def _add_launches(path: str) -> None:
    """Add this process's kernel launch counts to a shard's
    ``shardNNNN.launches.json`` (summed over its attempts), so a fleet's
    launches can be read after its worker processes are gone."""
    from ..kernels import graphs

    try:
        with open(path) as fh:
            seen = json.load(fh)
    except (OSError, ValueError):
        seen = {}
    for mod in graphs._counter_modules():
        name = mod.__name__.rsplit(".", 1)[1]
        seen[name] = int(seen.get(name, 0)) + int(mod.launches)
    from ..utils.aio import durable_write

    durable_write(path, lambda fh: json.dump(seen, fh), mode="wt")


def serve_main(argv=None) -> int:
    """serve: the always-on consensus service. An HTTP/JSON front end takes
    concurrent correction jobs, a cross-job batcher merges their windows
    into shared device batches (each job's FASTA byte-identical to a solo
    daccord run), per-tenant admission control with RSS and free-disk
    watermarks sheds load, and a warm-state manager keeps each solve group
    (its ladder on the card, its CUDA graphs, its threads and audit
    workers) resident across jobs."""
    p = argparse.ArgumentParser(prog="serve", description=serve_main.__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8947,
                   help="listen port (0 = ephemeral; pair with --ready-file)")
    p.add_argument("--workdir", required=True,
                   help="service state root: job spool dirs, durable job "
                        "commits, telemetry sidecars")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where the groups' ladders run (default cuda, or cpu "
                        "for --backend cpu|native; no fallback)")
    p.add_argument("--backend", choices=BACKENDS, default="auto",
                   help="the engine of every solve group (see daccord "
                        "--backend); auto follows --device")
    p.add_argument("-b", "--batch", type=int, default=None,
                   help="merged cross-job dispatch width (default: 2048 on "
                        "cuda, 512 on cpu, 4096 native)")
    p.add_argument("--workers", type=int, default=2,
                   help="concurrent job slots (each job runs its own "
                        "feeder; the device is shared through the batcher)")
    p.add_argument("--ladder", choices=("fused", "split"), default="fused",
                   help="group dispatch strategy (see daccord --ladder); "
                        "ladder groups only: native groups run fused dense")
    p.add_argument("--paged", action="store_true",
                   help="pack merged cross-job batches as the paged wire "
                        "format (kernels/paging.py); ladder groups only")
    p.add_argument("--dp", choices=("fused", "scan"), default="fused",
                   help="the groups' heaviest-path route (see daccord --dp)")
    p.add_argument("--flush-lag-ms", type=float, default=50.0,
                   help="stale cross-job pool flush deadline: bounds the "
                        "latency one job's rows can pay waiting for others")
    p.add_argument("--idle-evict-s", type=float, default=600.0,
                   help="warm solve-group TTL (the group, its graphs, "
                        "threads and workers go after this long idle)")
    p.add_argument("--max-queued", type=int, default=32,
                   help="service-wide admission queue depth")
    p.add_argument("--tenant-max-queued", type=int, default=8,
                   help="queued+running jobs per tenant")
    p.add_argument("--tenant-max-mb", type=float, default=1024.0,
                   help="queued input bytes per tenant (MB)")
    p.add_argument("--rss-soft-mb", type=float, default=0.0,
                   help="pause admission at this host RSS (set below the "
                        "pipeline's DACCORD_GOV_RSS_* watermarks so new "
                        "work sheds before running feeders pause); 0 = off")
    p.add_argument("--rss-hard-mb", type=float, default=0.0,
                   help="reject and engage the batch-ladder shed at this "
                        "host RSS; 0 = off")
    p.add_argument("--events", default=None, metavar="PATH",
                   help="service events jsonl (serve.* lifecycle + metrics "
                        "snapshots; default WORKDIR/serve.events.jsonl)")
    p.add_argument("--ready-file", default=None, metavar="PATH",
                   help="write {port, pid} JSON here once the listener is "
                        "bound (scripts discovering an ephemeral --port 0)")
    p.add_argument("--metrics-snapshot-s", type=float, default=30.0)
    p.add_argument("--slo-p99-s", type=float, default=0.0,
                   help="p99 job-latency SLO target: the ticker tracks "
                        "rolling p99 against it, emits serve.slo burn events "
                        "and sheds batch width before a breach (0 = off)")
    p.add_argument("--slo-window-s", type=float, default=60.0,
                   help="rolling window the SLO p99 is computed over")
    p.add_argument("--no-journal", action="store_true",
                   help="disable the write-ahead job journal (jobs queued "
                        "or running at a crash are then lost; the default "
                        "journal replays them on restart)")
    p.add_argument("--checkpoint-reads", type=int, default=16,
                   help="per-job progress checkpoint stride (emitted reads "
                        "between durable progress manifests: the resume "
                        "point of a replay or takeover; 0 = off)")
    p.add_argument("--peer-dir", default=None, metavar="DIR",
                   help="shared-FS lease root: serve processes pointing at "
                        "the same dir form a takeover group; any of them "
                        "claims a dead peer's stale per-job lease and "
                        "finishes the journaled job byte-identically "
                        "(default: off, journal replay only)")
    p.add_argument("--peer-name", default="", metavar="NAME",
                   help="lease holder identity (default "
                        "<workdir-basename>@<host>:<pid>)")
    p.add_argument("--lease-ttl-s", type=float, default=15.0,
                   help="a per-job lease older than this is stale (peer "
                        "takeover fires)")
    p.add_argument("--heartbeat-s", type=float, default=1.0,
                   help="lease renewal and takeover-scan cadence")
    p.add_argument("--drain-deadline-s", type=float, default=0.0,
                   help="bounded graceful shutdown: a drain outliving this "
                        "journal-marks in-flight jobs INTERRUPTED (resumable "
                        "on restart) and exits nonzero (0 = unbounded)")
    p.add_argument("--aot-cache", default=None, metavar="DIR",
                   help="fleet-shared kernel cache: the card's groups install "
                        "the nvcc-built kernel libraries from (and publish "
                        "them to) this shared-FS dir, so a fresh peer runs no "
                        "nvcc (serve/aotcache.py). Default: $DACCORD_AOT_CACHE, "
                        "else <peer-dir>/aotcache when --peer-dir is set; "
                        "'off' disables")
    p.add_argument("--audit-rate", type=float, default=None, metavar="F",
                   help="sampled shadow verification for solve groups: the "
                        "fraction of windows per merged batch re-solved on "
                        "the CPU ladder and compared (default: env "
                        "DACCORD_AUDIT_RATE or 1/64; 0 disables; native "
                        "groups never audit). Never changes output bytes")
    args = p.parse_args(argv)

    backend_explicit = args.backend != "auto"
    _resolve_device(args)
    if args.backend == "auto":
        args.backend = args.device
    if args.paged and args.backend == "native":
        raise SystemExit("--paged is the ladder's wire format; --backend "
                         "native solves dense rows on host (drop one flag)")
    if args.ladder == "split" and args.backend == "native":
        raise SystemExit("--ladder split is the ladder's dispatch strategy; "
                         "--backend native escalates per window on host")
    if args.audit_rate is not None and not 0.0 <= args.audit_rate <= 1.0:
        raise SystemExit("--audit-rate must be within [0, 1]")
    if args.backend == "cuda":
        from ..utils.device import resolve_device

        try:
            resolve_device("cuda")
        except RuntimeError as e:
            # no fallback hides the card: a cuda service without one does
            # not start
            raise SystemExit(f"serve --backend cuda: {e}") from None
    from ..runtime.faults import FaultPlan

    try:
        FaultPlan.from_env()
    except ValueError as e:
        raise SystemExit(str(e)) from None
    from ..utils.obs import auto_batch_size

    if args.batch is None:
        args.batch = auto_batch_size(args.backend)
    from ..serve import AdmissionConfig, ConsensusService, ServeConfig
    from ..serve.http import start_server

    aot_dir = args.aot_cache or os.environ.get("DACCORD_AOT_CACHE")
    if not aot_dir and args.peer_dir:
        # the fleet's convention: the kernel cache lives beside the lease
        # dir, shared by every peer of a takeover group
        aot_dir = os.path.join(args.peer_dir, "aotcache")
    if aot_dir in ("off", "none", "0"):
        aot_dir = None
    cfg = ServeConfig(
        workdir=args.workdir, backend=args.backend,
        backend_explicit=backend_explicit, batch=args.batch,
        workers=args.workers, ladder_mode=args.ladder, paged=args.paged,
        dp_route=args.dp, flush_lag_s=args.flush_lag_ms / 1000.0,
        idle_evict_s=args.idle_evict_s,
        metrics_snapshot_s=args.metrics_snapshot_s,
        slo_p99_s=args.slo_p99_s, slo_window_s=args.slo_window_s,
        journal=not args.no_journal,
        checkpoint_reads=args.checkpoint_reads,
        peer_dir=args.peer_dir, peer_name=args.peer_name,
        lease_ttl_s=args.lease_ttl_s, heartbeat_s=args.heartbeat_s,
        drain_deadline_s=args.drain_deadline_s, audit_rate=args.audit_rate,
        aot_dir=aot_dir,
        admission=AdmissionConfig(
            max_queued_jobs=args.max_queued,
            tenant_max_queued=args.tenant_max_queued,
            tenant_max_bytes=int(args.tenant_max_mb * 1024 * 1024),
            rss_soft_mb=args.rss_soft_mb, rss_hard_mb=args.rss_hard_mb),
        events_path=args.events)
    svc = ConsensusService(cfg)
    httpd, port, _t = start_server(svc, args.host, args.port)
    # router discovery: publish the URL as an announce lease beside the job
    # leases (a no-op without --peer-dir)
    svc.announce(f"http://{args.host}:{port}")
    if args.ready_file:
        from ..utils.aio import durable_write

        durable_write(args.ready_file,
                      lambda fh: json.dump({"port": port, "pid": os.getpid()}, fh),
                      mode="wt")
    print(json.dumps({"serving": f"http://{args.host}:{port}",
                      "backend": args.backend, "batch": args.batch,
                      "workdir": args.workdir}), file=sys.stderr)
    import signal
    import threading

    def _stop(signum, frame):
        # graceful drain on SIGTERM/SIGINT: in-flight jobs finish, pools
        # drain, telemetry commits durably
        threading.Thread(target=lambda: (svc.shutdown(drain=True), httpd.shutdown()),
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    # SIGINT takes the same graceful path (no KeyboardInterrupt surfaces
    # once the handler is installed)
    signal.signal(signal.SIGINT, _stop)
    # serve_forever runs on the daemon thread; block until shutdown()
    _t.join()
    # an unclean drain (a wedged group thread outliving --drain-deadline-s,
    # its in-flight jobs journal-marked INTERRUPTED) exits nonzero, so a
    # supervisor knows to restart and replay
    return 0 if getattr(svc, "clean", True) else 1


def merge_main(argv=None) -> int:
    """daccord-merge: validating merge gate and crash-durable concatenation
    of the shard FASTAs: manifests are checked for presence, byte-range
    coverage, read and base counts and sha256 before the output commits."""
    p = argparse.ArgumentParser(prog="daccord-merge", description=merge_main.__doc__)
    p.add_argument("outdir")
    p.add_argument("n", type=int, help="number of shards")
    p.add_argument("out_fasta")
    p.add_argument("--allow-degraded", action="store_true",
                   help="merge even when shards completed degraded or "
                        "quarantined, and skip shards with no output at all "
                        "instead of refusing")
    args = p.parse_args(argv)
    from ..parallel.launch import MergeGateError, merge_shards
    from ..utils.obs import sha256_file

    try:
        n = merge_shards(args.outdir, args.n, args.out_fasta,
                         allow_degraded=args.allow_degraded)
    except MergeGateError as ex:
        raise SystemExit("daccord-merge: refusing to merge:\n  "
                         + "\n  ".join(ex.issues)) from None
    print(f"merged {n} fragments sha256={sha256_file(args.out_fasta)}", file=sys.stderr)
    return 0


def intrinsicqv_main(argv=None) -> int:
    """compute-inqual: intrinsic QV track (``computeintrinsicqv``)."""
    p = argparse.ArgumentParser(prog="compute-inqual", description=intrinsicqv_main.__doc__)
    p.add_argument("db")
    p.add_argument("las")
    p.add_argument("-d", type=int, default=20, help="expected coverage depth")
    p.add_argument("--block", type=int, default=None, metavar="I",
                   help="process only DB block I (1-based); writes a per-block "
                        "track to merge with `catrack`")
    args = p.parse_args(argv)
    db = read_db(args.db, load_bases=False)  # lengths only: block jobs stay O(block)
    lastools.compute_intrinsic_qv(db, LasFile(args.las), depth=args.d, block=args.block)
    return 0


def detectrepeats_main(argv=None) -> int:
    """las-detect-repeats: repeat intervals (``lasdetectsimplerepeats``)."""
    p = argparse.ArgumentParser(prog="las-detect-repeats",
                                description=detectrepeats_main.__doc__)
    p.add_argument("db")
    p.add_argument("las")
    p.add_argument("-d", type=int, default=20, help="expected coverage depth")
    p.add_argument("--factor", type=float, default=2.0, help="over-coverage factor")
    p.add_argument("--qv-track", default="inqual", metavar="NAME",
                   help="intrinsic-QV track gating which tiles may be repeat-"
                        "annotated; '' disables")
    p.add_argument("--qv-max", type=int, default=100,
                   help="tiles with QV above this are too low-quality to "
                        "repeat-annotate (255 = no coverage always excluded)")
    p.add_argument("--grow", type=int, default=2,
                   help="dilate detected intervals by this many tiles per "
                        "side (tile-granular thresholding under-calls repeat "
                        "edges where coverage decays)")
    p.add_argument("--block", type=int, default=None, metavar="I",
                   help="process only DB block I (1-based); writes a per-block "
                        "track to merge with `catrack`")
    args = p.parse_args(argv)
    db = read_db(args.db, load_bases=False)
    lastools.detect_repeats(db, LasFile(args.las), depth=args.d, cov_factor=args.factor,
                            block=args.block, qv_track=args.qv_track or None,
                            qv_max=args.qv_max, grow=args.grow)
    return 0


def filteralignments_main(argv=None) -> int:
    """las-filter: drop repeat-inconsistent alignments (``lasfilteralignments``)."""
    p = argparse.ArgumentParser(prog="las-filter", description=filteralignments_main.__doc__)
    p.add_argument("db")
    p.add_argument("las")
    p.add_argument("out")
    p.add_argument("--max-err", type=float, default=None)
    p.add_argument("--rep-margin", type=float, default=0.015,
                   help="repeat-confined alignments survive while their error "
                        "rate is within this of the unique-region profile "
                        "(cross-repeat-copy alignments carry the copies' "
                        "divergence on top of it)")
    p.add_argument("--mem-records", type=int, default=2_000_000,
                   help="bound peak memory to ~this many records (the "
                        "pre-filter LAS is the workflow's largest file); "
                        "chunked pile-aligned passes, byte-identical output")
    args = p.parse_args(argv)
    db = read_db(args.db, load_bases=False)
    las = LasFile(args.las)
    n = lastools.filter_alignments(db, las, args.out, max_err=args.max_err,
                                   rep_margin=args.rep_margin,
                                   mem_records=args.mem_records)
    print(f"kept {n} of {las.novl}", file=sys.stderr)
    return 0


def filtersym_main(argv=None) -> int:
    """las-filter-sym: symmetrize a filtered LAS (``filtersym``)."""
    p = argparse.ArgumentParser(prog="las-filter-sym", description=filtersym_main.__doc__)
    p.add_argument("las")
    p.add_argument("out")
    p.add_argument("--db", default=None, help="DB for exact complement mirroring")
    p.add_argument("--mem-records", type=int, default=2_000_000,
                   help="above this record count (with --db) the symmetric "
                        "join hash-partitions its key sets onto disk so "
                        "memory stays bounded; output is byte-identical")
    args = p.parse_args(argv)
    db = read_db(args.db, load_bases=False) if args.db else None
    if db is not None and LasFile(args.las).novl > args.mem_records:
        n = filter_symmetric_external(args.las, args.out, db, mem_records=args.mem_records)
    else:
        n = lastools.filter_symmetric(args.las, args.out, db=db)
    print(f"kept {n}", file=sys.stderr)
    return 0


def lasindex_main(argv=None) -> int:
    """las-index: build or refresh the aread byte index sidecar, so sharded
    jobs skip the whole-file scan."""
    p = argparse.ArgumentParser(prog="las-index", description=lasindex_main.__doc__)
    p.add_argument("las")
    args = p.parse_args(argv)
    idx = index_las(args.las)
    print(f"{len(idx)} piles -> {args.las}.idx", file=sys.stderr)
    return 0


def lassort_main(argv=None) -> int:
    """las-sort: sort a LAS by (aread, bread) (the LAsort role: a
    block-memory external sort, so inputs far larger than RAM still sort)."""
    p = argparse.ArgumentParser(prog="las-sort", description=lassort_main.__doc__)
    p.add_argument("las")
    p.add_argument("out")
    p.add_argument("--mem-records", type=int, default=2_000_000,
                   help="records held in memory per sorted run; files with "
                        "more records than this go through on-disk runs + "
                        "k-way merge (byte-identical to the in-memory sort)")
    args = p.parse_args(argv)
    n = sort_las_external(args.las, args.out, mem_records=args.mem_records)
    print(f"sorted {n} overlaps", file=sys.stderr)
    return 0


def dbsplit_main(argv=None) -> int:
    """db-split: recompute the DB's block partition (DAZZ_DB ``DBsplit``)."""
    p = argparse.ArgumentParser(prog="db-split", description=dbsplit_main.__doc__)
    p.add_argument("db")
    p.add_argument("-s", "--size", type=float, default=200.0,
                   help="block size in megabases (DBsplit -s)")
    args = p.parse_args(argv)
    blocks = split_db(args.db, int(args.size * 1_000_000))
    print(f"{len(blocks)} blocks", file=sys.stderr)
    return 0


def catrack_main(argv=None) -> int:
    """catrack: merge per-block tracks into the whole-DB track (DAZZ_DB
    ``Catrack``), after `inqual --block` or `repeats --block`."""
    p = argparse.ArgumentParser(prog="catrack", description=catrack_main.__doc__)
    p.add_argument("db")
    p.add_argument("track", help="track name (e.g. inqual, rep)")
    p.add_argument("-d", "--delete", action="store_true",
                   help="remove the per-block track files after merging")
    args = p.parse_args(argv)
    n = catrack(args.db, args.track, delete=args.delete)
    print(f"merged track '{args.track}' over {n} reads", file=sys.stderr)
    return 0


def lasmerge_main(argv=None) -> int:
    """las-merge: merge sorted LAS files into one (the LAmerge role:
    DALIGNER writes one LAS per DB-block pair)."""
    p = argparse.ArgumentParser(prog="las-merge", description=lasmerge_main.__doc__)
    p.add_argument("out")
    p.add_argument("las", nargs="+", help="input LAS files (aread-sorted)")
    args = p.parse_args(argv)
    try:
        n = merge_las(args.las, args.out)
    except ValueError as ex:
        raise SystemExit(f"las-merge: {ex}") from None
    print(f"merged {len(args.las)} files -> {n} overlaps", file=sys.stderr)
    return 0


def fasta2db_main(argv=None) -> int:
    """fasta2db: build a Dazzler DB triple from FASTA (DAZZ_DB fasta2DB)."""
    p = argparse.ArgumentParser(prog="fasta2db", description=fasta2db_main.__doc__)
    p.add_argument("fasta")
    p.add_argument("db", help="output .db path")
    p.add_argument("--cutoff", type=int, default=0,
                   help="drop reads shorter than this (Dazzler trim semantics)")
    args = p.parse_args(argv)
    recs = list(read_fasta(args.fasta))
    n_all = len(recs)
    if args.cutoff > 0:
        recs = [r for r in recs if len(r.seq) >= args.cutoff]
    db = write_db(args.db, [seq_to_ints(r.seq) for r in recs],
                  names=[r.name for r in recs], cutoff=args.cutoff)
    dropped = n_all - len(recs)
    print(f"{db.nreads} reads, {db.totlen} bases"
          + (f" ({dropped} below cutoff dropped)" if dropped else ""), file=sys.stderr)
    return 0


def db2fasta_main(argv=None) -> int:
    """db2fasta: dump a Dazzler DB back to FASTA (DAZZ_DB DB2fasta)."""
    p = argparse.ArgumentParser(prog="db2fasta", description=db2fasta_main.__doc__)
    p.add_argument("db")
    p.add_argument("-o", "--out", default="-", help="output FASTA ('-' = stdout)")
    args = p.parse_args(argv)
    db = read_db(args.db)
    recs = [FastaRecord(db.names[i] if i < len(db.names) else f"read{i}",
                        ints_to_seq(db.read_bases(i))) for i in range(db.nreads)]
    write_fasta(sys.stdout if args.out == "-" else args.out, recs)
    return 0


def dbstats_main(argv=None) -> int:
    """db-stats: read and base counts, length distribution, N50 and block
    partition (DAZZ_DB ``DBstats``)."""
    p = argparse.ArgumentParser(prog="db-stats", description=dbstats_main.__doc__)
    p.add_argument("db")
    args = p.parse_args(argv)
    rlens = np.sort(read_lengths(args.db))[::-1]
    tot = int(rlens.sum())
    n50 = 0
    if tot:
        n50 = int(rlens[np.searchsorted(np.cumsum(rlens), tot / 2)])
    try:
        nblocks = len(db_blocks(args.db))
    except (OSError, ValueError, IndexError):
        nblocks = 1
    print(f"{len(rlens):>12,} reads  {tot:>15,} bases  in {nblocks} block(s)")
    if len(rlens):
        print(f"{'min':>12} {int(rlens[-1]):>11,}\n"
              f"{'median':>12} {int(np.median(rlens)):>11,}\n"
              f"{'mean':>12} {int(rlens.mean()):>11,}\n"
              f"{'N50':>12} {n50:>11,}\n"
              f"{'max':>12} {int(rlens[0]):>11,}")
    return 0


def dbshow_main(argv=None) -> int:
    """db-show: print selected reads as FASTA (DAZZ_DB ``DBshow``). Read
    selectors are 0-based ids or i-j ranges (end exclusive); no selector
    dumps the whole DB."""
    p = argparse.ArgumentParser(prog="db-show", description=dbshow_main.__doc__)
    p.add_argument("db")
    p.add_argument("reads", nargs="*", help="read ids: '7' or '3-12' (0-based, end-exclusive)")
    p.add_argument("-o", "--out", default="-", help="output FASTA ('-' = stdout)")
    args = p.parse_args(argv)
    db = read_db(args.db, load_bases=False)  # bases seeked per selected read
    ids: list[int] = []
    for sel in args.reads:
        try:
            if "-" in sel:
                i, j = (int(x) for x in sel.split("-", 1))
                ids.extend(range(i, j))
            else:
                ids.append(int(sel))
        except ValueError:
            raise SystemExit(f"db-show: bad read selector {sel!r} (use 'i' or 'i-j')") from None
    if not args.reads:
        ids = list(range(db.nreads))
    bad = [i for i in ids if not (0 <= i < db.nreads)]
    if bad:
        raise SystemExit(f"db-show: read id(s) out of range (DB has {db.nreads} reads): {bad[:5]}")
    recs = (FastaRecord(db.names[i] if i < len(db.names) else f"read{i}", ints_to_seq(bases))
            for i, bases in zip(ids, decode_reads_from_bps(db, ids)))
    write_fasta(sys.stdout if args.out == "-" else args.out, recs)
    return 0


def lasshow_main(argv=None) -> int:
    """las-show: human-readable LAS dump (DALIGNER ``LAshow``)."""
    p = argparse.ArgumentParser(prog="las-show", description=lasshow_main.__doc__)
    p.add_argument("las")
    p.add_argument("-n", type=int, default=None, help="print at most N records")
    p.add_argument("--trace", action="store_true", help="also print per-tile (diffs, b-bases)")
    args = p.parse_args(argv)
    las = LasFile(args.las)
    print(f"{las.novl} records, tspace {las.tspace}")
    for i, o in enumerate(las):
        if args.n is not None and i >= args.n:
            break
        strand = "c" if o.is_comp else "n"
        print(f"{o.aread:>9} {o.bread:>9} {strand} "
              f"[{o.abpos:>9}..{o.aepos:>9}] x [{o.bbpos:>9}..{o.bepos:>9}] "
              f"diffs {o.diffs}")
        if args.trace:
            for d, b in o.trace:
                print(f"          ({d:>4}, {b:>4})")
    return 0


def lascheck_main(argv=None) -> int:
    """las-check: validate LAS structure (DALIGNER ``LAcheck``): header count
    against records, aread sort order, coordinate sanity, trace tile counts,
    and (with a DB) coordinates against read lengths. Exit status 1 on any
    violation."""
    p = argparse.ArgumentParser(prog="las-check", description=lascheck_main.__doc__)
    p.add_argument("las")
    p.add_argument("--db", default=None, help="DB to bounds-check coordinates against")
    p.add_argument("--max-report", type=int, default=10)
    args = p.parse_args(argv)
    rlens = read_lengths(args.db) if args.db else None
    try:
        las = LasFile(args.las)
    except ValueError as ex:  # IngestError: torn/corrupt header
        print(f"{args.las}: {ex}", file=sys.stderr)
        print(f"{args.las}: 0 records BAD", file=sys.stderr)
        return 1
    errs: list[str] = []

    def report(msg: str):
        if len(errs) < args.max_report:
            errs.append(msg)

    n = 0
    prev = (-1, -1, -1)
    try:
        for o in las:
            key = (o.aread, o.bread, o.abpos)
            if key < prev:
                report(f"record {n}: sort order violated {prev} > {key}")
            prev = key
            if not (0 <= o.abpos < o.aepos) or not (0 <= o.bbpos < o.bepos):
                report(f"record {n}: degenerate span a[{o.abpos},{o.aepos}) b[{o.bbpos},{o.bepos})")
            elif len(o.trace) != o.ntiles(las.tspace):
                report(f"record {n}: {len(o.trace)} trace tiles, expected {o.ntiles(las.tspace)}")
            elif int(o.trace[:, 1].sum()) != o.bepos - o.bbpos:
                report(f"record {n}: trace b-bases {int(o.trace[:, 1].sum())} != span {o.bepos - o.bbpos}")
            if rlens is not None:
                if not (0 <= o.aread < len(rlens)) or not (0 <= o.bread < len(rlens)):
                    report(f"record {n}: read id out of range ({o.aread}, {o.bread})")
                elif o.aepos > rlens[o.aread] or o.bepos > rlens[o.bread]:
                    report(f"record {n}: span exceeds read length")
            n += 1
    except (ValueError, struct.error) as ex:
        # a file cut mid-record is what this tool exists to detect
        report(f"record {n}: file truncated or corrupt mid-record ({ex})")
    if n != las.novl:
        report(f"header novl {las.novl} != {n} records")
    for iss in sidecar_issues(args.las):
        # a torn .idx sidecar costs every array job a silent full rescan
        report(iss.describe())
    for e in errs:
        print(e, file=sys.stderr)
    print(f"{args.las}: {n} records {'OK' if not errs else 'BAD'}", file=sys.stderr)
    return 1 if errs else 0


def lassplit_main(argv=None) -> int:
    """las-split: split an aread-sorted LAS into per-DB-block files (DALIGNER
    ``LAsplit``, the inverse of las-merge). The output template must contain
    '#' (the block number)."""
    p = argparse.ArgumentParser(prog="las-split", description=lassplit_main.__doc__)
    p.add_argument("las")
    p.add_argument("db", help="DB whose block partition drives the split")
    p.add_argument("template", help="output path template, e.g. out.#.las")
    args = p.parse_args(argv)
    if "#" not in args.template:
        raise SystemExit("las-split: template must contain '#'")
    las = LasFile(args.las)
    total = 0
    for i, (lo, hi) in enumerate(db_blocks(args.db), start=1):
        start, end = range_for_areads(args.las, lo, hi)
        n = write_las(args.template.replace("#", str(i)), las.tspace,
                      las.iter_range(start, end))
        total += n
        print(f"block {i}: reads [{lo},{hi}) -> {n} overlaps", file=sys.stderr)
    if total != las.novl:
        # records whose aread lies outside the block partition (a LAS of
        # another DB) would vanish silently
        raise SystemExit(f"las-split: {las.novl - total} of {las.novl} overlaps "
                         f"fall outside {args.db}'s block partition")
    return 0


def fillfasta_main(argv=None) -> int:
    """fill-fasta: replace non-ACGT symbols with seeded random bases so the
    2-bit Dazzler DB can hold the reads (``fillfasta``)."""
    p = argparse.ArgumentParser(prog="fill-fasta", description=fillfasta_main.__doc__)
    p.add_argument("fasta")
    p.add_argument("out", help="output FASTA ('-' = stdout)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed for the fill bases")
    args = p.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    stats = {"reads": 0, "filled": 0}

    def fill():  # streamed: one read in memory
        for rec in read_fasta(args.fasta):
            s = np.frombuffer(rec.seq.upper().encode(), dtype=np.uint8).copy()
            bad = ~np.isin(s, acgt)
            nb = int(bad.sum())
            if nb:
                s[bad] = acgt[rng.integers(0, 4, size=nb)]
                stats["filled"] += nb
            stats["reads"] += 1
            yield FastaRecord(rec.name, s.tobytes().decode())

    write_fasta(sys.stdout if args.out == "-" else args.out, fill())
    print(f"filled {stats['filled']} non-ACGT symbols in {stats['reads']} reads",
          file=sys.stderr)
    return 0


def qveval_main(argv=None) -> int:
    """qv-eval: align corrected reads back to their truth and report the
    consensus Q-score."""
    p = argparse.ArgumentParser(prog="qv-eval", description=qveval_main.__doc__)
    p.add_argument("fasta", help="corrected FASTA (names 'read<ID>/<frag>')")
    p.add_argument("truth", help="sim truth .npz (genome/starts/ends/strands)")
    p.add_argument("--raw-db", default=None,
                   help="also score the uncorrected reads of this DB (raw Q)")
    p.add_argument("--json", default="-", help="write the JSON line here")
    args = p.parse_args(argv)
    import math

    from ..oracle.align import edit_distance, infix_distance

    t = np.load(args.truth)
    genome, starts, ends, strands = t["genome"], t["starts"], t["ends"], t["strands"]

    def truth_of(rid: int) -> np.ndarray:
        tr = genome[starts[rid] : ends[rid]]
        return revcomp_ints(tr) if strands[rid] == 1 else tr

    tot_e = tot_l = 0
    n_frags = n_skipped = 0
    scored_rids = set()
    for rec in read_fasta(args.fasta):
        name = rec.name.split()[0]
        try:
            if not name.startswith("read"):
                raise ValueError(name)
            rid = int(name.removeprefix("read").split("/")[0])
            if not (0 <= rid < len(starts)):  # also rejects negative ids
                raise IndexError(rid)
            tr = truth_of(rid)
        except (ValueError, IndexError):
            n_skipped += 1
            continue
        f = seq_to_ints(rec.seq)
        tot_e += infix_distance(f, tr)
        tot_l += len(f)
        n_frags += 1
        scored_rids.add(rid)
    err = tot_e / tot_l if tot_l else float("nan")
    q = -10.0 * math.log10(max(err, 1e-9)) if tot_l else float("nan")
    line = {"fragments": n_frags, "skipped": n_skipped, "bases": tot_l,
            "errors": tot_e, "error_rate": round(err, 6), "qscore": round(q, 2)}
    if args.raw_db:
        db = read_db(args.raw_db)
        raw_e = raw_l = 0
        for rid in sorted(scored_rids):
            raw = db.read_bases(rid)
            raw_e += edit_distance(raw, truth_of(rid))
            raw_l += len(raw)  # the errors / len(sequence) of the above
        raw_err = raw_e / raw_l if raw_l else float("nan")
        raw_q = -10.0 * math.log10(max(raw_err, 1e-9)) if raw_l else float("nan")
        line.update(raw_error_rate=round(raw_err, 6), raw_qscore=round(raw_q, 2),
                    delta_q=round(q - raw_q, 2))
    out = json.dumps(line)
    if args.json == "-":
        print(out)
    else:
        with open(args.json, "wt") as fh:
            fh.write(out + "\n")
        print(out, file=sys.stderr)
    return 0

def router_main(argv=None) -> int:
    """router: the stateless front door of a serve fleet. It discovers peers
    from the shared lease dir's announce leases, rendezvous-hashes tenants to
    the peers whose groups are warm, spills around shedding or burning
    owners, proxies submit/result/stream/abort with idempotency keys passing
    through, and (optionally) runs the SLO-burn autoscaler that spawns and
    reaps serve peers."""
    p = argparse.ArgumentParser(prog="router", description=router_main.__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8946,
                   help="listen port (0 = ephemeral; pair with --ready-file)")
    p.add_argument("--workdir", required=True,
                   help="router state root: router.events.jsonl telemetry")
    p.add_argument("--peer-dir", required=True, metavar="DIR",
                   help="the serve fleet's shared lease root (the SAME dir "
                        "every serve --peer-dir points at): peers are "
                        "discovered from its announce leases")
    p.add_argument("--poll-s", type=float, default=1.0,
                   help="healthz poll + discovery sweep cadence")
    p.add_argument("--lease-ttl-s", type=float, default=15.0,
                   help="an announce lease older than this = peer down")
    p.add_argument("--spill-burn", type=float, default=1.0,
                   help="owner SLO burn >= this (red band) spills the tenant "
                        "to the least-loaded ready peer (0 = never spill on "
                        "burn)")
    p.add_argument("--proxy-timeout-s", type=float, default=600.0)
    p.add_argument("--healthz-timeout-s", type=float, default=5.0,
                   help="per-poll deadline: bounds the poll loop against a "
                        "hung peer socket")
    p.add_argument("--breaker-fails", type=int, default=3,
                   help="consecutive transport failures that open a peer's "
                        "circuit breaker")
    p.add_argument("--breaker-open-s", type=float, default=5.0,
                   help="breaker cooldown before a half-open probe")
    p.add_argument("--net-retries", type=int, default=2,
                   help="transient-class (reset/refused) retry budget per "
                        "proxied call; non-idempotent submits never retry")
    p.add_argument("--events", default=None, metavar="PATH",
                   help="router events jsonl (router.* + scale.*; default "
                        "WORKDIR/router.events.jsonl)")
    p.add_argument("--ready-file", default=None, metavar="PATH",
                   help="write {port, pid} JSON here once bound")
    # the SLO-burn autoscaler (off unless --autoscale-max > 0)
    p.add_argument("--autoscale-max", type=int, default=0, metavar="N",
                   help="enable the autoscaler with this fleet-size cap: "
                        "sustained fleet burn spawns serve peers into "
                        "--autoscale-root, idle spawned peers drain after "
                        "--autoscale-idle-s (0 = autoscaler off)")
    p.add_argument("--autoscale-min", type=int, default=1)
    p.add_argument("--autoscale-root", default=None, metavar="DIR",
                   help="workdir root for spawned peers (default "
                        "WORKDIR/peers)")
    p.add_argument("--autoscale-burn", type=float, default=1.0,
                   help="fleet burn (max over ready peers) >= this arms the "
                        "scale-out trigger")
    p.add_argument("--autoscale-sustain-s", type=float, default=5.0)
    p.add_argument("--autoscale-cooldown-s", type=float, default=30.0)
    p.add_argument("--autoscale-idle-s", type=float, default=120.0,
                   help="an idle spawned peer older than this drains "
                        "(graceful shutdown; 0 = never scale in)")
    p.add_argument("--autoscale-backend", choices=BACKENDS, default="cuda",
                   help="the spawned peers' --backend (default the card; "
                        "auto raises in the peer without one)")
    p.add_argument("--autoscale-batch", type=int, default=None,
                   help="the spawned peers' -b (default: their own auto batch)")
    p.add_argument("--autoscale-workers", type=int, default=2)
    p.add_argument("--autoscale-slo-p99-s", type=float, default=0.0,
                   help="forwarded to spawned peers so they report burn")
    p.add_argument("--autoscale-arg", action="append", default=[],
                   metavar="ARG", help="extra serve flag for spawned peers "
                        "(repeatable)")
    args = p.parse_args(argv)

    from ..serve.router import Router, RouterConfig, start_router

    rcfg = RouterConfig(workdir=args.workdir, peer_dir=args.peer_dir,
                        poll_s=args.poll_s, lease_ttl_s=args.lease_ttl_s,
                        spill_burn=args.spill_burn,
                        proxy_timeout_s=args.proxy_timeout_s,
                        healthz_timeout_s=args.healthz_timeout_s,
                        breaker_fails=args.breaker_fails,
                        breaker_open_s=args.breaker_open_s,
                        net_retries=args.net_retries,
                        events_path=args.events)
    router = Router(rcfg)
    if args.autoscale_max > 0:
        from ..serve.autoscale import AutoscaleConfig, Autoscaler

        acfg = AutoscaleConfig(
            peer_dir=args.peer_dir,
            root=args.autoscale_root or os.path.join(args.workdir, "peers"),
            max_peers=args.autoscale_max, min_peers=args.autoscale_min,
            spawn_burn=args.autoscale_burn,
            sustain_s=args.autoscale_sustain_s,
            cooldown_s=args.autoscale_cooldown_s,
            idle_ttl_s=args.autoscale_idle_s,
            backend=args.autoscale_backend, batch=args.autoscale_batch,
            workers=args.autoscale_workers,
            slo_p99_s=args.autoscale_slo_p99_s,
            extra_args=tuple(args.autoscale_arg))
        router.autoscaler = Autoscaler(acfg, router.log)
    httpd, port, _t = start_router(router, args.host, args.port)
    if args.ready_file:
        from ..utils.aio import durable_write

        durable_write(args.ready_file,
                      lambda fh: json.dump({"port": port, "pid": os.getpid()}, fh),
                      mode="wt")
    print(json.dumps({"routing": f"http://{args.host}:{port}",
                      "peer_dir": args.peer_dir,
                      "autoscale_max": args.autoscale_max}), file=sys.stderr)
    import signal
    import threading

    def _stop(signum, frame):
        threading.Thread(target=lambda: (router.shutdown(), httpd.shutdown()),
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    _t.join()
    return 0


def fleet_main(argv=None) -> int:
    """fleet: run all N shards to completion under supervision — a bounded
    local pool of shard worker processes plus shared-FS lease takeover for
    several hosts; crashed or hung workers are requeued with backoff, a
    shard that kills K consecutive workers is poison-quarantined while the
    rest of the fleet continues, and --merge ends in the validating merge
    gate."""
    p = argparse.ArgumentParser(prog="fleet", description=fleet_main.__doc__)
    p.add_argument("db")
    p.add_argument("las")
    p.add_argument("outdir")
    p.add_argument("-n", "--nshards", type=int, required=True)
    p.add_argument("--workers", type=int, default=2,
                   help="local worker subprocess slots")
    p.add_argument("--max-attempts", type=int, default=5,
                   help="worker spawns per shard before it is quarantined")
    p.add_argument("--poison-after", type=int, default=3,
                   help="consecutive worker failures that declare a shard poison")
    p.add_argument("--heartbeat", type=float, default=1.0, metavar="S",
                   help="lease mtime renewal period")
    p.add_argument("--lease-ttl", type=float, default=15.0, metavar="S",
                   help="a lease older than this is stale: any host may take "
                        "the shard over (must exceed a few heartbeats plus "
                        "shared-FS mtime lag and host clock skew)")
    p.add_argument("--stall-timeout", type=float, default=600.0, metavar="S",
                   help="a worker whose progress manifest has not moved for "
                        "this long is declared hung and requeued")
    p.add_argument("--speculate-factor", type=float, default=4.0,
                   help="re-execute a shard lagging the fleet median "
                        "throughput by this factor once slots are idle "
                        "(0 = off)")
    p.add_argument("--checkpoint-every", type=int, default=16,
                   help="worker checkpoint cadence (reads); progress "
                        "manifests also drive hang detection")
    p.add_argument("-b", "--batch", type=int, default=None,
                   help="every worker's -b (default: the backend's auto "
                        "batch, utils.obs.auto_batch_size)")
    p.add_argument("--backend", choices=BACKENDS, default="auto",
                   help="every worker's engine; auto = the card when the "
                        "probe sees one, else an error, or with --device cpu "
                        "the native engine (the CPU ladder without g++)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="every worker's --device (default: the backend's)")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="every worker's -t (feeder threads; default: the "
                        "worker's own)")
    p.add_argument("--dp", choices=("fused", "scan"), default=None,
                   help="every worker's heaviest-path route")
    p.add_argument("--ingest-policy", choices=("strict", "quarantine", "off"),
                   default="strict")
    p.add_argument("--paged", choices=("on", "off", "auto"), default="off",
                   help="paged window batching forwarded to every worker "
                        "(see daccord --paged)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="several cards a worker: not ported (N > 1 is "
                        "refused)")
    p.add_argument("--max-pile-overlaps", type=int, default=None, metavar="N",
                   help="monster-pile budget forwarded to every worker (see "
                        "daccord --max-pile-overlaps); 0 disables")
    p.add_argument("--events", default=None, metavar="PATH",
                   help="fleet events jsonl (spawn/heartbeat/takeover/retry/"
                        "poison/speculate/done; schema: tools/eventcheck.py). "
                        "Default: OUTDIR/fleet.events.jsonl")
    p.add_argument("--no-worker-telemetry", action="store_true",
                   help="do not thread per-worker telemetry sidecars "
                        "(shardNNNN.events.jsonl, shardNNNN.ledger.jsonl) "
                        "through the workers")
    p.add_argument("--merge", default=None, metavar="FASTA",
                   help="after the fleet finishes, run the validating merge "
                        "gate into this file")
    p.add_argument("--allow-degraded", action="store_true",
                   help="let --merge proceed over degraded/quarantined/"
                        "missing shards, and exit 0 even when shards were "
                        "poisoned")
    args = p.parse_args(argv)
    want = {"cuda": "cuda", "cpu": "cpu", "native": "cpu"}.get(args.backend)
    if args.device is not None and want is not None and args.device != want:
        raise SystemExit(f"--backend {args.backend} contradicts --device "
                         f"{args.device} (drop one of the two flags)")
    from ..parallel.fleet import Fleet, FleetConfig
    from ..parallel.launch import MergeGateError, merge_shards
    from ..runtime.faults import FaultPlan

    try:
        faults = FaultPlan.from_env()
    except ValueError as e:
        raise SystemExit(str(e)) from None
    cfg = FleetConfig(nshards=args.nshards, workers=args.workers,
                      max_attempts=args.max_attempts,
                      poison_after=args.poison_after,
                      heartbeat_s=args.heartbeat, lease_ttl_s=args.lease_ttl,
                      stall_timeout_s=args.stall_timeout,
                      speculate_factor=args.speculate_factor,
                      checkpoint_every=args.checkpoint_every,
                      batch=args.batch, backend=args.backend,
                      device=args.device, threads=args.threads,
                      dp_route=args.dp, ingest_policy=args.ingest_policy,
                      paged=args.paged, mesh=args.mesh,
                      max_pile_overlaps=args.max_pile_overlaps,
                      worker_telemetry=not args.no_worker_telemetry,
                      events_path=args.events if args.events is not None
                      else os.path.join(args.outdir, "fleet.events.jsonl"))
    try:
        fleet = Fleet(args.db, args.las, args.outdir, cfg, faults=faults)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"fleet: {e}") from None
    manifest = fleet.run()
    print(json.dumps({k: manifest[k] for k in
                      ("nshards", "done", "poison", "degraded", "wall_s")}),
          file=sys.stderr)
    if args.merge:
        try:
            n = merge_shards(args.outdir, args.nshards, args.merge,
                             allow_degraded=args.allow_degraded)
        except MergeGateError as ex:
            raise SystemExit("fleet: merge gate refused:\n  "
                             + "\n  ".join(ex.issues)) from None
        # the merged output's digest into fleet.json: the integrity chain's
        # last durable link (the audit tool re-verifies it offline)
        from ..parallel.launch import _write_manifest_durable
        from ..utils.obs import sha256_file

        merged_sha = sha256_file(args.merge)
        fj = os.path.join(args.outdir, "fleet.json")
        try:
            with open(fj) as fh:
                fm = json.load(fh)
        except (OSError, ValueError):
            fm = None
        if fm is not None:
            fm["merged_fasta"] = args.merge
            fm["merged_fragments"] = n
            fm["merged_sha256"] = merged_sha
            _write_manifest_durable(fj, fm)
        print(f"merged {n} fragments -> {args.merge} sha256={merged_sha}",
              file=sys.stderr)
    return 0 if (not manifest["poison"] or args.allow_degraded) else 1


_TOOLS = {
    "daccord": daccord_main,
    "shard": shard_main,
    "serve": serve_main,
    "router": router_main,
    "fleet": fleet_main,
    "merge": merge_main,
    "audit": audit_main,
    "inqual": intrinsicqv_main,
    "repeats": detectrepeats_main,
    "filter": filteralignments_main,
    "filtersym": filtersym_main,
    "lassort": lassort_main,
    "lasmerge": lasmerge_main,
    "catrack": catrack_main,
    "lasindex": lasindex_main,
    "lasshow": lasshow_main,
    "lascheck": lascheck_main,
    "lassplit": lassplit_main,
    "dbstats": dbstats_main,
    "dbshow": dbshow_main,
    "fasta2db": fasta2db_main,
    "db2fasta": db2fasta_main,
    "dbsplit": dbsplit_main,
    "fillfasta": fillfasta_main,
    "qveval": qveval_main,
    "eventcheck": eventcheck_main,
    "trace": trace_main,
    "top": top_main,
    "sentinel": sentinel_main,
    "prof": prof_main,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    usage = (f"usage: python -m daccord_tpu_torch.tools.cli <tool> [args]\n"
             f"tools: {', '.join(_TOOLS)}\n{USAGE}")
    if argv[:1] in (["-h"], ["--help"]):
        print(usage)
        return 0
    if not argv:
        print(usage, file=sys.stderr)
        return 2
    tool = argv.pop(0)
    if tool not in _TOOLS:
        print(f"unknown tool {tool!r}; tools: {', '.join(_TOOLS)}", file=sys.stderr)
        return 2
    return _TOOLS[tool](argv)


if __name__ == "__main__":
    sys.exit(main())
