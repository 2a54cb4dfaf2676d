"""End-to-end correction pipeline: DB + LAS piles -> window batches -> FASTA.

The port of ``daccord_tpu/runtime/pipeline.py``'s default ``daccord`` run,
in this order:

- the ingest gate (``formats/ingest.py``): every record header of the byte
  range is validated before any decoder trusts it. ``strict`` (the default)
  raises an ``IngestError`` naming each issue's kind, byte offset and pile;
  ``quarantine`` streams the clean byte segments through the feeders and
  emits each corrupt pile's read uncorrected, with one sidecar row; ``off``
  trusts the input;
- the profile pass: a strided sample of (clean) piles, windowed on the
  host, gives the two-pass error profile (skipped when a profile is passed
  in);
- the host windowing of every pile: rank the pile's overlaps (trace-diff
  rate, plus the B read's intrinsic QV when the DB has an ``inqual`` track)
  so the best fill the depth slots, then realign each overlap's trace tiles,
  cut windows and pack them into [D, L] rows. By default one call of the
  host library per pile does the last three (``native/dazz_native.cpp
  process_pile``), on ``feeder_threads`` threads ahead of the batching loop
  when that is above 0; ``use_native=False`` runs the numpy feeder
  (``oracle/windows.py``, ``kernels/tensorize.py``), which writes the same
  bytes. A pile of more than ``max_pile_overlaps`` overlaps is contained
  before it is windowed, as a quarantined pile is (the monster-pile guard);
- skip-shallow (``skip_shallow``, on by default): windows with fewer than
  ``min_depth`` segments never reach the device (the solver would mark them
  unsolved; off, it does, and the FASTA is the same);
- batching, one ladder call per batch of ``batch_size`` rows (a partial
  batch is padded with empty rows so every call of a bucket has one shape).
  Dense (``paged="off"``), each window goes to the smallest (D, L) bucket of
  ``depth_buckets`` x ``seg_len_buckets`` that holds it. Paged
  (``kernels/paging.py``), a family router sends each window to the
  smallest corpus-derived (depth, pages) shape family that holds it, and a
  batch ships as a page pool and a page table instead of the dense tile.
  A bucket flushes when it holds ``batch_size`` rows, when its pages fill
  one pool, when its oldest row has waited ``bucket_flush_reads`` reads, or
  at the end of the run. With ``ladder_mode="split"`` (the two-stream
  ladder) a batch runs tier 0 alone (Stream A), the rows the fused ladder
  would rescue pool per bucket, and a pool flushes by the same rules
  (``rescue_flush_reads``) as a whole-ladder Stream B batch;
- the in-flight deque: each batch is handed to the ladder dispatcher
  (``kernels/tiers.py LadderDispatcher``) and queued; once ``max_inflight``
  are queued, the oldest half is fetched and scattered to their reads, so
  the host windows, scatters and stitches while the card solves. A call
  whose shadow-audit rows the audit worker has not sent back yet stays
  queued (up to ``AUDIT_LAG`` times the depth) rather than block the
  pipeline on them: the worker's start (an interpreter and numpy, about
  0.5 s on an H100 host) otherwise stalls the first fetches of every run.
  ``max_inflight=1`` solves each batch on the pipeline's thread. A fetched
  batch scatters into its reads' result arrays as array ops, one slice per
  read;
- the device supervisor (``supervise``, ``runtime/supervisor.py``) wraps
  every dispatch and fetch: deadlines, retries, the capacity governor's
  bisect on an out-of-memory error, failover of the calls in flight to the
  ``failover_backend`` engine on device loss, and the shadow audit of a
  seeded sample of each fetched batch on the CPU ladder. The host-memory
  watermark is checked once per pile block and the monster-pile guard once
  per pile (``runtime/governor.py``); ``DACCORD_FAULT`` injects the faults
  of ``runtime/faults.py``;
- the homopolymer rescue (``ConsensusConfig.hp_rescue``, ``oracle/hp.py``):
  after each fetch (and after the shadow audit's comparison, which sees the
  ladder's own rows), the windows that failed or solved badly and hold a
  long run solve again in run-length-compressed space on the host, in the
  host library (``hp_rescue_windows``) or, with ``hp_native=False``, in the
  python ``hp_candidate`` loop (the same bytes). A split run's Stream A
  rows headed for the rescue pool get theirs when their Stream B rows land;
- end-trim: prefix/suffix runs of windows solved only by a low-confidence
  rescue tier (min_count <= 1) count as unsolved, because read ends have
  thin piles and such windows carry near-raw error rates (split mode only:
  ``patch`` refills unsolved windows with raw bases, which no rescue
  consensus is worse than);
- stitching (an unsolved window splits the read, or in ``patch`` mode keeps
  the read's own bases), and FASTA records in input order.

``native_solver=True`` (``--backend native``) solves every batch with the
host library's tier ladder instead (``_build_native_fallback``, the same
engine the supervisor fails over to), with the homopolymer rescue inside
the engine; no card is used, batches are dense and fused, and the
supervisor fails over to the engine itself.

Windows are solved independently, so how rows are grouped into batches, and
how many batches are in flight, never changes a window's result.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..formats.dazzdb import DazzDB, read_db, read_track
from ..formats.fasta import FastaRecord, write_fasta
from ..formats.ingest import scan_with_db
from ..formats.las import _HDR_SIZE, LasFile, index_las
from ..kernels import paging
from ..kernels.tensorize import BatchShape, WindowBatch, pad_batch, tensorize_windows
from ..kernels import graphs
from ..kernels.graphs import pick_width
from ..kernels.tiers import (LadderDispatcher, TierLadder, fetch, fetch_many, landed,
                             rescue_candidates, stream_dispatcher, upload_arrays)
from ..native.api import ColumnarLas, process_pile_native
from ..oracle.consensus import ConsensusConfig, estimate_profile_two_pass, stitch_results
from ..oracle.profile import ErrorProfile
from ..oracle.windows import cut_windows, refine_overlap
from ..tools.lastools import QV_NOCOV, QV_SCALE
from ..utils import aio
from ..utils.bases import ints_to_seq
from ..utils.device import resolve_device
from ..utils.obs import (JsonlLogger, MetricsRegistry, StageProfile, Tracer,
                         WindowLedger)


INGEST_POLICIES = ("strict", "quarantine", "off")
LADDER_MODES = ("fused", "split")
FAILOVER_BACKENDS = ("auto", "native", "cpu")


#: ladder calls that may stay in flight, as a multiple of ``max_inflight``,
#: while the audit worker's rows for the oldest are not back
AUDIT_LAG = 4


@dataclass
class PipelineConfig:
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    batch_size: int = 2048       # windows per ladder call
    depth: int = 32              # D: segments per window row (depth cap)
    seg_len: int = 64            # L: bases per segment
    max_kmers: int = 64          # tier-0 top-M active set
    rescue_max_kmers: int = 256  # active set of the min_count <= 1 tiers
    overflow_rescue: bool = False    # re-solve top-M-capped windows at
                                 # rescue_max_kmers
    profile_sample_piles: int = 4    # piles (strided across the range) of
                                 # the profile pass
    profile_sample_offset: int = 0   # pile-index shift of that stride;
                                 # distinct offsets draw disjoint samples
                                 # (tools/profilevar.py)
    device: str = "cuda"         # "cuda" or "cpu"; no silent fallback
    max_inflight: int = 8        # ladder calls in flight: the deque fills to
                                 # this depth, then drains half of it
                                 # (1 = solve each batch on the pipeline's
                                 # thread)
    depth_buckets: tuple = (8, 16)   # dense sub-depth buckets below ``depth``;
                                 # () = one bucket
    seg_len_buckets: tuple = ()  # dense sub-length buckets below ``seg_len``
    paged: str = "off"           # "on" | "off" | "auto" (on for cuda, off
                                 # for cpu): ship batches as page pool +
                                 # page table (kernels/paging.py)
    page_len: int = 16           # paged page length; must divide seg_len
    paged_families: int = 4      # most shape families the router derives
    bucket_flush_reads: int = 128    # flush a partial bucket once its oldest
                                 # row has waited this many reads
    ladder_mode: str = "fused"   # "fused": one ladder call solves a batch
                                 # whole; "split": the two-stream ladder,
                                 # Stream A calls run tier 0 alone, the rows
                                 # the fused ladder would rescue (tier-0
                                 # failures, top-M capped rows with the
                                 # overflow rescue) pool on the host per
                                 # bucket and flush as dense whole-ladder
                                 # Stream B batches. Byte-identical to fused
                                 # (windows solve independently)
    rescue_flush_reads: int = 128    # split: flush a partial rescue pool
                                 # once its oldest row has waited this many
                                 # reads (bounds the emission lag a pooled
                                 # window adds)
    dp_route: str = "fused"      # heaviest-path route: "fused" (DP +
                                 # backtrack kernel) or "scan" (DP kernel,
                                 # torch backtrack); bit-identical
    use_native: bool = True      # window piles in the host library; False:
                                 # the numpy feeder (same bytes, slower)
    feeder_threads: int = 0      # piles windowed by this many threads ahead
                                 # of the batching loop (0 = in the loop);
                                 # the library releases the GIL. Needs
                                 # use_native
    depth_rank: bool = True      # best-ranked overlaps fill the depth slots
    skip_shallow: bool = True    # windows with fewer than min_depth segments
                                 # stay on the host, unsolved; False sends
                                 # them to the ladder, which marks them
                                 # unsolved (the same FASTA)
    qv_track: str | None = "inqual"  # intrinsic-QV track whose B-read tile
                                 # QVs join the depth-ranking score (absent
                                 # track: trace-diff rate only)
    end_trim: bool = True        # rescue-tier-solved read ends count as
                                 # unsolved
    ingest_policy: str = "strict"    # "strict" | "quarantine" | "off"
                                 # (formats/ingest.py)
    quarantine_path: str | None = None   # jsonl sidecar, one row per
                                 # contained pile (created only when one is)
    max_pile_overlaps: int = 100_000     # monster-pile guard: a pile of more
                                 # overlaps is contained (read emitted
                                 # uncorrected) before it is windowed;
                                 # 0 = off
    supervise: bool = True       # wrap every ladder dispatch and fetch in
                                 # the device supervisor
                                 # (runtime/supervisor.py): deadlines,
                                 # retries, the governor, failover, the
                                 # shadow audit
    events_path: str | None = None   # supervisor/event jsonl; None = share
                                 # log_path's logger
    log_path: str | None = None  # jsonl event log ('-' = stderr)
    ledger_path: str | None = None   # per-window outcome ledger jsonl
    metrics_snapshot_s: float = 30.0  # cadence of the periodic ``metrics``
                                 # and ``stage.profile`` events (rates, pad
                                 # waste, RSS, device peak memory, the
                                 # saturation gauges); 0 = off (the
                                 # end-of-run rollup still lands)
    failover_backend: str = "auto"   # degraded engine on declared device
                                 # loss: 'cpu' (the port's own ladder on
                                 # the CPU, byte-exact with the card: W in
                                 # one order on both), 'native' (the host
                                 # library's ladder), 'auto' = cpu for a
                                 # cpu primary, native on cuda
    failback: bool = False       # a background re-probe may route
                                 # dispatches back to a revived card
    audit_rate: float | None = None  # shadow audit: the fraction of each
                                 # fetched batch's windows solved again on
                                 # the CPU ladder and compared byte for
                                 # byte. None = env DACCORD_AUDIT_RATE
                                 # (default 1/64); 0 = off. A divergence
                                 # re-solves the whole batch on that
                                 # reference, so the rate never changes
                                 # output bytes
    audit_worker: bool | None = None   # solve the audit's samples in
                                 # worker processes (audit/worker.py: the
                                 # CPU ladder in numpy), sent at dispatch
                                 # and compared at fetch; None = on cuda
                                 # only (on the CPU no card waits on the
                                 # pipeline's thread)
    native_threads: int = 0      # threads of the native engine and of the
                                 # host library's hp pass (0 = every usable
                                 # CPU)
    native_solver: bool = False  # solve every batch with the host library's
                                 # tier ladder (the native failover engine)
                                 # instead of the device ladder: no card,
                                 # dense fused batches; max_kmers=0 is the
                                 # full graph
    hp_native: bool = True       # the homopolymer rescue in the host library
                                 # (hp_rescue_windows; inside the engine with
                                 # native_solver); False = the python
                                 # hp_candidate loop (the same bytes)
    mesh: int = 0                # shard each batch over N mesh members
                                 # (parallel/mesh.py): the cards
                                 # parallel.mesh.visible_devices lists on
                                 # cuda (fewer refuses the run), N members
                                 # on the CPU; every member runs the whole
                                 # ladder on its row slice. Supervised,
                                 # device loss shrinks the mesh N -> N/2
                                 # before any failover. 0 or 1 = one device
    job_tag: str | None = None   # the serve plane's job tag: stamped on every
                                 # dispatched batch (WindowBatch.job) and
                                 # every ledger row, so a merged trace
                                 # attributes batches to jobs; None (batch
                                 # runs) leaves both as they were


@dataclass
class PipelineStats:
    n_reads: int = 0
    n_windows: int = 0
    n_solved: int = 0
    n_skipped_shallow: int = 0
    n_topm_overflow: int = 0
    n_end_trimmed: int = 0
    n_hp_rescued: int = 0        # windows the homopolymer rescue replaced
    hp_wall_s: float = 0.0       # host wall of the hp pass after fetches
                                 # (0 with the native engine, whose solve
                                 # call holds it)
    n_fragments: int = 0
    n_batches: int = 0
    n_quarantined: int = 0       # piles contained (their reads emitted
                                 # uncorrected), monster piles included
    n_ingest_issues: int = 0     # integrity violations the scan found
    n_monster_piles: int = 0     # piles contained by the monster guard
    bases_in: int = 0
    bases_out: int = 0
    tier_histogram: dict = field(default_factory=dict)
    batches_by_bucket: dict = field(default_factory=dict)  # bucket shape ->
                                 # ladder calls
    paged: bool = False          # batches shipped as page pool + table
    native_host: bool = False    # piles windowed by the host library
    qv_ranked: bool = False      # a QV track joined the depth ranking
    pad_cells: int = 0           # payload cells shipped: dense seqs, or the
    used_cells: int = 0          # paged pool; used = real bases
    h2d_bytes: int = 0           # bytes of the arrays handed to the ladder
                                 # (copied host -> device on cuda)
    peak_inflight: int = 0       # most ladder calls queued at once
    graph_capture_s: float = 0.0  # wall of this run's CUDA graph captures
                                 # (kernels/graphs.py; 0 on the CPU and on a
                                 # rerun in the process, whose graphs exist)
    graphs: int = 0              # graphs this run captured
    graph_replays: int = 0       # graph replays of this run's ladder calls
    # two-stream ladder accounting. rescue_slots_executed counts the rescue
    # slots the ladder ran: fused, the width picked for a batch's rescue
    # candidates (kernels/graphs.py pick_width; from its final rows, so a
    # tier-0 failure the wide rescue solved is missed); split, the padded
    # width of each Stream B batch
    n_rescue_windows: int = 0    # windows that went through a rescue stage
    rescue_slots_executed: int = 0
    n_dispatch_tier0: int = 0    # Stream A ladder calls (split)
    n_dispatch_rescue: int = 0   # Stream B ladder calls (split)
    rescue_dispatches: list = field(default_factory=list)  # split: one
                                 # {rows, slots, reason} per Stream B call
                                 # (reason: full | lag | final | pressure)
    ingest_s: float = 0.0        # the ingest scan (host)
    profile_s: float = 0.0       # profile pass and paged family sample (host)
    windowing_s: float = 0.0     # wall the pile loop blocked on the
                                 # feeder; with feeder threads, less than
                                 # the feeder's CPU time, which they spend
                                 # ahead of the loop
    ladder_s: float = 0.0        # wall of the ladder dispatches: with the
                                 # dispatcher (max_inflight > 1) the enqueue
                                 # only; at max_inflight=1 the whole ladder
                                 # call, device results on the host
    device_s: float = 0.0        # wall the host blocked in fetch, waiting
                                 # for in-flight ladder calls
    solve_s: float = 0.0         # wall of the ladder calls themselves, on
                                 # the thread that ran them (the
                                 # dispatcher's, or the pipeline's at
                                 # max_inflight=1)
    solve_cpu_s: float = 0.0     # that thread's CPU time in those calls
                                 # (solve_s less it: waits for the card
                                 # and for the interpreter lock)
    stage_profile: dict = field(default_factory=dict)  # StageProfile.summary()
                                 # of the feeder stages
    degraded: bool = False       # the supervisor failed over mid-run (the
                                 # run completed on the fallback engine)
    fallback_reason: str | None = None
    n_capacity_events: int = 0   # capacity-classified ladder ops (governor
                                 # ladder engagements)
    n_backpressure: int = 0      # host-memory watermark force-flushes
    batch_effective: int | None = None   # the smallest ratcheted width when
                                 # the governor engaged, else batch_size
                                 # (None = unsupervised run)
    governor_ratchet: dict = field(default_factory=dict)  # shape key ->
                                 # ratcheted width, entries of this run
    audit_s: float = 0.0         # host wall of the shadow audit on the
                                 # pipeline's thread: its own solves
                                 # without the worker; with it the sends,
                                 # the wait for its rows not yet back and
                                 # the compares
    audit_worker_s: float = 0.0  # the audit workers' own solve wall (their
                                 # processes; not on the pipeline's thread)
    audit_warm_s: float = 0.0    # wall of the in-process reference's
                                 # first solve at each shape (not in
                                 # audit_s)
    audit_local: int = 0         # batches audited on the pipeline's thread
                                 # (with no worker)
    audit_worker_start: dict = field(default_factory=dict)  # the slowest
                                 # worker's start walls (boot_s: the
                                 # interpreter, import_s: numpy and its
                                 # ladder), paid by the process's first
                                 # audited run; empty if they never got
                                 # ready
    audit_disabled: str | None = None   # why the audit stopped mid-run
                                 # (``audit.disabled``), else None
    audit_drain_s: float = 0.0   # the part of audit_s spent in the final
                                 # drain (the wait for the last verdicts)
    audit_send_s: float = 0.0    # the part of audit_s spent in the sends at
                                 # dispatch (sample, rows, queue)
    audit_send_cpu_s: float = 0.0  # the pipeline thread's CPU time in those
                                 # sends: audit_send_s less it is waiting
                                 # (for the interpreter lock above all)
    audit_take_s: float = 0.0    # of audit_send_s, taking the sampled rows
                                 # (a paged batch's table rows and the pages
                                 # they name; the workers unpack them)
    audit_take_cpu_s: float = 0.0  # the pipeline thread's CPU time in the take
    audit_tail: dict = field(default_factory=dict)  # with the workers: their
                                 # backlog when the final flush began and
                                 # each later part's send-to-solved seconds
                                 # (AuditWorker.anatomy)
    sup_counters: dict = field(default_factory=dict)  # the supervisor's
                                 # counters (dispatch, fetch, retries,
                                 # timeouts, probes, degraded_solves,
                                 # audits, sdc_detected, ...)
    wall_s: float = 0.0
    host_s: float = 0.0          # wall_s less device_s
    # the saturation profiler. feeder_s = the wall the pile loop blocked on
    # the feeder (windowing_s, with an injected stall); dispatch_s = the
    # wall inside ladder dispatches (ladder_s: the enqueue with the
    # dispatcher, the whole call at max_inflight=1 and on the native
    # engine); verdict/bottleneck = obs.bottleneck_verdict of the run,
    # stamped into shard_done, the metrics rollup and its .prom
    feeder_s: float = 0.0
    dispatch_s: float = 0.0
    dispatch_walls: dict | None = None   # a mesh run's staged dispatch walls
                                 # (pack_s, stage_s, launch_s, their sum
                                 # dispatch_s, restaged); None on one device
    mesh_health: dict | None = None  # a mesh run's final health map
                                 # (ShardedLadderSolver.health_map: per
                                 # member state, rows, busy/idle/overlap
                                 # fractions, kernel launches); None on one
                                 # device
    verdict: str = "balanced"
    bottleneck: dict = field(default_factory=dict)
    metrics: dict = field(default_factory=dict)  # the end-of-run
                                 # MetricsRegistry rollup (launch.run_shard
                                 # commits it beside the shard manifest)

    @property
    def pad_waste(self) -> float:
        return 1.0 - self.used_cells / self.pad_cells if self.pad_cells else 0.0

    @property
    def rescue_density(self) -> float:
        """Rescue windows per rescue slot the ladder ran (1.0: every slot of
        the M=256 tier held a real window)."""
        return (self.n_rescue_windows / self.rescue_slots_executed
                if self.rescue_slots_executed else 0.0)

    def bases_per_sec(self) -> float:
        return self.bases_out / self.wall_s if self.wall_s else 0.0

    def windows_per_sec(self) -> float:
        return self.n_windows / self.wall_s if self.wall_s else 0.0




class QvRanker:
    """Per-overlap B-read quality from an intrinsic-QV track.

    The track holds one QV byte per tspace tile per read; :meth:`rates`
    averages each B read's tiles under its aligned interval and returns
    error-rate units (QV / QV_SCALE), NaN when no covered tile has coverage.
    The per-read prefix sums are one global cumsum built here, differenced
    inside each read's tile span, so ranking a pile is vectorized numpy
    (it runs in the feeder threads, which only read this state).
    """

    def __init__(self, qv_payloads: list, tspace: int, db: DazzDB):
        self.tspace = tspace
        nt = np.fromiter((len(p) for p in qv_payloads), np.int64,
                         len(qv_payloads))
        self.tile_base = np.zeros(len(nt) + 1, np.int64)
        np.cumsum(nt, out=self.tile_base[1:])
        flat = (np.concatenate(qv_payloads) if len(qv_payloads)
                else np.zeros(0, np.uint8))
        valid = flat != QV_NOCOV
        self.cv = np.zeros(len(flat) + 1, np.float64)
        np.cumsum(np.where(valid, flat, 0), out=self.cv[1:])
        self.cc = np.zeros(len(flat) + 1, np.int64)
        np.cumsum(valid, out=self.cc[1:])
        self.rlens = np.fromiter((db.read_length(i)
                                  for i in range(len(qv_payloads))),
                                 np.int64, len(qv_payloads))

    def rates(self, bread, bbpos, bepos, comp) -> np.ndarray:
        """Per-overlap mean QV rate; NaN = no QV information."""
        bread = np.asarray(bread, np.int64)
        bb = np.asarray(bbpos, np.int64)
        be = np.asarray(bepos, np.int64)
        comp = np.asarray(comp).astype(bool)
        inb = (bread >= 0) & (bread < len(self.rlens))
        br = np.where(inb, bread, 0)
        blen = self.rlens[br]
        # LAS B coordinates of complemented overlaps live in complement
        # space; the track indexes forward-strand tiles
        fb = np.where(comp, blen - be, bb)
        fe = np.where(comp, blen - bb, be)
        nt = self.tile_base[br + 1] - self.tile_base[br]
        g0 = np.maximum(fb // self.tspace, 0)
        g1 = np.minimum((np.maximum(fe, fb + 1) - 1) // self.tspace, nt - 1)
        ok = inb & (nt > 0) & (g1 >= g0)
        lo = np.where(ok, self.tile_base[br] + g0, 0)
        hi = np.where(ok, self.tile_base[br] + g1 + 1, 0)
        cnt = self.cc[hi] - self.cc[lo]
        sums = self.cv[hi] - self.cv[lo]
        return np.where(ok & (cnt > 0),
                        sums / np.maximum(cnt, 1) / QV_SCALE, np.nan)


#: weight of the B read's intrinsic QV rate in the depth-ranking score. The
#: pair trace rate already holds B's errors, and it alone separates
#: alignments across repeat copies, so the QV term enters small: enough to
#: sink intrinsically noisy B reads without diluting the pair signal.
QV_RANK_WEIGHT = 0.25


def _rank_scores(diffs: np.ndarray, spans: np.ndarray,
                 bq: np.ndarray | None) -> np.ndarray:
    """Depth-ranking score per overlap (lower ranks first): the pair
    trace-diff rate plus, when a QV track is loaded, the down-weighted
    intrinsic error rate of the B read. Overlaps whose B tiles have no QV
    coverage take the pile median, so unknown quality ranks neutral, not
    best. One function for both feeders, whose orders must agree."""
    score = diffs.astype(np.float64) / spans
    if bq is not None:
        valid = ~np.isnan(bq)
        fill = float(np.median(bq[valid])) if valid.any() else 0.0
        score = score + QV_RANK_WEIGHT * np.where(valid, bq, fill)
    return score


def _depth_order(diffs, abpos, aepos, bread, bbpos, bepos, comp,
                 qvr: QvRanker | None) -> np.ndarray:
    """The pile's overlaps best first (lowest :func:`_rank_scores`, stable),
    so the best alignments fill the depth slots: one rule for both feeders."""
    span = np.maximum(np.asarray(aepos) - np.asarray(abpos), 1)
    bq = None if qvr is None else qvr.rates(bread, bbpos, bepos, comp)
    return np.argsort(_rank_scores(np.asarray(diffs), span, bq), kind="stable")


def load_qv_ranker(db: DazzDB, las: LasFile, cfg: PipelineConfig) -> QvRanker | None:
    """The run's QV ranker, or None when ranking or the track is off, the
    track is absent, or its tile geometry does not match this LAS's tspace
    (a track written under another tspace would map the wrong tiles)."""
    if not cfg.qv_track or not cfg.depth_rank:
        return None
    try:
        payloads = read_track(db.path, cfg.qv_track)
    except FileNotFoundError:
        return None
    tspace = las.tspace
    if any(len(p) != (db.read_length(i) + tspace - 1) // tspace
           for i, p in enumerate(payloads)):
        return None
    return QvRanker(payloads, tspace, db)


def _stride_take(n_items: int, n: int, offset: int = 0) -> np.ndarray:
    """Indices of ``n`` items spread evenly across ``n_items``."""
    if n_items == 0 or n == 0:
        return np.zeros(0, np.int64)
    return np.unique((np.linspace(0, n_items - 1, min(n, n_items)).astype(int)
                      + offset) % n_items)


def _strided_pile_ranges(las: LasFile, n: int, start: int | None = None,
                         end: int | None = None, offset: int = 0) -> list[tuple[int, int]]:
    """Byte ranges of ``n`` piles spread evenly across ``[start, end)``
    (default: the whole file), from the aread index sidecar, the stride
    shifted by ``offset`` piles."""
    idx = index_las(las.path)
    lo = start if start is not None else _HDR_SIZE
    hi = end if end is not None else aio.getsize(las.path)
    if len(idx) == 0:
        return [(lo, hi)]
    sel = np.nonzero((idx[:, 1] >= lo) & (idx[:, 1] < hi))[0]
    if len(sel) == 0:
        return [(lo, hi)]
    out = []
    for t in _stride_take(len(sel), n, offset):
        j = int(sel[t])
        s = int(idx[j, 1])
        e = int(idx[j + 1, 1]) if j + 1 < len(idx) else hi
        out.append((s, min(e, hi)))
    return out


def _sample_windows(db: DazzDB, las: LasFile, cfg: PipelineConfig,
                    start: int | None = None, end: int | None = None,
                    pile_ranges: list | None = None):
    """The one strided pile sample (refined overlaps and cut windows of
    ``cfg.profile_sample_piles`` piles, one per strided range), shared by the
    profile pass and the paged family derivation. ``pile_ranges`` (the ingest
    scan's clean piles, under the quarantine policy) replaces the index
    stride, so the sample never decodes a corrupt pile."""
    off = cfg.profile_sample_offset
    if pile_ranges is not None:
        ranges = [pile_ranges[int(t)]
                  for t in _stride_take(len(pile_ranges), cfg.profile_sample_piles, off)]
    else:
        ranges = _strided_pile_ranges(las, cfg.profile_sample_piles, start, end, off)
    refined_all, windows_all = [], []
    for s, e in ranges:
        for aread, pile in las.iter_piles(s, e):
            a_bases = db.read_bases(aread)
            refined = [refine_overlap(o, a_bases, db.read_bases(o.bread), las.tspace)
                       for o in pile]
            refined_all.extend(refined)
            windows_all.extend(cut_windows(a_bases, refined, w=cfg.consensus.w,
                                           adv=cfg.consensus.adv))
            break   # one pile per strided range
    return refined_all, windows_all


def estimate_profile_for_shard(db: DazzDB, las: LasFile, cfg: PipelineConfig,
                               start: int | None = None, end: int | None = None,
                               pile_ranges: list | None = None,
                               return_windows: bool = False):
    """Profile pass over the strided pile sample of ``[start, end)``.
    ``return_windows`` also returns the sampled windows, so a paged run
    derives its shape families from the same sample instead of sampling
    twice."""
    refined_all, windows_all = _sample_windows(db, las, cfg, start, end, pile_ranges)
    prof = estimate_profile_two_pass(refined_all, windows_all, cfg.consensus,
                                     sample=32)
    return (prof, windows_all) if return_windows else prof


def families_from_windows(windows: list, cfg: PipelineConfig) -> list:
    """Shape families for the paged router from a window sample (its
    length x depth histogram). The sample only shifts family budgets, never
    correctness: the full-coverage family routes any window the sample did
    not predict."""
    shape = BatchShape(depth=cfg.depth, seg_len=cfg.seg_len, wlen=cfg.consensus.w)
    if windows:
        b = tensorize_windows([(0, ws) for ws in windows], shape)
        ns = b.nsegs
        pg = paging.window_pages(b.lens, cfg.page_len)
    else:
        ns = pg = np.zeros(0, np.int64)
    return paging.derive_families(
        ns, pg, max_depth=cfg.depth,
        max_pages=-(-cfg.depth * cfg.seg_len // cfg.page_len),
        budget=cfg.paged_families, page_len=cfg.page_len)


def derive_families_for_shard(db: DazzDB, las: LasFile, cfg: PipelineConfig,
                              start: int | None = None, end: int | None = None,
                              pile_ranges: list | None = None) -> list:
    """:func:`families_from_windows` over a fresh pile sample, for a run whose
    profile was passed in (no profile-pass sample to reuse)."""
    _, windows_all = _sample_windows(db, las, cfg, start, end, pile_ranges)
    return families_from_windows(windows_all, cfg)


def run_families(db: DazzDB, las: LasFile, cfg: PipelineConfig,
                 sample: list | None = None, start: int | None = None,
                 end: int | None = None, pile_ranges: list | None = None) -> list:
    """The shape families a paged run routes to: derived from the profile
    pass's ``sample`` when there is one (else from a fresh sample), each
    pool budget raised where needed so that one ``batch_size``-row pool
    holds at least one worst-case window of its family (or the router's
    budget cut could never make progress)."""
    fams = (families_from_windows(sample, cfg) if sample is not None
            else derive_families_for_shard(db, las, cfg, start, end, pile_ranges))
    B = cfg.batch_size
    return [f if B * f.budget >= f.pages else
            paging.ShapeFamily(depth=f.depth, pages=f.pages, page_len=f.page_len,
                               pool_pages=-(-f.pages // B))
            for f in fams]


def paged_enabled(cfg: PipelineConfig, device) -> bool:
    """Whether a run ships paged batches: ``on``, or ``auto`` on cuda."""
    if cfg.paged not in ("on", "off", "auto"):
        raise ValueError(f"paged={cfg.paged!r}: expected on|off|auto")
    on = cfg.paged == "on" or (cfg.paged == "auto" and device.type == "cuda")
    if on and (cfg.page_len <= 0 or cfg.seg_len % cfg.page_len):
        raise ValueError(f"page_len {cfg.page_len} must be positive and divide "
                         f"seg_len {cfg.seg_len}")
    return on


def dense_buckets(cfg: PipelineConfig) -> list[tuple[int, int]]:
    """The dense (D, L) buckets: every depth of ``depth_buckets`` below
    ``depth`` plus ``depth``, times every length of ``seg_len_buckets``
    below ``seg_len`` plus ``seg_len``; depth-major."""
    D, L = cfg.depth, cfg.seg_len
    d_b = sorted({b for b in cfg.depth_buckets if 0 < b < D} | {D})
    l_b = sorted({b for b in cfg.seg_len_buckets if 0 < b < L} | {L})
    return [(d, ln) for d in d_b for ln in l_b]


def route_dense(buckets: list[tuple[int, int]], nsegs: np.ndarray,
                lens: np.ndarray) -> np.ndarray:
    """Index of the smallest bucket that holds each window: the smallest
    depth at or above its segment count, then the smallest length at or
    above its longest segment."""
    d_arr = np.asarray(sorted({d for d, _ in buckets}))
    l_arr = np.asarray(sorted({ln for _, ln in buckets}))
    assign = np.searchsorted(d_arr, nsegs, side="left")
    if len(l_arr) > 1:
        assign = assign * len(l_arr) + np.searchsorted(l_arr, lens.max(axis=1),
                                                        side="left")
    return assign


def _window_one_pile(db: DazzDB, col: ColumnarLas, cfg: PipelineConfig,
                     aread: int, s: int, e: int, qvr: QvRanker | None,
                     prof: StageProfile | None = None):
    """Window one pile (records ``s:e`` of ``col``) through the host library;
    the one body of the synchronous and the threaded native feeder, so they
    write the same bytes. Runs in the feeder threads. ``prof`` books the
    stage walls: ``decode`` (2-bit decodes), ``rank`` (depth ranking) and
    ``realign`` (the library call, which also cuts and packs the windows)."""
    t0 = time.perf_counter()
    a = db.read_bases(aread)
    t1 = time.perf_counter()
    order = None
    if cfg.depth_rank:
        order = _depth_order(col.diffs[s:e], col.abpos[s:e], col.aepos[s:e],
                             col.bread[s:e], col.bbpos[s:e], col.bepos[s:e],
                             col.comp[s:e], qvr)
    t2 = time.perf_counter()
    idxs = np.arange(s, e) if order is None else s + order
    b_reads = db.read_bases_batch(col.bread[idxs])
    t3 = time.perf_counter()
    seqs, lens, nsegs = process_pile_native(a, col, s, e, b_reads, cfg.consensus.w,
                                            cfg.consensus.adv, cfg.depth,
                                            cfg.seg_len, order=order)
    if prof is not None:
        prof.add("decode", (t1 - t0) + (t3 - t2))
        prof.add("rank", t2 - t1)
        prof.add("realign", time.perf_counter() - t3)
    return aread, a, seqs, lens, nsegs


def _monster_marker(aread: int, n_overlaps: int) -> tuple:
    """Quarantine marker for a pile over the overlap budget: it rides the
    ingest containment path (read emitted uncorrected, sidecar row,
    ``n_quarantined``)."""
    return ("quarantine", int(aread), -1, "monster_pile",
            f"pile busts the capacity budget ({n_overlaps} overlaps)")


def _load_columns(las: LasFile, start, end, prof: StageProfile | None) -> ColumnarLas:
    t0 = time.perf_counter()
    col = ColumnarLas(las.path, start, end)
    if prof is not None:
        prof.add("decode", time.perf_counter() - t0)   # the columnar parse
    return col


def iter_pile_blocks(db: DazzDB, las: LasFile, cfg: PipelineConfig,
                     qvr: QvRanker | None = None, *, start: int | None = None,
                     end: int | None = None, monster=None,
                     prof: StageProfile | None = None):
    """Yield (aread, a_bases, seqs [nwin,D,L], lens [nwin,D], nsegs [nwin])
    per pile of ``[start, end)``, windowed on the host: by the host library
    (``use_native``), else by the numpy feeder. Both write the same bytes.
    ``monster(aread, n_overlaps) -> bool`` is asked before each pile is
    windowed; a pile it refuses yields a :func:`_monster_marker` instead."""
    if cfg.use_native:
        col = _load_columns(las, start, end, prof)
        for aread, s, e in col.piles():
            if monster is not None and monster(aread, e - s):
                yield _monster_marker(aread, e - s)
                continue
            yield _window_one_pile(db, col, cfg, aread, s, e, qvr, prof)
        return
    w, adv = cfg.consensus.w, cfg.consensus.adv
    shape = BatchShape(depth=cfg.depth, seg_len=cfg.seg_len, wlen=w)
    it = las.iter_piles(start, end)
    while True:
        t0 = time.perf_counter()
        nxt = next(it, None)
        if nxt is None:
            return
        aread, pile = nxt
        if prof is not None:
            prof.add("decode", time.perf_counter() - t0)   # the LAS record walk
        if monster is not None and monster(aread, len(pile)):
            yield _monster_marker(aread, len(pile))
            continue
        t0 = time.perf_counter()
        a = db.read_bases(aread)
        t1 = time.perf_counter()
        if cfg.depth_rank and pile:
            cols = [[getattr(o, f) for o in pile] for f in (
                "diffs", "abpos", "aepos", "bread", "bbpos", "bepos", "is_comp")]
            pile = [pile[i] for i in _depth_order(*cols, qvr)]
        t2 = time.perf_counter()
        refined, b_dec = [], 0.0
        for o in pile:
            td = time.perf_counter()
            b = db.read_bases(o.bread)
            b_dec += time.perf_counter() - td
            refined.append(refine_overlap(o, a, b, las.tspace))
        t3 = time.perf_counter()
        windows = cut_windows(a, refined, w=w, adv=adv)
        t4 = time.perf_counter()
        b = tensorize_windows([(aread, ws) for ws in windows], shape)
        if prof is not None:
            prof.add("decode", (t1 - t0) + b_dec)
            prof.add("rank", t2 - t1)
            prof.add("realign", (t3 - t2) - b_dec)
            prof.add("kmer", t4 - t3)
            prof.add("tensorize", time.perf_counter() - t4)
        yield aread, a, b.seqs, b.lens, b.nsegs


class _Ready:
    """A resolved stand-in for a Future: monster-pile markers interleave
    with the windowing jobs in input order."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def result(self):
        return self.v


def iter_pile_blocks_threaded(db: DazzDB, las: LasFile, cfg: PipelineConfig,
                              nthreads: int, qvr: QvRanker | None = None, *,
                              start: int | None = None, end: int | None = None,
                              monster=None, prof: StageProfile | None = None):
    """The native stream of :func:`iter_pile_blocks`, windowed by
    ``nthreads`` threads with a bounded in-order prefetch of ``nthreads + 2``
    piles: the same blocks in the same order, so every downstream byte is
    the same; only the wall changes. The monster guard runs in the ordered
    submission loop; ``prof`` stage walls sum across the threads."""
    col = _load_columns(las, start, end, prof)
    piles = iter(col.piles())
    with ThreadPoolExecutor(max_workers=nthreads) as ex:
        def submit(aread, s, e):
            if monster is not None and monster(aread, e - s):
                return _Ready(_monster_marker(aread, e - s))
            return ex.submit(_window_one_pile, db, col, cfg, aread, s, e, qvr, prof)

        inflight: deque = deque()
        for item in piles:
            inflight.append(submit(*item))
            if len(inflight) >= nthreads + 2:
                break
        while inflight:
            yield inflight.popleft().result()
            for item in piles:
                inflight.append(submit(*item))
                break


class _PendingRead:
    """One read's bases (``patch`` mode stitches them into unsolved windows)
    and its window results as arrays, filled batch by batch: the consensus
    rows, their lengths, whether each window solved and by which tier (-1:
    unsolved)."""

    __slots__ = ("aread", "a_bases", "n_windows", "n_done", "cons", "cons_len",
                 "solved", "tiers")

    def __init__(self, aread: int, a_bases: np.ndarray, n_windows: int):
        self.aread = aread
        self.a_bases = a_bases
        self.n_windows = n_windows
        self.n_done = 0
        self.cons: np.ndarray | None = None     # [n, CL] int8, at the first scatter
        self.cons_len = np.zeros(n_windows, dtype=np.int32)
        self.solved = np.zeros(n_windows, dtype=bool)
        self.tiers = np.full(n_windows, -1, dtype=np.int32)

    def results(self, w: int, adv: int) -> list:
        """(wstart, wlen, consensus or None) of every window, in order."""
        return [(j * adv, w, self.cons[j, :self.cons_len[j]] if ok else None)
                for j, ok in enumerate(self.solved.tolist())]


def _trim_rescue_ends(pr: _PendingRead, rescue_tiers: set, stats: PipelineStats) -> None:
    """Unsolve the prefix and suffix runs of rescue-tier-solved windows (the
    end-trim of the module docstring): each sweep skips over unsolved
    windows and stops at the first window a confident tier solved."""
    confident = pr.solved & ~np.isin(pr.tiers, list(rescue_tiers))
    if confident.any():
        first = int(np.argmax(confident))
        last = pr.n_windows - 1 - int(np.argmax(confident[::-1]))
        trim = np.zeros(pr.n_windows, dtype=bool)
        trim[:first] = True
        trim[last + 1:] = True
        trim &= pr.solved
    else:
        trim = pr.solved.copy()
    n = int(trim.sum())
    if not n:
        return
    for t, c in zip(*np.unique(pr.tiers[trim], return_counts=True)):
        stats.tier_histogram[int(t)] = stats.tier_histogram.get(int(t), 0) - int(c)
    pr.solved[trim] = False
    stats.n_solved -= n
    stats.n_end_trimmed += n


class _RowBuffer:
    """The rows of one bucket waiting for a batch (or for a Stream B batch):
    blocks of (seqs, lens, nsegs, rid, widx, pages), their count and pages,
    and the read count when the oldest of them came."""

    __slots__ = ("blocks", "nrows", "npages", "first_seen")

    def __init__(self):
        self.blocks: list[tuple] = []
        self.nrows = 0
        self.npages = 0
        self.first_seen: int | None = None

    def push(self, cols: tuple, n_reads: int) -> None:
        self.blocks.append(cols)
        self.nrows += len(cols[2])
        self.npages += int(cols[5].sum())
        if self.first_seen is None:
            self.first_seen = n_reads

    def pop(self, take: int) -> list[np.ndarray]:
        """The first ``take`` rows; the rest stay and keep the oldest row's
        stamp."""
        cat = [np.concatenate([blk[i] for blk in self.blocks]) for i in range(6)]
        self.blocks = [tuple(a[take:] for a in cat)] if self.nrows > take else []
        self.nrows -= take
        if not self.nrows:
            self.first_seen = None
        rows = [a[:take] for a in cat]
        self.npages -= int(rows[5].sum())
        return rows

    def fit(self, take: int, cap_pages: int) -> int:
        """The largest prefix of at most ``take`` rows (never zero) whose
        pages fit ``cap_pages``."""
        pages = np.concatenate([blk[5] for blk in self.blocks])[:take]
        fit = int(np.searchsorted(np.cumsum(pages), cap_pages, side="right"))
        return max(min(take, fit), 1)

    def full(self, B: int, cap_pages: int | None) -> bool:
        """A whole batch of rows, or (paged) a whole pool of pages."""
        return self.nrows >= B or (cap_pages is not None and self.npages >= cap_pages)

    def stale(self, n_reads: int, limit: int) -> bool:
        return self.first_seen is not None and n_reads - self.first_seen >= limit


class _Stager:
    """The double-buffered staging of a mesh run's batches: one daemon
    thread runs the host half of each dispatch (``ShardedLadderSolver.stage``:
    the pad to a mesh multiple, the row slices and, on cuda, each slice's
    copy on its member's copy stream) while earlier calls solve; the
    pipeline's thread launches finished stages. Depth 2: one batch staging
    and at most one waiting; :meth:`submit` blocks beyond that, so the
    feeder cannot run ahead of the memory watermarks. A ticket keeps its
    host batch: a staging error dispatches that instead, and every replay
    of the supervisor uses it. The thread never logs (the events file has
    one writer, the pipeline's thread, which logs ``dispatch.stage`` when it
    launches the ticket)."""

    class _Ticket:
        __slots__ = ("batch", "meta", "staged", "error", "done")

        def __init__(self, batch, meta):
            self.batch = batch
            self.meta = meta
            self.staged = None
            self.error: BaseException | None = None
            self.done = threading.Event()

    def __init__(self, stage_fn, prof=None):
        self._stage_fn = stage_fn
        self._prof = prof
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mesh-stager")
        self._thread.start()

    def submit(self, batch, meta) -> "_Stager._Ticket":
        t = self._Ticket(batch, meta)
        self._q.put(t)
        return t

    def _loop(self) -> None:
        while True:
            t = self._q.get()
            if t is None:
                return
            try:
                t.staged = self._stage_fn(t.batch, prof=self._prof)
            except BaseException as e:  # noqa: BLE001 - the launch dispatches t.batch
                t.error = e
            finally:
                t.done.set()

    def stop(self) -> None:
        self._q.put(None)


def _check_config(cfg: PipelineConfig) -> None:
    if cfg.feeder_threads < 0 or (cfg.feeder_threads and not cfg.use_native):
        raise ValueError(f"feeder_threads={cfg.feeder_threads}: threads window "
                         "piles through the host library (use_native), 0 in the loop")
    if cfg.ladder_mode not in LADDER_MODES:
        raise ValueError(f"ladder_mode={cfg.ladder_mode!r}: expected "
                         + "|".join(LADDER_MODES))
    if cfg.rescue_flush_reads < 1:
        raise ValueError(f"rescue_flush_reads={cfg.rescue_flush_reads}: at least 1")
    if cfg.ingest_policy not in INGEST_POLICIES:
        raise ValueError(f"ingest_policy={cfg.ingest_policy!r}: expected "
                         + "|".join(INGEST_POLICIES))
    if cfg.max_inflight < 1:
        raise ValueError(f"max_inflight={cfg.max_inflight}: at least 1")
    if cfg.max_pile_overlaps < 0:
        raise ValueError(f"max_pile_overlaps={cfg.max_pile_overlaps}: 0 (off) "
                         "or a positive budget")
    if cfg.failover_backend not in FAILOVER_BACKENDS:
        raise ValueError(f"failover_backend={cfg.failover_backend!r}: expected "
                         + "|".join(FAILOVER_BACKENDS))


def _native_wide_rescue(wide, b, out: dict, nt: int) -> None:
    """The overflow rescue on the native engine, with the device ladder's
    semantics (``kernels/tiers.py ladder_core``): windows whose top-M cap
    bound re-solve at the rescue active-set size, and the wide result
    replaces the capped one wherever it solves."""
    idx = np.nonzero(out["m_ovf"])[0]
    sub = replace(b, seqs=b.seqs[idx], lens=b.lens[idx], nsegs=b.nsegs[idx],
                  read_ids=b.read_ids[idx], wstarts=b.wstarts[idx])
    res = wide.solve(sub, n_threads=nt)
    take = res["solved"]
    ti = idx[take]
    for key in ("cons", "cons_len", "err", "tier"):
        out[key][ti] = res[key][take]
    out["solved"][ti] = True
    out["m_ovf"][ti] = res["m_ovf"][take]


def _build_native_fallback(profile: ErrorProfile, cfg: PipelineConfig):
    """The supervisor's native failover engine: the host library's tier
    ladder at the run's top-M caps (``native/api.py NativeLadder``), which
    no CUDA fault can reach. It agrees with the card within ROADMAP's drift
    bound, not byte for byte (its DP sums in its own order)."""
    from ..native.api import NativeLadder
    from ..oracle.consensus import make_offset_likely

    nt = cfg.native_threads if cfg.native_threads > 0 else len(os.sched_getaffinity(0))
    nladder = NativeLadder(make_offset_likely(profile, cfg.consensus), cfg.consensus,
                           max_kmers=cfg.max_kmers,
                           rescue_max_kmers=cfg.rescue_max_kmers)
    wide = (nladder.with_caps(cfg.rescue_max_kmers, cfg.rescue_max_kmers)
            if cfg.overflow_rescue and 0 < cfg.max_kmers < cfg.rescue_max_kmers
            else None)

    def solve(b):
        out = nladder.solve(b, n_threads=nt)
        if wide is not None and out["m_ovf"].any():
            _native_wide_rescue(wide, b, out, nt)
        return out

    solve.__name__ = "native-ladder"
    # the native primary layers its in-engine hp rescue on this very
    # construction, so the primary and the failover never diverge
    solve.nladder, solve.nt = nladder, nt
    return solve


def _hp_pass(out: dict, seqs, lens, nsegs, cfg: PipelineConfig, hp_ols: dict,
             hp_nladder, nt: int) -> int:
    """The homopolymer rescue over one fetched batch's rows, in place: the
    rows that failed or solved with err above ``hp_err`` and hold a long run
    solve in run-length-compressed space, and an accepted candidate replaces
    the row (its consensus may be longer than the ladder's, so ``cons``
    widens to hold it), with tier ``HP_TIER``. ``seqs``/``lens``/``nsegs``
    are the rows as dispatched. Returns the rescued count."""
    from ..oracle.hp import HP_TIER, hp_candidate

    ccfg = cfg.consensus
    take = len(nsegs)
    if hp_nladder is not None:
        from types import SimpleNamespace

        sub = {"cons": np.array(out["cons"], dtype=np.int8),
               "cons_len": np.array(out["cons_len"], dtype=np.int32),
               "err": np.array(out["err"], dtype=np.float32),
               "tier": np.where(out["solved"], out["tier"], -1).astype(np.int32)}
        n = hp_nladder.hp_rescue(SimpleNamespace(seqs=seqs, lens=lens, nsegs=nsegs),
                                 sub, n_threads=nt)
        if n:
            hit = sub["tier"] == HP_TIER
            out.update(cons=sub["cons"], cons_len=sub["cons_len"], err=sub["err"],
                       tier=np.where(hit, HP_TIER, out["tier"]),
                       solved=np.asarray(out["solved"]) | hit)
        return n
    found = {}
    for i in range(take):
        nseg = int(nsegs[i])
        if nseg < ccfg.dbg.min_depth:
            continue
        solved = bool(out["solved"][i])
        derr = float(out["err"][i]) if solved else float("inf")
        if solved and derr <= ccfg.hp_err:
            continue
        dseq = (np.asarray(out["cons"][i][:out["cons_len"][i]], dtype=np.int8)
                if solved else None)
        segs = [np.asarray(seqs[i, d, :lens[i, d]], dtype=np.int8) for d in range(nseg)]
        res = hp_candidate(segs, dseq, derr, hp_ols, ccfg)
        if res is not None:
            found[i] = res
    if found:
        cons = np.asarray(out["cons"])
        width = max(cons.shape[1], max(len(r.seq) for r in found.values()))
        wide = np.full((take, width), 4, dtype=np.int8)
        wide[:, :cons.shape[1]] = cons
        cons_len = np.array(out["cons_len"], dtype=np.int32)
        err = np.array(out["err"], dtype=np.float32)
        tier = np.array(out["tier"], dtype=np.int32)
        solved = np.array(out["solved"], dtype=bool)
        for i, r in found.items():
            wide[i, :len(r.seq)] = r.seq
            cons_len[i] = len(r.seq)
            err[i] = r.err
            tier[i] = HP_TIER
            solved[i] = True
        out.update(cons=wide, cons_len=cons_len, err=err, tier=tier, solved=solved)
    return len(found)


class _Telemetry:
    """One run's telemetry: the buffered event and log writers, the span
    tracer, the per-window ledger, the metrics registry and the feeder's
    stage profile. Made before the run and closed in :func:`correct_shard`'s
    ``finally``, so an aborted run flushes its buffered tail, stops a
    profiler capture and closes every open span (the pairing
    ``tools/trace.py --check`` holds)."""

    def __init__(self, cfg: PipelineConfig, start, end):
        # file-backed streams buffer (their cost is on the pile loop); '-'
        # streams stay line-flushed, since stderr is watched live
        def _mk(path):
            kw = {"buffer_lines": 64, "flush_s": 2.0} if path and path != "-" else {}
            return JsonlLogger(path, **kw)

        self.log = _mk(cfg.log_path)
        self.ev_log = _mk(cfg.events_path) if cfg.events_path else self.log
        # the stream boundary first: a resumed shard appends to the same file
        # with a fresh relative clock, and eventcheck --strict resets there
        self.ev_log.log("shard_start", start=int(start or 0),
                        end=int(-1 if end is None else end), pid=os.getpid())
        self.tracer = Tracer(self.ev_log)
        self.ledger = WindowLedger(cfg.ledger_path) if cfg.ledger_path else None
        self.metrics = MetricsRegistry()
        self.stage = StageProfile(threads=max(1, cfg.feeder_threads))
        self.prof_stop = None
        self.run_span = self.tracer.open("run")

    def close(self) -> None:
        if self.prof_stop is not None:
            # an abort mid-capture still stops the profiler and writes its
            # trace (a torn capture is worse than none)
            self.prof_stop()
        self.tracer.unwind()
        if self.ledger is not None:
            self.ledger.close()
        if self.ev_log is not self.log:
            self.ev_log.close()
        self.log.close()


def correct_shard(db: DazzDB, las: LasFile, cfg: PipelineConfig,
                  start: int | None = None, end: int | None = None,
                  profile: ErrorProfile | None = None, solver=None,
                  ingest_report=None):
    """Correct every pile of the byte range ``[start, end)`` (default: the
    whole file); yields (aread, fragments, stats) in input order. Under the
    strict ingest policy a corrupt range raises ``IngestError`` before any
    pile is windowed.

    ``solver`` replaces the run's own solve path (:func:`build_solve_path`)
    with an async solver of the same duck type (``dispatch``, ``fetch``,
    ``fetch_many``; the serve plane's ``serve.batcher.JobSolver``), by the
    JAX package's rules: it turns off the local ladder, the dispatcher, the
    supervisor and paging; ``--ladder split`` stays on only for a solver
    with ``routes_streams``; a solver with ``accepts_partial`` gets its
    batches unpadded; its ``ladder`` and ``hp_ols``, when it has them, are
    reused instead of built. ``ingest_report`` is a scan of exactly this
    range made before (the run then does not scan again)."""
    from .faults import FaultPlan
    from .governor import GovernorConfig, check_host_pressure

    # the native engine runs on the host: the card is not asked for
    native = solver is None and cfg.native_solver
    dev = torch.device("cpu") if cfg.native_solver else resolve_device(cfg.device)
    paged_on = paged_enabled(cfg, dev) and not native and solver is None
    _check_config(cfg)
    stats = PipelineStats(paged=paged_on, native_host=cfg.use_native)
    t_start = time.perf_counter()
    tel = _Telemetry(cfg, start, end)
    # one fault plan for the whole range: the supervisor consumes the device
    # kinds, the guards below host_rss, monster_pile and feeder_stall
    plan = FaultPlan.from_env()
    gov_cfg = GovernorConfig.from_env()
    worker = None
    g0 = (graphs.CACHE.capture_s, graphs.CACHE.captures, graphs.CACHE.replays)
    try:
        worker = _start_audit_worker(cfg, dev, tel.ev_log, stats)
        w0 = worker.worker_s if worker is not None else 0.0
        yield from _correct_range(db, las, cfg, start, end, profile, dev, paged_on,
                                  stats, t_start, tel, plan, gov_cfg,
                                  check_host_pressure, worker, solver, ingest_report)
    finally:
        if worker is not None:
            stats.audit_worker_s = worker.worker_s - w0
            stats.audit_worker_start = dict(worker.startup)
            worker.forget()
        stats.graph_capture_s = graphs.CACHE.capture_s - g0[0]
        stats.graphs = graphs.CACHE.captures - g0[1]
        stats.graph_replays = graphs.CACHE.replays - g0[2]
        tel.close()


def _start_audit_worker(cfg: PipelineConfig, dev, ev_log, stats: PipelineStats):
    """The audit workers of a supervised, audited run, or None. They are
    the process's (``audit.worker.shared``): the first such run starts them
    first, so their imports overlap its ingest scan, profile and windowing,
    and later runs reuse them. Workers that cannot start log
    ``audit.disabled``; the run goes on without the audit."""
    from ..utils.obs import env_float

    rate = cfg.audit_rate if cfg.audit_rate is not None else env_float(
        "DACCORD_AUDIT_RATE", 1.0 / 64.0)
    use = cfg.audit_worker if cfg.audit_worker is not None else dev.type == "cuda"
    # the native engine is not audited: its reference would be itself
    if not (cfg.supervise and rate > 0.0 and use) or cfg.native_solver:
        return None
    from ..audit.worker import shared

    try:
        return shared()
    except Exception as e:
        ev_log.log("audit.disabled", error=str(e)[:200])
        if stats is not None:
            stats.audit_disabled = str(e)[:200]
        return None


class SolvePath:
    """The ``dispatch`` and ``fetch_many`` of one solve path and what holds
    them up: the ladder's ``LadderDispatcher`` thread (None: the calls run
    on the caller's thread, or the native engine's) and the supervisor
    (None: unsupervised). ``sync_engine``: the engine solves inside the
    dispatch call. ``engine_landed`` tells, without waiting, whether the
    engine's handle of a call has its result on the host (None: a
    synchronous engine's handle always has). :meth:`close` stops the
    threads (the audit worker belongs to the caller)."""

    def __init__(self, dispatch, fetch_many, sync_engine: bool, sup=None,
                 dispatcher=None, mesh=None, engine_landed=None):
        self.dispatch = dispatch
        self.fetch_many = fetch_many
        self.sync_engine = sync_engine
        self.sup = sup
        self.dispatcher = dispatcher
        self.mesh = mesh             # the sharded solver of a mesh path
        self._engine_landed = engine_landed or (lambda h: True)

    def audit_pending(self, handle) -> bool:
        """Whether ``handle``'s shadow-audit rows are not back yet."""
        return self.sup is not None and self.sup.audit_pending(handle)

    def landed(self, handle) -> bool:
        """Whether ``handle``'s result is on the host, so that its fetch
        neither waits on the engine nor solves on the host (a supervised
        handle: ``DeviceSupervisor.landed``). Never waits; the shadow
        audit's rows are :meth:`audit_pending`'s."""
        if self.sup is None:
            return self._engine_landed(handle)
        return self.sup.landed(handle, self._engine_landed)

    def close(self) -> None:
        if self.dispatcher is not None:
            self.dispatcher.close()
        if self.mesh is not None:
            self.mesh.close()
        if self.sup is not None:
            self.sup.close()


def build_solve_path(profile: ErrorProfile, cfg: PipelineConfig, dev, ladder, *,
                     native: bool, supervise: bool, tracer, ev_log, plan, gov_cfg,
                     worker=None, engine_hp: bool | None = None, on_hp=None,
                     make_ladder=None, audit_rate: float | None = None,
                     describe_prefix: str = "", mesh: int = 0) -> SolvePath:
    """The solve path of a run: the one construction ``correct_shard`` and
    the serve plane's solve groups (``serve/batcher.py``) share, so the two
    cannot diverge.

    ``native``: the host library's tier ladder (:func:`_build_native_fallback`)
    solving in the dispatch call, its hp rescue inside it when
    ``engine_hp`` (default: the config's hp rescue in the host library;
    ``on_hp(n)`` gets each call's rescued count), supervised inline with
    itself as the failover and no audit. Otherwise ``ladder`` (a
    ``TierLadder`` on ``dev``) behind a ``LadderDispatcher`` thread when
    ``cfg.max_inflight > 1``, the stream tag of a batch picking its program
    (``stream_dispatcher``); supervised, the warm deadline scales with the
    card's measured round trip, the failover engine is ``cfg``'s
    (``failover_backend``; the card's graphs are dropped first), and the
    shadow audit's reference is the ladder on the CPU (``make_ladder("cpu")``,
    built once, never copied off the card), solved in ``worker``'s processes
    when one is given (sent that ladder here). ``audit_rate`` None reads
    ``cfg.audit_rate``. ``mesh`` > 1 shards every batch over that many
    members of ``dev``'s kind (``parallel/mesh.py``; a ``mesh.build`` span
    and a ``mesh.init`` event) in place of the dispatcher, supervised with
    the partial-mesh rung."""
    from ..kernels.tiers import audit_reference
    from .supervisor import DeviceSupervisor, SupervisorConfig

    if audit_rate is None:
        audit_rate = cfg.audit_rate
    sup_cfg = SupervisorConfig.from_env(**({"failback": True} if cfg.failback else {}))
    if native:
        if engine_hp is None:
            engine_hp = cfg.consensus.hp_rescue and cfg.hp_native
        # one construction with the failover engine: the two never diverge
        engine = _build_native_fallback(profile, cfg)

        def native_solve(b):
            out = engine(b)
            if engine_hp:
                n = engine.nladder.hp_rescue(b, out, n_threads=engine.nt)
                if on_hp is not None:
                    on_hp(n)
            return out

        native_solve.__name__ = "native-ladder"
        if not supervise:
            # a synchronous engine: its handle is its result
            return SolvePath(native_solve, list, sync_engine=True)
        # the primary is the degraded engine: it fails over to itself, and
        # it is not audited (its reference would be itself)
        sup = DeviceSupervisor(
            native_solve, lambda h: h, fallback_factory=lambda: native_solve,
            log=ev_log, cfg=sup_cfg, faults=plan, probe_fn=lambda: True,
            describe=describe_prefix + "native-ladder", fingerprint_prefix="native:",
            inline=True, governor_cfg=gov_cfg, tracer=tracer, audit_rate=audit_rate)
        return SolvePath(sup.dispatch, sup.fetch_many, sync_engine=True, sup=sup)
    mesh_solver = dispatcher = None
    if mesh > 1:
        from ..parallel.mesh import make_mesh, make_sharded_solver

        with tracer.span("mesh.build"):
            mesh_solver = make_sharded_solver(ladder, make_mesh(mesh, platform=dev.type),
                                              batch=cfg.batch_size, tracer=tracer)
        ev_log.log("mesh.init", nd=int(mesh_solver.nd), devices=mesh_solver.describe(),
                   esc_cap=int(mesh_solver._esc_cap_for(cfg.batch_size)))
        # the mesh routes a batch's stream tag to its program itself
        dispatch_fn, fetch_fn = mesh_solver.dispatch, mesh_solver.fetch
        fetch_many_fn = mesh_solver.fetch_many
    else:
        dispatcher = LadderDispatcher(dev, tracer) if cfg.max_inflight > 1 else None
        # a batch's stream tag picks its program: Stream A (tier 0 alone) or
        # the whole ladder (fused batches and Stream B's)
        dispatch_fn = stream_dispatcher(ladder, dispatcher, tracer)
        fetch_fn, fetch_many_fn = fetch, fetch_many
    sync_engine = dispatcher is None and mesh_solver is None
    engine_landed = mesh_solver.landed if mesh_solver is not None else landed
    if not supervise:
        return SolvePath(dispatch_fn, fetch_many_fn, sync_engine=sync_engine,
                         dispatcher=dispatcher, mesh=mesh_solver,
                         engine_landed=engine_landed)
    from ..utils.obs import device_alive, measure_rtt_s

    host_ladder: list = []

    def cpu_ladder() -> TierLadder:
        # built from the profile's numpy tables, never copied off the
        # card: a poisoned CUDA context cannot be read from
        if not host_ladder:
            host_ladder.append(make_ladder("cpu"))
        return host_ladder[0]

    if worker is not None:
        worker.build(cpu_ladder().spec())

    def fallback_factory():
        # the card is lost: its graphs cannot run on a poisoned context
        graphs.CACHE.clear()
        kind = cfg.failover_backend
        if kind == "auto":
            kind = "cpu" if dev.type == "cpu" else "native"
        if kind == "native":
            return _build_native_fallback(profile, cfg)
        return audit_reference(cpu_ladder())

    rtt_s = None
    if dev.type == "cuda":
        # no graph capture of another thread overlaps the probe's copies
        with graphs.CACHE.lock:
            rtt_s = measure_rtt_s(device=dev)
    if mesh_solver is not None:
        desc = mesh_solver.describe()
    else:
        desc = "cpu-ladder" if dev.type == "cpu" else "device-ladder"
    sup = DeviceSupervisor(
        # a mesh's drained group is one guarded fetch, as in the JAX package
        dispatch_fn, fetch_fn, fetch_many_fn if mesh_solver is not None else None,
        fallback_factory=fallback_factory,
        log=ev_log, cfg=sup_cfg, faults=plan,
        # the card's warm deadline scales with its measured round trip; a
        # CPU ladder cannot hang the way a card can and keeps the flat
        # deadline, as the native engine does
        rtt_s=rtt_s,
        probe_fn=lambda: device_alive(sup_cfg.probe_timeout_s, str(dev)),
        describe=describe_prefix + desc,
        fingerprint_prefix=f"{dev.type}:", inline=dev.type == "cpu",
        governor_cfg=gov_cfg, tracer=tracer, mesh=mesh_solver,
        # the reference is the card's own ladder on the CPU, byte-exact
        # with the card; the native engine would not be
        audit_ref_factory=lambda: audit_reference(cpu_ladder()),
        audit_rate=audit_rate, audit_worker=worker)
    return SolvePath(sup.dispatch, sup.fetch_many, sync_engine=sync_engine,
                     sup=sup, dispatcher=dispatcher, mesh=mesh_solver,
                     engine_landed=engine_landed)


def _correct_range(db, las, cfg, start, end, profile, dev, paged_on, stats,
                   t_start, tel: _Telemetry, plan, gov_cfg, check_host_pressure,
                   worker, solver=None, ingest_report=None):
    log, ev_log, tracer, ledger = tel.log, tel.ev_log, tel.tracer, tel.ledger
    metrics, prof = tel.metrics, tel.stage
    job = cfg.job_tag
    report = None
    if ingest_report is not None and cfg.ingest_policy != "off":
        # scanned before (the serve plane scans a job at admission and again
        # at its start): the checks are the scan's own, not paid twice
        report = ingest_report
        stats.n_ingest_issues = len(report.issues)
        if report.issues and cfg.ingest_policy == "strict":
            raise report.error()
    elif cfg.ingest_policy != "off":
        t0 = time.perf_counter()
        with tracer.span("scan"):
            report = scan_with_db(db, las, start, end)
        stats.ingest_s = time.perf_counter() - t0
        stats.n_ingest_issues = len(report.issues)
        ev_log.log("ingest.scan", path=las.path, records=report.n_records,
                   piles=report.n_piles, issues=len(report.issues),
                   policy=cfg.ingest_policy)
        for iss in report.issues[:64]:
            ev_log.log("ingest.issue", kind=iss.kind, offset=iss.offset,
                       aread=-1 if iss.aread is None else int(iss.aread),
                       detail=iss.detail)
        if report.issues and cfg.ingest_policy == "strict":
            raise report.error()
    # a custom solver brings its own programs and the native engine solves
    # on the host: both run on one device (logged, not refused). A cuda
    # mesh with too few cards stops here, before the profile pass
    mesh_n = cfg.mesh if cfg.mesh and cfg.mesh > 1 else 0
    if mesh_n and (solver is not None or cfg.native_solver):
        log.log("info", msg=f"mesh={mesh_n} inapplicable here (native engine "
                            "or custom solver); running on one device")
        mesh_n = 0
    if mesh_n:
        from ..parallel.mesh import check_mesh_devices

        check_mesh_devices(mesh_n, dev.type)
    # quarantine: the profile sample and the family sample take clean piles
    # only (the aread index cannot be built over a corrupt file)
    clean = report.pile_ranges if report is not None and report.issues else None
    qvr = load_qv_ranker(db, las, cfg)
    stats.qv_ranked = qvr is not None

    sample = None
    if profile is None:
        t0 = time.perf_counter()
        with tracer.span("profile"):
            if paged_on:
                profile, sample = estimate_profile_for_shard(
                    db, las, cfg, start, end, pile_ranges=clean, return_windows=True)
            else:
                profile = estimate_profile_for_shard(db, las, cfg, start, end,
                                                     pile_ranges=clean)
        stats.profile_s = time.perf_counter() - t0

    def make_ladder(device):
        return TierLadder.from_config(profile, cfg.consensus, max_kmers=cfg.max_kmers,
                                      rescue_max_kmers=cfg.rescue_max_kmers,
                                      overflow_rescue=cfg.overflow_rescue,
                                      device=device, route=cfg.dp_route)

    # a custom solver (the serve plane's cross-job batcher) brings its own
    # solve path and, when it has one, its warm ladder
    native = solver is None and cfg.native_solver
    ladder = getattr(solver, "ladder", None)
    if solver is None and not native:
        with tracer.span("ladder.build"):
            ladder = make_ladder(dev)
    w, adv = cfg.consensus.w, cfg.consensus.adv
    B = cfg.batch_size
    min_depth = cfg.consensus.dbg.min_depth
    tier_ks = [t[0] for t in cfg.consensus.tiers]
    # patch mode refills unsolved windows with raw bases, which no rescue
    # consensus is worse than: the end-trim applies to split mode only
    rescue_tiers = ({i for i, t in enumerate(cfg.consensus.tiers) if t[1] <= 1}
                    if cfg.end_trim and cfg.consensus.mode != "patch" else set())
    if paged_on:
        t0 = time.perf_counter()
        with tracer.span("paging.derive"):
            families = run_families(db, las, cfg, sample, start, end, clean)
        stats.profile_s += time.perf_counter() - t0
        for fi, f in enumerate(families):
            ev_log.log("paging.family", family=f.describe(), bucket=fi,
                       depth=int(f.depth), pages=int(f.pages),
                       page_len=int(f.page_len), pool_pages=int(f.budget))
        buckets = None
        shapes = [BatchShape(depth=f.depth, seg_len=cfg.seg_len, wlen=w)
                  for f in families]
        labels = [f.describe() for f in families]
        cap_pages = [B * f.budget for f in families]
    else:
        families = None
        buckets = dense_buckets(cfg)
        shapes = [BatchShape(depth=d, seg_len=ln, wlen=w) for d, ln in buckets]
        labels = [f"D{d}xL{ln}" for d, ln in buckets]
        cap_pages = [None] * len(buckets)
    nb = len(shapes)
    # the native engine escalates a window on the host: batches go fused; a
    # custom solver runs the two streams only if it routes their tags
    split = cfg.ladder_mode == "split" and (
        (solver is None and not native) or getattr(solver, "routes_streams", False))
    if native and (cfg.ladder_mode == "split" or cfg.paged != "off"):
        log.log("info", msg="ladder_mode/paged inapplicable to the native "
                            "engine; running dense and fused")
    elif solver is not None and (cfg.paged != "off" or (cfg.ladder_mode == "split"
                                                         and not split)):
        log.log("info", msg="ladder_mode/paged inapplicable with a custom solver; "
                            "running dense" + ("" if split else " and fused"))
    # a solver that pads its own (merged) batches gets them unpadded: rows
    # padded here would be dead rows it cannot give to another job
    partial = solver is not None and getattr(solver, "accepts_partial", False)

    # the homopolymer rescue: in the native engine's solve call, or a host
    # pass after each fetch (the host library's, or the python loop's)
    hp_nt = cfg.native_threads if cfg.native_threads > 0 else len(os.sched_getaffinity(0))
    hp_ols = hp_nladder = None
    if cfg.consensus.hp_rescue and not (native and cfg.hp_native):
        # a warm solver's tables, shared read-only across its jobs
        hp_ols = getattr(solver, "hp_ols", None)
        if hp_ols is None:
            from ..oracle.consensus import make_offset_likely

            hp_ols = make_offset_likely(profile, cfg.consensus)
        if cfg.hp_native:
            from ..native.api import NativeLadder

            hp_nladder = NativeLadder(hp_ols, cfg.consensus, max_kmers=cfg.max_kmers,
                                      rescue_max_kmers=cfg.rescue_max_kmers)

    if solver is not None:
        path = SolvePath(solver.dispatch, solver.fetch_many, sync_engine=False)
    else:
        path = build_solve_path(
            profile, cfg, dev, ladder, native=native, supervise=cfg.supervise,
            tracer=tracer, ev_log=ev_log, plan=plan, gov_cfg=gov_cfg, worker=worker,
            on_hp=lambda n: setattr(stats, "n_hp_rescued", stats.n_hp_rescued + n),
            make_ladder=make_ladder, mesh=mesh_n)
    dispatch_fn, fetch_many_fn, sup = path.dispatch, path.fetch_many, path.sup
    mesh_solver = path.mesh
    # the ledger's mesh column: the run's own mesh, a mesh-backed serve
    # group's width (its job solver's ``mesh``) or an injected sharded
    # solver's; 0 leaves the rows as they were
    ledger_mesh = mesh_n or int(getattr(solver, "nd", 0) or getattr(solver, "mesh", 0) or 0)
    audit_pending = (path.audit_pending if sup is not None and cfg.max_inflight > 1
                     else lambda h: False)
    # the saturation accounting: a synchronous engine (the native engine, or
    # the ladder on the pipeline's thread at max_inflight=1) solves inside
    # the dispatch call, so its busy wall is the dispatch wall and the host
    # is blocked there. With the dispatcher only the fetch blocks the host,
    # and the busy wall is the sum of the calls' own spans on their engine
    # (on cuda the card's, from two timing events; tiers.fetch), booked as
    # each call lands. The JAX package books its deque's occupancy instead,
    # from a dispatch into an empty deque to the fetch that empties it; the
    # port's deque holds finished calls until half of it drains, so that
    # integral reads the whole run busy whatever the card does
    sync_engine = path.sync_engine
    busy = [0.0]

    def timed_dispatch(batch):
        t_d = time.perf_counter()
        handle = dispatch_fn(batch)
        dt = time.perf_counter() - t_d
        # with the dispatcher this wall is the enqueue alone (the call runs
        # on its thread): a dispatch here means less than a JAX dispatch,
        # whose wall holds the host side of the jitted call
        stats.ladder_s += dt
        if sync_engine:
            busy[0] += dt
        return handle

    # one torch.profiler capture a run (DACCORD_PROFILE_DIR): the Nth ladder
    # call (DACCORD_PROFILE_DISPATCH, default 2: past the first shape's build
    # and capture) from its dispatch through the drain that fetches it (the
    # JAX package's bracket: the calls in flight stay in flight), written as
    # a chrome trace into the directory. The profiler's start and stop take
    # the graph cache's lock, which the dispatcher thread holds around each
    # call: CUPTI's stop deadlocked with a graph replay on the dispatcher's
    # thread (both threads' stacks, H100: PERF.md section 7), and under the
    # lock no replay runs while CUPTI turns on or off. Never on the native
    # engine or with a custom solver
    from ..utils.obs import env_float, profile_all_threads

    prof_dir = os.environ.get("DACCORD_PROFILE_DIR")
    cap = {"n": 0, "fetched": 0, "active": None,
           "done": not prof_dir or native or solver is not None,
           "at": max(1, int(env_float("DACCORD_PROFILE_DISPATCH", 2)))}

    def prof_due() -> bool:
        """Count a dispatch; True for the one to capture."""
        if cap["done"]:
            return False
        cap["n"] += 1
        return cap["n"] >= cap["at"]

    def prof_start() -> None:
        cap["done"] = True
        try:
            t0 = time.perf_counter()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(prof_dir, exist_ok=True)
            p = profile_all_threads(acts)
            with graphs.CACHE.lock:
                p.start()
            cap["active"] = p
            # wall_s: what the capture itself cost the run (here the start;
            # at stop the stop and the export)
            ev_log.log("profile.capture", dir=prof_dir, dispatch=cap["n"], state="start",
                       wall_s=round(time.perf_counter() - t0, 4))
        except Exception as e:   # profiling must never sink a run
            log.log("warn", msg=f"profiler start failed: {e}")

    def prof_landed(n: int) -> None:
        """Count ``n`` fetched calls; stop the capture at the drain that
        fetched the captured one (calls land oldest first)."""
        cap["fetched"] += n
        if cap["active"] is not None and cap["fetched"] >= cap["n"]:
            prof_stop()

    def prof_stop() -> None:
        p = cap["active"]
        if p is None:
            return
        cap["active"] = None
        try:
            t0 = time.perf_counter()
            with graphs.CACHE.lock:
                p.stop()
            path = os.path.join(prof_dir, f"daccord-{os.getpid()}-{cap['n']}.trace.json")
            p.export_chrome_trace(path)
            ev_log.log("profile.capture", dir=prof_dir, dispatch=cap["n"], state="stop",
                       wall_s=round(time.perf_counter() - t0, 4))
        except Exception as e:
            log.log("warn", msg=f"profiler stop failed: {e}")

    # an aborted run still stops an open capture and writes its trace
    tel.prof_stop = prof_stop

    pending: dict[int, _PendingRead] = {}
    order: list[int] = []
    ready: dict[int, list[np.ndarray]] = {}
    # per-bucket row buffers: the windows waiting for a batch, and (split)
    # the rescue pools, Stream B's input
    bufs = [_RowBuffer() for _ in range(nb)]
    pools = [_RowBuffer() for _ in range(nb)]
    # (handle, rid, widx, take, nsegs, dispatch time, bucket, stream, seqs,
    # lens) of each ladder call in flight, oldest first
    inflight: deque = deque()
    qfh = None

    def finalize_read(r: int, pr: _PendingRead) -> None:
        if rescue_tiers:
            _trim_rescue_ends(pr, rescue_tiers, stats)
        ready[r] = stitch_results(pr.a_bases, pr.results(w, adv), cfg.consensus)
        del pending[r]

    def take_rows(buf: "_RowBuffer", bi: int) -> int:
        """The rows of ``buf``'s next batch: at most B, and on a paged run
        the largest prefix (never zero rows) whose pages fit one pool, the
        guarantee behind pack_paged's budget check."""
        take = min(B, buf.nrows)
        return buf.fit(take, cap_pages[bi]) if paged_on else take

    def scatter(out: dict, rid, widx, take: int, nsegs_b, wall: float,
                stream: str = "full") -> None:
        """One fetched batch's rows into their pending reads, as array ops
        over each read's run of rows (a read's rows are contiguous in a
        batch: they are pushed together)."""
        solved = np.asarray(out["solved"][:take], dtype=bool)
        tier = np.where(solved, np.asarray(out["tier"][:take]), -1).astype(np.int32)
        cl = np.asarray(out["cons_len"][:take])
        cons = np.asarray(out["cons"][:take])
        stats.n_topm_overflow += int(np.asarray(out["m_ovf"][:take]).sum())
        stats.n_solved += int(solved.sum())
        for t, c in zip(*np.unique(tier[solved], return_counts=True)):
            stats.tier_histogram[int(t)] = stats.tier_histogram.get(int(t), 0) + int(c)
        rid = rid[:take]
        cuts = np.flatnonzero(rid[1:] != rid[:-1]) + 1
        for a, b in zip(np.r_[0, cuts], np.r_[cuts, take]):
            r = int(rid[a])
            pr = pending[r]
            wj = widx[a:b]
            if pr.cons is None or pr.cons.shape[1] < cons.shape[1]:
                # an hp-rescued row may be longer than the ladder's rows
                wide = np.full((pr.n_windows, cons.shape[1]), 4, dtype=np.int8)
                if pr.cons is not None:
                    wide[:, :pr.cons.shape[1]] = pr.cons
                pr.cons = wide
            pr.cons[wj, :cons.shape[1]] = cons[a:b]
            pr.cons_len[wj] = cl[a:b]
            pr.solved[wj] = solved[a:b]
            pr.tiers[wj] = tier[a:b]
            pr.n_done += int(b - a)
            if pr.n_done == pr.n_windows:
                finalize_read(r, pr)
        if ledger is not None:
            for i in range(take):
                t = int(tier[i])
                ledger.record(int(rid[i]), int(widx[i]), w, int(nsegs_b[i]), t,
                              tier_ks[t] if 0 <= t < len(tier_ks) else -1,
                              bool(solved[i]), stream,
                              rescued=stream == "rescue" or t >= 1, wall_s=wall, job=job,
                              mesh=ledger_mesh)

    def drain(to_depth: int, audited_only: bool = False) -> None:
        """Fetch the oldest calls until ``to_depth`` stay in flight, and
        scatter them; with ``audited_only``, only those before the first
        whose shadow-audit rows are not back yet."""
        n_pop = len(inflight) - to_depth
        if audited_only:
            n_pop = next((i for i in range(max(n_pop, 0))
                          if audit_pending(inflight[i][0])), n_pop)
        if n_pop <= 0:
            return
        land([inflight.popleft() for _ in range(n_pop)])

    def drain_final() -> None:
        """Empty the deque at the end of the run in the order the shadow
        audit's rows come back: the calls whose rows are back are fetched
        and scattered first (oldest first), and the pipeline waits only when
        none is, for the oldest. The workers solve the last samples while
        the host scatters and stitches, instead of the host waiting for
        every verdict before its first scatter. Windows solve independently,
        so the order changes no byte. A split run drains oldest first: its
        Stream A rows fill the rescue pools in dispatch order."""
        if split:
            drain(0)
            return
        while inflight:
            back = {i for i, e in enumerate(inflight) if not audit_pending(e[0])} or {0}
            entries = [e for i, e in enumerate(inflight) if i in back]
            rest = [e for i, e in enumerate(inflight) if i not in back]
            inflight.clear()
            inflight.extend(rest)
            land(entries)

    def land(entries: list) -> None:
        """Fetch ``entries`` (popped from the deque), then pool, hp-rescue
        and scatter their rows."""
        t0 = time.perf_counter()
        # the device.fetch span wraps exactly the region device_s times, so
        # tools/trace.py's device sum reconciles with device_s
        f_sp = tracer.open("device.fetch", n=len(entries))
        outs = fetch_many_fn([e[0] for e in entries])
        now = time.perf_counter()
        tracer.close(f_sp)
        prof_landed(len(entries))
        stats.device_s += now - t0
        metrics.counter("fetch_calls").inc()
        for (h, rid, widx, take, nsegs_b, t_d, bi, stream, seqs, lens, b_sp), out in zip(
                entries, outs):
            metrics.histogram("batch_turnaround_s").observe(now - t_d)
            inner = getattr(h, "inner", h)
            stats.solve_s += getattr(inner, "solve_s", 0.0)
            stats.solve_cpu_s += getattr(inner, "cpu_s", 0.0)
            if not sync_engine:
                busy[0] += getattr(inner, "busy_s", 0.0)
            out = {k: v[:take] if np.ndim(v) else v for k, v in out.items()}
            if stream == "tier0":
                # the rows the fused ladder would rescue pool for Stream B
                # and scatter once, when their Stream B rows land; a Stream
                # A batch a failover solved whole pools them too (the same
                # bytes come back)
                need = rescue_candidates(out, nsegs_b, ladder)
                if need.any():
                    sel = np.nonzero(need)[0]
                    pgs = (paging.window_pages(lens[sel], cfg.page_len) if paged_on
                           else np.zeros(len(sel), np.int64))
                    pools[bi].push((seqs[sel], lens[sel], nsegs_b[sel], rid[sel],
                                    widx[sel], pgs), stats.n_reads)
                    keep = np.nonzero(~need)[0]
                    out = {k: v[keep] if np.ndim(v) else v for k, v in out.items()}
                    rid, widx, nsegs_b = rid[keep], widx[keep], nsegs_b[keep]
                    seqs, lens = seqs[keep], lens[keep]
                    take = len(keep)
            elif stream == "full" and ladder is not None:
                # the fused ladder's rescue demand, from its final rows
                # (escalation-solved, still failed at depth, and top-M
                # capped with the overflow rescue on; a tier-0 failure the
                # wide rescue solved is missed) and the width it ran at
                deep = nsegs_b >= min_depth
                need_f = (out["tier"] >= 1) | (~out["solved"] & deep)
                if ladder.wide_p0 is not None:
                    need_f |= out["m_ovf"] & deep
                n_need = int(need_f.sum())
                if n_need:
                    stats.n_rescue_windows += n_need
                    stats.rescue_slots_executed += pick_width(n_need, B)
            if hp_ols is not None and take:
                # after the audit's comparison (inside the fetch), so the
                # audit sees the ladder's own rows
                t0 = time.perf_counter()
                hp_sp = tracer.open("hp", parent=b_sp, attach=False)
                stats.n_hp_rescued += _hp_pass(out, seqs, lens, nsegs_b, cfg,
                                               hp_ols, hp_nladder, hp_nt)
                tracer.close(hp_sp)
                stats.hp_wall_s += time.perf_counter() - t0
            n_s = int(np.sum(out["solved"]))
            if take:
                scatter(out, rid, widx, take, nsegs_b, now - t_d, stream)
            tracer.close(b_sp, windows=int(take), solved=n_s)
            log.log("batch", windows=int(take), solved=n_s, stream=stream,
                    pool=sum(pb.nrows for pb in pools), inflight=len(inflight),
                    t_turnaround=round(now - t_d, 4))

    def submit_batch(buf: "_RowBuffer", bi: int, take: int, stream: str,
                     fl_sp=None) -> None:
        """Pop ``take`` rows of ``buf`` into a batch of bucket ``bi``, pad or
        pack it, dispatch it and queue its handle. ``fl_sp`` (a Stream B
        flush) closes once the batch is packed: the dispatch books under its
        own span, and the two stay disjoint."""
        seqs, lens, nsg, rid, widx, pgs = buf.pop(take)
        batch = WindowBatch(seqs=seqs, lens=lens, nsegs=nsg, shape=shapes[bi],
                            read_ids=rid, wstarts=widx * adv, stream=stream,
                            job=job or "")
        if paged_on:
            n_pages = int(pgs.sum())
            with prof.timed("pack"):
                batch = paging.pack_paged(batch, families[bi], target_rows=B)
            stats.pad_cells += int(batch.pool.size)
            ev_log.log("batch.paged", windows=int(take), bucket=bi,
                       family=families[bi].describe(), pages=n_pages,
                       pool_pages=int(batch.pool.shape[0] - 1),
                       table_cells=int(batch.table.size) * 4,
                       occupancy=round(n_pages / max(batch.pool.shape[0] - 1, 1), 4))
        elif native or partial:
            # the host engine walks real rows: padding would only add dead
            # ones (and each partial batch keeps its own shape key); a
            # partial-capable solver pads the batches it merges
            stats.pad_cells += int(batch.seqs.size)
        else:
            with prof.timed("pack"):
                batch = pad_batch(batch, B)
            stats.pad_cells += int(batch.seqs.size)
        stats.used_cells += int(lens.sum())
        stats.h2d_bytes += sum(int(a.nbytes) for a in upload_arrays(batch))
        tracer.close(fl_sp)
        b_sp = tracer.open("batch", attach=False, stream=stream, rows=int(take),
                           bucket=bi)
        meta = (rid, widx, take, nsg, bi, stream, seqs, lens, b_sp)
        if stager is not None:
            # staged under the calls in flight, launched in order
            launch_staged()
            staged_pending.append(stager.submit(batch, meta))
            launch_staged()
            return
        # a capture starts and stops outside the dispatch span: its cost is
        # its own (profile.capture's wall_s), not the dispatch's
        capture = prof_due()
        if capture:
            prof_start()
        d_sp = tracer.open("dispatch", parent=b_sp, stream=stream)
        handle = timed_dispatch(batch)
        tracer.close(d_sp)
        queue_call(handle, meta)

    def queue_call(handle, meta) -> None:
        """A dispatched call into the deque; a full deque drains half."""
        rid, widx, take, nsg, bi, stream, seqs, lens, b_sp = meta
        metrics.counter("dispatches").inc()
        stats.n_batches += 1
        stats.batches_by_bucket[labels[bi]] = stats.batches_by_bucket.get(labels[bi], 0) + 1
        inflight.append((handle, rid, widx, take, nsg, time.perf_counter(), bi, stream,
                         seqs, lens, b_sp))
        stats.peak_inflight = max(stats.peak_inflight, len(inflight))
        if len(inflight) >= cfg.max_inflight:
            drain(cfg.max_inflight // 2,
                  audited_only=len(inflight) < AUDIT_LAG * cfg.max_inflight)

    # a mesh run stages batch N+1 (pad, slices, copies to the members) on a
    # thread while the calls in flight solve, and launches it from here;
    # DACCORD_MESH_PIPELINE=0 dispatches unstaged (same bytes)
    stager = None
    staged_pending: deque = deque()
    if mesh_solver is not None and os.environ.get("DACCORD_MESH_PIPELINE", "1") != "0":
        stager = _Stager(mesh_solver.stage, prof=prof)
        ev_log.log("dispatch.pipeline", depth=2, solver=mesh_solver.describe())

    def launch_staged(block: bool = False) -> None:
        """Launch the staged batches in order. A batch still staging blocks
        only with ``block`` or an empty deque (the members would idle)."""
        while staged_pending:
            t = staged_pending[0]
            if not t.done.is_set() and not block and inflight:
                return
            t.done.wait()
            staged_pending.popleft()
            take, b_sp = t.meta[2], t.meta[8]
            if t.error is None:
                ev_log.log("dispatch.stage", rows=int(take),
                           pack_s=round(t.staged.pack_s, 4),
                           stage_s=round(t.staged.stage_s, 4))
            if prof_due():
                prof_start()
            l_sp = tracer.open("dispatch.launch", parent=b_sp, attach=False, rows=int(take))
            t_l = time.perf_counter()
            # a batch whose staging failed is dispatched as it is
            handle = timed_dispatch(t.batch if t.error is not None else t.staged)
            tracer.close(l_sp)
            ev_log.log("dispatch.launch", rows=int(take),
                       launch_s=round(time.perf_counter() - t_l, 4))
            queue_call(handle, t.meta)

    def flush_rescues(final: bool, pressure: bool = False) -> None:
        """Stream B: each bucket's rescue pool as dense whole-ladder
        batches, when it holds a full batch (or a full pool of pages), when
        its oldest row has waited ``rescue_flush_reads`` reads (which bounds
        the emission lag a pooled window adds), at the end, or under host
        memory pressure."""
        if not split:
            return
        for bi, buf in enumerate(pools):
            stale = buf.stale(stats.n_reads, cfg.rescue_flush_reads)
            while buf.nrows and (buf.full(B, cap_pages[bi])
                                 or final or stale or pressure):
                reason = ("full" if buf.full(B, cap_pages[bi])
                          else "pressure" if pressure else "final" if final else "lag")
                stale = False
                take = take_rows(buf, bi)
                stats.n_dispatch_rescue += 1
                stats.n_rescue_windows += take
                stats.rescue_slots_executed += B
                stats.rescue_dispatches.append({"rows": take, "slots": B,
                                                "reason": reason})
                # the flush span covers the pool's pop and the pad: the
                # dispatch books under its own span
                fl_sp = tracer.open("flush", reason=reason, rows=take, bucket=bi)
                metrics.histogram("flush_rows").observe(take)
                ev_log.log("ladder.flush", rows=take, slots=B, reason=reason, bucket=bi)
                submit_batch(buf, bi, take, "rescue", fl_sp)

    def run_batches(final: bool) -> None:
        for bi, buf in enumerate(bufs):
            # a partial flush once the bucket's oldest row has waited too
            # long bounds the in-order emission lag under bucket skew
            stale = buf.stale(stats.n_reads, cfg.bucket_flush_reads)
            while buf.nrows and (buf.full(B, cap_pages[bi])
                                 or final or stale):
                stale = False
                if split:
                    stats.n_dispatch_tier0 += 1
                submit_batch(buf, bi, take_rows(buf, bi), "tier0" if split else "full")
        flush_rescues(final)
        if final:
            launch_staged(block=True)
            a0 = sup.audit_s if sup is not None else 0.0
            drain_final()
            stats.audit_drain_s = (sup.audit_s if sup is not None else 0.0) - a0
            # the last Stream A rows pool fresh rescue rows; Stream B rows
            # never pool, so one more round empties the pools
            while any(pb.nrows for pb in pools):
                flush_rescues(True)
                launch_staged(block=True)
                drain(0)

    emit_idx = 0

    def emit_ready():
        nonlocal emit_idx
        while emit_idx < len(order) and order[emit_idx] in ready:
            r = order[emit_idx]
            frags = ready.pop(r)
            stats.n_fragments += len(frags)
            stats.bases_out += sum(len(f) for f in frags)
            stats.wall_s = time.perf_counter() - t_start
            yield r, frags, stats
            emit_idx += 1

    def monster(aread: int, n_overlaps: int) -> bool:
        """The monster-pile guard, asked once per pile before it is
        windowed: True = contain it (the budget, or an injected
        ``monster_pile`` fault)."""
        injected = plan is not None and plan.monster_check()
        budget = cfg.max_pile_overlaps
        if not injected and not (budget and n_overlaps > budget):
            return False
        stats.n_monster_piles += 1
        ev_log.log("governor.monster", aread=int(aread), overlaps=int(n_overlaps),
                   budget=int(budget or 0), injected=injected)
        return True

    def block_iter(s, e):
        kw = dict(start=s, end=e, monster=monster, prof=prof)
        if cfg.feeder_threads:
            return iter_pile_blocks_threaded(db, las, cfg, cfg.feeder_threads, qvr, **kw)
        return iter_pile_blocks(db, las, cfg, qvr, **kw)

    def segmented():
        # clean byte segments stream through the feeders; each contained
        # pile rides along as a marker in byte order
        for seg in report.segments:
            if seg[0] == "clean":
                yield from block_iter(seg[1], seg[2])
            else:
                yield seg

    bad_reads = db.bad_reads
    blocks = segmented() if clean is not None else block_iter(start, end)
    # the injected feeder slowdown (DACCORD_FAULT=feeder_stall:MS): a sleep
    # a pile block, booked under the profiler's `stall` stage, so the
    # verdict names it
    stall_s = (plan.feeder_stall_ms() if plan is not None else 0.0) / 1e3
    if stall_s:
        ev_log.log("sup_fault", kind="feeder_stall", op="feeder", n=int(stall_s * 1e3))

    def timed_blocks():
        # a feeder span a pile block: the wall the pile loop blocks on the
        # feeder (decode, ranking, the host library's windowing); the pile
        # span before it is closed, so these parent under the run span
        while True:
            f_sp = tracer.open("feeder")
            t0 = time.perf_counter()
            blk = next(blocks, None)
            if blk is None:
                stats.windowing_s += time.perf_counter() - t0
                tracer.close(f_sp, status="end")
                return
            if stall_s:
                # the sleep's measured wall, not its nominal length: the
                # stage table then reconciles with the feeder wall exactly
                t_s = time.perf_counter()
                time.sleep(stall_s)
                prof.add("stall", time.perf_counter() - t_s)
            stats.windowing_s += time.perf_counter() - t0
            tracer.close(f_sp)
            yield blk

    def saturation():
        """(gauges, stage summary, verdict) of the run so far: the one
        computation of the periodic snapshot and the end-of-run stamp."""
        from ..utils.obs import bottleneck_verdict, saturation_gauges

        now = time.perf_counter()
        busy_s, blocked = busy[0], stats.device_s
        if sync_engine:
            # the solve runs inside the dispatch: the host is blocked there,
            # and that wall is the engine's busy time
            blocked += stats.ladder_s
            busy_s += stats.device_s
        gs = saturation_gauges(max(now - t_start, 1e-9), blocked, busy_s)
        summ = prof.summary()
        return gs, summ, bottleneck_verdict(gs, summ["stages"])

    def metrics_snap(final: bool = False) -> None:
        """Refresh the registry's gauges and write a ``stage.profile`` event
        (and, unless ``final``, a ``metrics`` snapshot). On the pipeline's
        thread, never the dispatcher's: the allocator's peak is a host-side
        read, and nothing here waits on the card."""
        from .governor import host_rss_mb
        from ..utils.obs import device_peak_bytes

        el = max(time.perf_counter() - t_start, 1e-9)
        g = metrics.gauge
        g("windows_per_sec").set(stats.n_windows / el)
        g("bases_per_sec").set(stats.bases_out / el)
        g("pad_waste").set(stats.pad_waste)
        g("rescue_density").set(stats.rescue_density)
        g("rss_mb").set(host_rss_mb())
        g("pool_rows").set(float(sum(pb.nrows for pb in pools)) if split else 0.0)
        g("inflight").set(float(len(inflight)))
        g("n_reads").set(float(stats.n_reads))
        g("n_windows").set(float(stats.n_windows))
        g("n_solved").set(float(stats.n_solved))
        gs, summ, bver = saturation()
        for k, v in gs.items():
            g(k).set(v)
        g("feeder_s").set(stats.windowing_s)
        g("dispatch_s").set(stats.ladder_s)
        g("stage_threads").set(float(summ["threads"]))
        for name, row in summ["stages"].items():
            g(f"stage_{name}_s").set(row["wall_s"])
        ev_log.log("stage.profile", stages=summ["stages"], threads=summ["threads"],
                   feeder_s=round(stats.windowing_s, 4),
                   dispatch_s=round(stats.ladder_s, 4),
                   verdict=bver["verdict"], stage=bver["stage"] or "",
                   device_idle_frac=bver["device_idle_frac"],
                   host_blocked_frac=bver["host_blocked_frac"],
                   overlap_frac=bver["overlap_frac"], final=final)
        if not native and not (sup is not None and sup.failed_over):
            # a failed-over card's context may be poisoned: not asked again
            dpb = device_peak_bytes(dev)
            if dpb is not None:
                g("device_peak_bytes").set(float(dpb))
        hm = mesh_telemetry()
        if not final:
            metrics.snapshot(ev_log, **({"mesh": hm} if hm else {}))
        return hm

    def mesh_telemetry() -> dict | None:
        """A mesh run's health map (``ShardedLadderSolver.health_map``) for
        the snapshot, its gauges, and a ``mesh.device`` row per member with
        the slice width its capacity rung runs at, when the governor has
        ratcheted one."""
        if mesh_solver is None:
            return None
        hm = mesh_solver.health_map()
        rat = sup.governor.active_state() if sup is not None else {}
        rung_rows = min(rat.values()) // max(mesh_solver.nd, 1) if rat else None
        if rung_rows is not None:
            hm["rung_rows_per_device"] = int(rung_rows)
        metrics.gauge("mesh_nd").set(float(hm["nd"]))
        metrics.gauge("mesh_devices_lost").set(
            float(sum(1 for r in hm["devices"].values() if r["state"] != "ok")))
        for i, row in sorted(hm["devices"].items()):
            ev_log.log("mesh.device", device=int(i), state=row["state"],
                       platform=row["platform"], dispatches=int(row["dispatches"]),
                       dispatch_wall_s=round(row["dispatch_wall_s"], 4),
                       rows=int(row["rows"]), hbm_peak_bytes=row["hbm_peak_bytes"],
                       busy_frac=row["busy_frac"], idle_frac=row["idle_frac"],
                       overlap_frac=row["overlap_frac"],
                       **({"rung_rows": int(rung_rows)} if rung_rows is not None else {}))
        return hm

    bp_latched = None
    last_snap = time.perf_counter()
    try:
        for blk in timed_blocks():
            if (cfg.metrics_snapshot_s
                    and time.perf_counter() - last_snap >= cfg.metrics_snapshot_s):
                last_snap = time.perf_counter()
                metrics_snap()
            pa = blk[1] if isinstance(blk[0], str) else blk[0]
            pile_sp = tracer.open("pile", aread=int(-1 if pa is None else pa))
            # host-memory watermark, once per pile block: pressure
            # force-flushes the partial buckets (hard: and every call in
            # flight). Flush cadence changes no window's bytes. Real
            # pressure latches per level until it clears
            level, rss_mb, injected = check_host_pressure(plan, gov_cfg)
            if not injected:
                if level is None:
                    bp_latched = None
                elif level == "soft" and bp_latched == "hard":
                    bp_latched, level = "soft", None
                elif bp_latched == level:
                    level = None
            if level is not None:
                stats.n_backpressure += 1
                ev_log.log("governor.backpressure", level=level, rss_mb=round(rss_mb, 1),
                           injected=injected, pool=0, inflight=len(inflight))
                run_batches(final=False)
                for bi, buf in enumerate(bufs):
                    while buf.nrows:
                        if split:
                            stats.n_dispatch_tier0 += 1
                        submit_batch(buf, bi, take_rows(buf, bi),
                                     "tier0" if split else "full")
                flush_rescues(False, pressure=True)
                if level == "hard":
                    launch_staged(block=True)
                    drain(0)
                yield from emit_ready()
                if not injected:
                    bp_latched = level
            if isinstance(blk[0], str):
                # a contained pile: its read is emitted uncorrected
                _, q_aread, q_off, q_kind, q_detail = blk
                stats.n_quarantined += 1
                ev_log.log("ingest.quarantine", kind=q_kind, offset=int(q_off),
                           aread=-1 if q_aread is None else int(q_aread))
                if cfg.quarantine_path is not None:
                    if qfh is None:
                        qfh = aio.open_output(cfg.quarantine_path, "at", domain="sidecar")
                    qfh.write(json.dumps(dict(path=las.path, aread=q_aread,
                                              offset=int(q_off), kind=q_kind,
                                              detail=q_detail)) + "\n")
                    qfh.flush()
                if (q_aread is not None and 0 <= q_aread < len(db.reads)
                        and q_aread not in bad_reads):
                    a = db.read_bases(int(q_aread))
                    stats.n_reads += 1
                    stats.bases_in += len(a)
                    order.append(int(q_aread))
                    ready[int(q_aread)] = [a]
                yield from emit_ready()
                tracer.close(pile_sp, quarantined=True)
                continue
            aread, a_bases, seqs, lens, nsegs = blk
            stats.n_reads += 1
            stats.bases_in += len(a_bases)
            nwin = len(nsegs)
            stats.n_windows += nwin
            order.append(aread)
            if nwin == 0:
                ready[aread] = []
            else:
                pr = pending[aread] = _PendingRead(aread, a_bases, nwin)
                widx = np.arange(nwin, dtype=np.int64)
                shallow = (nsegs < min_depth) if cfg.skip_shallow else np.zeros(nwin, bool)
                n_sh = int(shallow.sum())
                pr.n_done += n_sh
                stats.n_skipped_shallow += n_sh
                if ledger is not None:
                    for wj in np.nonzero(shallow)[0]:
                        ledger.record(aread, int(wj), w, int(nsegs[wj]), -1, -1, False,
                                      "skip", rescued=False, wall_s=0.0, job=job,
                                      mesh=ledger_mesh)
                keep = ~shallow
                seqs, lens, nsegs, widx = seqs[keep], lens[keep], nsegs[keep], widx[keep]
                rid = np.full(len(nsegs), aread, dtype=np.int64)
                if not len(nsegs):
                    if pr.n_done == pr.n_windows:
                        finalize_read(aread, pr)
                else:
                    if paged_on:
                        # family router: the smallest (depth, pages) family
                        # that holds each window
                        pgs = paging.window_pages(lens, cfg.page_len)
                        assign = paging.assign_family(families, nsegs, pgs)
                    else:
                        pgs = np.zeros(len(nsegs), np.int64)
                        assign = route_dense(buckets, nsegs, lens)
                    for bi in range(nb):
                        sel = np.nonzero(assign == bi)[0]
                        if len(sel):
                            Db, Lb = shapes[bi].depth, shapes[bi].seg_len
                            bufs[bi].push((seqs[sel, :Db, :Lb], lens[sel, :Db],
                                              nsegs[sel], rid[sel], widx[sel], pgs[sel]),
                                             stats.n_reads)
            run_batches(final=False)
            yield from emit_ready()
            tracer.close(pile_sp)
        t_final = time.time()
        run_batches(final=True)
        if worker is not None:
            stats.audit_tail = worker.anatomy(t_final)
        yield from emit_ready()
    finally:
        if stager is not None:
            stager.stop()
        path.close()
        if qfh is not None:
            qfh.close()
    stats.wall_s = time.perf_counter() - t_start
    if sup is not None:
        # the governor's rung solves block the host at dispatch time,
        # outside the drain's fetch timer
        stats.device_s += sup.gov_device_s
        stats.degraded = sup.failed_over
        stats.fallback_reason = sup.fail_reason
        gov = sup.governor
        stats.n_capacity_events = gov.counters["classify"]
        stats.governor_ratchet = gov.active_state()
        stats.batch_effective = (min(stats.governor_ratchet.values())
                                 if stats.governor_ratchet else cfg.batch_size)
        stats.audit_s = sup.audit_s
        stats.audit_warm_s = sup.audit_warm_s
        stats.audit_local = sup.audits_local
        stats.audit_disabled = stats.audit_disabled or sup.audit_disabled
        stats.sup_counters = dict(sup.counters)
        stats.audit_send_s = sup.audit_send_s
        stats.audit_send_cpu_s = sup.audit_send_cpu_s
        stats.audit_take_s = sup.audit_take_s
        stats.audit_take_cpu_s = sup.audit_take_cpu_s
        ev_log.log("sup_done", state=sup.state, degraded=sup.failed_over,
                   audit_s=round(sup.audit_s, 4), **sup.counters,
                   **{f"gov_{k}": v for k, v in gov.counters.items()})
    stats.host_s = stats.wall_s - stats.device_s
    # the saturation profiler's end-of-run stamp, computed once from the
    # final walls: the stats, the metrics rollup (and its .prom), the last
    # stage.profile event and shard_done
    _, sat_summ, sat_verdict = saturation()
    stats.feeder_s = round(stats.windowing_s, 4)
    stats.dispatch_s = round(stats.ladder_s, 4)
    walls = None
    if mesh_solver is not None:
        # a mesh dispatch's host walls decompose into pack, stage and launch
        walls = stats.dispatch_walls = mesh_solver.dispatch_walls()
        stats.dispatch_s = round(walls["dispatch_s"], 4)
    stats.stage_profile = sat_summ
    stats.verdict = sat_verdict["verdict"]
    stats.bottleneck = sat_verdict
    hm_final = metrics_snap(final=True)
    stats.mesh_health = hm_final
    metrics.snapshot(ev_log, final=True, **({"mesh": hm_final} if hm_final else {}))
    stats.metrics = metrics.rollup()
    stats.metrics["verdict"] = stats.verdict
    done = dict(
        reads=stats.n_reads, windows=stats.n_windows, solved=stats.n_solved,
        skipped_shallow=stats.n_skipped_shallow, topm_overflow=stats.n_topm_overflow,
        hp_rescued=stats.n_hp_rescued, qv_ranked=stats.qv_ranked,
        bases_out=stats.bases_out, quarantined=stats.n_quarantined,
        ingest_issues=stats.n_ingest_issues, pad_waste=round(stats.pad_waste, 4),
        paged=stats.paged, wall_s=round(stats.wall_s, 3),
        # the anchors tools/trace.py reconciles its span sums against
        device_s=round(stats.device_s, 4), host_s=round(stats.host_s, 4),
        # the saturation profiler's record, tools/prof.py's first source;
        # a mesh run adds its staged dispatch's walls
        stages={k: v["wall_s"] for k, v in sat_summ["stages"].items()},
        stage_threads=sat_summ["threads"], feeder_s=stats.feeder_s,
        dispatch_s=stats.dispatch_s, verdict=stats.verdict, bottleneck=sat_verdict,
        mesh=int(ledger_mesh),
        **({"pack_s": round(walls["pack_s"], 4), "stage_s": round(walls["stage_s"], 4),
            "launch_s": round(walls["launch_s"], 4), "restaged": int(walls["restaged"])}
           if walls is not None else {}),
        tiers=stats.tier_histogram, native=stats.native_host,
        ladder=cfg.ladder_mode, rescue_slots=stats.rescue_slots_executed,
        rescue_windows=stats.n_rescue_windows,
        rescue_density=round(stats.rescue_density, 4),
        capacity_events=stats.n_capacity_events, backpressure=stats.n_backpressure,
        monster_piles=stats.n_monster_piles, batch_effective=stats.batch_effective,
        bases_per_sec=round(stats.bases_per_sec(), 1), degraded=stats.degraded,
        windows_per_sec=round(stats.n_windows / stats.wall_s, 1) if stats.wall_s else 0.0)
    log.log("shard_done", **done)
    if ev_log is not log:
        ev_log.log("shard_done", **done)
    # a finished run closes its span here, not in the unwind, so a trace
    # tells it from an aborted one
    tracer.close(tel.run_span, reads=stats.n_reads, status="done")


def correct_to_fasta(db_path: str, las_path: str, out_path,
                     cfg: PipelineConfig | None = None,
                     start: int | None = None, end: int | None = None,
                     profile: ErrorProfile | None = None, solver=None) -> PipelineStats:
    """Run the pipeline over ``[start, end)`` of the LAS and write the
    corrected fragments as FASTA (``-`` = stdout); records are named
    ``read<id>/<fragment>``. ``solver`` is :func:`correct_shard`'s (e.g. a
    ``parallel.mesh`` sharded solver). The data kinds of ``DACCORD_FAULT``
    corrupt the inputs first (as in the JAX package). Under the quarantine
    policy the sidecar defaults to ``<out>.quarantine.jsonl`` and starts
    fresh, as a ledger does."""
    from .faults import maybe_apply_data_faults

    cfg = cfg or PipelineConfig()
    fired = maybe_apply_data_faults(las_path=las_path, db_path=db_path)
    if fired and cfg.events_path:
        with JsonlLogger(cfg.events_path) as fl:
            for f in fired:
                fl.log("ingest.fault", kind=f["kind"], path=f["path"],
                       record=f["record"], offset=f.get("offset", -1))
    if cfg.ingest_policy == "quarantine":
        if cfg.quarantine_path is None and isinstance(out_path, str) and out_path != "-":
            cfg = replace(cfg, quarantine_path=out_path + ".quarantine.jsonl")
        if cfg.quarantine_path and os.path.exists(cfg.quarantine_path):
            os.remove(cfg.quarantine_path)
    if cfg.ledger_path and os.path.exists(cfg.ledger_path):
        os.remove(cfg.ledger_path)
    t0 = time.perf_counter()
    # only the strict policy aborts on a corrupt DB read record; quarantine
    # contains it through db.bad_reads, and off trusts the input
    db = read_db(db_path, strict=cfg.ingest_policy == "strict")
    las = LasFile(las_path)
    stats = PipelineStats()
    recs = []
    for rid, frags, st in correct_shard(db, las, cfg, start, end, profile=profile,
                                        solver=solver):
        stats = st
        for fi, f in enumerate(frags):
            recs.append(FastaRecord(f"read{rid}/{fi}", ints_to_seq(f)))
    write_fasta(sys.stdout if out_path == "-" else out_path, recs)
    stats.wall_s = time.perf_counter() - t0
    return stats
