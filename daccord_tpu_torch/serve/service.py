"""ConsensusService: the always-on serving core behind ``serve``.

The port's copy of the JAX package's ``serve/service.py``.

Owns the job registry, a bounded worker pool draining the admission queue,
the warm solve-group cache, and a ticker thread doing the housekeeping a
long-lived server needs: stale cross-job pools flush (latency bound), RSS
pressure drives the shed ladder (group batch widths halve under sustained
pressure, restore when it clears), idle groups evict, and the metrics
registry snapshots into the service events sidecar at a bounded cadence.

Telemetry layout (one file per concern, so the strict eventcheck state
machines never interleave):

    <workdir>/serve.events.jsonl      serve.* lifecycle + metrics snapshots
    <workdir>/g<N>.events.jsonl       each solve group's supervisor/governor
                                      stream (sup_*, governor.*, serve.batch)
    <workdir>/jobs/<id>/events.jsonl  the job's own pipeline telemetry
                                      (shard_start, spans, shard_done)
    <workdir>/jobs/<id>/ledger.jsonl  per-window outcome ledger, job-tagged
    <workdir>/journal.jsonl           write-ahead job journal:
                                      NOT an events file — fsync'd
                                      lifecycle records replayed at
                                      restart (serve/journal.py); mirrored
                                      into serve.events as serve.journal
    <workdir>/jobs/<id>/progress.json per-job pipeline checkpoint (the
                                      replay/takeover resume point)

All of it passes ``eventcheck --strict``.

Latency is a first-class metric here: per-job
queue/first-result/total latencies feed histograms whose p50/p95/p99 ride
every metrics snapshot and the durable rollup committed at shutdown.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
from dataclasses import dataclass, field

from ..utils.obs import JsonlLogger, MetricsRegistry
from .admission import AdmissionConfig, AdmissionController
from .batcher import GroupConfig, SolveGroup
from .jobs import ABORTED, DONE, FAILED, QUEUED, RUNNING, Job, JobSpec, run_job
from .state import WarmState


class _LockedLogger(JsonlLogger):
    """JsonlLogger safe for concurrent writers (HTTP threads, workers, the
    ticker): the timestamp is taken and the line buffered under one lock, so
    ``t`` stays monotonic per file — the strict eventcheck contract."""

    def __init__(self, path: str | None = None, **kw):
        super().__init__(path, **kw)
        self._wlock = threading.Lock()

    def log(self, event: str, **fields) -> None:
        with self._wlock:
            super().log(event, **fields)

    def close(self) -> None:
        with self._wlock:
            super().close()


@dataclass
class ServeConfig:
    workdir: str = "daccord-serve"
    backend: str = "native"          # resolved engine (native|cpu|cuda)
    backend_explicit: bool = True    # the operator named it (hp default rule)
    batch: int = 512                 # merged dispatch width
    workers: int = 2                 # concurrent job threads
    ladder_mode: str = "fused"       # fused | split (ladder groups only)
    paged: bool = False              # paged wire format for merged batches
    page_len: int = 16
    dp_route: str = "fused"          # the groups' heaviest-path route (fused |
                                     # scan; bit-identical)
    flush_lag_s: float = 0.05        # stale cross-job pool flush deadline
    idle_evict_s: float = 600.0      # warm-group TTL
    job_retention_s: float = 3600.0  # terminal jobs leave the in-memory
                                     # registry (and GET /v1/jobs) this long
                                     # after finishing; durable results stay
                                     # on disk under jobs/<id>/. 0 = keep
                                     # forever (tests); an always-on server
                                     # must bound registry growth
    metrics_snapshot_s: float = 30.0
    shed_max_levels: int = 3         # batch-ladder floor under pressure
    # SLO burn tracking: rolling p99 job latency over
    # slo_window_s compared against the p99 target. burn = p99/target;
    # crossing slo_shed_burn drives the batch-width shed ladder BEFORE the
    # target is breached (burn >= 1 is the breach the sentinel flags), and
    # dropping below slo_clear_burn releases the slo-held shed rung.
    # 0 = tracking off.
    slo_p99_s: float = 0.0
    slo_window_s: float = 60.0
    slo_shed_burn: float = 0.8
    slo_clear_burn: float = 0.5
    # the crash-durable tier: the write-ahead job journal + per-job
    # pipeline checkpoints + (optional) peer lease takeover
    journal: bool = True             # fsync'd WAL under <workdir>/journal.jsonl
    checkpoint_reads: int = 16       # per-job progress checkpoint stride
                                     # (emitted reads between durable
                                     # progress manifests; 0 = off — a
                                     # replayed job then re-runs from its
                                     # first read, still byte-identical)
    peer_dir: str | None = None      # shared-FS root for per-job lease files
                                     # (leases/ beneath it): serve processes
                                     # pointing at the SAME peer_dir form a
                                     # takeover group — any of them finishes
                                     # a dead peer's journaled jobs. None =
                                     # solo durability (journal replay only).
                                     # Peers' WORKDIR BASENAMES must be
                                     # unique within a group (the stable
                                     # lease namespace); a live collision is
                                     # refused at submit (lease_conflict)
    peer_name: str = ""              # lease holder identity; default
                                     # <workdir-basename>:<pid>
    lease_ttl_s: float = 15.0        # older per-job lease is stale (takeover)
    heartbeat_s: float = 1.0         # lease renewal + takeover-scan cadence
    aot_dir: str | None = None       # the fleet-shared kernel cache
                                     # (serve/aotcache.py): a cuda service
                                     # installs the nvcc-built kernels from it
                                     # (or builds and publishes them) before
                                     # it reports ready; the serve CLI
                                     # defaults it to $DACCORD_AOT_CACHE or
                                     # <peer_dir>/aotcache
    audit_rate: float | None = None  # sampled shadow verification for the
                                     # solve groups; None = env
                                     # DACCORD_AUDIT_RATE (1/64), 0 = off
    drain_deadline_s: float = 0.0    # bounded graceful shutdown: >0 means a
                                     # drain that outlives this many seconds
                                     # journal-marks in-flight jobs
                                     # INTERRUPTED (resumable on restart)
                                     # and shutdown reports unclean (the
                                     # serve CLI exits nonzero). 0 = legacy
                                     # unbounded-ish drain (timeout_s)
    # the disk-pressure governor. The free-bytes admission
    # watermarks live on AdmissionConfig (disk_soft_mb / disk_hard_mb);
    # watch_dir defaults to the serve workdir at construction.
    journal_compact_mb: float = 64.0 # ONLINE journal compaction triggers
                                     # when journal.jsonl reaches this size
                                     # (or the hard free-space watermark
                                     # fires): the restart-only compaction
                                     # without the restart, so a filling
                                     # volume is relieved by the journal's
                                     # own garbage. 0 = size trigger off
    lease_grace_beats: int = 3       # consecutive failed lease renewals
                                     # (EIO-class, real or injected)
                                     # tolerated before a holder self-
                                     # demotes: one shared-FS hiccup must
                                     # not abort healthy in-flight work,
                                     # but a holder that cannot prove
                                     # liveness for this many heartbeats
                                     # stands down before the TTL lets a
                                     # peer steal the lease mid-commit
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    events_path: str | None = None   # default: <workdir>/serve.events.jsonl

    def group_ladder_mode(self) -> str:
        # the native engine escalates per window on the host: stream routing
        # (and paging) are the ladder's
        return "fused" if self.backend == "native" else self.ladder_mode


class ConsensusService:
    def __init__(self, cfg: ServeConfig):
        from ..runtime.faults import FaultPlan

        self.cfg = cfg
        os.makedirs(cfg.workdir, exist_ok=True)
        os.makedirs(os.path.join(cfg.workdir, "jobs"), exist_ok=True)
        if not cfg.admission.watch_dir:
            # the free-bytes watermarks read the serve volume by default
            # (they stay off until disk_soft_mb/disk_hard_mb are set)
            cfg.admission.watch_dir = cfg.workdir
        ev = cfg.events_path or os.path.join(cfg.workdir,
                                             "serve.events.jsonl")
        self.events = _LockedLogger(ev, buffer_lines=16, flush_s=1.0)
        self.metrics = MetricsRegistry()
        self.faults = FaultPlan.from_env()
        self.admission = AdmissionController(cfg.admission, log=self.events,
                                             faults=self.faults)
        self.warm = WarmState(cfg.idle_evict_s, log=self.events)
        self.jobs: dict[str, Job] = {}
        self._jobs_lock = threading.Lock()
        # the crash-durable tier: stable service identity (lease file
        # namespace + foreign job keys), the per-job lease registry, and the
        # client idempotency-key map (rebuilt from the journal at replay)
        import socket

        self.service_id = os.path.basename(
            os.path.abspath(cfg.workdir)) or "serve"
        # holder identity includes the hostname (fleet convention): two
        # hosts' processes must never read each other's leases as their own
        # — `still_owns` is the double-commit gate and keys on this string
        self.peer = cfg.peer_name or \
            f"{self.service_id}@{socket.gethostname()}:{os.getpid()}"
        self._lease_lock = threading.Lock()
        self._owned_leases: dict[str, str] = {}   # job id -> lease path
        self._lease_grace: dict[str, int] = {}    # job id -> consecutive
                                                  # failed renew beats
        self._idem: dict[str, str | None] = {}    # idem key -> job id
        # the front door: the announce lease (peer discovery for the
        # router — <peer_dir>/peers/<service_id>.lease carrying our URL),
        # readiness (journal replay finished AND no group build in flight),
        # and the tenant -> group-key map behind the evict-vs-route guard
        self._announce_url: str | None = None
        self._announce_path: str | None = None
        self._replay_done = not cfg.journal
        self._tenant_keys: dict[str, set] = {}
        self.clean = True                         # last shutdown's verdict
        # resume the id sequence past any job dirs already in the (durable)
        # workdir — or named by the journal (a post-admit crash can journal
        # an id whose spool dir never landed): a restarted server must never
        # reuse jNNNNN — the old run's committed out.fasta would be served
        # as (or clobbered by) the new job's
        last = 0
        for name in os.listdir(os.path.join(cfg.workdir, "jobs")):
            if name.startswith("j") and name[1:].isdigit():
                last = max(last, int(name[1:]))
        self._journal_path = os.path.join(cfg.workdir, "journal.jsonl")
        replayed = {}
        torn = 0
        if cfg.journal:
            from .journal import replay as journal_replay

            replayed, torn = journal_replay(self._journal_path)
            for jid in replayed:
                short = jid.rsplit(".", 1)[-1]
                if short.startswith("j") and short[1:].isdigit():
                    last = max(last, int(short[1:]))
        self._job_ids = itertools.count(last + 1)
        self._group_ids = itertools.count(0)
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._shed = 0
        # SLO burn state: finished-job latencies inside the
        # rolling window, the slo-held shed rung, and the last emitted burn
        # band (serve.slo emits on band changes, not every tick)
        from collections import deque

        self._lat_window: deque = deque()
        # guards window iteration in _slo_tick against concurrent worker
        # appends (deque append is atomic; iterating one mid-append raises)
        self._lat_lock = threading.Lock()
        self._slo_shed = 0
        self._slo_band: int | None = None
        self._slo_burn_last = 0.0    # last computed burn (healthz: the
                                     # router's spill + autoscaler signal)
        # lifetime peaks: the rollup must answer "how
        # bad did it GET", not just "how bad is it now"
        self._peak_rss_mb = 0.0
        self._peak_queue_depth = 0
        # the disk-pressure governor's state: what latched the 507
        # state (journal refusal vs free-bytes watermark) and the online-
        # compaction rate limiter
        self._disk_latch_src: str | None = None
        self._last_compact = 0.0
        # the saturation profiler: the serve-plane verdict denominator
        # is DEMAND wall (ticker-sampled time with >= 1 job queued/running),
        # not uptime — an always-on server that simply has no traffic is
        # balanced, not host_feeder-starved
        self._demand_s = 0.0
        self._last_demand_tick = time.time()
        self._verdict = "balanced"
        self.started_ts = time.time()
        self.log_event("serve.start", workdir=cfg.workdir,
                       backend=cfg.backend, batch=int(cfg.batch),
                       workers=int(cfg.workers), pid=os.getpid())
        if cfg.aot_dir and cfg.backend == "cuda":
            # the ladder's kernels before the first job and before readiness:
            # installed from the fleet's cache, or built here and published
            from .aotcache import prepare_kernels

            prepare_kernels(cfg.aot_dir, log=self.events)
        # the write-ahead journal opens AFTER replay folded (and compacted)
        # the previous incarnation's records — compaction rewrites the file
        # via rename, so it must finish before the append fd is taken
        self.journal = None
        if cfg.journal:
            from .journal import JobJournal, compact

            compact(self._journal_path, replayed)
            self.journal = JobJournal(self._journal_path, faults=self.faults)
            self._replay(replayed, torn)
        self._replay_done = True
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"daccord-serve-worker-{i}")
            for i in range(max(1, cfg.workers))]
        for t in self._workers:
            t.start()
        self._ticker = threading.Thread(target=self._tick_loop, daemon=True,
                                        name="daccord-serve-ticker")
        self._ticker.start()

    # ------------------------------------------------------------------
    # plumbing used by jobs.run_job
    # ------------------------------------------------------------------

    def log_event(self, event: str, **fields) -> None:
        self.events.log(event, **fields)

    def build_group(self, key: str, profile, cfg) -> SolveGroup:
        """Factory handed to WarmState.acquire: one solve group with its
        own events sidecar (the strict state-machine lint needs one
        supervisor stream per file)."""
        scfg = self.cfg
        name = f"g{next(self._group_ids)}"
        glog = _LockedLogger(os.path.join(scfg.workdir,
                                          f"{name}.events.jsonl"),
                             buffer_lines=16, flush_s=1.0)
        gcfg = GroupConfig(backend=scfg.backend, batch=scfg.batch,
                           ladder_mode=scfg.group_ladder_mode(),
                           paged=scfg.paged and scfg.backend != "native",
                           page_len=scfg.page_len, dp_route=scfg.dp_route,
                           shed_levels=self._shed,
                           audit_rate=scfg.audit_rate, aot_dir=scfg.aot_dir)
        g = SolveGroup(key, profile, cfg, gcfg, log=glog, name=name)
        self.log_event("serve.group", group=name, key=key[:16],
                       backend=scfg.backend, batch=int(scfg.batch))
        return g

    def note_tenant_key(self, tenant: str, key: str) -> None:
        """Record that ``tenant``'s jobs solve on group ``key`` (called by
        run_job at acquire time) and stamp the route — the tenant→warmth
        map behind the evict-vs-route guard."""
        with self._jobs_lock:
            self._tenant_keys.setdefault(tenant, set()).add(key)
        self.warm.note_route(key)

    def observe_latency(self, job: Job) -> None:
        """Per-job latency histograms (p50/p95/p99 ride the snapshots)."""
        h = self.metrics.histogram
        if job.started_ts:
            h("job_queue_s").observe(job.started_ts - job.submitted_ts)
        if job.first_emit_ts:
            h("job_first_result_s").observe(
                job.first_emit_ts - job.submitted_ts)
        if job.done_ts:
            h("job_latency_s").observe(job.done_ts - job.submitted_ts)
            if self.cfg.slo_p99_s:
                # rolling SLO window (pruned by the ticker's slo pass)
                with self._lat_lock:
                    self._lat_window.append(
                        (job.done_ts, job.done_ts - job.submitted_ts))
        if job.done_ts and job.windows and job.started_ts:
            run_s = max(job.done_ts - job.started_ts, 1e-9)
            self.metrics.gauge("last_job_windows_per_sec").set(
                job.windows / run_s)

    # ------------------------------------------------------------------
    # crash durability: journal, replay, per-job leases
    # ------------------------------------------------------------------

    def journal_mark(self, rec: str, job_id: str, **fields) -> None:
        """Durably append one lifecycle record (no-op with the journal off)
        and mirror it into the events stream (``serve.journal``) + the
        ``journal_records`` counter, so recovery is observable without
        reading the journal file itself.

        A disk refusal (ENOSPC/EIO, real or injected) never raises — the
        appenders are HTTP threads, workers, and the ticker. It is counted,
        surfaced as an ``io.fault`` event, and latches the admission
        ``disk_pressure`` state (507-style refusals) until the volume
        proves writable again (``_disk_tick``'s probe)."""
        j = self.journal   # racing shutdown's None-swap: read once
        if j is None:
            return
        before = j.append_failures
        if not j.append(rec, job_id, **fields):
            if j.append_failures > before:
                # a disk refusal, not the closed-fd shutdown-drain window
                self.log_event("io.fault", domain="journal", op="append",
                               error=str(j.last_error or "?")[:200])
                self.metrics.counter("journal_append_failures").inc()
                self._enter_disk_pressure(
                    "journal", j.last_error or "append refused")
            return
        self.metrics.counter("journal_records").inc()
        self.log_event("serve.journal", rec=rec, job=job_id)

    def _lease_file(self, job_id: str) -> str | None:
        """The per-job lease path under the peer dir (None with takeover
        off). Local ids (jNNNNN) are namespaced by this service's identity;
        a foreign key (``<service>.<jobid>``, from a takeover) already is."""
        if not self.cfg.peer_dir:
            return None
        key = job_id if "." in job_id else f"{self.service_id}.{job_id}"
        return os.path.join(self.cfg.peer_dir, "leases", f"{key}.lease")

    def _claim_job_lease(self, job, nbytes: int,
                         idem: str | None = None) -> bool:
        """Claim (or re-claim) the job's lease with the full job descriptor
        as payload, so a peer takeover is self-contained — the taker needs
        nothing from this process but the lease file and the shared-FS
        jobdir. Returns False ONLY when a live claim race was lost (a peer
        owns the job now); True with takeover off (no lease to lose)."""
        import dataclasses

        from ..utils import lease

        path = self._lease_file(job.id)
        if path is None:
            return True
        short = job.id.rsplit(".", 1)[-1]
        svc = job.id.rsplit(".", 1)[0] if "." in job.id else self.service_id
        extra = {"service": svc, "job": short,
                 "jobdir": os.path.abspath(job.dir),
                 "tenant": job.tenant, "nbytes": int(nbytes),
                 "spec": dataclasses.asdict(job.spec), "idem": idem}
        ok, _ = lease.claim(path, self.peer, self.cfg.lease_ttl_s,
                            extra=extra)
        if ok:
            with self._lease_lock:
                self._owned_leases[job.id] = path
        return ok

    def still_owns(self, job_id: str) -> bool:
        """Pre-commit ownership re-check (the fencing-free protocol's last
        gate): True when this process still holds the job's lease — or
        takeover is off entirely. A long GIL-bound solve can stall the
        heartbeat past the TTL; if a peer claimed the lease meanwhile, the
        PEER owns the commit and the runner must stand down rather than
        double-commit (the sub-heartbeat window that remains is the
        protocol's documented inherent race, now read-to-rename instead of
        solve-length)."""
        if not self.cfg.peer_dir:
            return True
        from ..utils import lease

        path = self._lease_file(job_id)
        info, lstat = lease.read_result(path)
        for i in range(3):
            # an EIO-class read hiccup here is NOT ownership loss — failing
            # the gate on it would strand a finished solve (stand down with
            # no taker to finish the job). Bounded re-read, like the
            # heartbeat's renewal grace; absent/torn/foreign stay decisive.
            if lstat != "error":
                break
            time.sleep(0.01 * (2 ** i))
            info, lstat = lease.read_result(path)
        return info is not None and info.get("host") == self.peer

    def release_job_lease(self, job_id: str) -> None:
        """Holder-checked release of a finished job's lease (no-op when we
        hold none — e.g. solo mode, or ownership already lost to a taker)."""
        from ..utils import lease

        with self._lease_lock:
            path = self._owned_leases.pop(job_id, None)
        self._lease_grace.pop(job_id, None)
        if path is not None:
            lease.release(path, host=self.peer)

    def _durable_status(self, job_id: str) -> dict | None:
        """A committed job's status straight from its durable manifest —
        how an idempotent resubmission is answered after the in-memory
        registry pruned (or never held, across a restart) the job."""
        p = os.path.join(self.cfg.workdir, "jobs", job_id, "manifest.json")
        try:
            with open(p) as fh:
                st = json.load(fh)
        except (OSError, json.JSONDecodeError):
            return None
        return st if isinstance(st, dict) else None

    def _replay(self, entries: dict, torn: int) -> None:
        """Fold the previous incarnation's journal back into live state
        (called once, before the workers start):

        - terminal jobs contribute their idempotency keys only;
        - orphans whose jobdir already holds a committed manifest (a peer
          — or the pre-crash rename — finished them) are journal-marked
          committed, never re-run;
        - a ``committing`` orphan whose part file matches the recorded
          byte count is FINISHED in place (rename + manifest), no recompute;
        - an orphan whose lease a live peer holds becomes a *watch* job
          (the peer is running it; the ticker flips it DONE when the
          manifest lands, or re-admits it if the lease goes stale);
        - every other orphan is re-admitted through the NORMAL quota path
          (an admission refusal journals ``failed``) and re-queued,
          resuming from its per-job checkpoint.
        """
        from ..utils import lease
        from ..utils.aio import durable_write
        from .jobs import JobSpec

        n_orphan = n_finished = n_watch = n_failed = 0
        for e in entries.values():
            if e.terminal:
                if e.idem:
                    self._idem[e.idem] = e.job
                continue
            if e.idem:
                self._idem[e.idem] = e.job
            jobdir = e.dir or os.path.join(self.cfg.workdir, "jobs", e.job)
            manifest = os.path.join(jobdir, "manifest.json")
            part = os.path.join(jobdir, "out.fasta.part")
            def _register_done(entry, jdir):
                # recovered-to-done jobs join the registry so clients keep
                # GETting status/result across the restart (pruned on the
                # normal retention schedule)
                if entry.spec is None:
                    return
                sp = JobSpec(**entry.spec)
                sp.nbytes = entry.nbytes
                jb = Job(id=entry.job, tenant=entry.tenant, spec=sp,
                         dir=jdir, state=DONE)
                jb.done_ts = time.time()
                jb.settled.set()
                with self._jobs_lock:
                    self.jobs.setdefault(entry.job, jb)

            if os.path.exists(manifest):
                # finished by a peer (or this process, pre-crash): the
                # durable commit is the truth — record it, never re-run.
                # A NON-terminal entry means the committer died between its
                # serve.commit flush-through and the committed journal
                # append (or a peer committed): re-emit the recovery form
                # (fragments=-1) so every done job keeps >= 1 commit event
                # — terminal entries already logged theirs (event-before-
                # journal ordering in run_job), so re-emitting would double
                self.journal_mark("committed", e.job, by="manifest")
                try:
                    fb = int(json.load(open(manifest)).get("fasta_bytes", 0))
                except (OSError, json.JSONDecodeError, ValueError,
                        TypeError):
                    fb = 0
                self.log_event("serve.commit", job=e.job, fragments=-1,
                               bytes=fb)
                _register_done(e, jobdir)
                n_finished += 1
                continue
            if e.spec is None:
                self.journal_mark("failed", e.job, error="replay: no spec")
                n_failed += 1
                continue
            spec = JobSpec(**e.spec)
            spec.nbytes = e.nbytes
            job = Job(id=e.job, tenant=e.tenant, spec=spec, dir=jobdir)
            lp = self._lease_file(e.job)
            if lp is not None:
                info = lease.read(lp)
                age = lease.stale_s(lp)
                fresh_foreign = (info is not None
                                 and info.get("host") != self.peer
                                 and age is not None
                                 and age <= self.cfg.lease_ttl_s)
                # exactly-once gate — BEFORE any recovery action, including
                # the mid-commit finalize below: the lease CLAIM decides who
                # recovers the orphan. A fresh foreign lease, or losing the
                # claim race on a stale one to a peer mid-takeover, means
                # the job is someone else's now: watch their manifest,
                # never run (or finalize) it ourselves.
                if fresh_foreign or not self._claim_job_lease(
                        job, e.nbytes, idem=e.idem):
                    job.state, job.watch = RUNNING, True
                    with self._jobs_lock:
                        self.jobs[e.job] = job
                    n_watch += 1
                    continue
            if e.part_name:
                # attempts write private part files; the committing record
                # names the one whose bytes are fsync'd
                part = os.path.join(jobdir, e.part_name)
            part_ok = (e.state == "committing" and os.path.exists(part)
                       and os.path.getsize(part) >= e.part_bytes
                       and e.part_bytes > 0)
            if part_ok and e.part_sha:
                # content verification: the journaled committing
                # digest must match the fsync'd prefix on disk — a part file
                # silently corrupted between crash and recovery falls
                # through to orphan re-admission (re-solve), never to a
                # publishing rename of wrong bytes
                from ..utils.obs import sha256_file

                if sha256_file(part, limit=e.part_bytes) != e.part_sha:
                    self.log_event(
                        "io.fault", domain="manifest", op="finalize",
                        error=f"job {e.job}: part digest mismatches the "
                              "journaled committing record"[:200])
                    part_ok = False
            if part_ok:
                # the crash landed between the FASTA fsync and the
                # publishing rename: every byte is durable — finish the
                # commit in place, byte-identical, zero recompute
                os.truncate(part, e.part_bytes)
                fasta = os.path.join(jobdir, "out.fasta")
                os.replace(part, fasta)
                durable_write(manifest,
                              lambda mh, j=e.job, f=fasta: json.dump(
                                  {"job": j, "state": "done", "fasta": f,
                                   "fasta_bytes": os.path.getsize(f),
                                   "recovered": True}, mh),
                              mode="wt", domain="manifest")
                self.journal_mark("committed", e.job, by="replay")
                self.log_event("serve.commit", job=e.job, fragments=-1,
                               bytes=os.path.getsize(fasta))
                self.release_job_lease(e.job)
                _register_done(e, jobdir)
                n_finished += 1
                continue
            try:
                self.admission.admit(e.tenant, e.nbytes, job=e.job)
            except Exception as exc:
                if lp is not None:
                    # same rule as the takeover scan: no headroom here
                    # means hand the lease back for a peer WITH headroom —
                    # a quota-tight restart must not convert recoverable
                    # orphans into permanent failures
                    self.release_job_lease(e.job)
                    job.state, job.watch = RUNNING, True
                    with self._jobs_lock:
                        self.jobs[e.job] = job
                    n_watch += 1
                    continue
                self.journal_mark("failed", e.job,
                                  error=f"replay admission: {exc}"[:200])
                n_failed += 1
                continue
            with self._jobs_lock:
                self.jobs[e.job] = job
            self.journal_mark("replayed", e.job)
            self.metrics.counter("replay_orphans").inc()
            n_orphan += 1
            self._queue.put(e.job)
        if entries or torn:
            self.log_event("serve.replay", jobs=len(entries),
                           orphans=n_orphan, finished=n_finished,
                           watch=n_watch, failed=n_failed, torn=torn)

    # ------------------------------------------------------------------
    # front-end API (HTTP layer calls these)
    # ------------------------------------------------------------------

    @staticmethod
    def _estimate_bytes(body: dict) -> int:
        """Admission charge for a submission BEFORE anything is spooled or
        scanned: path inputs by on-disk size, uploads by decoded base64
        size. Admission must run on this estimate first — spooling or
        scanning an over-quota tenant's input would let rejected requests
        burn disk and CPU the quota exists to protect. A Dazzler ``.db``
        is a tiny stub whose real payload lives in the hidden
        ``.<name>.idx``/``.bps`` siblings — charge those too, or a
        multi-GB DB would bill as a few hundred bytes and the byte quota
        would be toothless."""
        files = body.get("files")
        if isinstance(files, dict):
            return sum(len(v) * 3 // 4 for v in files.values()
                       if isinstance(v, str))
        n = 0
        for key in ("db", "las"):
            p = body.get(key)
            if not isinstance(p, str):
                continue
            if not os.path.exists(p) and os.path.exists(p + ".db"):
                p = p + ".db"
            if os.path.exists(p):
                n += os.path.getsize(p)
            if key == "db":
                from ..formats.dazzdb import _db_stems

                try:
                    d, stem = _db_stems(p)
                except Exception:
                    continue
                for ext in (".idx", ".bps", ".names"):
                    h = os.path.join(d, f".{stem}{ext}")
                    if os.path.exists(h):
                        n += os.path.getsize(h)
        return n

    def submit(self, body: dict) -> dict:
        """Admit + enqueue one job; returns its status dict. Raises
        ValueError (bad spec / failed ingest validation → 400) or
        AdmissionReject (→ 429/503). Admission is charged FIRST, on the
        pre-spool byte estimate; any later refusal releases the charge and
        removes the job's spool directory, so rejected requests leave no
        disk residue.

        ``idempotency_key``: a client that lost its connection
        mid-submit (the server crashed after journaling ADMITTED but before
        answering) retries with the same key and gets the EXISTING job —
        whatever state it reached, including done — instead of a second
        run. The key rides the journal, so dedupe survives restarts."""
        if not isinstance(body, dict):
            raise ValueError("body must be a JSON object")
        body = dict(body)
        idem = body.pop("idempotency_key", None)
        if idem is not None and (not isinstance(idem, str) or not idem):
            raise ValueError("idempotency_key must be a non-empty string")
        if idem is not None:
            from .admission import AdmissionReject

            with self._jobs_lock:
                seen = self._idem.get(idem, "")
                if seen is None:
                    # a concurrent submit with the same key is mid-admission
                    raise AdmissionReject("idempotent_in_flight",
                                          f"key {idem!r} is being admitted",
                                          retryable=True)
                if not seen:
                    self._idem[idem] = None   # reserve
            if seen:
                # outside the jobs lock: status() takes it too
                st = self.status(seen) or self._durable_status(seen)
                if st is not None:
                    self.metrics.counter("idempotent_hits").inc()
                    return {**st, "idempotent": True}
                # journaled key whose job left no trace (failed replay):
                # run it fresh under the same key. Compare-and-set the
                # reservation — two concurrent traceless retries must not
                # both win (the loser gets the retryable 429)
                with self._jobs_lock:
                    if self._idem.get(idem) != seen:
                        raise AdmissionReject(
                            "idempotent_in_flight",
                            f"key {idem!r} is being admitted",
                            retryable=True)
                    self._idem[idem] = None
        try:
            return self._submit_new(body, idem)
        except BaseException:
            if idem is not None:
                with self._jobs_lock:
                    if self._idem.get(idem) is None:
                        del self._idem[idem]
            raise

    def _submit_new(self, body: dict, idem: str | None) -> dict:
        job_id = f"j{next(self._job_ids):05d}"
        jobdir = os.path.join(self.cfg.workdir, "jobs", job_id)
        tenant = str(body.get("tenant", "default"))
        charged = self._estimate_bytes(body)
        self.admission.admit(tenant, charged, job=job_id)
        try:
            spec = JobSpec.from_json(body, jobdir)
            # release() must mirror the admitted charge exactly
            spec.nbytes = charged
            # the ingest gate AT ADMISSION: a strict-policy job with
            # integrity violations is refused here with the structured
            # report — it never reaches a worker
            if spec.ingest_policy == "strict":
                from ..formats.dazzdb import read_db
                from ..formats.ingest import IngestError, scan_with_db
                from ..formats.las import LasFile

                try:
                    rep = scan_with_db(read_db(spec.db, strict=True),
                                       LasFile(spec.las), None, None)
                except (IngestError, ValueError, OSError) as e:
                    raise ValueError(f"ingest validation failed: {e}")
                if rep.issues:
                    first = rep.issues[0]
                    raise ValueError(
                        f"ingest validation: {len(rep.issues)} issue(s); "
                        f"first: {first.kind} at byte {first.offset}")
        except Exception:
            import shutil

            self.admission.release(tenant, charged)
            shutil.rmtree(jobdir, ignore_errors=True)
            raise
        os.makedirs(jobdir, exist_ok=True)
        job = Job(id=job_id, tenant=tenant, spec=spec, dir=jobdir)
        with self._jobs_lock:
            self.jobs[job_id] = job
            if idem is not None:
                self._idem[idem] = job_id
        # WRITE-AHEAD: the admitted record (spec + charge + idempotency
        # key) is durable before the job is queued or the client answered —
        # a crash from here on is recoverable by replay
        import dataclasses

        self.journal_mark("admitted", job_id, tenant=tenant,
                          nbytes=int(spec.nbytes),
                          spec=dataclasses.asdict(spec),
                          dir=os.path.abspath(jobdir), idem=idem)
        if not self._claim_job_lease(job, spec.nbytes, idem=idem):
            # a FRESH job's lease already exists and is live: another
            # service in the peer group shares our workdir basename (the
            # lease namespace) and minted the same id. Running unleased
            # would dodge every exactly-once gate — refuse loudly instead;
            # the operator must give peers distinct workdir basenames.
            from .admission import AdmissionReject

            import shutil

            with self._jobs_lock:
                self.jobs.pop(job_id, None)
                if idem is not None and self._idem.get(idem) == job_id:
                    del self._idem[idem]
            self.admission.release(tenant, spec.nbytes)
            # the refused job's spool is OURS (the holder has its own
            # workdir) — keeping it would strand tenant bytes forever
            shutil.rmtree(jobdir, ignore_errors=True)
            self.journal_mark("failed", job_id, error="lease conflict")
            raise AdmissionReject(
                "lease_conflict",
                f"lease for {self.service_id}.{job_id} is held by another "
                "service — peer-group workdir basenames must be unique",
                retryable=False)
        self.metrics.counter("jobs_submitted").inc()
        # the evict-vs-route guard: a submit IS a route landing —
        # stamp every group key this tenant has solved on, so the idle
        # sweep cannot evict the group the router's stickiness sent this
        # job to while its profile/fingerprint is still being computed
        with self._jobs_lock:
            keys = list(self._tenant_keys.get(tenant, ()))
        for k in keys:
            self.warm.note_route(k)
        self.log_event("serve.job", job=job_id, state=QUEUED,
                       tenant=spec.tenant)
        self._queue.put(job_id)
        return job.status()

    def status(self, job_id: str) -> dict | None:
        with self._jobs_lock:
            job = self.jobs.get(job_id)
        return None if job is None else job.status()

    def abort(self, job_id: str, reason: str = "client") -> bool:
        with self._jobs_lock:
            job = self.jobs.get(job_id)
        if job is None or job.state in (DONE, FAILED, ABORTED):
            return False
        if job.watch:
            # a peer owns and runs this job: an abort here could not stop
            # it (and setting the local abort_event would be silently
            # dropped on a takeover reclaim) — refuse honestly (409)
            # rather than claim an abort nothing will honor
            return False
        job.abort_event.set()
        # a QUEUED job aborts synchronously: its quota charge releases NOW
        # (a tenant cancelling its backlog must get its slots back without
        # waiting for a worker to churn to each cancelled job) — the
        # worker loop skips already-terminal jobs when it dequeues them
        with self._jobs_lock:
            was_queued = job.state == QUEUED
            if was_queued:
                job.state = ABORTED
                job.done_ts = time.time()
        if was_queued:
            self.admission.release(job.tenant, job.spec.nbytes)
            self.metrics.counter("jobs_aborted").inc()
            self.journal_mark("aborted", job_id, reason=reason)
            self.release_job_lease(job_id)
            job.settled.set()
        # otherwise outcome counting happens ONCE in the worker loop
        # (jobs_<state>); counting the request here too would double-bill
        self.log_event("serve.abort", job=job_id, reason=reason)
        return True

    def wait(self, job_id: str, timeout_s: float = 300.0) -> dict | None:
        """Wait for a job to reach a terminal state with its effects done
        (``Job.settled``: its quota, group and lease released, its latency
        observed), at most ``timeout_s`` (HTTP ``?wait=1``). Returns the
        status then, or the status at the timeout; None for an unknown
        job."""
        deadline = time.time() + timeout_s
        while True:
            with self._jobs_lock:
                job = self.jobs.get(job_id)
            if job is None:
                return None
            if job.state in (DONE, FAILED, ABORTED) and job.settled.is_set():
                return job.status()
            left = deadline - time.time()
            if left <= 0:
                return job.status()
            # a watch job turns terminal on the ticker without a run here:
            # look at the state again at least every 50 ms
            job.settled.wait(min(left, 0.05))

    def health(self) -> dict:
        """Liveness snapshot that takes NO SolveGroup lock: the group lock
        is held across real device solves (a cold first batch builds the
        kernels), and a liveness probe that queued behind it would
        time out and get a perfectly healthy server killed by its
        orchestrator. Only the (briefly-held) jobs lock is touched; the
        per-group busy flags come from a try-lock (``SolveGroup.busy`` —
        never a blocking acquire), and queue depth is a lock-free qsize.
        The on-call triage fields: uptime, queue depth, and
        WHICH group is mid-solve when latency spikes."""
        from ..runtime.governor import host_rss_mb
        from ..utils.obs import disk_free_mb

        with self._jobs_lock:
            states: dict[str, int] = {}
            for j in self.jobs.values():
                states[j.state] = states.get(j.state, 0) + 1
        with self._lease_lock:
            held = sorted(self._owned_leases)
        return {"ok": True,
                # ready != ok: up-but-mid-build is alive yet a
                # terrible routing target — the journal has replayed AND no
                # group build is in flight.
                # WarmState.building() is a brief map scan, never a group
                # lock, so the no-blocking contract above holds
                "ready": bool(self._replay_done
                              and self.warm.building() == 0),
                "uptime_s": round(time.time() - self.started_ts, 3),
                "jobs": states, "shed_level": self._shed,
                "queue_depth": self._queue.qsize(),
                # the router's spill/least-loaded signal (0.0 = no SLO
                # tracking or an empty window)
                "burn": self._slo_burn_last,
                "groups_busy": {g.name: g.busy()
                                for g in self.warm.groups()},
                # the crash-durable tier: this process's lease
                # identity + the jobs it currently owns — the per-process
                # ownership state daccord-top renders
                "peer": self.peer,
                "leases": held,
                "rss_mb": round(host_rss_mb(), 1),
                # the disk-pressure governor: the on-call "is the
                # volume the problem" pair — daccord-top's DISK column
                "disk_free_mb": round(disk_free_mb(self.cfg.workdir), 1),
                "disk_pressure": bool(self.admission.disk_pressure)}

    def stats(self) -> dict:
        """Full stats (the /v1/metrics body). NOTE: group stats take each
        group's solve lock, so this can block behind an in-flight device
        solve — liveness probes must use :meth:`health` instead."""
        return {**self.health(),
                "admission": self.admission.stats(),
                "warm": self.warm.stats(),
                # saturation verdict: last computed by
                # _refresh_gauges over the demand wall
                "verdict": self._verdict,
                "metrics": self.metrics.rollup(),
                **({"device": self.device_stats()}
                   if self.cfg.backend == "cuda" else {})}

    def device_stats(self) -> dict:
        """The card as this process sees it: the caching allocator's
        allocated bytes now, the graph cache's captures, capture wall,
        replays and shapes held, and each kernel wrapper's launch count
        (a group's pre-capture warm-ups not counted). Host-side reads:
        nothing waits on the card."""
        import torch

        from ..kernels import graphs

        c = graphs.CACHE
        return {"allocated_bytes": int(torch.cuda.memory_allocated())
                if torch.cuda.is_initialized() else 0,
                "graphs": {"captures": c.captures,
                           "capture_s": round(c.capture_s, 4),
                           "replays": c.replays, "shapes": c.shapes()},
                "launches": {m.__name__.rsplit(".", 1)[1]: m.launches
                             for m in graphs._counter_modules()}}

    def stats_prom(self) -> str:
        """Prometheus text exposition of the live registry (the
        scrapeable health plane behind ``GET /v1/metrics?format=prom``).
        Health/admission scalars fold in as extra gauges so one scrape
        answers the whole on-call checklist; renders through the shared
        ``obs.render_prom`` (``obs.parse_prom`` lints it)."""
        from ..utils.obs import render_prom

        self._refresh_gauges()
        roll = self.metrics.rollup()
        g = roll["gauges"]
        g["uptime_s"] = round(time.time() - self.started_ts, 3)
        g["queue_depth"] = self._queue.qsize()
        adm = self.admission.stats()
        for k in ("admitted", "rejected", "shed"):
            roll["counters"][f"admission_{k}"] = int(adm.get(k, 0))
        for grp in self.warm.groups():
            g[f"group_busy_{grp.name}"] = float(grp.busy())
        # the bottleneck verdict rides the rollup so render_prom exposes
        # daccord_serve_bottleneck_verdict{verdict="..."}
        roll["verdict"] = self._verdict
        return render_prom(roll, prefix="daccord_serve")

    def shutdown(self, drain: bool = True, timeout_s: float = 300.0) -> bool:
        """Graceful stop: admission closes, queued+running jobs finish
        (``drain``), pools drain, telemetry commits durably.

        Bounded drain: with ``drain_deadline_s`` set, a
        drain that outlives it — a group thread wedged in a solve — stops
        waiting: every in-flight job is journal-marked INTERRUPTED (an
        orphan the next restart replays and resumes) and the method returns
        False (the serve CLI exits nonzero). Returns True on a clean drain;
        the verdict also lands on ``self.clean``."""
        self.admission.drain()
        clean = True
        if drain:
            bound = self.cfg.drain_deadline_s or 0.0
            deadline = time.time() + (bound if bound > 0 else timeout_s)
            while True:
                with self._jobs_lock:
                    busy = any(j.state in (QUEUED, RUNNING) and not j.watch
                               for j in self.jobs.values())
                if not busy and self._queue.empty():
                    break
                if time.time() >= deadline:
                    if bound > 0:
                        clean = False
                        with self._jobs_lock:
                            stuck = [j for j in self.jobs.values()
                                     if j.state in (QUEUED, RUNNING)
                                     and not j.watch]
                        for j in stuck:
                            # resumable on restart: the journal keeps the
                            # job live, the per-job checkpoint bounds the
                            # recompute; the lease is deliberately NOT
                            # released — a peer takes it over once stale
                            self.journal_mark("interrupted", j.id)
                            self.log_event("serve.job", job=j.id,
                                           state="interrupted",
                                           tenant=j.tenant)
                    break
                time.sleep(0.05)
        self._stop.set()
        for _ in self._workers:
            self._queue.put(None)
        for t in self._workers:
            t.join(timeout=10.0)
        if any(t.is_alive() for t in self._workers):
            clean = False   # a wedged worker thread cannot be drained
        self._ticker.join(timeout=10.0)
        if clean:
            # a wedged solve could hold a group lock forever — only a clean
            # drain flushes residual pools (the unclean path is exiting: the
            # journal already holds everything a restart needs)
            for g in self.warm.groups():
                g.drain_all()
        self._refresh_gauges()
        self.metrics.snapshot(self.events, final=True)
        from ..utils.aio import durable_write
        from ..utils.obs import _note_dropped

        try:
            durable_write(
                os.path.join(self.cfg.workdir, "serve.metrics.json"),
                lambda fh: json.dump(self.stats(), fh), mode="wt",
                domain="sidecar")
            # the scrapeable twin: the same registry as a prom
            # text exposition, durably beside the JSON rollup
            prom = self.stats_prom()
            durable_write(
                os.path.join(self.cfg.workdir, "serve.metrics.prom"),
                lambda fh: fh.write(prom), mode="wt", domain="sidecar")
        except OSError:
            # telemetry never raises into shutdown: a full volume costs the
            # rollup sidecars, not the drain verdict (counted like any
            # other dropped telemetry)
            _note_dropped(1)
        with self._jobs_lock:
            n_done = sum(j.state == DONE for j in self.jobs.values())
        self.log_event("serve.done", jobs=len(self.jobs), done=n_done,
                       wall_s=round(time.time() - self.started_ts, 3))
        self.warm.close()
        if self.journal is not None:
            # close the append fd, then compact: terminal jobs collapse to
            # their idempotency memory, so a long-lived service's journal
            # (and the next restart's replay) stays bounded
            from .journal import compact, replay as journal_replay

            self.journal.close()
            self.journal = None
            entries, _ = journal_replay(self._journal_path)
            compact(self._journal_path, entries)
        # release still-held leases ONLY on a clean exit: an unclean one
        # leaves them for peer takeover / our own restart (holder-checked,
        # so a taker that already claimed is never disturbed)
        if clean:
            with self._lease_lock:
                held = list(self._owned_leases)
            for jid in held:
                self.release_job_lease(jid)
        # the announce lease drops on ANY shutdown verdict: a draining-but-
        # unclean peer is equally gone from the router's point of view (an
        # unreleased announce would cost the router a TTL of proxy errors)
        if self._announce_path is not None:
            from ..utils import lease

            lease.release(self._announce_path, host=self.peer)
            self._announce_path = None
        self.events.close()
        self.clean = clean
        return clean

    # ------------------------------------------------------------------
    # background threads
    # ------------------------------------------------------------------

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            job_id = self._queue.get()
            if job_id is None:
                return
            # claim atomically: abort() releases a QUEUED job's quota
            # synchronously under this same lock, so exactly one of the two
            # (claim here, or queued-abort there) wins — never both
            with self._jobs_lock:
                job = self.jobs.get(job_id)
                if job is None or job.state != QUEUED:
                    # pre-dequeue abort already released the charge/counted
                    continue
                aborted_now = job.abort_event.is_set()
                if aborted_now:
                    job.state = ABORTED
                    job.done_ts = time.time()
                else:
                    job.state = RUNNING
            if aborted_now:
                self.admission.release(job.tenant, job.spec.nbytes)
                self.metrics.counter("jobs_aborted").inc()
                job.settled.set()
                continue
            with self._jobs_lock:
                running = sum(1 for j in self.jobs.values()
                              if j.state == RUNNING)
            self.metrics.gauge("active_jobs").set(running + 1)
            try:
                run_job(job, self)
            except Exception as e:  # noqa: BLE001 — a worker must survive
                # run_job already isolates job failures; anything escaping
                # here is a harness bug, and losing the worker thread would
                # silently shrink service capacity AND strand queued jobs
                job.state = FAILED
                job.error = job.error or f"{type(e).__name__}: {e}"[:500]
                job.done_ts = job.done_ts or time.time()
                self.log_event("serve.job", job=job.id, state=FAILED,
                               tenant=job.tenant, error=job.error)
            if not job.watch:
                # a demoted run returns non-terminal (RUNNING-watch): its
                # outcome is the TAKER's to count — the watch resolution
                # counts jobs_done when the peer's manifest lands
                self.metrics.counter(f"jobs_{job.state}").inc()
            with self._jobs_lock:
                running = sum(1 for j in self.jobs.values()
                              if j.state == RUNNING)
            self.metrics.gauge("active_jobs").set(float(running))
            job.settled.set()

    def _tick_loop(self) -> None:
        last_snap = time.time()
        last_pressure = 0.0
        last_beat = 0.0
        while not self._stop.wait(self.cfg.flush_lag_s):
            # EVERY housekeeping step is guarded: the single ticker thread
            # dying (full disk on the events file, a group close raising)
            # would silently stop pressure shedding, stale flushes, job
            # pruning, and eviction for the rest of the server's life
            try:
                # latency bound: stale cross-job pools flush even when
                # every cohabitant is busy windowing
                for g in self.warm.groups():
                    g.flush_stale(self.cfg.flush_lag_s)
                now = time.time()
                # demand-wall sampling: accrue wall while any
                # job is queued/running — the saturation verdict's
                # denominator (see _refresh_gauges)
                dt = now - self._last_demand_tick
                self._last_demand_tick = now
                with self._jobs_lock:
                    active = any(j.state in (QUEUED, RUNNING)
                                 for j in self.jobs.values())
                if active:
                    self._demand_s += dt
                if now - last_pressure >= 1.0:
                    last_pressure = now
                    self._pressure_tick()
                    self._disk_tick(now)
                    self._prune_jobs(now)
                if self.cfg.peer_dir \
                        and now - last_beat >= self.cfg.heartbeat_s:
                    # watch jobs only exist when peer_dir is set, so the
                    # lease tick (and its O(jobs) scans) stays off entirely
                    # for solo deployments
                    last_beat = now
                    self._lease_tick()
                self.warm.evict_idle()
                if (self.cfg.metrics_snapshot_s
                        and now - last_snap >= self.cfg.metrics_snapshot_s):
                    last_snap = now
                    self._refresh_gauges()
                    self.metrics.snapshot(self.events)
            except Exception as e:  # noqa: BLE001 — ticker must survive
                try:
                    self.log_event("serve.job", job="-", state="tick_error",
                                   tenant="-", error=str(e)[:200])
                except Exception:
                    pass

    def _prune_jobs(self, now: float) -> None:
        """Bound the in-memory registry: terminal jobs drop out
        ``job_retention_s`` after finishing (status turns 404; the durable
        commit under jobs/<id>/ is untouched). Without this an always-on
        server's registry — and every loop that iterates it — grows with
        lifetime job count."""
        ttl = self.cfg.job_retention_s
        if not ttl:
            return
        with self._jobs_lock:
            for jid, j in list(self.jobs.items()):
                if (j.state in (DONE, FAILED, ABORTED) and j.done_ts
                        and now - j.done_ts >= ttl):
                    del self.jobs[jid]

    def announce(self, url: str) -> None:
        """Publish this peer's HTTP address for front-door discovery:
        an announce lease at
        ``<peer_dir>/peers/<service_id>.lease`` carrying the URL, renewed
        every ``_lease_tick`` — the job-lease protocol reused verbatim, so
        a dead peer's announce goes stale on exactly the same clock as its
        job leases and the router needs no second liveness protocol. No-op
        without a peer_dir (solo deployments have no router)."""
        if not self.cfg.peer_dir:
            return
        from ..utils import lease

        path = os.path.join(self.cfg.peer_dir, "peers",
                            f"{self.service_id}.lease")
        # our service_id namespace (unique-basename rule): a previous
        # incarnation's leftover announce is ours to replace
        lease.release(path)
        lease.claim(path, self.peer, self.cfg.lease_ttl_s,
                    extra={"url": url, "service": self.service_id})
        self._announce_url = url
        self._announce_path = path
        self.log_event("serve.announce", url=url, peer=self.peer)

    def _demote_job(self, job, jid: str, to: str) -> None:
        """Stand down from a job whose lease we can no longer prove we hold
        (a taker owns it, or the renew grace ran out): our run aborts at its
        next check and the job becomes a watch (a committed peer manifest
        flips it DONE). A still-QUEUED job flips to RUNNING-watch under the
        lock so the worker's dequeue skips it (state != QUEUED) instead of
        misreading the demotion abort_event as a client abort — and its
        quota charge releases NOW (the taker charged its own)."""
        with self._lease_lock:
            self._owned_leases.pop(jid, None)
        with self._jobs_lock:
            was_queued = job.state == QUEUED
            if was_queued:
                job.state = RUNNING
            job.watch = True
        job.abort_event.set()
        if was_queued:
            self.admission.release(job.tenant, job.spec.nbytes)
        self.journal_mark("demoted", jid, to=to)

    def _lease_tick(self) -> None:
        """The peer-takeover heartbeat, at ``heartbeat_s``
        cadence so a serve fleet never storms the shared FS:

        1. renew every lease we hold — with the fleet's re-read-before-
           renew ownership check: if a taker claimed our stale lease during
           a pause, renewing would keep THE TAKER'S lease fresh while two
           processes run one job. We stand down (abort our run, watch the
           taker) instead.
        2. resolve watch jobs: a peer-held job whose manifest landed is
           DONE here too; one whose lease went stale re-enters the takeover
           scan below.
        3. scan the shared lease dir for stale leases of dead peers, claim
           them (race-safe), and re-admit their journaled jobs through the
           normal quota path — the byte contract is unchanged because the
           job runs through the same pipeline against the same shared-FS
           inputs, resuming from the dead peer's per-job checkpoint.
        """
        import glob as _glob

        from ..utils import lease
        from .jobs import JobSpec

        ttl = self.cfg.lease_ttl_s
        # 0. renew the announce lease (router discovery) — same
        # re-read-before-renew discipline as job leases; a vanished file
        # (an operator rm) is simply re-announced
        if self._announce_path is not None:
            info = lease.read(self._announce_path)
            if info is None:
                lease.claim(self._announce_path, self.peer, ttl,
                            extra={"url": self._announce_url,
                                   "service": self.service_id})
            elif info.get("host") == self.peer:
                lease.renew(self._announce_path)
        # 1. renew (ownership-checked)
        with self._lease_lock:
            held = list(self._owned_leases.items())
        for jid, path in held:
            with self._jobs_lock:
                job = self.jobs.get(jid)
            if job is None or job.state in (DONE, FAILED, ABORTED):
                self.release_job_lease(jid)
                continue
            info, lstat = lease.read_result(path)
            if info is not None and info.get("host") != self.peer:
                # ownership lost: never renew the taker's lease
                self._lease_grace.pop(jid, None)
                self._demote_job(job, jid, str(info.get("host", "?")))
                continue
            # ``lstat`` != ok (absent / torn / EIO-class read error) leaves
            # ownership unproven this beat; still attempt the bump — utime
            # can succeed where the read hiccupped — and count a failed
            # beat against the bounded grace. One shared-FS hiccup must not
            # abort healthy in-flight work, but a holder that cannot prove
            # liveness for lease_grace_beats heartbeats stands down BEFORE
            # the TTL lets a peer steal the lease out from under a commit.
            if lease.renew(path):
                self._lease_grace.pop(jid, None)
                continue
            n = self._lease_grace.get(jid, 0) + 1
            self._lease_grace[jid] = n
            grace = max(1, int(self.cfg.lease_grace_beats))
            self.log_event("io.fault", domain="lease", op="renew",
                           error=f"beat {n}/{grace} ({lstat})")
            if n >= grace:
                self._lease_grace.pop(jid, None)
                self._demote_job(job, jid, "(renew grace exhausted)")
        # 2. watch jobs: peer finished, or peer died
        with self._jobs_lock:
            watches = [j for j in self.jobs.values()
                       if j.watch and j.state not in (DONE, FAILED, ABORTED)]
        for job in watches:
            if os.path.exists(os.path.join(job.dir, "manifest.json")):
                with self._jobs_lock:
                    job.state = DONE
                    job.done_ts = job.done_ts or time.time()
                    job.watch = False
                job.settled.set()
                self.metrics.counter("jobs_done").inc()
                self.journal_mark("committed", job.id, by="peer")
                self.log_event("serve.job", job=job.id, state=DONE,
                               tenant=job.tenant)
        # 3. takeover scan
        if not self.cfg.peer_dir:
            return
        with self._lease_lock:
            mine = set(self._owned_leases.values())
        for path in _glob.glob(os.path.join(self.cfg.peer_dir, "leases",
                                            "*.lease")):
            if path in mine:
                continue
            age = lease.stale_s(path)
            if age is None or age <= ttl:
                continue
            info = lease.read(path)
            if not info or not info.get("jobdir") or not info.get("spec"):
                # torn lease from a killed claimer: clear it once stale so
                # the dir doesn't accrete litter (the job itself is in the
                # dead process's journal; its restart replays it)
                lease.release(path)
                continue
            jobdir = info["jobdir"]
            if os.path.exists(os.path.join(jobdir, "manifest.json")):
                # committed, then the committer died before releasing
                lease.release(path)
                continue
            key = (info["job"] if info.get("service") == self.service_id
                   else f"{info.get('service', '?')}.{info['job']}")
            with self._jobs_lock:
                existing = self.jobs.get(key)
                if existing is not None and not existing.watch \
                        and existing.state in (QUEUED, RUNNING):
                    continue   # already ours (replay got here first)
                if existing is not None and existing.running_local:
                    # a demoted straggler thread is still unwinding this
                    # job: re-queueing now would put two local threads on
                    # one job. It exits at its next abort check; until
                    # then the lease stays stale — a later tick (or a
                    # peer) reclaims
                    continue
            ok, tk = lease.claim(path, self.peer, ttl,
                                 extra={k: info.get(k) for k in
                                        ("service", "job", "jobdir",
                                         "tenant", "nbytes", "spec",
                                         "idem")})
            if not ok:
                continue   # another peer won the race
            tenant = str(info.get("tenant", "default"))
            nbytes = int(info.get("nbytes", 0) or 0)
            try:
                # the NORMAL quota path: a loaded peer refuses the orphan
                # and hands the lease back for someone with headroom
                self.admission.admit(tenant, nbytes, job=key)
            except Exception:
                lease.release(path, host=self.peer)
                continue
            try:
                spec = JobSpec(**info["spec"])
            except TypeError:
                self.admission.release(tenant, nbytes)
                lease.release(path, host=self.peer)
                continue
            spec.nbytes = nbytes
            with self._jobs_lock:
                job = self.jobs.get(key)
                if job is not None:
                    # our own watch job whose peer died: reclaim it
                    job.state = QUEUED
                    job.watch = False
                    job.abort_event = threading.Event()
                    job.settled = threading.Event()
                else:
                    job = Job(id=key, tenant=tenant, spec=spec, dir=jobdir)
                    self.jobs[key] = job
            with self._lease_lock:
                self._owned_leases[key] = path
            idem = info.get("idem")
            if idem:
                with self._jobs_lock:
                    self._idem[idem] = key
            self.journal_mark("admitted", key, tenant=tenant, nbytes=nbytes,
                              spec=info["spec"], dir=jobdir, idem=idem,
                              takeover=True)
            self.metrics.counter("takeovers").inc()
            self.log_event(
                "serve.takeover", job=key,
                prev_host=str((tk or {}).get("prev_host", "?")),
                stale_s=float((tk or {}).get("stale_s", round(age, 3))))
            self._queue.put(key)

    def _slo_tick(self) -> None:
        """SLO burn tracking: rolling p99 job latency over the
        window vs the target. ``burn = p99/target``; crossing the shed
        fraction raises the slo-held shed rung so the batch ladder engages
        BEFORE the target is breached (burn >= 1 — the breach the sentinel
        flags), and a cleared window releases it one rung per tick.
        ``serve.slo`` emits on burn-band changes, not every tick."""
        cfg = self.cfg
        if not cfg.slo_p99_s:
            return
        now = time.time()
        win = self._lat_window
        with self._lat_lock:
            while win and now - win[0][0] > cfg.slo_window_s:
                win.popleft()
            lats = sorted(v for _, v in win)
        n = len(lats)
        p99 = lats[min(int(0.99 * n), n - 1)] if n else None
        if p99 is None:
            # an empty window (traffic stopped) must still release a held
            # rung per tick, or a past burst pins the shed ladder forever
            self._slo_burn_last = 0.0
            if self._slo_shed:
                self._slo_shed -= 1
            return
        burn = round(p99 / cfg.slo_p99_s, 3)
        self._slo_burn_last = burn
        self.metrics.gauge("slo_burn").set(burn)
        self.metrics.gauge("slo_p99_s").set(round(p99, 4))
        if burn >= cfg.slo_shed_burn:
            self._slo_shed = min(self._slo_shed + 1, cfg.shed_max_levels)
        elif burn < cfg.slo_clear_burn and self._slo_shed:
            self._slo_shed -= 1
        band = int(burn * 10)
        if band != self._slo_band:
            self._slo_band = band
            self.log_event("serve.slo", target_s=cfg.slo_p99_s,
                           p99_s=round(p99, 4), burn=burn, n=n,
                           window_s=cfg.slo_window_s, shed=self._slo_shed)

    def _pressure_tick(self) -> None:
        """The shed ladder: hard pressure halves every
        group's merged-batch width one rung per second of sustained
        pressure (bounded); clear pressure restores one rung per second.
        The SLO burn tracker holds its own rung (``_slo_tick``) — the
        effective level is the max of the two, so latency pressure sheds
        before an SLO breach even when RSS is fine. Degrades throughput,
        never bytes — it is the capacity governor's batch-bisect argument
        applied service-wide."""
        level, rss = self.admission.pressure_level()
        self._peak_rss_mb = max(self._peak_rss_mb, rss)
        qd = self._queue.qsize()
        self._peak_queue_depth = max(self._peak_queue_depth, qd)
        self._slo_tick()
        want = self._shed
        if level == "hard":
            want = min(self._shed + 1, self.cfg.shed_max_levels)
        elif level is None and self._shed:
            want = self._shed - 1
        want = max(want, self._slo_shed)
        if want != self._shed:
            self._shed = want
            self.log_event("serve.shed", level=int(want),
                           rss_mb=round(rss, 1))
            for g in self.warm.groups():
                g.set_shed(want)

    def _enter_disk_pressure(self, src: str, detail: str) -> None:
        """Latch the admission ``disk_pressure`` state (idempotent):
        submissions answer machine-readable 507-style refusals until the
        volume proves writable again. Every in-flight job is journal-marked
        INTERRUPTED — a resumable record, NOT an abort: the jobs keep
        running (compute needs no disk until commit), but if the full
        volume kills the process first, replay resumes them from their
        checkpoints instead of losing them. The marks themselves may be
        refused by the same full disk — tolerated (append returns False);
        a never-marked orphan replays identically."""
        if self.admission.disk_pressure is not None:
            return
        self.admission.disk_pressure = f"{src}: {detail}"[:200]
        self._disk_latch_src = src
        _, free = self.admission.disk_level()
        self.log_event("disk.pressure", level="enter", src=src,
                       free_mb=round(free, 1), detail=str(detail)[:200])
        self.metrics.counter("disk_pressure_events").inc()
        with self._jobs_lock:
            inflight = [j.id for j in self.jobs.values()
                        if j.state in (QUEUED, RUNNING) and not j.watch]
        for jid in inflight:
            self.journal_mark("interrupted", jid)

    def _clear_disk_pressure(self, free: float) -> None:
        detail = self.admission.disk_pressure
        self.admission.disk_pressure = None
        self._disk_latch_src = None
        self.log_event("disk.pressure", level="clear", src="probe",
                       free_mb=round(free, 1), detail=str(detail or "")[:200])

    def _disk_probe_ok(self) -> bool:
        """One raw write+fsync on the serve volume — deliberately NOT
        through the aio fault hook (the probe asks the REAL disk, and must
        not consume injected-fault counters): the latch clears only when
        bytes demonstrably reach durability again."""
        p = os.path.join(self.cfg.workdir, ".disk.probe")
        try:
            fd = os.open(p, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            try:
                os.write(fd, b"ok\n")
                os.fsync(fd)
            finally:
                os.close(fd)
            os.remove(p)
            return True
        except OSError:
            return False

    def _disk_tick(self, now: float) -> None:
        """The disk-pressure governor, mirroring the RSS ladder
        at the same 1 Hz cadence: free-bytes watermarks latch the admission
        507 state at hard, a successful probe (plus a clear watermark)
        releases it, and the journal compacts ONLINE at a size or hard
        free-space watermark — a filling volume is relieved by the
        journal's own garbage before an operator has to bounce the
        server."""
        level, free = self.admission.disk_level()
        if free >= 0:
            self.metrics.gauge("disk_free_mb").set(round(free, 1))
        self.metrics.gauge("disk_pressure").set(
            1.0 if self.admission.disk_pressure else 0.0)
        if level == "hard" and self.admission.disk_pressure is None:
            self._enter_disk_pressure(
                "watermark",
                f"free {free:.0f} MiB <= hard "
                f"{self.admission.cfg.disk_hard_mb:.0f} MiB")
        elif self.admission.disk_pressure is not None and level is None \
                and self._disk_probe_ok():
            self._clear_disk_pressure(free)
        j = self.journal
        if j is None:
            return
        size_mb = j.size_bytes() / float(1 << 20)
        want = bool(self.cfg.journal_compact_mb
                    and size_mb >= self.cfg.journal_compact_mb) \
            or level == "hard"
        if want and now - self._last_compact >= 5.0:
            # rate-limited: a journal that compacts to >= the watermark
            # (nothing terminal to collapse) must not rewrite every tick
            self._last_compact = now
            res = j.compact_online()
            if res is not None:
                self.log_event("journal.compact", **res)
                self.metrics.counter("journal_compactions").inc()

    def _refresh_gauges(self) -> None:
        from ..runtime.governor import host_rss_mb

        g = self.metrics.gauge
        with self._jobs_lock:
            g("jobs_total").set(float(len(self.jobs)))
            g("jobs_running").set(float(sum(
                1 for j in self.jobs.values() if j.state == RUNNING)))
        rss = host_rss_mb()
        self._peak_rss_mb = max(self._peak_rss_mb, rss)
        qd = self._queue.qsize()
        self._peak_queue_depth = max(self._peak_queue_depth, qd)
        g("rss_mb").set(rss)
        # peaks, not just the last sample: the durable
        # rollup must answer "how bad did it get", and a drained shutdown
        # always reads 0 at the last tick
        g("rss_mb_peak").set(self._peak_rss_mb)
        g("queue_depth").set(float(qd))
        g("queue_depth_peak").set(float(self._peak_queue_depth))
        g("shed_level").set(float(self._shed))
        from ..utils.obs import disk_free_mb

        free = disk_free_mb(self.cfg.workdir)
        if free >= 0:
            g("disk_free_mb").set(round(free, 1))
        g("disk_pressure").set(
            1.0 if self.admission.disk_pressure else 0.0)
        with self._lease_lock:
            g("leases_held").set(float(len(self._owned_leases)))
        mixed = rows = 0
        busy_s = blocked_s = 0.0
        for grp in self.warm.groups():
            s = grp.stats()
            mixed += s["mixed_batches"]
            rows += s["rows"]
            # per-group starvation gauges: each warm group's
            # device-idle / host-blocked fractions over its own lifetime
            sat = s.get("saturation") or {}
            g(f"group_device_idle_frac_{grp.name}").set(
                float(sat.get("device_idle_frac", 1.0)))
            g(f"group_host_blocked_frac_{grp.name}").set(
                float(sat.get("host_blocked_frac", 0.0)))
            busy_s += float(sat.get("busy_s", 0.0))
            blocked_s += float(sat.get("blocked_s", 0.0))
        g("batcher_rows").set(float(rows))
        g("batcher_mixed_batches").set(float(mixed))
        # service-level saturation + verdict over the DEMAND wall: device
        # gaps while jobs were live mean the feeders (job windowing) starve
        # the warm groups — the serve-plane form of host_feeder
        from ..utils.obs import bottleneck_verdict, saturation_gauges

        if self._demand_s > 1e-6:
            sat = saturation_gauges(self._demand_s, blocked_s, busy_s)
            self._verdict = bottleneck_verdict(sat)["verdict"]
        else:
            sat = saturation_gauges(1.0, 0.0, 1.0)   # no traffic: balanced
            self._verdict = "balanced"
        for k, v in sat.items():
            g(k).set(v)
        g("demand_s").set(round(self._demand_s, 3))
