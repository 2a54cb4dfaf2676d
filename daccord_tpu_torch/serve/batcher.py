"""Cross-job batcher: shared device batches over concurrent jobs' windows.

The port's copy of the JAX package's ``serve/batcher.py``. Window streams
from concurrent jobs may share device batches because every window solves
on its own (the property behind the split ladder, the governor's bisect and
the paged router). A job's pipeline runs exactly as a solo run does (its
own feeder, profile, scatter, stitch, commit); only its dispatch seam
changes: instead of solving its own batches, it hands row blocks to a
:class:`SolveGroup`, which pools rows from every job it serves per (depth,
seg-len, stream) bucket, flushes merged batches padded to the group's width
through one shared supervised solve path, and scatters each merged result
back to the jobs' handles. The shared path is the pipeline's own
(``runtime/pipeline.py build_solve_path``: the ``LadderDispatcher`` thread,
the supervisor with its watchdog, retries, failover, capacity governor and
shadow audit), so a device loss replays a mixed batch whole and a device
OOM bisects it, with every job's bytes unchanged.

Warmth is the point: the group owns the ``TierLadder`` (its tables on the
card), its CUDA graphs, its dispatcher thread, its supervisor's cold-shape
state and ratchets, and its audit worker processes, so the Nth job pays none
of a fresh ``daccord``'s cold start. Merged batches are padded to the
group's width, so the group replays one graph per shape and stage; on the
card every dense width is captured when the group is built (before it
serves), and a new width is captured only when a shed rung or the governor
shrinks it (or a paged family is derived from the first pooled rows), under
the graph cache's lock. Groups are keyed by solve fingerprint
(``jobs.solve_fingerprint``): jobs whose solve semantics differ never share
a batch.

Group modes mirror the pipeline's dispatch strategies:

- ``ladder_mode='split'``: the jobs' pipelines run the two-stream machinery
  (the solver's ``routes_streams``); tier-0 and rescue rows pool apart here
  and each merged batch goes to its program by its stream tag
  (``kernels.tiers.stream_dispatcher``, the pipeline's rule).
- ``paged=True``: merged batches pack into the paged wire format
  (``kernels/paging.py``); shape families derive from the first pooled rows
  of each bucket, so the router follows the live mix of jobs.

Locking: one RLock per group serializes pool mutation, flushes and drains.
Jobs take turns driving the device (one card is one resource); the
dispatcher thread still overlaps each job's host windowing with the card.
"""

from __future__ import annotations

import gc
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..kernels.tensorize import BatchShape, WindowBatch, pad_batch, slice_batch
from ..runtime.governor import GovernorConfig, merge_results
from ..utils.obs import NullLogger, Tracer


class JobAborted(RuntimeError):
    """Raised by :meth:`SolveGroup.fetch` on a handle whose job was
    released mid-flight (client disconnect or DELETE). The job's own
    pipeline unwinds on it; the other jobs never see it."""


class JobHandle:
    """One job-side dispatch: ``n`` rows whose results arrive as ordered
    parts (a handle's rows may split across consecutive merged batches).
    ``result()`` merges them with the governor's ``merge_results``, the
    row-exact merge the bisect rung uses."""

    __slots__ = ("job", "n", "parts", "filled", "event", "aborted")

    def __init__(self, job: str, n: int):
        self.job = job
        self.n = int(n)
        self.parts: list[tuple[int, dict]] = []
        self.filled = 0
        self.event = threading.Event()
        self.aborted = False

    def add_part(self, n: int, out: dict) -> None:
        self.parts.append((n, out))
        self.filled += n
        if self.filled >= self.n:
            self.event.set()

    def abort(self) -> None:
        self.aborted = True
        self.event.set()

    def result(self) -> dict:
        return merge_results(self.parts)


class _Block:
    """A contiguous run of one handle's rows sitting in a pool."""

    __slots__ = ("handle", "batch", "pages")

    def __init__(self, handle: JobHandle, batch: WindowBatch, pages):
        self.handle = handle
        self.batch = batch
        self.pages = pages          # int64 [rows] (paged groups) or None


class _Pool:
    """FIFO of row blocks for one (depth, seg-len, wlen, stream) bucket."""

    __slots__ = ("blocks", "rows", "pages", "oldest_ts", "shape", "stream")

    def __init__(self, shape: BatchShape, stream: str):
        self.blocks: deque[_Block] = deque()
        self.rows = 0
        self.pages = 0
        self.oldest_ts: float | None = None
        self.shape = shape
        self.stream = stream

    def append(self, blk: _Block) -> None:
        self.blocks.append(blk)
        self.rows += blk.batch.size
        if blk.pages is not None:
            self.pages += int(blk.pages.sum())
        if self.oldest_ts is None:
            self.oldest_ts = time.time()


@dataclass
class GroupConfig:
    backend: str = "native"      # native | cpu | cuda
    batch: int = 512             # merged dispatch width (the service batch)
    ladder_mode: str = "fused"   # fused | split (group-level routing)
    paged: bool = False          # pack merged batches as the paged wire format
    page_len: int = 16
    paged_families: int = 4
    dp_route: str = "fused"      # the ladder's heaviest-path route (fused |
                                 # scan); bit-identical, so not a key
    mesh: int = 0                # several cards: not ported (raises above 1)
    max_inflight: int = 8        # merged batches in flight before a drain
    min_width: int = 8           # shed floor for the width ladder
    shed_levels: int = 0         # current load-shed level: merged batches
                                 # dispatch at batch >> shed_levels (the
                                 # batch ladder as the overload policy);
                                 # mutated via set_shed
    aot_dir: str | None = None   # the fleet-shared kernel cache
                                 # (serve/aotcache.py): a card group installs
                                 # the nvcc-built kernels from it, or builds
                                 # and publishes them, at its build
    audit_rate: float | None = None  # the shadow audit's rate for the group's
                                 # supervisor; None = env DACCORD_AUDIT_RATE
                                 # (1/64), 0 disables. Native groups never
                                 # audit: the reference is the primary there
    governor: GovernorConfig = field(default_factory=GovernorConfig.from_env)


class SolveGroup:
    """Shared solve path + cross-job row pools for one solve fingerprint.

    The solve path is the pipeline's (``build_solve_path``): ``native`` the
    host library's tier ladder, supervised inline with itself as failover;
    ``cpu`` and ``cuda`` the ladder on that device behind its dispatcher
    thread, supervised with the configured failover and the shadow audit
    (on the card in audit worker processes of the group's own)."""

    def __init__(self, key: str, profile, cfg, gcfg: GroupConfig,
                 log=None, name: str = "g0"):
        if gcfg.mesh and gcfg.mesh > 1:
            raise ValueError(
                f"mesh={gcfg.mesh}: solve groups over several cards wait for the "
                "port of parallel/mesh.py (ROADMAP Queue 1 item 5)")
        self.key = key
        self.name = name
        self.cfg = cfg                      # canonical PipelineConfig
        self.gcfg = gcfg
        self.log = log if log is not None else NullLogger()
        self.tracer = Tracer(self.log)
        self._lock = threading.RLock()
        self._pools: dict[tuple, _Pool] = {}
        self._inflight: deque = deque()
        self._families: dict[tuple, list] = {}   # (D, L) -> ShapeFamily list
        self.counters = {"dispatches": 0, "rows": 0, "batches": 0,
                         "mixed_batches": 0, "demand_flushes": 0,
                         "lag_flushes": 0, "shed_flushes": 0}
        # saturation accounting over the group's lifetime: dispatch wall,
        # fetch-blocked wall and the engine's busy wall. A native group
        # solves inside the dispatch call, so its busy time is its dispatch
        # wall; a ladder group books each call's own span on its engine (on
        # the card between two timing events), as the pipeline does
        self.sat = {"dispatch_s": 0.0, "fetch_blocked_s": 0.0, "busy_s": 0.0}
        self._sync_engine = gcfg.backend == "native"
        self.ladder = None
        self.worker = None
        self.graphs = {"precaptured": 0, "precapture_s": 0.0}
        self._profile = profile
        self._hp_ols = None          # lazy (the hp pass's tables)
        self._build_solver(profile, cfg)
        # refcount/idle bookkeeping owned by WarmState
        self.refs = 0
        self.last_used = time.time()
        self.created = time.time()

    # ------------------------------------------------------------------
    # solve-path construction (the pipeline's, shared)
    # ------------------------------------------------------------------

    def _build_solver(self, profile, cfg) -> None:
        import torch

        from ..kernels import graphs
        from ..kernels.tiers import TierLadder
        from ..runtime.faults import FaultPlan
        from ..runtime.pipeline import build_solve_path
        from ..utils.device import resolve_device

        g = self.gcfg
        common = dict(supervise=True, tracer=self.tracer, ev_log=self.log,
                      plan=FaultPlan.from_env(), gov_cfg=g.governor,
                      audit_rate=g.audit_rate, describe_prefix="serve-")
        if g.backend == "native":
            if g.paged or g.ladder_mode == "split":
                raise ValueError("native serve groups run fused dense: the "
                                 "host engine escalates per window")
            # the job pipelines run the hp pass on the host after each fetch,
            # as a solo device run does, so the engine runs none
            self.path = build_solve_path(profile, cfg, torch.device("cpu"), None,
                                         native=True, engine_hp=False, **common)
            return
        if g.backend not in ("cpu", "cuda"):
            raise ValueError(f"backend {g.backend!r}: expected native, cpu or cuda")
        dev = resolve_device(g.backend)
        if dev.type == "cuda" and g.aot_dir:
            # the ladder's kernels from the fleet's cache (or built here and
            # published) before the first launch; once a process
            from .aotcache import prepare_kernels

            prepare_kernels(g.aot_dir, log=self.log)

        def make_ladder(device):
            return TierLadder.from_config(profile, cfg.consensus, max_kmers=cfg.max_kmers,
                                          rescue_max_kmers=cfg.rescue_max_kmers,
                                          overflow_rescue=cfg.overflow_rescue,
                                          device=device, route=g.dp_route)

        rate = g.audit_rate if g.audit_rate is not None else cfg.audit_rate
        if rate is None:
            from ..utils.obs import env_float

            rate = env_float("DACCORD_AUDIT_RATE", 1.0 / 64.0)
        if dev.type == "cuda" and rate > 0.0:
            # the group's own workers: each is sent this group's ladder, so
            # two groups of one process never share (and overwrite) one
            from ..audit.worker import AuditWorker

            try:
                self.worker = AuditWorker()
            except Exception as e:
                self.log.log("audit.disabled", error=str(e)[:200])
        try:
            with graphs.CACHE.lock:
                # the tables' uploads, the round-trip probe and the captures
                # touch the card: never beside another thread's capture
                self.ladder = make_ladder(dev)
                self.path = build_solve_path(profile, cfg, dev, self.ladder, native=False,
                                             worker=self.worker, make_ladder=make_ladder,
                                             **common)
                if dev.type == "cuda":
                    self._precapture()
        except BaseException:
            # a group that cannot serve gives back what it started
            if getattr(self, "path", None) is not None:
                self.path.close()
            if self.worker is not None:
                self.worker.close()
                self.worker = None
            raise

    def _precapture(self) -> None:
        """Capture every stage of every dense shape the group dispatches at
        its width (each depth bucket; tier 0 and the escalation at each
        width of ``graphs.widths``) before the group serves, under the
        graph cache's lock the caller holds. The warm-ups' launches are
        taken off the kernels' counts: they solve no job's rows."""
        if self.gcfg.paged:
            return       # families derive from the first pooled rows
        from ..kernels import graphs
        from ..runtime.pipeline import dense_buckets
        from ..utils.bases import PAD

        B = self._width()
        c0, s0 = graphs.CACHE.captures, graphs.CACHE.capture_s
        before = graphs.launch_counts()
        for d, ln in dense_buckets(self.cfg):
            shape = BatchShape(depth=d, seg_len=ln, wlen=self.cfg.consensus.w)
            empty = WindowBatch(seqs=np.full((B, d, ln), PAD, np.int8),
                                lens=np.zeros((B, d), np.int32),
                                nsegs=np.zeros(B, np.int32), shape=shape,
                                read_ids=np.full(B, -1, np.int64),
                                wstarts=np.zeros(B, np.int64))
            for width in graphs.widths(B):
                graphs.CACHE.run(empty, self.ladder, esc_cap=width, log=self.log)
        graphs._add_counts(graphs._counts_delta(graphs.launch_counts(), before), -1)
        self.graphs = {"precaptured": graphs.CACHE.captures - c0,
                       "precapture_s": round(graphs.CACHE.capture_s - s0, 4)}

    # ------------------------------------------------------------------
    # job-side API
    # ------------------------------------------------------------------

    @property
    def sup(self):
        return self.path.sup

    def job_solver(self, job: str) -> "JobSolver":
        return JobSolver(self, job)

    @property
    def hp_ols(self):
        """The group's shared OffsetLikely tables for the hp pass (built
        once, read-only across job threads). Double-checked: once built, a
        new job never queues behind another's solve (which holds the group
        lock) to read them."""
        ols = self._hp_ols
        if ols is not None:
            return ols
        with self._lock:
            if self._hp_ols is None:
                from ..oracle.consensus import make_offset_likely

                self._hp_ols = make_offset_likely(self._profile,
                                                  self.cfg.consensus)
            return self._hp_ols

    def set_shed(self, levels: int) -> None:
        """Load-shed rung: merged batches dispatch at ``batch >> levels``
        (floored) until pressure clears: the capacity governor's batch
        ladder promoted to the service's overload policy."""
        with self._lock:
            self.gcfg.shed_levels = max(0, int(levels))

    def _width(self) -> int:
        w = self.gcfg.batch >> self.gcfg.shed_levels
        return max(self.gcfg.min_width, w)

    def _pool_key(self, batch: WindowBatch) -> tuple:
        return (batch.shape.depth, batch.shape.seg_len, batch.shape.wlen,
                getattr(batch, "stream", "full"))

    def dispatch(self, job: str, batch: WindowBatch) -> JobHandle:
        """Pool one job batch's rows; flush merged batches when a bucket
        holds a dispatch width. Returns the job-side handle."""
        h = JobHandle(job, batch.size)
        if batch.size == 0:
            h.event.set()
            return h
        with self._lock:
            pk = self._pool_key(batch)
            pool = self._pools.get(pk)
            if pool is None:
                pool = self._pools[pk] = _Pool(batch.shape, pk[3])
            pages = None
            if self.gcfg.paged:
                from ..kernels import paging

                pages = paging.window_pages(batch.lens, self.gcfg.page_len)
            pool.append(_Block(h, batch, pages))
            self.counters["rows"] += batch.size
            while pool.rows >= self._width():
                self._flush(pk, reason="full")
            if len(self._inflight) >= self.gcfg.max_inflight:
                self._drain(self.gcfg.max_inflight // 2)
        return h

    def fetch(self, handle: JobHandle) -> dict:
        """Block until ``handle``'s rows are solved; the calling job thread
        drives the shared flush/drain machinery itself (no thread of the
        group's own), so a lone job proceeds at full speed and jobs complete
        each other's handles as a side effect of their own."""
        if not handle.event.is_set():
            with self._lock:
                while not handle.event.is_set():
                    pk = self._pool_of(handle)
                    if pk is not None:
                        self.counters["demand_flushes"] += 1
                        self._flush(pk, reason="demand")
                    elif self._inflight:
                        self._drain(0)
                    else:
                        raise RuntimeError(
                            f"handle for job {handle.job!r} has rows neither "
                            "pooled nor in flight (batcher bookkeeping bug)")
        if handle.aborted:
            raise JobAborted(f"job {handle.job!r} aborted")
        return handle.result()

    def fetch_many(self, handles: list) -> list[dict]:
        return [self.fetch(h) for h in handles]

    def flush_stale(self, max_age_s: float) -> None:
        """Service-ticker hook: flush pools whose oldest rows have waited
        longer than ``max_age_s`` (bounds the latency one job's rows can pay
        waiting for others). Non-blocking on the group lock: the ticker must
        not stall behind one group's solve, whose own flushes drain it."""
        if not self._lock.acquire(blocking=False):
            return
        try:
            now = time.time()
            for pk, pool in list(self._pools.items()):
                if (pool.rows and pool.oldest_ts is not None
                        and now - pool.oldest_ts >= max_age_s):
                    self.counters["lag_flushes"] += 1
                    self._flush(pk, reason="lag")
            if self._inflight:
                self._drain(0)
        finally:
            self._lock.release()

    def release_job(self, job: str) -> None:
        """Drop a released (aborted or finished) job's rows from every pool
        so they never waste a device slot; handles left incomplete abort.
        Rows already in a merged batch in flight stay: their results scatter
        into dead handles harmlessly, and the other jobs' rows are untouched
        (an abort never poisons a cohabitant)."""
        with self._lock:
            for pool in self._pools.values():
                kept: deque[_Block] = deque()
                for blk in pool.blocks:
                    if blk.handle.job == job:
                        pool.rows -= blk.batch.size
                        if blk.pages is not None:
                            pool.pages -= int(blk.pages.sum())
                        blk.handle.abort()
                    else:
                        kept.append(blk)
                pool.blocks = kept
                if not pool.rows:
                    pool.oldest_ts = None

    def drain_all(self) -> None:
        """Flush every pool and drain every in-flight batch (shutdown)."""
        with self._lock:
            for pk, pool in list(self._pools.items()):
                while pool.rows:
                    self._flush(pk, reason="final")
            if self._inflight:
                self._drain(0)

    def busy(self) -> bool:
        """True while the group lock is held (a flush or drain is running).
        A pure try-lock: a liveness probe never queues behind a solve."""
        locked = self._lock.acquire(blocking=False)
        if locked:
            self._lock.release()
        return not locked

    def saturation(self) -> dict:
        """Starvation and overlap gauges over this group's lifetime
        (``obs.saturation_gauges``) with the raw walls (``busy_s``,
        ``blocked_s``) the service sums into its demand-weighted verdict.
        Lock-free like :meth:`stats`."""
        from ..utils.obs import saturation_gauges

        el = max(time.time() - self.created, 1e-9)
        busy = self.sat["busy_s"]
        blocked = self.sat["fetch_blocked_s"]
        if self._sync_engine:
            blocked += self.sat["dispatch_s"]
            busy += self.sat["fetch_blocked_s"]
        return {**saturation_gauges(el, blocked, busy),
                "dispatch_s": round(self.sat["dispatch_s"], 4),
                "blocked_s": round(blocked, 4),
                "busy_s": round(busy, 4), "lifetime_s": round(el, 3)}

    def stats(self) -> dict:
        """Group stats. Non-blocking on the group lock: during a solve the
        counters are read without it (dict reads are atomic under the GIL),
        and a momentarily stale gauge beats stalling the ticker."""
        locked = self._lock.acquire(blocking=False)
        try:
            pooled = sum(p.rows for p in self._pools.values())
            sup = self.sup
            return {"key": self.key, "name": self.name, **self.counters,
                    "pooled_rows": pooled, "inflight": len(self._inflight),
                    "width": self._width(), "refs": self.refs,
                    "busy": not locked,
                    "saturation": self.saturation(),
                    "degraded": bool(sup is not None and sup.failed_over),
                    "governor": (sup.governor.counters.copy() if sup is not None
                                 else {}),
                    "graphs": dict(self.graphs)}
        finally:
            if locked:
                self._lock.release()

    def close(self) -> None:
        """Give back what the group holds: its dispatcher and watchdog
        threads, its audit worker processes, and on the card the graphs and
        buffers of the shapes no other live ladder ran."""
        path, self.path = self.path, _ClosedPath()
        try:
            path.close()
        finally:
            if self.worker is not None:
                self.worker.close()
                self.worker = None
            ladder, self.ladder = self.ladder, None
            if ladder is not None and ladder.device.type == "cuda":
                from ..kernels import graphs

                graphs.CACHE.release(ladder)
            del path, ladder
            # the supervisor and its governor hold each other: collect the
            # cycle now, so the ladder's tables leave the card with it
            gc.collect()
            self.tracer.unwind()
            if self.log is not None:
                self.log.close()

    # ------------------------------------------------------------------
    # merged-batch assembly
    # ------------------------------------------------------------------

    def _pool_of(self, handle: JobHandle) -> tuple | None:
        for pk, pool in self._pools.items():
            for blk in pool.blocks:
                if blk.handle is handle:
                    return pk
        return None

    def _family_for(self, pool: _Pool, nsegs: np.ndarray,
                    pages: np.ndarray):
        """Shape families for this bucket's (D, L), derived from the first
        pooled rows, so the grid follows the live mix of jobs. The
        mandatory full-coverage family guarantees any later window routes
        somewhere."""
        from ..kernels import paging

        fk = (pool.shape.depth, pool.shape.seg_len)
        fams = self._families.get(fk)
        if fams is None:
            D, L = fk
            PL = self.gcfg.page_len
            fams = paging.derive_families(
                np.asarray(nsegs, np.int64), np.asarray(pages, np.int64),
                max_depth=D, max_pages=-(-D * L // PL),
                budget=self.gcfg.paged_families, page_len=PL)
            # a width-wide pool must fit at least one worst-case window
            fams = [f if self._width() * f.budget >= f.pages else
                    paging.ShapeFamily(depth=f.depth, pages=f.pages,
                                       page_len=f.page_len,
                                       pool_pages=-(-f.pages // self._width()))
                    for f in fams]
            self._families[fk] = fams
            for fi, f in enumerate(fams):
                self.log.log("paging.family", family=f.describe(), bucket=fi,
                             depth=int(f.depth), pages=int(f.pages),
                             page_len=int(f.page_len), pool_pages=int(f.budget))
        # the smallest family covering every row of this merged batch
        mxd = int(np.max(nsegs)) if len(nsegs) else 0
        mxp = int(np.max(pages)) if len(pages) else 0
        for f in fams:
            if f.depth >= mxd and f.pages >= mxp:
                return f
        return fams[-1]

    def _flush(self, pk: tuple, reason: str) -> None:
        pool = self._pools.get(pk)
        if pool is None or not pool.rows:
            return
        width = self._width()
        take = min(width, pool.rows)
        # pop a `take`-row prefix, splitting the last block if needed
        taken: list[tuple[JobHandle, WindowBatch, np.ndarray | None]] = []
        need = take
        while need > 0:
            blk = pool.blocks[0]
            if blk.batch.size <= need:
                pool.blocks.popleft()
                taken.append((blk.handle, blk.batch, blk.pages))
                need -= blk.batch.size
            else:
                head = slice_batch(blk.batch, 0, need)
                tail = slice_batch(blk.batch, need, blk.batch.size)
                taken.append((blk.handle, head,
                              None if blk.pages is None else blk.pages[:need]))
                blk.batch = tail
                if blk.pages is not None:
                    blk.pages = blk.pages[need:]
                need = 0
        pool.rows -= take
        pool.oldest_ts = time.time() if pool.rows else None
        if self.gcfg.paged:
            pool.pages = sum(int(b.pages.sum()) for b in pool.blocks
                             if b.pages is not None)

        jobs: list[str] = []
        for h, _, _ in taken:
            if h.job not in jobs:
                jobs.append(h.job)

        def _cat(get):
            arrs = [get(b) for _, b, _ in taken]
            return np.concatenate(arrs) if len(arrs) > 1 else arrs[0]

        merged = WindowBatch(
            seqs=_cat(lambda b: b.seqs), lens=_cat(lambda b: b.lens),
            nsegs=_cat(lambda b: b.nsegs), shape=pool.shape,
            read_ids=_cat(lambda b: b.read_ids),
            wstarts=_cat(lambda b: b.wstarts), stream=pool.stream,
            job="+".join(jobs))
        if self.gcfg.paged:
            from ..kernels import paging

            pages = np.concatenate([p for _, _, p in taken]) \
                if len(taken) > 1 else taken[0][2]
            fam = self._family_for(pool, merged.nsegs, pages)
            # the dispatch width must hold this family's worst-case window
            # even after a shed rung shrank _width() below the width the
            # family's fixup assumed
            width = max(width, -(-fam.pages // fam.budget))
            # the family's pool budget: rows past it go back to the front of
            # the pool, in order (pack_paged's overflow guarantee)
            budget = fam.pool_rows(width) - 1
            fit = int(np.searchsorted(np.cumsum(pages), budget,
                                      side="right"))
            fit = max(min(fit, take), 1)
            if fit < take:
                self._requeue(pool, taken, fit)
                taken, merged, pages = self._retake(taken, merged, pages, fit)
                jobs = [j for j in jobs
                        if any(h.job == j for h, _, _ in taken)]
            merged = paging.pack_paged(merged, fam, target_rows=width)
        elif self.gcfg.backend != "native":
            merged = pad_batch(merged, width)
        rows = sum(b.size for _, b, _ in taken)
        self.counters["batches"] += 1
        self.counters["dispatches"] += 1
        if len(jobs) > 1:
            self.counters["mixed_batches"] += 1
        if self.gcfg.shed_levels:
            self.counters["shed_flushes"] += 1
        self.log.log("serve.batch", windows=rows, jobs=len(jobs),
                     stream=pool.stream, width=int(merged.size),
                     reason=reason, job="+".join(jobs))
        t_d = time.perf_counter()
        dh = self.path.dispatch(merged)
        dt = time.perf_counter() - t_d
        self.sat["dispatch_s"] += dt
        if self._sync_engine:
            self.sat["busy_s"] += dt
        rowmap = [(h, b.size) for h, b, _ in taken]
        self._inflight.append((dh, rowmap, rows))

    def _requeue(self, pool: _Pool, taken, fit: int) -> None:
        """Push rows past ``fit`` back to the front of the pool (the paged
        budget cut), keeping block order and each handle's row order."""
        off = 0
        tail_blocks: list[_Block] = []
        for h, b, p in taken:
            if off + b.size <= fit:
                off += b.size
                continue
            lo = max(fit - off, 0)
            tb = slice_batch(b, lo, b.size)
            tail_blocks.append(_Block(h, tb, None if p is None else p[lo:]))
            off += b.size
        for tb in reversed(tail_blocks):
            pool.blocks.appendleft(tb)
            pool.rows += tb.batch.size
            if tb.pages is not None:
                pool.pages += int(tb.pages.sum())
        if pool.rows and pool.oldest_ts is None:
            pool.oldest_ts = time.time()

    @staticmethod
    def _retake(taken, merged, pages, fit):
        """Trim the taken list, merged batch and page vector to ``fit``."""
        new_taken = []
        off = 0
        for h, b, p in taken:
            if off >= fit:
                break
            n = min(b.size, fit - off)
            new_taken.append((h, slice_batch(b, 0, n),
                              None if p is None else p[:n]))
            off += n
        return new_taken, slice_batch(merged, 0, fit), pages[:fit]

    # ------------------------------------------------------------------
    # drain + scatter
    # ------------------------------------------------------------------

    def _drain(self, to_depth: int) -> None:
        n_pop = len(self._inflight) - to_depth
        if n_pop <= 0:
            return
        entries = [self._inflight.popleft() for _ in range(n_pop)]
        t_f = time.perf_counter()
        try:
            outs = self.path.fetch_many([e[0] for e in entries])
        except BaseException:
            # the popped entries' handles would be stranded (neither pooled
            # nor in flight): abort them, so the other jobs' fetch raises
            # JobAborted with the truth (the solve path died); the error
            # itself goes to whoever drove this drain
            for _, rowmap, _ in entries:
                for handle, _n in rowmap:
                    handle.abort()
            raise
        self.sat["fetch_blocked_s"] += time.perf_counter() - t_f
        for (dh, rowmap, rows), out in zip(entries, outs):
            if not self._sync_engine:
                inner = getattr(dh, "inner", dh)
                self.sat["busy_s"] += getattr(inner, "busy_s", 0.0)
            lo = 0
            for handle, n in rowmap:
                part = self._slice_out(out, lo, lo + n, rows)
                lo += n
                handle.add_part(n, part)

    @staticmethod
    def _slice_out(out: dict, lo: int, hi: int, live: int) -> dict:
        """Rows [lo, hi) of a merged result, per field. Row-shaped arrays
        slice; numeric scalars zero for every part (a batch-level scalar
        cannot be attributed to one job's rows)."""
        part: dict = {}
        for k, v in out.items():
            if isinstance(v, np.ndarray) and v.ndim >= 1 and len(v) >= live:
                part[k] = v[lo:hi]
            elif isinstance(v, (int, float, np.integer, np.floating)):
                part[k] = type(v)(0)
            elif isinstance(v, np.ndarray) and v.ndim == 0:
                part[k] = np.zeros_like(v)
            else:
                part[k] = v
        return part


class _ClosedPath:
    """What a closed group dispatches through: nothing."""

    sup = None

    def close(self) -> None:
        pass


class JobSolver:
    """Per-job facade over a :class:`SolveGroup`: the async-solver duck type
    ``correct_shard`` takes (``dispatch``/``fetch``/``fetch_many``).
    ``accepts_partial`` tells the pipeline to skip its own padding (the
    group pads merged batches); ``routes_streams`` keeps the pipeline's
    split-ladder machinery on (the group routes the stream tags)."""

    accepts_partial = True
    routes_streams = True

    def __init__(self, group: SolveGroup, job: str):
        self.group = group
        self.job = job

    @property
    def ladder(self):
        """The group's warm ``TierLadder`` (None for native groups): the
        pipeline reuses it instead of building one per job."""
        return self.group.ladder

    @property
    def hp_ols(self):
        """The group's shared hp-pass OffsetLikely tables (read-only)."""
        return self.group.hp_ols

    def describe(self) -> str:
        return f"serve-batcher:{self.group.name}"

    def dispatch(self, batch: WindowBatch) -> JobHandle:
        return self.group.dispatch(self.job, batch)

    def fetch(self, handle: JobHandle) -> dict:
        return self.group.fetch(handle)

    def fetch_many(self, handles: list) -> list[dict]:
        return self.group.fetch_many(handles)
