"""Device supervisor: fault-tolerant dispatch/fetch with watchdog
classification, failover and optional failback.

The port's copy of ``daccord_tpu/runtime/supervisor.py``: the state
machine, its events and its fault plan are the JAX package's, so a
``DACCORD_FAULT`` spec walks the same transitions in both packages::

    HEALTHY ──cold shape──▶ COMPILING ──done──▶ HEALTHY
       │                        │ deadline
       │ timeout/error          ▼
       └──────────────────▶ SUSPECT ──probe alive──▶ RETRYING ──ok──▶ HEALTHY
                                │ probe dead /            │ fail
                                │ retries exhausted ◀─────┘
                                ▼
                              LOST ──fallback built──▶ DEGRADED
                                                          │ re-probe alive
                                                          ▼
                               HEALTHY ◀──primary ok── FAILBACK

*Deadline classification*: the first dispatch of a shape whose key is not in
the cold-shape registry (``utils/obs.py``) is COMPILING: its kernels may be
built by nvcc at first use, so it gets the long compile deadline and emits
heartbeats instead of being declared wedged. A warm op gets
``SupervisorConfig.op_deadline_s``, or, given the card's measured round
trip ``rtt_s`` (``utils.obs.measure_rtt_s``), ``rtt_s * rtt_mult`` floored at
``min_op_deadline_s``; expiry makes the device SUSPECT, and a
probe in a child process (``utils.obs.device_alive``) decides between
RETRYING (backoff with deterministic jitter, the op re-dispatched from its
retained batch) and LOST.

*Error classes*: a CUDA error that poisons the process's context (an
unspecified launch failure, an illegal address or instruction, a trap, a
device-side assert, an uncorrectable ECC error, and every later call on that
context) is device loss at once: no retry on this process can succeed. An
out-of-memory error (``torch.cuda.OutOfMemoryError``) is the capacity class,
which the governor (``runtime/governor.py``) walks down its bisect ladder
and which never spends the transient retry budget. A kernel that fails to
build, refuses its arguments or fails to launch without poisoning the
context (``kernels.nvcc.KernelError``, ``ValueError``, ``TypeError``) is
deterministic: it is raised to the caller, with no retry and no failover,
since it would fail the same way again and a failover would hide the
kernel. The ladder dispatcher
(``kernels/tiers.py``) raises a call's error again at ``fetch``, and the
supervisor classifies it there.

*Failover*: on LOST the supervisor builds the degraded engine once (the
port's plain ladder on the CPU, byte-exact with the card, or the host
library's native ladder) and re-solves every batch in flight on it; handles
retain their batch for that replay, so no window is dropped or duplicated.
Under the two-stream ladder (``--ladder split``) both streams' batches
replay so: a Stream B batch to its own result (the engine is a whole
ladder), a Stream A batch to whole-ladder rows, which compose byte for
byte, since the pipeline's pool rule (``kernels.tiers.rescue_candidates``)
solves every window it pools again to the same bytes and the others are
final.
With ``failback`` a background re-probe can route new dispatches back to a
revived card.

*Shadow audit*: a seeded sample of each fetched batch's rows is solved again
on the trusted reference (``kernels.tiers.audit_reference``: the card's own
ladder on the CPU) and compared byte for byte; a divergence logs
``sup_sdc`` and re-solves the whole batch on the reference, so the audit
rate changes detection latency, never output bytes. With an
``audit_worker`` (``audit/worker.py``, the default on the card) the
sample is drawn when the batch is dispatched and sent to that process (the
CPU ladder in numpy, byte-equal to the reference); its rows are compared
when the batch is fetched. Without a worker (the CPU default) the sample is
solved in this process at fetch time.

*Mesh* (``parallel/mesh.py``, ``mesh=`` the sharded solver): its shape
keys end in ``:m<N>`` (the active width), the governor bisects in mesh
multiples, and declared device loss first shrinks the mesh N -> N/2 (the
partial-mesh rung: ``mesh.shrink`` with the culprit member and a
``mesh.device`` row per member it drops) and replays the retained batch on
the rest, byte-identical; only at width 1 does the run fail over. A shadow
audit divergence on a mesh is attributed to its member by solving the
divergent window once on every member, and strikes that member's trust
ratchet (TRUSTED -> SUSPECT -> QUARANTINED), persisted in the trust registry
(``utils.obs.record_trust``, keys ``<platform>:m<K>``); a quarantined member
is shrunk out, in this run and, from the registry, at the next one's start
(``DACCORD_TRUST_PROBATION=1`` demotes it to SUSPECT instead).
"""

from __future__ import annotations

import queue
import random
import threading
import time
from dataclasses import dataclass

import os

from ..kernels.nvcc import KernelError
from ..utils.obs import TRUST_QUARANTINED, TRUST_SUSPECT, TRUST_TRUSTED
from ..utils.obs import env_float as _env_float
from .faults import (FaultCompileStall, FaultDeviceLost, FaultDeviceOOM,
                     FaultDispatchError, FaultHang, FaultPlan)
from .governor import (CapacityError, CapacityGovernor, GovernorConfig,
                       is_capacity_error)

# states (strings, not an enum: they go straight into JSON events)
HEALTHY = "HEALTHY"
COMPILING = "COMPILING"
SUSPECT = "SUSPECT"
RETRYING = "RETRYING"
LOST = "LOST"
DEGRADED = "DEGRADED"
FAILBACK = "FAILBACK"

#: legal state transitions (also enforced by ``eventcheck --strict``)
TRANSITIONS = {
    HEALTHY: {COMPILING, SUSPECT},
    COMPILING: {HEALTHY, SUSPECT},
    SUSPECT: {RETRYING, LOST, HEALTHY},
    RETRYING: {HEALTHY, COMPILING, SUSPECT, LOST},
    LOST: {DEGRADED},
    DEGRADED: {FAILBACK},
    # a failback rebuilds nothing but treats every shape as cold again
    FAILBACK: {HEALTHY, COMPILING, SUSPECT, LOST},
}

#: what a CUDA error that leaves the process's context unusable says
#: (cudaGetErrorString, and torch's "CUDA error: ..." on every later call)
_DEVICE_LOST_MARKERS = ("unspecified launch failure", "illegal memory access",
                        "illegal instruction", "device-side assert",
                        "uncorrectable ECC", "ECC error", "misaligned address",
                        "hardware stack error", "an illegal address",
                        "CUDA error: unknown error", "GPU is lost",
                        "device is unavailable")


class DeviceLostError(RuntimeError):
    """The supervisor declared the primary engine dead."""


class WatchdogTimeout(RuntimeError):
    """A guarded op exceeded its deadline."""


def is_device_lost_error(exc: BaseException) -> bool:
    """True when ``exc`` is a CUDA error after which no call of this
    process can reach the card (an unspecified launch failure, a trap, an
    illegal access, a device-side assert, an uncorrectable ECC error, and
    any later call on the poisoned context)."""
    if isinstance(exc, (DeviceLostError, FaultDeviceLost)):
        return True
    msg = str(exc)
    return any(m in msg for m in _DEVICE_LOST_MARKERS)


@dataclass
class SupervisorConfig:
    op_deadline_s: float = 300.0      # warm-shape deadline (no RTT estimate)
    rtt_mult: float = 300.0           # RTT-scaled deadline = rtt_s * this
    min_op_deadline_s: float = 30.0   # floor under the RTT scaling
    compile_deadline_s: float = 3600.0  # cold-shape deadline (the nvcc
                                      # builds at first use take seconds;
                                      # the bound is a wedge detector)
    heartbeat_s: float = 30.0         # COMPILING heartbeat cadence
    max_retries: int = 3
    backoff_base_s: float = 0.5
    backoff_cap_s: float = 30.0
    jitter: float = 0.25              # +[0, jitter) fraction, deterministic RNG
    probe_timeout_s: int = 150
    failback: bool = False
    failback_probe_s: float = 300.0   # min seconds between failback re-probes
    seed: int = 0

    @classmethod
    def from_env(cls, **overrides) -> "SupervisorConfig":
        """Env-tunable knobs (``DACCORD_SUP_*``); keyword overrides win."""
        cfg = cls(
            op_deadline_s=_env_float("DACCORD_SUP_OP_DEADLINE_S", 300.0),
            compile_deadline_s=_env_float("DACCORD_SUP_COMPILE_DEADLINE_S", 3600.0),
            heartbeat_s=_env_float("DACCORD_SUP_HEARTBEAT_S", 30.0),
            max_retries=int(_env_float("DACCORD_SUP_RETRIES", 3)),
            backoff_base_s=_env_float("DACCORD_SUP_BACKOFF_S", 0.5),
            probe_timeout_s=int(_env_float("DACCORD_PROBE_TIMEOUT_S", 150)),
            failback=_env_float("DACCORD_SUP_FAILBACK", 0.0) > 0,
        )
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg


class _Watchdog:
    """One daemon worker thread running guarded ops with a deadline.

    An abandoned (hung) op leaves its worker stuck inside the call; the
    watchdog then starts a fresh worker and queue, so later ops never queue
    behind it. Workers are daemonic: a hung call must not block exit."""

    def __init__(self):
        self._spawn()

    def _spawn(self) -> None:
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, args=(self._q,),
                                        daemon=True,
                                        name="daccord-supervisor-watchdog")
        self._thread.start()

    @staticmethod
    def _loop(q: queue.Queue) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            fn, args, box, done = item
            try:
                box[0] = fn(*args)
            except BaseException as e:  # noqa: BLE001 - relayed to caller
                box[1] = e
            finally:
                done.set()

    def run(self, fn, args, deadline_s: float, slice_s: float | None = None,
            on_wait=None):
        """Run ``fn(*args)`` on the worker; raise :class:`WatchdogTimeout`
        after ``deadline_s``. ``slice_s`` splits the wait so ``on_wait(t)``
        can emit heartbeats while a long (cold) op is legitimately silent."""
        box: list = [None, None]
        done = threading.Event()
        self._q.put((fn, args, box, done))
        waited = 0.0
        while True:
            step = deadline_s - waited
            if slice_s is not None:
                step = min(step, slice_s)
            if done.wait(step):
                break
            waited += step
            if waited >= deadline_s:
                self._spawn()   # abandon: the worker may be hung forever
                raise WatchdogTimeout(f"op exceeded {deadline_s:.0f}s deadline")
            if on_wait is not None:
                on_wait(waited)
        if box[1] is not None:
            raise box[1]
        return box[0]

    def close(self) -> None:
        """Stop the current worker once it is idle (a hung one is left)."""
        self._q.put(None)


class _SupHandle:
    """In-flight op handle: retains the dispatched batch so a retry can
    re-dispatch it and a failover can replay it on the degraded engine.
    ``result`` is set when the governor already solved the batch at
    dispatch time; fetch returns it directly, even after a later
    failover. ``audit_wait_ns`` is the fetch's wall in its shadow audit
    (the ``audit`` span: the wait for the worker's rows, or the in-process
    solve of the sample), booked by a serve group at its drain."""

    __slots__ = ("inner", "batch", "key", "degraded", "result", "audit", "audit_wait_ns")

    def __init__(self, inner, batch, key: str, degraded: bool = False,
                 result=None):
        self.inner = inner
        self.batch = batch
        self.key = key
        self.degraded = degraded
        self.result = result
        self.audit = None     # (rows, worker ticket): the sample drawn
                              # at dispatch and sent to the worker
        self.audit_wait_ns = 0


def shape_key(batch, fp_prefix: str, mesh_suffix: str = "") -> str:
    """The shape identity of a batch: the cold-shape registry and the
    governor's ratchet key (``cuda:B2048xD32xL64``; paged batches add the
    table, page and pool dims and ``:pg``). A Stream A batch of the
    two-stream ladder (``stream == "tier0"``) runs another program at the
    same shape (tier 0 alone, its own graph) and adds ``:t0``; Stream B's
    rescue batches run the whole ladder and share the fused key. A mesh
    dispatch ends in ``mesh_suffix`` (``:m<N>``)."""
    t0 = ":t0" if getattr(batch, "stream", "full") == "tier0" else ""
    if getattr(batch, "pool", None) is not None:
        b, ppw = batch.table.shape
        return (f"{fp_prefix}B{b}xD{batch.lens.shape[1]}"
                f"xL{batch.shape.seg_len}"
                f"xP{ppw}x{batch.family.page_len}"
                f"xN{batch.pool.shape[0]}:pg{t0}{mesh_suffix}")
    seqs = getattr(batch, "seqs", None)
    if seqs is None:
        return fp_prefix + "opaque" + mesh_suffix
    b, d, l = seqs.shape
    return f"{fp_prefix}B{b}xD{d}xL{l}{t0}{mesh_suffix}"


def _batch_id(batch) -> dict:
    """``{"batch": id}`` for a serve group's merged batch (its trace id,
    ``WindowBatch.rid``), else {}."""
    rid = getattr(batch, "rid", "")
    return {"batch": rid} if rid else {}


def _book_audit_wait(h, t0_ns: int) -> None:
    """Add the audit's wall since ``t0_ns`` to ``h.audit_wait_ns`` (a
    handle of another kind gets the attribute)."""
    h.audit_wait_ns = getattr(h, "audit_wait_ns", 0) + time.perf_counter_ns() - t0_ns


def _is_tier0(batch) -> bool:
    return getattr(batch, "stream", "full") == "tier0"


class DeviceSupervisor:
    """Wraps a solver's ``dispatch``/``fetch`` callables in the watchdog,
    classification and failover state machine, behind the same interface
    (with ``fetch_many``), so it drops into ``correct_shard``
    transparently.

    ``inline=True`` runs ops on the caller's thread with no watchdog (a
    CPU ladder cannot hang the way a card can). ``mesh`` is the sharded
    solver (``parallel/mesh.py``) of a mesh primary; ``fetch_many_fn`` a
    grouped fetch, guarded as one op (the mesh's, as in the JAX package). ``probe_fn`` answers
    whether the device is alive (default :func:`utils.obs.device_alive` on
    cuda). ``audit_ref_factory`` builds the shadow audit's in-process
    reference; ``audit_rate`` None reads ``DACCORD_AUDIT_RATE`` (default
    1/64). ``audit_worker`` (an ``AuditWorker`` sent its ladder) solves
    the samples in its own process; the in-process reference re-solves a
    batch found divergent. The caller closes the worker."""

    def __init__(self, dispatch_fn, fetch_fn, fetch_many_fn=None, *, fallback_factory=None,
                 log=None, cfg: SupervisorConfig | None = None,
                 faults: FaultPlan | None = None, probe_fn=None, describe: str = "",
                 fingerprint_prefix: str = "", inline: bool = False,
                 governor_cfg: GovernorConfig | None = None, tracer=None, mesh=None,
                 audit_ref_factory=None, audit_rate: float | None = None,
                 audit_worker=None, rtt_s: float | None = None):
        from ..utils.obs import NullLogger, Tracer

        self._dispatch_fn = dispatch_fn
        self._fetch_fn = fetch_fn
        self._fetch_many_fn = fetch_many_fn
        self._fallback_factory = fallback_factory
        self._fallback = None
        self.cfg = cfg or SupervisorConfig.from_env()
        self.log = log if log is not None else NullLogger()
        self.faults = faults if faults is not None else FaultPlan.from_env()
        self._probe_fn = probe_fn
        self._fp_prefix = fingerprint_prefix
        self._rng = random.Random(self.cfg.seed)
        self._inline = inline
        self._wd = None if inline else _Watchdog()
        self._seen_shapes: set[str] = set()
        self._ignore_fp_registry = False   # set on failback
        self._last_failback_probe = 0.0
        self.state = HEALTHY
        self.failed_over = False
        self.fail_reason: str | None = None
        # the JAX package's counters
        self.counters = {"dispatch": 0, "fetch": 0, "retries": 0,
                         "timeouts": 0, "probes": 0, "degraded_solves": 0,
                         "heartbeats": 0, "mesh_shrinks": 0,
                         "audits": 0, "sdc_detected": 0}
        # host-blocking wall inside governor ladder solves (they run at
        # dispatch time, so the pipeline's fetch timer never sees them)
        self.gov_device_s = 0.0
        self.tracer = tracer if tracer is not None else Tracer(self.log)
        self._mesh = mesh
        self.governor = CapacityGovernor(
            self._gov_solve_width, log=self.log,
            cfg=governor_cfg or GovernorConfig.from_env(), tracer=self.tracer,
            # a mesh bisects its slices in lockstep: widths stay mesh
            # multiples and the floor scales by the mesh's width
            quantum_fn=(lambda: self._mesh.nd) if mesh is not None else None)
        if rtt_s:
            self.op_deadline_s = max(self.cfg.min_op_deadline_s,
                                     rtt_s * self.cfg.rtt_mult)
        else:
            self.op_deadline_s = self.cfg.op_deadline_s
        self._audit_ref_factory = audit_ref_factory
        if audit_rate is None:
            audit_rate = _env_float("DACCORD_AUDIT_RATE", 1.0 / 64.0)
        self._audit_rate = (max(0.0, float(audit_rate))
                            if audit_ref_factory is not None else 0.0)
        self._audit_ref = None
        self._worker = audit_worker if self._audit_rate > 0.0 else None
        self._n_audit = 0          # audited-batch ordinal, seeds the sampler
        self.audit_s = 0.0         # host wall of the audit on this process:
                                   # the shadow solves, or with a worker the
                                   # sample's send, the wait for rows not
                                   # yet back, and the compare
        self.audit_warm_s = 0.0    # wall of the in-process reference's
                                   # first solve at each shape (not in
                                   # audit_s)
        self.audits_local = 0      # batches audited in this process
        self.audit_send_s = 0.0    # the sends' part of audit_s (sample,
                                   # rows, queue to the worker)
        self.audit_take_s = 0.0    # of that, taking the sampled rows (a
                                   # paged batch's table rows and pages)
        # this thread's CPU time in the sends and in the take: the rest of
        # their wall is waiting (for the interpreter lock above all)
        self.audit_send_cpu_s = 0.0
        self.audit_take_cpu_s = 0.0
        self.audit_disabled: str | None = None   # why the audit stopped
        self._audit_warmed: set[tuple] = set()
        self._trust: dict[int, dict] = {}
        self._trust_strikes_max = max(1, int(_env_float("DACCORD_TRUST_STRIKES", 2)))
        self._trust_probation = os.environ.get("DACCORD_TRUST_PROBATION", "") == "1"
        self.log.log("sup_init", primary=describe or "solver",
                     op_deadline_s=round(self.op_deadline_s, 1),
                     compile_deadline_s=self.cfg.compile_deadline_s,
                     rtt_s=rtt_s, faults=bool(self.faults),
                     failback=self.cfg.failback, inline=inline,
                     audit_rate=self._audit_rate)
        if self._mesh is not None:
            self._trust_load()

    def close(self) -> None:
        """Stop the watchdog's worker thread."""
        if self._wd is not None:
            self._wd.close()

    # ---- state machine -------------------------------------------------

    def _transition(self, to: str, reason: str = "") -> None:
        if to == self.state:
            return
        self.log.log("sup_state", state_from=self.state, state_to=to,
                     reason=reason)
        self.state = to

    def _probe(self) -> bool:
        self.counters["probes"] += 1
        t0 = time.time()
        if self.faults is not None:
            ov = self.faults.probe_override()
            if ov is not None:
                self.log.log("sup_probe", alive=ov, wall_s=0.0, injected=True)
                return ov
        with self.tracer.span("probe"):
            if self._probe_fn is not None:
                alive = bool(self._probe_fn())
            else:
                from ..utils.obs import device_alive

                alive = device_alive(self.cfg.probe_timeout_s)
        self.log.log("sup_probe", alive=alive, wall_s=round(time.time() - t0, 3))
        return alive

    def _mesh_suffix(self) -> str:
        """``:m<N>`` of a mesh primary at its current width: a mesh call is
        another program than one card's at the same batch shape (and than
        the same mesh at another width), so it is cold, ratcheted and
        registered apart. The partial-mesh rung changes N mid-run."""
        return f":m{self._mesh.nd}" if self._mesh is not None else ""

    def _shape_key(self, batch) -> str:
        return shape_key(batch, self._fp_prefix, self._mesh_suffix())

    def _is_fresh(self, key: str) -> bool:
        """Cold classification: not yet dispatched in this process and not
        in the cold-shape registry (which a failback ignores: a cold
        classification only costs a longer deadline)."""
        if key in self._seen_shapes:
            return False
        if self._ignore_fp_registry:
            return True
        from ..utils.obs import fingerprint_seen

        return not fingerprint_seen(key)

    # ---- guarded op core -----------------------------------------------

    def _guarded(self, op: str, fn, make_args, key: str, fresh: bool,
                 width: int | None = None):
        """Run one logical op with deadline classification and retry/probe.
        ``make_args(attempt)`` builds the arguments per attempt (a retried
        fetch re-dispatches its retained batch). Raises
        :class:`DeviceLostError` when the op cannot be salvaged,
        :class:`CapacityError` when it is memory-classified (the caller
        routes it to the governor, never the transient retry ladder) and a
        deterministic error (a kernel's build, arguments or launch) as it
        is."""
        cfg = self.cfg
        injected: BaseException | None = None
        if self.faults is not None:
            try:
                self.faults.op(op, compiling=fresh, width=width)
            except FaultDeviceLost as e:
                self.log.log("sup_fault", kind=e.kind, op=op, n=e.n)
                self._transition(SUSPECT, reason=str(e))
                raise DeviceLostError(str(e)) from e
            except (FaultHang, FaultDispatchError, FaultCompileStall,
                    FaultDeviceOOM) as e:
                self.log.log("sup_fault", kind=e.kind, op=op, n=e.n)
                injected = e
        if fresh:
            from ..utils.obs import expected_compile_wall_s

            b = int(key.rsplit("B", 1)[-1].split("x")[0]) if "B" in key else 0
            self._transition(COMPILING, reason=f"cold shape {key}")
            self.log.log("sup_compile", key=key,
                         expected_wall_s=round(expected_compile_wall_s(b), 1))

        def heartbeat(waited: float) -> None:
            self.counters["heartbeats"] += 1
            self.log.log("sup_heartbeat", op=op, key=key, waited_s=round(waited, 1),
                         deadline_s=cfg.compile_deadline_s, state=self.state)

        attempt = 0
        # retry budgets apply per class: timeouts and transient errors each
        # have their own; a deterministic class never consumes either
        n_retry = {"timeout": 0, "transient": 0}
        while True:
            attempt += 1
            err: BaseException | None = None
            try:
                if injected is not None:
                    e, injected = injected, None
                    raise e
                if self._inline:
                    out = fn(*make_args(attempt))
                else:
                    deadline = cfg.compile_deadline_s if fresh else self.op_deadline_s
                    # make_args runs inside the worker: a retry's re-dispatch
                    # is a device call that can hang too
                    a = attempt
                    # the op's spans parent under the caller's open span
                    out = self._wd.run(self.tracer.adopted(self.tracer.current(),
                                                           lambda: fn(*make_args(a))),
                                       (), deadline,
                                       slice_s=cfg.heartbeat_s if fresh else None,
                                       on_wait=heartbeat if fresh else None)
                if self.state in (COMPILING, RETRYING, FAILBACK, SUSPECT):
                    self._transition(HEALTHY, reason=f"{op} ok")
                return out
            except FaultCompileStall:
                # one silent heartbeat slice, then proceed: the deterministic
                # stand-in for a long cold build
                heartbeat(cfg.heartbeat_s)
                continue
            except (WatchdogTimeout, FaultHang) as e:
                self.counters["timeouts"] += 1
                err = e
                cls = "timeout"
                reason = f"{op} timeout: {e}"
            except (DeviceLostError, CapacityError):
                raise
            except FaultDeviceLost as e:
                self._transition(SUSPECT, reason=str(e))
                raise DeviceLostError(str(e)) from e
            except Exception as e:
                if is_capacity_error(e):
                    # deterministic: the identical shape would fail again;
                    # the governor's ladder is the remedy (the card is full,
                    # not dead)
                    if self.state in (COMPILING, RETRYING, FAILBACK, SUSPECT):
                        self._transition(HEALTHY, reason="capacity classified")
                    raise CapacityError(f"{op}: {e}", width=int(width or 0)) from e
                if is_device_lost_error(e):
                    # a poisoned CUDA context: no retry in this process can
                    # reach the card, whatever a fresh process's probe says
                    reason = f"{op} error: {type(e).__name__}: {e}"
                    self._transition(SUSPECT, reason=reason[:200])
                    raise DeviceLostError(reason[:200]) from e
                if isinstance(e, (KernelError, ValueError, TypeError)):
                    # deterministic: the same call fails the same way on
                    # every retry, and a failover would hide the kernel
                    raise
                err = e
                cls = "transient"
                reason = f"{op} error: {type(e).__name__}: {e}"
            self._transition(SUSPECT, reason=reason[:200])
            if not self._probe():
                raise DeviceLostError(reason) from err
            n_retry[cls] += 1
            if n_retry[cls] > cfg.max_retries:
                raise DeviceLostError(
                    f"{op}: {cfg.max_retries} {cls} retries exhausted") from err
            delay = min(cfg.backoff_cap_s, cfg.backoff_base_s * (2 ** (n_retry[cls] - 1)))
            delay *= 1.0 + cfg.jitter * self._rng.random()
            self.counters["retries"] += 1
            self.log.log("sup_retry", op=op, attempt=attempt, cls=cls,
                         delay_s=round(delay, 3), reason=reason[:200])
            time.sleep(delay)
            self._transition(RETRYING, reason=f"{op} attempt {attempt + 1}")
            fresh = False   # a retry is never a cold build

    # ---- failover / failback -------------------------------------------

    def _engage_fallback(self, reason: str):
        if self._fallback is None:
            if self._fallback_factory is None:
                raise DeviceLostError(
                    f"device lost ({reason}) and no fallback engine configured")
            self._transition(LOST, reason=reason[:200])
            self.failed_over = True
            self.fail_reason = reason[:200]
            try:
                self._fallback = self._fallback_factory()
            except Exception as e:
                raise DeviceLostError(
                    f"device lost ({reason}) and the fallback engine could not "
                    f"be built: {e}") from e
            self._transition(DEGRADED, reason="fallback engine ready")
            self.log.log("sup_failover", reason=reason[:200],
                         fallback=getattr(self._fallback, "__name__",
                                          type(self._fallback).__name__))
        elif self.state != DEGRADED:
            # lost again after a failback: re-enter DEGRADED, or every later
            # dispatch would retry the dead primary
            self._transition(LOST, reason=reason[:200])
            self._transition(DEGRADED, reason="fallback engine re-engaged")
            self.log.log("sup_failover", reason=reason[:200],
                         fallback=getattr(self._fallback, "__name__",
                                          type(self._fallback).__name__))
        return self._fallback

    def _degraded_solve(self, batch, op: str):
        fb = self._engage_fallback("degraded op")
        if self.faults is not None:
            self.faults.op(op, degraded=True)   # only `crash` can fire here
        self.counters["degraded_solves"] += 1
        if hasattr(batch, "to_dense"):
            # the degraded engines iterate dense rows: unpack a paged batch
            # first (byte-identical by the pack/unpack round trip)
            batch = batch.to_dense()
        return fb(batch)

    def _maybe_failback(self) -> bool:
        """In DEGRADED with failback on: re-probe (rate-limited) and, when
        the card answers, route the next dispatches back to the primary,
        every shape cold again."""
        if self.state != DEGRADED or not self.cfg.failback:
            return False
        now = time.time()
        if now - self._last_failback_probe < self.cfg.failback_probe_s:
            return False
        self._last_failback_probe = now
        if self.faults is not None and self.faults.device_dead:
            return False
        if not self._probe():
            return False
        self._transition(FAILBACK, reason="re-probe alive")
        self._seen_shapes.clear()
        self._ignore_fp_registry = True
        if self._mesh is not None and self._mesh.nd < len(getattr(self._mesh, "_devices0", [])):
            # the revived members come back whole, every shape cold again
            nd_from = self._mesh.nd
            self._mesh.restore()
            self.log.log("mesh.restore", nd_from=nd_from, nd_to=self._mesh.nd)
        self.log.log("sup_failback")
        return True

    # ---- partial-mesh degradation rung ----------------------------------

    def _mesh_degrade(self, reason: str, culprit: int = -1) -> bool:
        """On declared device loss with a mesh primary: shrink the mesh
        N -> N/2 and keep the run on the rest (the caller replays the
        retained batch, byte-identical: windows solve independently)
        instead of failing over whole. False at width 1 (``mesh.degrade``):
        the caller fails over. Walks SUSPECT -> RETRYING.

        The culprit: an injected loss names its member
        (``device_lost:N@K``); a real loss on a card mesh probes every
        member against one deadline. It rides ``mesh.shrink``, and each
        member the shrink drops gets a ``mesh.device`` row."""
        m = self._mesh
        if m is None:
            return False
        if m.nd <= 1:
            self.log.log("mesh.degrade", nd=int(m.nd), reason=reason[:200])
            return False
        nd_from = m.nd
        if culprit < 0:
            if self.faults is not None and self.faults.dead_device >= 0:
                culprit = self.faults.dead_device
            elif self.faults is None and not getattr(m, "host_local", True):
                with self.tracer.span("probe"):
                    dead = m.probe_devices()
                if len(dead) == 1:
                    culprit = dead[0]
        prev = {i: row.get("state") for i, row in getattr(m, "device_stats", {}).items()}
        m.shrink(culprit=culprit)
        if self.faults is not None:
            # an injected loss marks the whole backend dead; here it was one
            # member, which the shrink just removed: the rest are a fresh
            # primary (a second device_lost spec kills another member)
            self.faults.device_dead = False
            self.faults.dead_device = -1
        self.counters["mesh_shrinks"] += 1
        self.log.log("mesh.shrink", nd_from=int(nd_from), nd_to=int(m.nd),
                     culprit=int(culprit), reason=reason[:200])
        self._log_dropped(prev)
        self._transition(RETRYING, reason=f"partial mesh {nd_from}->{m.nd}")
        return True

    def _log_dropped(self, prev: dict) -> None:
        """One ``mesh.device`` row per member whose state changed since
        ``prev``."""
        for i, row in getattr(self._mesh, "device_stats", {}).items():
            if row.get("state") != prev.get(i):
                self.log.log("mesh.device", device=int(i), state=row["state"],
                             platform=row.get("platform", "?"),
                             dispatches=int(row.get("dispatches", 0)))

    # ---- capacity governor hooks ---------------------------------------

    @staticmethod
    def _width_of(batch) -> int | None:
        w = getattr(batch, "size", None)
        return int(w) if w is not None else None

    def _gov_solve_width(self, batch):
        """One guarded dispatch and fetch of ``batch`` at its own (reduced)
        width: the governor's rung executor. A shrunken width is keyed
        normally (cold classification, registry); transient faults still
        retry; a capacity fault propagates for the governor to shrink
        further."""
        key = self._shape_key(batch)
        w = self._width_of(batch)
        fresh = self._is_fresh(key)
        self.counters["dispatch"] += 1
        t_d = time.time()
        inner = self._guarded("dispatch", self._dispatch_fn,
                              lambda attempt: (batch,), key, fresh, width=w)
        self._seen_shapes.add(key)
        if fresh:
            self._record_compile(key, time.time() - t_d)
        h = _SupHandle(inner, batch, key)
        self.counters["fetch"] += 1
        return self._guarded("fetch", self._fetch_fn,
                             lambda attempt: self._refetch_args(h, attempt),
                             key, fresh=False, width=w)

    def _gov_dispatch(self, batch, key: str, reason: str | None) -> _SupHandle:
        """Route ``batch`` through the governor's degradation ladder; a
        handle carrying the solved result. A ladder exhausted all the way
        down fails over; a device loss mid-walk shrinks a mesh primary
        first (the ratchets then key under the new ``:m<N>``), else fails
        over."""
        t0 = time.time()
        try:
            while True:
                try:
                    out = self.governor.solve(batch, key, reason=reason)
                    break
                except DeviceLostError as e:
                    if self._mesh_degrade(str(e)):
                        key = self._shape_key(batch)
                        continue
                    self._engage_fallback(str(e))
                    return _SupHandle(None, batch, key, degraded=True)
        except CapacityError as e:
            # last rung: failover. SUSPECT precedes LOST, the legal chain
            self._transition(SUSPECT, reason=f"capacity: {e}"[:200])
            self._engage_fallback(f"capacity ladder exhausted: {e}")
            return _SupHandle(None, batch, key, degraded=True)
        finally:
            if not self._inline:
                self.gov_device_s += time.time() - t0
        return _SupHandle(None, batch, key, result=out)

    # ---- solver interface ----------------------------------------------

    def dispatch(self, batch) -> _SupHandle:
        # a mesh StagedBatch carries its member slices and the host batch
        # they came from: only the first attempt uses the slices, and every
        # replay (retry, bisect, shrink, failover) the host batch
        staged = batch if hasattr(batch, "replay_batch") else None
        batch = staged.replay_batch if staged is not None else batch
        key = self._shape_key(batch)
        if self.state == DEGRADED:
            self._maybe_failback()
        if self.state in (LOST, DEGRADED):
            # degraded dispatch is lazy: the batch solves at fetch time, so
            # the pipeline's dispatch/drain cadence is kept
            self.counters["dispatch"] += 1
            if self.faults is not None:
                self.faults.op("dispatch", degraded=True)
            return _SupHandle(None, batch, key, degraded=True)
        w = self._width_of(batch)
        if w is not None and self.governor.planned_width(key, w) is not None:
            # a ratcheted shape dispatches at its known-good width directly
            return self._gov_dispatch(batch, key, reason=None)
        self.counters["dispatch"] += 1
        while True:
            fresh = self._is_fresh(key)
            t_d = time.time()
            arg = staged if staged is not None else batch
            try:
                inner = self._guarded("dispatch", self._dispatch_fn,
                                      lambda attempt: (arg if attempt == 1 else batch,),
                                      key, fresh, width=w)
                break
            except CapacityError as e:
                return self._gov_dispatch(batch, key, reason=str(e))
            except DeviceLostError as e:
                # the partial-mesh rung: a narrower mesh is a new primary at
                # a new :m<N> key; the slices staged for the old one go
                if self._mesh_degrade(str(e)):
                    staged = None
                    key = self._shape_key(batch)
                    continue
                self._engage_fallback(str(e))
                return _SupHandle(None, batch, key, degraded=True)
        self._seen_shapes.add(key)
        if fresh:
            self._record_compile(key, time.time() - t_d)
        h = _SupHandle(inner, batch, key)
        if self._worker is not None:
            self._audit_send(h)
        return h

    def _record_compile(self, key: str, wall_s: float) -> None:
        """Record a cold shape's first dispatch wall in the registry (the
        first, cold wall is kept) and as ``sup_compile_done``."""
        from ..utils.obs import record_fingerprint

        record_fingerprint(key, wall_s=wall_s)
        self.log.log("sup_compile_done", key=key, wall_s=round(wall_s, 3))

    def _refetch_args(self, h: _SupHandle, attempt: int):
        """Arguments of a guarded fetch: attempt 1 uses the live handle; a
        retry re-dispatches the retained batch first, so exactly one result
        per batch reaches the caller."""
        if attempt > 1 or h.inner is None:
            h.inner = self._dispatch_fn(h.batch)
        return (h.inner,)

    def fetch(self, handle: _SupHandle):
        h = handle
        if h.result is not None:
            # solved by the governor at dispatch time: final, also after a
            # later failover
            return h.result
        self.counters["fetch"] += 1
        if h.degraded or self.state in (LOST, DEGRADED):
            self._audit_drop(h)
            return self._degraded_solve(h.batch, "fetch")
        try:
            out = self._guarded("fetch", self._fetch_fn,
                                lambda attempt: self._refetch_args(h, attempt),
                                h.key, fresh=False, width=self._width_of(h.batch))
            return self._postfetch(h, out)
        except CapacityError as e:
            # the OOM surfaced at the fetch: the retained batch re-solves
            # down the ladder
            self._audit_drop(h)
            gh = self._gov_dispatch(h.batch, h.key, reason=str(e))
            if gh.result is not None:
                return gh.result
            return self._degraded_solve(h.batch, "fetch")
        except DeviceLostError as e:
            self._audit_drop(h)
            if self._mesh_degrade(str(e)):
                # replay the retained batch on the narrower mesh; a further
                # loss recurses (another shrink, or failover at width 1)
                return self.fetch(self.dispatch(h.batch))
            self._engage_fallback(str(e))
            return self._degraded_solve(h.batch, "fetch")

    def fetch_many(self, handles: list) -> list:
        """:meth:`fetch` of each handle, in order: each fetch is its own
        guarded op (a local card has no transfer round trip to group), as
        the JAX package's synchronous CPU engine counts them. With a
        ``fetch_many_fn`` (a mesh) the group is one guarded op, as the JAX
        package's grouped fetch is; on a declared loss every batch of the
        group replays on the narrower mesh, or on the failover engine."""
        if (self._fetch_many_fn is None or len(handles) == 1
                or any(h.degraded or h.result is not None for h in handles)
                or self.state in (LOST, DEGRADED)):
            return [self.fetch(h) for h in handles]
        self.counters["fetch"] += 1
        width = max((w for w in map(self._width_of, (h.batch for h in handles))
                     if w is not None), default=None)

        def make_args(attempt):
            for h in handles:
                if attempt > 1 or h.inner is None:
                    h.inner = self._dispatch_fn(h.batch)
            return ([h.inner for h in handles],)

        try:
            outs = self._guarded("fetch", self._fetch_many_fn, make_args,
                                 handles[0].key, fresh=False, width=width)
            return [self._postfetch(h, o) for h, o in zip(handles, outs)]
        except CapacityError:
            # a group is not a capacity unit: each batch on its own width
            self.counters["fetch"] -= 1
            return [self.fetch(h) for h in handles]
        except DeviceLostError as e:
            for h in handles:
                self._audit_drop(h)
            if self._mesh_degrade(str(e)):
                self.counters["fetch"] -= 1
                return [self.fetch(self.dispatch(h.batch)) for h in handles]
            self._engage_fallback(str(e))
            return [self._degraded_solve(h.batch, "fetch") for h in handles]

    # ---- silent-data-corruption defense --------------------------------

    def _postfetch(self, h, out):
        """On every successful primary fetch: inject a pending ``sdc``
        fault (silent corruption of the consensus rows), then the sampled
        shadow audit. Degraded and governor-solved results never pass here:
        their engine shares bytes with the reference."""
        if not isinstance(out, dict) or "cons" not in out:
            return out
        if self.faults is not None and self.faults.has_sdc_faults():
            spec = self.faults.sdc_check()
            if spec is not None:
                self._sdc_corrupt(out, spec.device)
        if self._audit_rate > 0.0 and self._audit_ref_factory is not None:
            if h.audit is None:
                out = self._audit(h, out)
            else:
                out = self._audit_remote(h, out)
        return out

    def _sdc_corrupt(self, out: dict, device: int) -> None:
        """Corrupt the rows mesh member ``device`` solved (every row when
        the spec names no member or there is no mesh); nothing when the
        member was shrunk out, or got only pad rows."""
        B = int(out["cons"].shape[0])
        rows = range(B)
        if device >= 0 and self._mesh is not None and self._mesh.nd > 1:
            members = self._mesh.member_ids()
            if device not in members:
                return
            per = -(-B // len(members))
            j = members.index(device)
            rows = range(j * per, min((j + 1) * per, B))
        self._corrupt_rows(out, rows)

    @staticmethod
    def _corrupt_rows(out: dict, rows) -> None:
        """Bump the live consensus bases of ``rows`` in place: valid
        alphabet, valid lengths, no flag touched."""
        import numpy as np

        cons = np.asarray(out["cons"])
        if not cons.flags.writeable:
            cons = cons.copy()
            out["cons"] = cons
        cl = np.asarray(out["cons_len"])
        solved = np.asarray(out["solved"])
        for i in rows:
            if not bool(solved[i]):
                continue
            n = int(cl[i])
            if n <= 0:
                continue
            seg = cons[i, :n]
            live = seg < 4
            seg[live] = (seg[live] + 1) % 4

    def _audit_engine(self):
        """Lazy build of the reference; a build failure disables the audit
        for the run (it is a defense, not a dependency)."""
        if self._audit_ref is None and self._audit_ref_factory is not None:
            try:
                with self.tracer.span("audit.build"):
                    self._audit_ref = self._audit_ref_factory()
            except Exception as e:
                self._audit_off(e)
                self._audit_ref_factory = None
                return None
        return self._audit_ref

    def _audit_off(self, e: BaseException) -> None:
        """Stop auditing for the rest of the run (a defense, not a
        dependency): ``audit.disabled`` with the error."""
        self.log.log("audit.disabled", error=str(e)[:200])
        self.audit_disabled = str(e)[:200]
        self._audit_rate = 0.0
        self._worker = None

    def _audit_sample(self, B: int) -> list[int]:
        """The seeded row sample of one audited batch: ``max(1,
        round(B * rate))`` rows, seeded by (seed, audit ordinal) so a rerun
        samples the same rows. On a mesh a lying member cannot hide in the
        rows not sampled: when the budget covers the mesh every member's
        slice gives a row each batch, below it the slices take turns."""
        rng = random.Random((self.cfg.seed << 16) ^ self._n_audit)
        k = min(max(1, round(B * self._audit_rate)), B)
        rows: set[int] = set()
        if self._mesh is not None and self._mesh.nd > 1:
            nd = self._mesh.nd
            per = -(-B // nd)
            for j in (range(nd) if k >= nd else [self._n_audit % nd]):
                lo, hi = j * per, min((j + 1) * per, B)
                if lo < hi:
                    rows.add(rng.randrange(lo, hi))
        while len(rows) < k:
            rows.add(rng.randrange(B))
        return sorted(rows)

    @staticmethod
    def _take_rows(batch, rows):
        """Row-subset copy of a batch (``audit.worker.take_rows``, in the
        host library with the interpreter lock held). A paged batch stays
        paged: those rows' table and the pool pages it names, unpacked where
        the sample is solved."""
        from ..audit.worker import take_rows

        return take_rows(batch, rows)

    @staticmethod
    def _rows_equal(dev: dict, ref: dict, i: int, j: int, tier0: bool = False):
        """Byte comparison of device row ``i`` against reference row ``j``:
        solved, and the consensus bytes of a solved row (err and tier never
        reach the FASTA). None skips a row the comparison cannot judge: on a
        Stream A batch (``tier0``) only the rows the device calls final
        (solved, no top-M flag) are compared, since the others pool for
        Stream B, where they are audited with the whole ladder."""
        import numpy as np

        if tier0 and (not bool(dev["solved"][i]) or bool(dev["m_ovf"][i])):
            return None
        if bool(dev["solved"][i]) != bool(ref["solved"][j]):
            return False
        if not bool(dev["solved"][i]):
            return True
        nd_, nr_ = int(dev["cons_len"][i]), int(ref["cons_len"][j])
        if nd_ != nr_:
            return False
        return bool(np.array_equal(np.asarray(dev["cons"])[i, :nd_],
                                   np.asarray(ref["cons"])[j, :nr_]))

    def _audit_send(self, h: _SupHandle) -> None:
        """At dispatch: draw the batch's sample (the ordinal in dispatch
        order, which is fetch order) and send its rows to the worker."""
        B = int(h.batch.size)
        if B <= 0:
            return
        t0, c0 = time.perf_counter(), time.thread_time()
        rows = self._audit_sample(B)
        self._n_audit += 1
        t1, c1 = time.perf_counter(), time.thread_time()
        sample = self._take_rows(h.batch, rows)
        t2, c2 = time.perf_counter(), time.thread_time()
        h.audit = (rows, self._worker.submit(sample, tier0_only=_is_tier0(h.batch)))
        dt = time.perf_counter() - t0
        self.audit_take_s += t2 - t1
        self.audit_take_cpu_s += c2 - c1
        self.audit_send_cpu_s += time.thread_time() - c0
        self.audit_send_s += dt
        self.audit_s += dt

    def landed(self, h: _SupHandle, engine_landed) -> bool:
        """Whether :meth:`fetch` of ``h`` would take its result without
        waiting on the engine or solving it on the host: a governor result,
        or a primary call that ``engine_landed(h.inner)`` says has landed.
        A degraded handle, or any while failed over, re-solves on the
        failover engine: not landed. The audit is :meth:`audit_pending`'s."""
        if h.result is not None:
            return True
        if h.degraded or h.inner is None or self.state in (LOST, DEGRADED):
            return False
        return engine_landed(h.inner)

    def audit_pending(self, h) -> bool:
        """Whether ``h``'s sample is with the worker and its rows are not
        back yet (no wait: the fetch of ``h`` would wait for them)."""
        return (getattr(h, "audit", None) is not None and self._worker is not None
                and not self._worker.done(h.audit[1]))

    def _audit_drop(self, h: _SupHandle) -> None:
        """The batch will not be compared (it re-solves elsewhere)."""
        if h.audit is not None and self._worker is not None:
            self._worker.discard(h.audit[1])
        h.audit = None

    def _audit_remote(self, h: _SupHandle, out: dict):
        """At fetch: wait for the worker's rows of ``h``'s sample and compare
        them byte for byte; a divergence re-solves the whole batch on the
        in-process reference, as :meth:`_audit` does."""
        from ..audit.worker import AuditWorkerError

        rows, ticket = h.audit
        h.audit = None
        worker = self._worker
        if worker is None:
            return out          # disabled since the batch was dispatched
        t0 = time.time()
        t_w = time.perf_counter_ns()
        try:
            with self.tracer.span("audit", rows=len(rows), **_batch_id(h.batch)):
                # a CPU process's wait: the flat deadline, not the card's
                # RTT-scaled one
                ref = worker.result(ticket, self.cfg.op_deadline_s)
        except AuditWorkerError as e:
            self._audit_off(e)
            return out
        finally:
            _book_audit_wait(h, t_w)
        self.counters["audits"] += 1
        tier0 = _is_tier0(h.batch)
        divergent = [i for j, i in enumerate(rows)
                     if self._rows_equal(out, ref, i, j, tier0) is False]
        if divergent:
            out = self._audit_diverged(h, out, rows, divergent)
        self.audit_s += time.time() - t0
        return out

    def _audit_diverged(self, h, out: dict, rows: list, divergent: list):
        """``sup_sdc``, the whole batch re-solved on the in-process
        reference (synchronous: rare, and the caller must not see the
        corrupt rows), and a trust strike. A Stream A batch re-solves to
        whole-ladder rows, which the pipeline's pool rule composes byte for
        byte, as it does a failover's."""
        import numpy as np

        B = int(np.asarray(out["cons"]).shape[0])
        self.counters["sdc_detected"] += 1
        culprit = self._sdc_attribute(h.batch, divergent[0])
        self.log.log("sup_sdc", key=h.key, rows=int(B), sampled=len(rows),
                     divergent=len(divergent), row=int(divergent[0]),
                     culprit=int(culprit))
        eng = self._audit_engine()
        if eng is not None:
            batch = h.batch
            dense = batch.to_dense() if hasattr(batch, "to_dense") else batch
            with self.tracer.span("audit.resolve", rows=int(B)):
                out = eng(dense)
        self._trust_strike(culprit, "shadow audit divergence")
        return out

    def _sdc_attribute(self, batch, row: int) -> int:
        """The mesh member that solved divergent window ``row`` wrongly:
        the window solved once on every member (the row repeated mesh-width
        times, one a slice) on the raw mesh, not the supervised path, and
        each member's copy compared with the reference. An injected liar
        (``sdc:N@K``) lies here too. -1 off a mesh or when no copy
        diverges."""
        m = self._mesh
        if m is None or m.nd <= 1:
            return -1
        eng = self._audit_engine()
        if eng is None:
            return -1
        import dataclasses

        import numpy as np

        dense = batch.to_dense() if hasattr(batch, "to_dense") else batch
        nd = int(m.nd)

        def rep(a):
            return np.repeat(a[row:row + 1], nd, axis=0)

        probe = dataclasses.replace(
            dense, seqs=rep(dense.seqs), lens=rep(dense.lens), nsegs=rep(dense.nsegs),
            read_ids=rep(dense.read_ids), wstarts=rep(dense.wstarts), stream="full")
        members = m.member_ids()
        try:
            pout = m.fetch(m.dispatch(probe))
        except Exception as e:
            self.log.log("audit.attrib", row=int(row), culprit=-1, nd=nd,
                         error=str(e)[:200])
            return -1
        if self.faults is not None:
            liars = self.faults.sdc_liars()
            for j, orig in enumerate(members):
                if orig in liars:
                    self._corrupt_rows(pout, [j])
        ref1 = eng(dataclasses.replace(
            dense, seqs=dense.seqs[row:row + 1], lens=dense.lens[row:row + 1],
            nsegs=dense.nsegs[row:row + 1], read_ids=dense.read_ids[row:row + 1],
            wstarts=dense.wstarts[row:row + 1], stream="full"))
        culprits = [members[j] for j in range(len(members))
                    if self._rows_equal(pout, ref1, j, 0) is False]
        culprit = int(culprits[0]) if culprits else -1
        self.log.log("audit.attrib", row=int(row), culprit=culprit, nd=nd)
        return culprit

    def _audit(self, h, out: dict):
        """Shadow-verify a seeded sample of ``out``'s rows, drawn now,
        against the in-process reference, byte for byte. On divergence:
        ``sup_sdc``, a trust strike, and the WHOLE batch re-solved on the
        reference, so a detected corruption never reaches the caller."""
        import numpy as np

        B = int(np.asarray(out["cons"]).shape[0])
        eng = self._audit_engine() if B > 0 else None
        if eng is None:
            return out
        rows = self._audit_sample(B)
        self._n_audit += 1
        self.counters["audits"] += 1
        self.audits_local += 1
        sample = self._take_rows(h.batch, rows)
        shape = (len(rows), sample.shape.depth, sample.shape.seg_len)
        if shape not in self._audit_warmed:
            # the first audit at a shape pays the reference's warm-up, once,
            # under its own span and audit_warm_s, not under audit_s
            self._audit_warmed.add(shape)
            t0 = time.time()
            with self.tracer.span("audit.warm", rows=len(rows)):
                eng(sample)
            self.audit_warm_s += time.time() - t0
        t0 = time.time()
        t_w = time.perf_counter_ns()
        with self.tracer.span("audit", rows=len(rows), **_batch_id(h.batch)):
            ref = eng(sample)
        _book_audit_wait(h, t_w)
        tier0 = _is_tier0(h.batch)
        divergent = [i for j, i in enumerate(rows)
                     if self._rows_equal(out, ref, i, j, tier0) is False]
        if divergent:
            out = self._audit_diverged(h, out, rows, divergent)
        self.audit_s += time.time() - t0
        return out

    def _trust_key(self, orig: int) -> str:
        """The trust registry's key of member ``orig``: ``<platform>:m<K>``
        (-1: the device of a run without a mesh)."""
        return f"{self._fp_prefix}m{int(orig)}"

    def _trust_strike(self, orig: int, reason: str) -> None:
        """Ratchet a device TRUSTED -> SUSPECT -> QUARANTINED (never looser
        within a run), persisted in the trust registry so the next run
        starts from it. Quarantine drives the existing rungs: the
        partial-mesh shrink for an attributed member, whole-program
        failover otherwise."""
        from ..utils.obs import record_trust

        orig = int(orig)
        ent = self._trust.setdefault(orig, {"state": TRUST_TRUSTED, "strikes": 0})
        ent["strikes"] += 1
        frm = ent["state"]
        to = TRUST_QUARANTINED if ent["strikes"] >= self._trust_strikes_max else TRUST_SUSPECT
        if frm == TRUST_QUARANTINED:
            to = TRUST_QUARANTINED
        ent["state"] = to
        self.log.log("trust.state", device=orig, state_from=frm, state_to=to,
                     strikes=int(ent["strikes"]))
        record_trust(self._trust_key(orig), to, ent["strikes"])
        if to != TRUST_QUARANTINED or frm == TRUST_QUARANTINED:
            return
        # SUSPECT first: the state machine has no HEALTHY -> RETRYING edge
        if (self._mesh is not None and self._mesh.nd > 1
                and orig in self._mesh.member_ids()):
            if self.state in (HEALTHY, COMPILING):
                self._transition(SUSPECT, reason=reason)
            self._mesh_degrade(f"trust quarantined: {reason}", culprit=orig)
        elif self._fallback_factory is not None:
            if self.state in (HEALTHY, COMPILING, RETRYING):
                self._transition(SUSPECT, reason=reason)
            try:
                self._engage_fallback(f"trust quarantined: {reason}")
            except DeviceLostError:
                pass        # no fallback buildable: keep running, keep auditing

    def _trust_load(self) -> None:
        """The registry's trust state of the active mesh members, read once
        after ``sup_init``: a quarantined member is shrunk out before it
        solves a window, unless ``DACCORD_TRUST_PROBATION=1`` demotes it to
        SUSPECT for a re-verify."""
        from ..utils.obs import record_trust, trust_registry

        reg = trust_registry()
        if not reg:
            return
        m = self._mesh
        for orig in list(m.member_ids()):
            ent = reg.get(self._trust_key(orig))
            if not ent:
                continue
            state = ent.get("state")
            strikes = int(ent.get("strikes", 0))
            self._trust[int(orig)] = {"state": state, "strikes": strikes}
            self.log.log("trust.load", device=int(orig), state=state, strikes=strikes)
            if state != TRUST_QUARANTINED:
                continue
            if self._trust_probation:
                demoted = max(0, strikes - 1)
                self._trust[int(orig)] = {"state": TRUST_SUSPECT, "strikes": demoted}
                self.log.log("trust.state", device=int(orig), state_from=state,
                             state_to=TRUST_SUSPECT, strikes=demoted)
                record_trust(self._trust_key(orig), TRUST_SUSPECT, demoted)
                continue
            while m.nd > 1 and orig in m.member_ids():
                nd_from = m.nd
                prev = {i: row.get("state") for i, row in
                        getattr(m, "device_stats", {}).items()}
                m.shrink(culprit=int(orig))
                self.counters["mesh_shrinks"] += 1
                self.log.log("mesh.shrink", nd_from=int(nd_from), nd_to=int(m.nd),
                             culprit=int(orig), reason="trust quarantined (registry)")
                self._log_dropped(prev)
