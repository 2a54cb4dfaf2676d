"""Shard fleet orchestrator: supervised multi-shard runs, the port's copy of
the JAX package's ``parallel/fleet.py`` (``fleet``).

One orchestrator (or several, on different hosts) drives all N ``-J i,n``
shards to completion unattended, over the shared filesystem the shard
launcher (``parallel/launch.py``) already requires.

**Work distribution is coordinator-free.** A shard is claimed by atomically
creating its lease file (``O_CREAT|O_EXCL``, ``utils/lease.py``) in
``OUTDIR/leases/``; of N hosts racing, exactly one wins. The holder renews
the lease by bumping its mtime every ``heartbeat_s``; a lease whose mtime is
older than ``lease_ttl_s`` is *stale* — its host died or wedged — and any
orchestrator may take the shard over by removing the stale file and
re-claiming. The takeover is logged with the previous holder's identity.

**Workers are expendable subprocesses** (``python -m
daccord_tpu_torch.tools.cli shard``), bounded by a local slot pool, each
given ``--backend`` and ``--device`` (a CPU fleet stays on the CPU by
request; ``--backend auto`` resolves once here, by
``utils.obs.resolve_auto_backend``: the card, or an error without one).
Their failure modes are detected, not awaited:

- *crash* — nonzero exit (or exit 0 without a trustworthy manifest);
- *hang* — no shard-manifest commit and no progress-manifest mtime movement
  for ``stall_timeout_s`` (the worker is SIGKILLed);
- *host death* — the lease goes stale and another orchestrator takes over.

A failed shard is requeued with exponential backoff + deterministic jitter
and bounded attempts. Shard commits are idempotent and crash-durable, so a
requeued worker resumes from the last checkpoint and the merged FASTA is
byte-identical to an unfaulted run.

**Poison-shard quarantine.** A shard that kills ``poison_after``
consecutive workers (or exhausts ``max_attempts``) is declared poison and
quarantined in the fleet manifest, with its last stderr tail, while the
rest of the fleet continues; the merge gate (``launch.merge_shards``) then
refuses the incomplete fleet unless ``--allow-degraded``.

**Stragglers** are flagged from progress-manifest throughput
(:func:`flag_stragglers`) and may be speculatively re-executed once slots
are idle.

**Capacity awareness.** A worker that exits 137 / SIGKILL without a
watchdog kill of our own is the OOM-killer's work: the shard is requeued
ONCE at half the worker's batch (``utils.obs.auto_batch_size`` of the
backend unless ``-b`` was given; every worker is passed its batch), logged
as ``fleet.capacity``. A second OOM falls through to the normal failure
ladder.

Fault injection (``runtime/faults.py``): ``worker_crash:N`` sends the Nth
spawned worker a mid-shard ``crash`` spec, ``worker_hang:N`` replaces the
Nth spawn with a progress-free sleeper, ``worker_oom:N`` with an exit-137
stand-in, ``lease_stall`` stops heartbeating the Nth claimed lease
(backdated so the takeover fires at once). Events (``fleet.*``) pass the
port's ``eventcheck --strict``.

Several cards under one worker (the JAX ``--mesh``) wait for the port of
``parallel/mesh.py`` (ROADMAP Queue 1 item 5): ``mesh > 1`` is refused.
"""

from __future__ import annotations

import json
import os
import random
import socket
import subprocess
import sys
import time
from dataclasses import dataclass

from ..runtime.faults import FaultPlan, non_fleet_spec
from ..utils import aio, lease
from ..utils.obs import (
    JsonlLogger,
    NullLogger,
    Tracer,
    auto_batch_size,
    resolve_auto_backend,
)
from .launch import _write_manifest_durable, load_shard_manifest, shard_paths

#: device-op index of the ``crash`` spec injected into a worker_crash-
#: sabotaged worker: late enough that the shard is genuinely mid-flight
#: (batches dispatched, checkpoints possibly committed), so the requeue
#: exercises resume — not just a failed spawn
_WORKER_CRASH_OP = 3

#: stderr bytes preserved in the fleet manifest for a poison shard
_STDERR_TAIL_BYTES = 4000


def lease_path(outdir: str, shard: int) -> str:
    return os.path.join(outdir, "leases", f"shard{shard:04d}.lease")


# The lease protocol itself (O_EXCL claim, re-read-before-renew heartbeat,
# holder-checked release, stale takeover) lives in utils/lease.py — shared
# with the serve tier's per-job leases. These wrappers
# keep the fleet's (outdir, shard) addressing.

def claim_lease(outdir: str, shard: int, host: str,
                ttl_s: float) -> tuple[bool, dict | None]:
    """Try to claim ``shard``'s lease for ``host`` (see ``utils.lease.claim``
    for the race-safety contract)."""
    return lease.claim(lease_path(outdir, shard), host, ttl_s,
                       extra={"shard": shard})


def read_lease(outdir: str, shard: int) -> dict | None:
    """The lease's payload, or None when absent/torn."""
    return lease.read(lease_path(outdir, shard))


def renew_lease(outdir: str, shard: int) -> None:
    """Heartbeat: bump the lease mtime (the staleness clock other hosts read)."""
    lease.renew(lease_path(outdir, shard))


def release_lease(outdir: str, shard: int, host: str | None = None) -> None:
    """Remove the lease; with ``host`` given, only while it still names that
    host (holder-checked release — see ``utils.lease.release``)."""
    lease.release(lease_path(outdir, shard), host=host)


def backdate_lease(outdir: str, shard: int, age_s: float) -> None:
    """Set the lease's mtime ``age_s`` into the past — how ``lease_stall``
    makes a wedged host's lease stale deterministically instead of burning
    ``lease_ttl_s`` of CI wall-clock (also the test hook for simulating a
    host that died right after claiming)."""
    lease.backdate(lease_path(outdir, shard), age_s)


def flag_stragglers(throughputs: dict[int, float],
                    factor: float) -> list[int]:
    """Shard ids whose reads/s lag the fleet median by ``factor``×.

    Pure policy, unit-testable: with fewer than 2 measurable shards or a
    zero median (nobody has emitted yet) nothing is flagged — speculation
    must never trigger on startup noise."""
    if factor <= 0 or len(throughputs) < 2:
        return []
    vals = sorted(throughputs.values())
    median = vals[len(vals) // 2]
    if median <= 0:
        return []
    return sorted(s for s, v in throughputs.items() if v * factor < median)


@dataclass
class FleetConfig:
    nshards: int
    workers: int = 2                  # local worker subprocess slots
    max_attempts: int = 5             # worker spawns per shard before poison
    poison_after: int = 3             # consecutive failures => poison
    heartbeat_s: float = 1.0          # lease mtime renewal period
    lease_ttl_s: float = 15.0         # older lease is stale (takeover)
    stall_timeout_s: float = 600.0    # no progress movement => hung worker
    backoff_base_s: float = 0.25
    backoff_cap_s: float = 8.0
    jitter: float = 0.25              # +[0, jitter) fraction, deterministic RNG
    speculate_factor: float = 4.0     # straggler threshold vs median (0 = off)
    speculate_min_runtime_s: float = 60.0
    poll_s: float = 0.05
    host: str = ""                    # lease identity; default hostname:pid
    events_path: str | None = None    # fleet.* jsonl sidecar
    # worker knobs (forwarded to the shard tool)
    backend: str = "auto"             # auto | cuda | cpu | native
    device: str | None = None         # cuda | cpu; forwarded as --device
                                      # (None: the backend's own device)
    batch: int | None = None
    threads: int | None = None        # each worker's -t (feeder threads);
                                      # None: the worker's default
    dp_route: str | None = None       # each worker's --dp (None: default)
    checkpoint_every: int = 16        # >0: progress manifests drive hang
                                      # detection and lossless requeue
    ingest_policy: str = "strict"
    paged: str = "off"                # ragged paged window batching, forwarded
                                      # to every worker (see daccord --paged)
    mesh: int = 0                     # several cards a worker: refused
                                      # above 1 (ROADMAP Queue 1 item 5)
    max_pile_overlaps: int | None = None  # monster-pile budget (None = the
                                          # pipeline default; 0 disables)
    disk_floor_mb: float = 0.0        # free-bytes spawn floor:
                                      # below this much free space on the
                                      # outdir volume the orchestrator
                                      # refuses to spawn NEW workers (each
                                      # writes shard outputs + telemetry
                                      # there) — running workers finish,
                                      # leases stay claimable by peers on
                                      # healthier volumes. 0 = off
    worker_telemetry: bool = True     # per-worker telemetry sidecars: every
                                      # shard worker writes
                                      # shardNNNN.events.jsonl (trace spans,
                                      # supervisor and governor events,
                                      # merged on ts by the trace tool) and
                                      # the per-window outcome ledger
                                      # shardNNNN.ledger.jsonl


@dataclass
class _Shard:
    shard: int
    status: str = "pending"           # pending|foreign|running|done|poison
    attempts: int = 0
    consec_fail: int = 0
    next_try_t: float = 0.0
    proc: subprocess.Popen | None = None
    spawn_t: float = 0.0
    stderr_path: str | None = None
    kill_reason: str | None = None
    last_emitted: int = 0
    last_beat: float = 0.0
    speculated: bool = False
    manifest: dict | None = None
    poison_reason: str | None = None
    # capacity awareness: a worker the kernel OOM-killed is a
    # resource-fit problem, not a poison input — requeued ONCE at a reduced
    # batch (threaded to the worker) before the normal failure ladder applies
    oom_requeued: bool = False
    batch_override: int | None = None
    span: str | None = None           # open worker-attempt trace span id


def _stderr_tail(path: str | None) -> str:
    if not path or not os.path.exists(path):
        return ""
    try:
        with open(path, "rb") as fh:
            fh.seek(max(0, os.path.getsize(path) - _STDERR_TAIL_BYTES))
            return fh.read().decode(errors="replace")
    except OSError:
        return ""


class Fleet:
    """One orchestrator instance; :func:`run_fleet` is the entry point."""

    def __init__(self, db: str, las: str, outdir: str, cfg: FleetConfig,
                 faults: FaultPlan | None = None):
        self.db, self.las, self.outdir, self.cfg = db, las, outdir, cfg
        if cfg.mesh and cfg.mesh > 1:
            raise ValueError(
                f"mesh={cfg.mesh}: a worker over several cards waits for the "
                "port of parallel/mesh.py (ROADMAP Queue 1 item 5)")
        # ``auto`` resolves once, before any lease is claimed (the bounded
        # probe would otherwise stall the heartbeats of the leases this host
        # holds): the card, or an error without one; every worker is then
        # given the resolved backend, so the fleet and its workers agree on
        # the batch the capacity requeue halves
        self.backend = resolve_auto_backend(cfg.device) \
            if cfg.backend == "auto" else cfg.backend
        self.device = cfg.device or ("cuda" if self.backend == "cuda" else "cpu")
        self.faults = faults
        self.host = cfg.host or f"{socket.gethostname()}:{os.getpid()}"
        os.makedirs(outdir, exist_ok=True)  # the events sidecar lands here
        self.log = JsonlLogger(cfg.events_path) if cfg.events_path \
            else NullLogger()
        # trace spans: one span per worker attempt (spawn → reap)
        # under a fleet-run root, so the trace tool can draw the fleet
        # timeline straight from the orchestrator's own sidecar
        self.tracer = Tracer(self.log)
        self._run_span: str | None = None
        self._rng = random.Random(0xF1EE7)  # deterministic backoff jitter
        self.shards = {s: _Shard(s) for s in range(cfg.nshards)}
        self.poison: list[dict] = []
        self._t0 = time.time()
    # -- worker process management ------------------------------------------

    def _worker_argv(self, shard: int) -> list[str]:
        cfg = self.cfg
        argv = [sys.executable, "-m", "daccord_tpu_torch.tools.cli", "shard",
                self.db, self.las, self.outdir,
                "-J", f"{shard},{cfg.nshards}",
                "--backend", self.backend, "--device", self.device,
                "--checkpoint-every", str(cfg.checkpoint_every),
                "--ingest-policy", cfg.ingest_policy,
                "--paged", cfg.paged]
        if cfg.worker_telemetry:
            # per-worker sidecars land beside the shard outputs; attempts
            # append (shard_start is the eventcheck stream boundary) and
            # the trace reader merges them with the fleet's own file on ts
            p = shard_paths(self.outdir, shard)
            argv += ["--events", p["events"], "--ledger", p["ledger"]]
        else:
            # the shard tool's own --ledger default is 'auto': an opted-out
            # fleet must say so explicitly or workers write ledgers anyway
            argv += ["--ledger", "none"]
        if cfg.max_pile_overlaps is not None:
            argv += ["--max-pile-overlaps", str(cfg.max_pile_overlaps)]
        if cfg.threads is not None:
            argv += ["-t", str(cfg.threads)]
        if cfg.dp_route:
            argv += ["--dp", cfg.dp_route]
        # no hp rescue, whatever the backend: the JAX fleet's workers run
        # its shard tool's default consensus
        argv += ["--no-hp-rescue"]
        # a capacity-requeued shard re-runs at its reduced batch; the
        # checkpointed resume keeps the output byte-identical regardless —
        # batch size never reaches the per-window math
        batch = self.shards[shard].batch_override or self._worker_batch()
        argv += ["-b", str(batch)]
        return argv

    def _worker_batch(self) -> int:
        """The batch a worker runs: ``cfg.batch`` when -b was given, else
        ``utils.obs.auto_batch_size`` of the resolved backend (native 4096,
        the card 2048, the CPU ladder 512), passed to every worker. The
        capacity requeue halves THIS number."""
        return self.cfg.batch or auto_batch_size(self.backend)

    def _worker_env(self, sabotage: str | None) -> dict:
        env = dict(os.environ)
        # the worker must import the port regardless of its cwd or an
        # uninstalled checkout: prepend the package's parent directory
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        # fleet kinds describe THIS orchestrator; only device/data kinds
        # pass through to the worker
        spec = non_fleet_spec(env.pop("DACCORD_FAULT", None))
        if sabotage == "worker_crash":
            spec = ",".join(x for x in (spec, f"crash:{_WORKER_CRASH_OP}") if x)
        if spec:
            env["DACCORD_FAULT"] = spec
        return env

    def _spawn(self, st: _Shard) -> None:
        cfg, s = self.cfg, st.shard
        sabotage = self.faults.fleet_spawn() if self.faults else None
        st.attempts += 1
        argv = self._worker_argv(s)
        if sabotage == "worker_hang":
            # a wedged worker: alive pid, no progress manifest ever — only
            # the stall watchdog can reclaim its slot
            argv = [sys.executable, "-c", "import time; time.sleep(600)"]
        elif sabotage == "worker_oom":
            # an OOM-killed worker: the kernel's SIGKILL surfaces as exit
            # status 137 with no manifest — the capacity-requeue path's
            # deterministic stand-in
            argv = [sys.executable, "-c", "import os; os._exit(137)"]
        if sabotage:
            self.log.log("fleet.fault", kind=sabotage, shard=s)
        st.stderr_path = os.path.join(
            self.outdir, f"shard{s:04d}.a{st.attempts}.stderr")
        with open(st.stderr_path, "wb") as errfh:
            st.proc = subprocess.Popen(argv, env=self._worker_env(sabotage),
                                       stdout=errfh,
                                       stderr=subprocess.STDOUT)
        st.status = "running"
        st.spawn_t = st.last_beat = time.time()
        st.kill_reason = None
        st.last_emitted = 0
        st.span = self.tracer.open("worker", attach=False,
                                   parent=self._run_span or "",
                                   shard=s, attempt=st.attempts,
                                   pid=st.proc.pid)
        self.log.log("fleet.spawn", shard=s, attempt=st.attempts,
                     pid=st.proc.pid)

    def _progress(self, st: _Shard) -> tuple[float, int]:
        """(mtime, emitted) of the shard's progress manifest; the spawn time
        and 0 when none exists yet (startup / non-checkpointed worker)."""
        p = shard_paths(self.outdir, st.shard)["progress"]
        try:
            mtime = os.path.getmtime(p)
        except OSError:
            return st.spawn_t, st.last_emitted
        emitted = st.last_emitted
        try:
            with open(p) as fh:
                emitted = int(json.load(fh).get("emitted", emitted))
        except (OSError, json.JSONDecodeError, ValueError, TypeError):
            pass  # torn mid-commit read: keep the last good value
        return mtime, emitted

    # -- failure / completion handling --------------------------------------

    def _mark_done(self, st: _Shard, m: dict) -> None:
        st.status, st.manifest = "done", m
        release_lease(self.outdir, st.shard, host=self.host)
        self.log.log("fleet.done", shard=st.shard,
                     reads=int(m.get("reads", 0)),
                     degraded=bool(m.get("degraded")))

    def _fail(self, st: _Shard, reason: str) -> None:
        cfg = self.cfg
        release_lease(self.outdir, st.shard, host=self.host)
        if reason in ("speculate", "capacity"):
            # not shard failures: a speculative kill is the fleet's own
            # doing, and an OOM-killed worker is a resource-fit problem the
            # reduced-batch requeue remedies — neither earns poison-streak
            # credit (attempts stay bounded either way)
            st.status, st.next_try_t = "pending", 0.0
            self.log.log("fleet.retry", shard=st.shard, attempt=st.attempts,
                         delay_s=0.0, reason=reason)
            return
        st.consec_fail += 1
        if st.consec_fail >= cfg.poison_after or st.attempts >= cfg.max_attempts:
            why = (f"{st.consec_fail} consecutive worker failures"
                   if st.consec_fail >= cfg.poison_after
                   else f"attempts exhausted ({st.attempts})")
            st.status, st.poison_reason = "poison", f"{why}; last: {reason}"
            qpath = shard_paths(self.outdir, st.shard)["quarantine"]
            self.poison.append({
                "shard": st.shard, "attempts": st.attempts,
                "reason": st.poison_reason,
                "stderr_tail": _stderr_tail(st.stderr_path),
                "quarantine": qpath if os.path.exists(qpath) else None,
            })
            self.log.log("fleet.poison", shard=st.shard, attempts=st.attempts,
                         reason=st.poison_reason)
            return
        delay = min(cfg.backoff_cap_s,
                    cfg.backoff_base_s * (2 ** (st.consec_fail - 1)))
        delay *= 1.0 + cfg.jitter * self._rng.random()
        st.status, st.next_try_t = "pending", time.time() + delay
        self.log.log("fleet.retry", shard=st.shard, attempt=st.attempts,
                     delay_s=round(delay, 3), reason=reason)

    # -- supervision loop ----------------------------------------------------

    def _reap(self) -> None:
        for st in self.shards.values():
            if st.status != "running" or st.proc is None:
                continue
            rc = st.proc.poll()
            if rc is None:
                continue
            st.proc = None
            self.tracer.close(st.span, rc=int(rc),
                              reason=st.kill_reason or "")
            st.span = None
            m, why = load_shard_manifest(self.outdir, st.shard)
            if rc == 0 and m is not None:
                st.consec_fail = 0
                self._mark_done(st, m)
            elif st.kill_reason == "ownership_lost":
                # the taker's worker owns the shard; watch it like any
                # foreign shard (done when its manifest lands, reclaimable
                # when its lease goes stale). Not a failure of the shard.
                st.status = "foreign"
            elif st.kill_reason == "speculate":
                self._fail(st, "speculate")
            elif rc in (137, -9) and st.kill_reason is None \
                    and not st.oom_requeued:
                # exit 137 / SIGKILL without a watchdog kill of our own: the
                # kernel OOM-killer (or the injected worker_oom stand-in).
                # A capacity-degraded exit is NOT a crash: requeue ONCE at a
                # reduced batch — the checkpointed resume keeps the bytes —
                # instead of counting it toward poison. A second OOM at the
                # reduced batch falls through to the normal failure ladder.
                st.oom_requeued = True
                st.batch_override = max(16, self._worker_batch() // 2)
                self.log.log("fleet.capacity", shard=st.shard,
                             batch=st.batch_override)
                self._fail(st, "capacity")
            else:
                reason = st.kill_reason or f"exit:{rc}"
                if rc == 0:
                    reason = f"exit:0 without a valid manifest" \
                             + (f" ({why})" if why else "")
                self._fail(st, reason)

    def _watchdog(self, now: float) -> None:
        cfg = self.cfg
        for st in self.shards.values():
            if st.status != "running" or st.proc is None or st.kill_reason:
                continue
            # a manifest committed DURING this attempt means the worker is in
            # its final moments — never classify that as a hang. A manifest
            # predating the spawn is the stale one this attempt exists to
            # recompute; it must not mute the watchdog.
            try:
                committed = os.path.getmtime(
                    shard_paths(self.outdir, st.shard)["manifest"])
            except OSError:
                committed = None
            if committed is not None and committed >= st.spawn_t:
                continue
            mtime, emitted = self._progress(st)
            st.last_emitted = emitted
            if now - max(st.spawn_t, mtime) > cfg.stall_timeout_s:
                st.kill_reason = "hang"
                st.proc.kill()

    def _heartbeat(self, now: float) -> None:
        for st in self.shards.values():
            if st.status != "running" or st.kill_reason:
                continue
            if now - st.last_beat < self.cfg.heartbeat_s:
                continue
            st.last_beat = now
            # ownership re-check before renewal: if our lease went stale
            # (host pause, FS stall) and another orchestrator took the shard
            # over, renewing would keep THE TAKER'S lease fresh while two
            # workers append to one FASTA. Kill ours instead and treat the
            # shard as foreign — the taker owns it now.
            lease = read_lease(self.outdir, st.shard)
            if lease is not None and lease.get("host") != self.host:
                st.kill_reason = "ownership_lost"
                st.proc.kill()
                self.log.log("fleet.demote", shard=st.shard,
                             new_host=str(lease.get("host", "?")))
                continue
            renew_lease(self.outdir, st.shard)
            self.log.log("fleet.heartbeat", shard=st.shard,
                         emitted=st.last_emitted)

    def _recheck_foreign(self) -> None:
        """Shards another (live) host holds: done when their manifest lands,
        back to pending when their lease goes stale or vanishes."""
        for st in self.shards.values():
            if st.status != "foreign":
                continue
            m, _ = load_shard_manifest(self.outdir, st.shard)
            if m is not None:
                st.status, st.manifest = "done", m
                self.log.log("fleet.done", shard=st.shard,
                             reads=int(m.get("reads", 0)),
                             degraded=bool(m.get("degraded")))
                continue
            path = lease_path(self.outdir, st.shard)
            try:
                stale = time.time() - os.path.getmtime(path) > self.cfg.lease_ttl_s
            except OSError:
                stale = True  # released without output: reclaimable
            if stale:
                st.status, st.next_try_t = "pending", 0.0

    def _claim_and_spawn(self, now: float) -> None:
        cfg = self.cfg
        if cfg.disk_floor_mb:
            from ..utils.obs import disk_free_mb

            free = disk_free_mb(self.outdir)
            if 0 <= free < cfg.disk_floor_mb:
                # below the free-bytes floor: spawning another writer would
                # only deepen the hole. Running workers finish; pending
                # shards wait (their leases stay claimable by peers whose
                # volumes have headroom). Logged at most once per second —
                # the poll loop spins at poll_s.
                if now - getattr(self, "_disk_floor_logged", 0.0) >= 1.0:
                    self._disk_floor_logged = now
                    self.log.log("disk.pressure", level="spawn_floor",
                                 src="fleet", free_mb=round(free, 1),
                                 detail=f"floor {cfg.disk_floor_mb:.0f} MiB")
                return
        slots = cfg.workers - sum(1 for st in self.shards.values()
                                  if st.status == "running")
        for st in sorted(self.shards.values(), key=lambda s: s.shard):
            if slots <= 0:
                break
            if st.status != "pending" or st.next_try_t > now:
                continue
            claimed, takeover = claim_lease(self.outdir, st.shard, self.host,
                                            cfg.lease_ttl_s)
            if not claimed:
                st.status = "foreign"
                continue
            if takeover:
                self.log.log("fleet.takeover", shard=st.shard, **takeover)
            if self.faults and self.faults.fleet_claim_stall():
                # the host wedges right after claiming: heartbeats never
                # start, and the backdate makes the stale-lease takeover
                # (by any orchestrator, this one included) fire immediately
                backdate_lease(self.outdir, st.shard, cfg.lease_ttl_s + 1.0)
                self.log.log("fleet.fault", kind="lease_stall", shard=st.shard)
                continue
            self._spawn(st)
            slots -= 1

    def _maybe_speculate(self, now: float) -> None:
        cfg = self.cfg
        if cfg.speculate_factor <= 0:
            return
        if any(st.status == "pending" for st in self.shards.values()):
            return  # real work queued: never burn a slot on speculation
        if sum(1 for st in self.shards.values()
               if st.status == "running") >= cfg.workers:
            return
        # kill_reason guards the race with _watchdog in the same iteration
        # (a hang kill must keep its classification — and its poison-streak
        # credit); zero-emitted workers are the watchdog's problem, never
        # speculation's
        thr = {st.shard: st.last_emitted / max(now - st.spawn_t, 1e-9)
               for st in self.shards.values()
               if st.status == "running" and not st.speculated
               and not st.kill_reason and st.last_emitted > 0
               and now - st.spawn_t > cfg.speculate_min_runtime_s}
        for s in flag_stragglers(thr, cfg.speculate_factor):
            st = self.shards[s]
            vals = sorted(thr.values())
            self.log.log("fleet.speculate", shard=s,
                         throughput=round(thr[s], 6),
                         median=round(vals[len(vals) // 2], 6))
            st.speculated, st.kill_reason = True, "speculate"
            st.proc.kill()

    def run(self) -> dict:
        cfg = self.cfg
        os.makedirs(self.outdir, exist_ok=True)
        self.log.log("fleet.init", nshards=cfg.nshards, workers=cfg.workers,
                     host=self.host)
        self._run_span = self.tracer.open("fleet.run", nshards=cfg.nshards)
        # idempotent rerun: shards that already committed need no worker
        for st in self.shards.values():
            m, _ = load_shard_manifest(self.outdir, st.shard)
            if m is not None:
                self._mark_done(st, m)
        try:
            # process reaping and claim/spawn run at poll_s (local, cheap);
            # everything that stats/reads the shared filesystem (progress
            # manifests, foreign manifests/leases) runs at heartbeat cadence
            # — that state only changes on a heartbeat timescale, and a
            # 20 Hz metadata storm per orchestrator is what kills shared-FS
            # deployments
            scan_every = min(cfg.heartbeat_s, 1.0)
            last_scan = 0.0
            while any(st.status not in ("done", "poison")
                      for st in self.shards.values()):
                now = time.time()
                self._reap()
                if now - last_scan >= scan_every:
                    last_scan = now
                    self._watchdog(now)
                    self._recheck_foreign()
                    self._maybe_speculate(now)
                self._heartbeat(now)
                self._claim_and_spawn(now)
                time.sleep(cfg.poll_s)
            manifest = {
                "nshards": cfg.nshards, "host": self.host,
                "wall_s": round(time.time() - self._t0, 3),
                "done": sorted(s for s, st in self.shards.items()
                               if st.status == "done"),
                "poison": self.poison,
                "degraded": sorted(s for s, st in self.shards.items()
                                   if st.manifest
                                   and (st.manifest.get("degraded")
                                        or st.manifest.get("quarantined"))),
                "attempts": {str(s): st.attempts
                             for s, st in self.shards.items()},
                # capacity awareness: OOM-killed workers requeued
                # at a reduced batch — enumerated (with the shard manifests'
                # batch_effective/governor state) so a round report can tell
                # capacity-degraded speed from degraded output
                "capacity_requeued": sorted(
                    s for s, st in self.shards.items() if st.oom_requeued),
            }
            _write_manifest_durable(os.path.join(self.outdir, "fleet.json"),
                                    manifest)
            # fleet-level scrape target: the shard rollups as one
            # shard-labeled prom exposition beside fleet.json
            try:
                prom = _fleet_prom_text(self.outdir)
                if prom:
                    aio.durable_write(
                        os.path.join(self.outdir, "fleet.metrics.prom"),
                        lambda fh: fh.write(prom), mode="wt")
            except OSError:
                pass
            self.log.log("fleet.finish", done=len(manifest["done"]),
                         poison=len(manifest["poison"]),
                         wall_s=manifest["wall_s"])
            self.tracer.close(self._run_span, status="done")
            return manifest
        finally:
            # an exception (or KeyboardInterrupt) must not strand worker
            # processes; released/stale leases let another host take over
            for st in self.shards.values():
                if st.proc is not None and st.proc.poll() is None:
                    st.proc.kill()
                    st.proc.wait()
                if st.status == "running":
                    release_lease(self.outdir, st.shard, host=self.host)
            # abort unwind: any spans still open (stranded workers, the
            # fleet-run root on an exception path) close with status=abort
            self.tracer.unwind()
            self.log.close()


def _fleet_prom_text(outdir: str) -> str:
    """One Prometheus exposition merging every committed shard rollup,
    shard-labeled — the fleet-level scrape target. The text
    format requires all samples of a metric to form ONE group, so samples
    regroup per metric family across shards (a shard-by-shard concat
    would interleave families and fail promtool) under a single ``# TYPE``
    each; a torn rollup skips — best-effort, it never sinks the fleet."""
    import glob
    import json as _json

    from ..utils.obs import render_prom

    fam_type: dict[str, str] = {}
    fam_samples: dict[str, list[str]] = {}
    order: list[str] = []
    for mp in sorted(glob.glob(os.path.join(outdir,
                                            "shard*.metrics.json"))):
        try:
            with open(mp) as fh:
                roll = _json.load(fh)
        except (OSError, _json.JSONDecodeError):
            continue
        if not isinstance(roll, dict) or "gauges" not in roll:
            continue
        text = render_prom(roll, labels={"shard": roll.get("shard", "?")})
        fam = None
        for ln in text.splitlines():
            if ln.startswith("# TYPE "):
                # render_prom emits every sample (incl. a summary's _count/
                # _sum) directly under its family's TYPE line
                fam = ln.split()[2]
                if fam not in fam_samples:
                    fam_type[fam] = ln
                    fam_samples[fam] = []
                    order.append(fam)
            elif fam is not None and ln.strip():
                fam_samples[fam].append(ln)
    lines: list[str] = []
    for fam in order:
        lines.append(fam_type[fam])
        lines.extend(fam_samples[fam])
    return "\n".join(lines) + "\n" if lines else ""


def run_fleet(db: str, las: str, outdir: str, cfg: FleetConfig,
              faults: FaultPlan | str | None = "env") -> dict:
    """Run all ``cfg.nshards`` shards to completion under supervision;
    returns (and durably writes, as ``OUTDIR/fleet.json``) the fleet
    manifest. ``faults`` defaults to the process ``DACCORD_FAULT`` plan
    (fleet kinds only — device/data kinds pass through to workers); pass
    ``None`` for an explicitly clean run or a :class:`FaultPlan` directly.

    The final `fleet.finish` event and the manifest enumerate done vs poison
    shards; completion of the *fleet* means every shard is terminal — a
    poison shard is quarantined, not blocking.
    """
    if faults == "env":
        faults = FaultPlan.from_env()
    return Fleet(db, las, outdir, cfg, faults=faults).run()
