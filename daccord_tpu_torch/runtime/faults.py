"""Deterministic fault injection for the device supervisor.

The port's copy of ``daccord_tpu/runtime/faults.py``: every kind of the
``DACCORD_FAULT`` grammar parses here exactly as there, so a composed spec
means the same in both packages. The port consumes the device kinds (the
supervisor), ``device_oom``, ``host_rss`` and ``monster_pile`` (the
governor and the pipeline), the data kinds (the ``daccord`` entry point),
``sdc`` (the shadow audit), the storage kinds (``utils/aio.py``),
``feeder_stall`` (the pipeline's pile loop) and the serve kinds
(``serve/journal.py``, ``serve/jobs.py``). The fleet and network kinds
parse, and nothing in the port consumes them yet.

Every failure mode the supervisor handles (``runtime/supervisor.py``) can be
reproduced on a CPU-only host from one env var, so the whole
dispatch/fetch/failover state machine is testable without a card and without
wall-clock waits::

    DACCORD_FAULT=fetch_hang:3            # 3rd fetch times out once
    DACCORD_FAULT=dispatch_error:5        # 5th dispatch raises once
    DACCORD_FAULT=device_lost:7           # 7th device op: chip declared dead
    DACCORD_FAULT=compile_stall           # first cold-shape op stalls once
    DACCORD_FAULT=device_lost:2,crash:9   # comma-joins compose

Grammar: ``kind[:N]`` with N the 1-based index of the triggering operation in
that kind's counter domain (default 1). Counters advance once per *logical*
operation (retries of the same op do not re-count), so a given spec fires at
exactly one reproducible point in a run. All faults are one-shot except the
state they leave behind: ``device_lost`` additionally marks the (virtual)
device dead, which the supervisor's probe consults before any real probe —
so the probe-declares-loss path runs deterministically too.

``device_lost`` accepts an optional mesh-member index: ``device_lost:2@3``
marks device 3 as the member that died. On a mesh primary the supervisor
attributes the partial-mesh shrink to that device index (``mesh.shrink``
``culprit`` + a ``mesh.device`` state row) — the per-chip attribution the
flight recorder exists for. Without ``@K`` the culprit is
unknown (-1), matching a real whole-program abort.

``crash`` is a test-only kind: it raises :class:`InjectedCrash`, a
``BaseException`` the supervisor deliberately does NOT catch, simulating a
hard process death (SIGKILL-ish) for checkpoint/resume composition tests.

Counter domains: ``fetch_hang`` counts fetches, ``dispatch_error`` counts
dispatches, ``device_lost``/``crash`` count device ops (dispatch + fetch,
interleaved in pipeline order), ``compile_stall`` counts cold-shape ops.

Data-corruption kinds (the ingest-layer twins) corrupt input
artifacts instead of raising at ops — N indexes the corrupted record::

    DACCORD_FAULT=las_bitflip:4           # flip abpos MSB of LAS record 4
    DACCORD_FAULT=las_truncate:30         # cut the LAS mid-record 30
    DACCORD_FAULT=db_garbage:2            # 0xFF over DB .idx read record 2

They are applied once by the pipeline entry points via
:func:`maybe_apply_data_faults` (or directly by tests / the pounce
corruption-fuzz step via the ``corrupt_*`` helpers).

Fleet kinds (the orchestrator-level twins, ``parallel/fleet.py``) sabotage
worker processes / lease renewal instead of device ops or artifacts::

    DACCORD_FAULT=worker_crash:2          # 2nd spawned worker dies mid-shard
    DACCORD_FAULT=worker_hang:3           # 3rd spawned worker wedges (no progress)
    DACCORD_FAULT=lease_stall             # 1st claimed lease stops heartbeating
    DACCORD_FAULT=worker_oom:2            # 2nd spawned worker exits like an
                                          # OOM-killed process (status 137)

Counter domains: ``worker_crash``/``worker_hang``/``worker_oom`` count
worker spawns (fleet-wide, in spawn order), ``lease_stall`` counts
successful lease claims. The orchestrator consumes them via
:meth:`FaultPlan.fleet_spawn` / :meth:`FaultPlan.fleet_claim_stall`; worker
subprocesses never see the fleet kinds (the fleet strips them from the
inherited ``DACCORD_FAULT``), so a composed spec like
``worker_crash:1,las_bitflip:3`` sends only the data kind down to the
workers.

Capacity kinds (the memory-exhaustion twins) make the capacity
governor (``runtime/governor.py``) deterministically testable on CPU::

    DACCORD_FAULT=device_oom:3            # 3rd device op: allocator OOM, and
                                          # a virtual HBM ceiling is set to
                                          # HALF that op's batch width — every
                                          # later primary op wider than the
                                          # ceiling OOMs too, so the governor's
                                          # bisect walk terminates exactly when
                                          # the shape genuinely fits
    DACCORD_FAULT=host_rss:2              # 2nd host-watermark check reports
                                          # hard memory pressure once
    DACCORD_FAULT=monster_pile:4          # 4th pile inspected by the monster
                                          # guard busts the budget once

Counter domains: ``device_oom`` counts device ops (dispatch + fetch, like
``device_lost``); ``host_rss`` counts watermark checks (one per pile block,
:meth:`FaultPlan.host_rss_check`); ``monster_pile`` counts piles inspected
before tensorization (:meth:`FaultPlan.monster_check`). The ceiling left by
``device_oom`` is deliberately NOT one-shot: re-dispatching the identical
doomed shape must keep failing (that is the failure mode under test), while
a bisected one fits.

Serve-tier kinds (the crash-durability twins) sabotage a
``daccord-serve`` process the way the fleet kinds sabotage worker
subprocesses — from inside, deterministically, so the whole journal-replay
and peer-takeover machinery runs on CPU in CI::

    DACCORD_FAULT=serve_crash:3           # the process dies HARD (exit 137,
                                          # no cleanup) right after its 3rd
                                          # journal append becomes durable
    DACCORD_FAULT=serve_hang:1            # the 1st job run wedges forever
                                          # (a group thread stuck in a solve)

Counter domains: ``serve_crash`` counts fsync'd journal appends
(:meth:`FaultPlan.serve_crash_check`, consumed by ``serve/journal.py`` —
the append is durable FIRST, then the process dies, so every record the
journal claims to hold survives the injected crash exactly like a real
SIGKILL between syscalls); ``serve_hang`` counts job runs
(:meth:`FaultPlan.serve_hang_check`, consumed by ``serve/jobs.run_job``).
Because the journal appends in lifecycle order (admitted, running,
progress..., committing, committed), ``serve_crash:N`` lands the death at
an exact lifecycle point: N=1 dies post-admit pre-queue, N=3 with a small
checkpoint stride dies running mid-batch, N=3 with checkpoints off dies
mid-commit — after the FASTA fsync, before the publishing rename. The kill
matrix in tests/test_serve_durability.py and the chaos soak
(``DACCORD_BENCH_SERVE_SOAK``) are built on exactly this determinism.
Like the fleet kinds, serve kinds never reach the per-job pipeline — the
pipeline's own FaultPlan parses the same spec, so the kinds are known
everywhere but consumed only by the serve layer.

The saturation-profiler kind deliberately breaks the index
grammar: ``feeder_stall:N`` reads N as MILLISECONDS of artificial delay
injected into EVERY feeder pile block (booked under the profiler's
``stall`` stage), not a 1-based trigger index — flipping a bottleneck
verdict requires sustained slowdown, not a one-shot event. It is the A/B
lever the acceptance run uses: the same corpus with ``feeder_stall:50``
must flip the committed verdict to ``host_feeder`` with ``stall`` named as
the dominant sub-stage, while the FASTA stays byte-identical (a slow feeder
changes wall-clock, never bytes).

Storage kinds (the I/O twins) make the disk say no — every
durable path (journal appends, lease claims/renewals, manifest commits,
spool uploads, telemetry sidecars, AOT-cache publishes) consults the plan
through ``utils/aio.py``'s fault hook, so the full-disk matrix runs
chip-free like every prior one::

    DACCORD_FAULT=io_enospc:3             # 3rd I/O primitive op: ENOSPC
    DACCORD_FAULT=io_eio:2                # 2nd op: transient EIO (the aio
                                          # bounded-retry wrapper absorbs it)
    DACCORD_FAULT=io_fsync_fail:1         # 1st op: the fsync step fails
    DACCORD_FAULT=io_short_write:2        # 2nd op: torn bytes hit the disk,
                                          # then the write errors (ENOSPC)
    DACCORD_FAULT=io_slow:50              # EVERY op delayed 50 ms (duration
                                          # grammar, like feeder_stall)
    DACCORD_FAULT=io_enospc:3@journal     # 3rd JOURNAL-domain op only

The optional ``@domain`` suffix scopes a storage spec to one path class —
``journal`` | ``lease`` | ``manifest`` | ``spool`` | ``sidecar`` | ``aot``
— with a per-domain counter, so ``io_enospc:3@journal`` means "the 3rd
journal write fails" regardless of how much lease/sidecar traffic
interleaves. Without a domain, N indexes the process-wide I/O-op counter.
Counter domains: every :meth:`FaultPlan.io_check` call (one per logical
aio primitive invocation — retries of the same op re-count, because each
retry genuinely re-runs the syscalls) advances both the global and the
per-domain counter. ``io_slow`` reads N as milliseconds and is continuous
(never fired-out), mirroring ``feeder_stall``; an ``@domain`` scopes the
delay. ``io_eio`` is the only *transient* class: ``aio.retrying`` retries
it with bounded backoff, while ``io_enospc`` / ``io_fsync_fail`` /
``io_short_write`` are persistent-for-this-op and surface to the caller
(a failed fsync in particular must never be silently retried — the page
state after it is undefined).

Network kinds (the socket twins) make the router → peer HTTP
fabric say no — every router/autoscaler/client call goes through the
``serve/netio.py`` choke point, which consults the plan before (and, for
``net_torn``, while) each request, so grey network failures run chip-free
and socket-free like every prior matrix::

    DACCORD_FAULT=net_refused:3           # 3rd HTTP op: connection refused
    DACCORD_FAULT=net_reset:2             # 2nd op: connection reset mid-flight
    DACCORD_FAULT=net_hang:1              # 1st op: the socket wedges until
                                          # the per-domain deadline expires
    DACCORD_FAULT=net_torn:512            # next response body truncated
                                          # after 512 bytes (N is BYTES, not
                                          # an op index — it tears the FIRST
                                          # matching op's stream)
    DACCORD_FAULT=net_slow:80             # EVERY op delayed 80 ms (duration
                                          # grammar, like io_slow)
    DACCORD_FAULT=net_reset:3@submit      # 3rd SUBMIT-domain op only

The optional ``@domain`` suffix scopes a net spec to one RPC class —
``healthz`` | ``submit`` | ``result`` | ``stream`` | ``abort`` — with a
per-domain counter, exactly the ``io_*@domain`` design one layer up.
Counter domains: every :meth:`FaultPlan.net_check` call (one per HTTP
*attempt* — retries re-count, each retry genuinely re-opens a socket)
advances both the global and the per-domain counter. ``net_slow`` reads N
as milliseconds and is continuous; ``net_torn`` reads N as a BYTE offset
and fires one-shot on the first matching op. ``net_reset`` and
``net_refused`` are the *transient* class: ``netio.request`` retries them
with bounded backoff+jitter (idempotent domains only — a submit without an
idempotency key is never retried); ``net_hang`` surfaces as a deadline
timeout and ``net_torn`` as a short-read integrity error, both feeding the
per-peer circuit breaker rather than the retry loop.

The silent-data-corruption kind is the one fault nothing in the
loud matrices can see: the device op SUCCEEDS, but the bytes are wrong ——
no exception, no timeout, no event at injection time (detection is the
shadow audit's job, runtime/supervisor.py)::

    DACCORD_FAULT=sdc:3                   # 3rd fetched device result:
                                          # consensus rows silently perturbed
    DACCORD_FAULT=sdc:1@2                 # 1st result: only mesh member 2's
                                          # row slice lies
    DACCORD_FAULT=sdc:*@3                 # EVERY result: member 3 lies
                                          # continuously (the chaos-storm
                                          # grammar; '*' = never fired-out)

Counter domain: ``sdc`` counts successfully fetched primary results
(:meth:`FaultPlan.sdc_check`, consumed by the supervisor AFTER unpack,
BEFORE the shadow audit sees the dict). The ``@K`` suffix reuses the
``device_lost`` ``@device`` grammar: member K's contiguous row slice of the
fetched batch is the only part perturbed — and K joins the plan's
persistent liar set, so the supervisor's per-member attribution probe
(which re-solves the divergent window on every member) deterministically
re-corrupts K's copy. That persistence is the point: a real lying chip
lies to the probe too, and without it culprit attribution of a one-shot
lie would be impossible.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


class FaultInjected(Exception):
    """Base class of injected (recoverable) faults. Instances carry the
    spec's ``kind`` and the 1-based index ``n`` in that kind's own counter
    domain, so event logs match the ``DACCORD_FAULT`` grammar exactly."""

    kind = "fault"
    n = 0


class FaultHang(FaultInjected):
    """Injected hang: the supervisor treats it exactly like a watchdog
    deadline expiry (no real wall-clock is spent)."""


class FaultDispatchError(FaultInjected):
    """Injected transient dispatch failure (retry succeeds)."""


class FaultDeviceLost(FaultInjected):
    """Injected terminal device loss (probe reports dead afterwards)."""


class FaultCompileStall(FaultInjected):
    """Injected first-compile stall (exercises the COMPILING/heartbeat
    path; the op then proceeds normally)."""


class FaultDeviceOOM(FaultInjected):
    """Injected capacity fault (an allocator OOM, RESOURCE_EXHAUSTED).

    Deterministic — the message carries the RESOURCE_EXHAUSTED marker so the
    supervisor's classifier treats it exactly like a real capacity
    abort: no transient retry ladder, straight to the governor's
    degradation ladder."""


class InjectedCrash(BaseException):
    """Test-only hard crash: BaseException so no supervisor/pipeline
    ``except Exception`` can swallow it — it must unwind like a kill."""


_KINDS = ("fetch_hang", "dispatch_error", "device_lost", "compile_stall",
          "crash", "las_bitflip", "las_truncate", "db_garbage",
          "worker_crash", "worker_hang", "lease_stall",
          "device_oom", "host_rss", "monster_pile", "worker_oom",
          "feeder_stall", "serve_crash", "serve_hang",
          "io_enospc", "io_eio", "io_fsync_fail", "io_short_write",
          "io_slow",
          "net_refused", "net_reset", "net_hang", "net_torn", "net_slow",
          "sdc")

#: storage kinds: consumed by the utils/aio.py fault hook at
#: every durable-I/O primitive, optionally scoped to one path class with
#: ``@domain``. ``io_slow`` reads N as milliseconds (duration grammar).
IO_KINDS = ("io_enospc", "io_eio", "io_fsync_fail", "io_short_write",
            "io_slow")

#: path classes a storage spec may scope to — the durable surfaces of the
#: multi-process tier: the serve job journal, shared-FS leases, shard/job
#: manifests, tenant spool uploads, telemetry sidecars, the AOT cache dir.
IO_DOMAINS = ("journal", "lease", "manifest", "spool", "sidecar", "aot")

#: network kinds: consumed by the serve/netio.py choke point at
#: every router/autoscaler/client HTTP attempt, optionally scoped to one
#: RPC class with ``@domain``. ``net_slow`` reads N as milliseconds and
#: ``net_torn`` reads N as a body byte offset (see the module doc).
NET_KINDS = ("net_refused", "net_reset", "net_hang", "net_torn", "net_slow")

#: RPC classes a net spec may scope to — the router → peer call surfaces:
#: healthz polls, job submits, result fetches, streamed result proxies,
#: abort/shutdown-drain calls.
NET_DOMAINS = ("healthz", "submit", "result", "stream", "abort")

#: fleet-orchestrator kinds: they sabotage worker spawns / lease renewal at
#: the fleet layer (parallel/fleet.py) and are stripped from the worker
#: subprocesses' environment — a worker must never fail to parse the spec
#: that describes how its own orchestrator is being tested.
FLEET_KINDS = ("worker_crash", "worker_hang", "lease_stall", "worker_oom")

#: data-corruption kinds: they corrupt the INPUT ARTIFACTS (deterministically,
#: keyed by record index N) instead of raising at a device op, exercising the
#: ingest integrity layer (formats/ingest.py) the way the device kinds
#: exercise the supervisor. Applied once per plan by apply_data_faults(),
#: which the pipeline entry points call before opening the artifacts.
DATA_KINDS = ("las_bitflip", "las_truncate", "db_garbage")


@dataclass
class FaultSpec:
    kind: str
    at: int = 1        # 1-based index in the kind's counter domain
    fired: bool = False
    device: int = -1   # mesh-member index a device_lost names (-1 = unknown)
    domain: str = ""   # path class an io_* spec scopes to ("" = any domain)


@dataclass
class FaultPlan:
    specs: list = field(default_factory=list)
    device_dead: bool = False
    # mesh-member index of the last fired device_lost (-1 = not attributed);
    # the supervisor's partial-mesh rung reads it to name the culprit chip
    dead_device: int = -1
    # virtual HBM ceiling left by a fired device_oom spec: every later
    # primary op wider than this raises (None = no ceiling). Not one-shot by
    # design — the doomed shape must keep failing until it is bisected small
    # enough, which is exactly the real allocator's behavior.
    oom_max_width: int | None = None
    # logical-operation counters (advance once per op, not per retry)
    n_dispatch: int = 0
    n_fetch: int = 0
    n_device: int = 0
    n_compile: int = 0
    # fleet counters (advance once per worker spawn / successful lease claim)
    n_spawn: int = 0
    n_claim: int = 0
    # capacity counters (advance once per watermark check / inspected pile)
    n_rss: int = 0
    n_pile: int = 0
    # serve counters (advance once per fsync'd journal append / job run)
    n_journal: int = 0
    n_jobrun: int = 0
    # storage counters (advance once per aio primitive invocation): the
    # process-wide op count plus one counter per path-class domain, so an
    # ``@domain`` spec indexes only its own class's traffic
    n_io: int = 0
    n_io_domain: dict = field(default_factory=dict)
    # network counters (advance once per HTTP attempt through serve/netio):
    # process-wide plus one counter per RPC-class domain, mirroring storage
    n_net: int = 0
    n_net_domain: dict = field(default_factory=dict)
    # silent-corruption counter (advances once per successfully fetched
    # primary result) and the persistent liar set: mesh members a fired
    # ``sdc@K`` spec named. A liar keeps lying to attribution probes — the
    # deterministic stand-in for a chip whose bad lane corrupts everything
    # it computes, which is what makes per-member culprit attribution sound
    n_result: int = 0
    liar_devices: set = field(default_factory=set)

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        specs = []
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            kind, _, at = part.partition(":")
            if kind not in _KINDS:
                raise ValueError(
                    f"DACCORD_FAULT: unknown kind {kind!r} (known: "
                    f"{', '.join(_KINDS)})")
            at, _, dev = at.partition("@")
            d, dom = -1, ""
            if dev:
                if kind in ("device_lost", "sdc"):
                    try:
                        d = int(dev)
                    except ValueError:
                        raise ValueError(
                            f"DACCORD_FAULT: bad device in {part!r}")
                elif kind in IO_KINDS:
                    if dev not in IO_DOMAINS:
                        raise ValueError(
                            f"DACCORD_FAULT: unknown io domain {dev!r} "
                            f"(known: {', '.join(IO_DOMAINS)})")
                    dom = dev
                elif kind in NET_KINDS:
                    if dev not in NET_DOMAINS:
                        raise ValueError(
                            f"DACCORD_FAULT: unknown net domain {dev!r} "
                            f"(known: {', '.join(NET_DOMAINS)})")
                    dom = dev
                else:
                    raise ValueError(
                        f"DACCORD_FAULT: @suffix only applies to device_lost "
                        f"and sdc (@device), io_* and net_* kinds (@domain) "
                        f"(got {part!r})")
            if kind == "sdc" and at == "*":
                # continuous storm: '*' = EVERY fetched result is perturbed
                # (never fired-out, like the duration kinds); at=0 encodes it
                n = 0
            else:
                try:
                    n = int(at) if at else 1
                except ValueError:
                    raise ValueError(f"DACCORD_FAULT: bad count in {part!r}")
                if n < 1:
                    raise ValueError(
                        f"DACCORD_FAULT: count must be >= 1 in {part!r}")
            specs.append(FaultSpec(kind, n, device=d, domain=dom))
        return cls(specs=specs)

    @classmethod
    def from_env(cls, env=None) -> "FaultPlan | None":
        """The process-wide plan, or None when ``DACCORD_FAULT`` is unset.
        Read at supervisor construction (once per shard), so a test can set
        the env var per run."""
        text = (env if env is not None else os.environ).get("DACCORD_FAULT")
        return cls.parse(text) if text else None

    def _take(self, kind: str, count: int) -> FaultSpec | None:
        for s in self.specs:
            if s.kind == kind and not s.fired and count >= s.at:
                s.fired = True
                return s
        return None

    def op(self, domain: str, compiling: bool = False,
           degraded: bool = False, width: int | None = None) -> None:
        """Advance counters for one logical ``dispatch``/``fetch`` op and
        raise the matching injected fault, if any. ``degraded`` ops (already
        failed over; no device involved) only ever raise ``crash`` — the
        device-fault kinds describe the primary engine. ``width`` is the
        op's batch width (rows), consulted by the ``device_oom`` virtual
        HBM ceiling."""
        if domain == "dispatch":
            self.n_dispatch += 1
        elif domain == "fetch":
            self.n_fetch += 1
        else:
            raise ValueError(f"unknown op domain {domain!r}")
        self.n_device += 1
        if compiling:
            self.n_compile += 1
        def _raise(exc_cls, kind: str, n: int, msg: str):
            e = exc_cls(msg)
            e.kind, e.n = kind, n
            raise e

        if self._take("crash", self.n_device) is not None:
            raise InjectedCrash(f"injected crash at {domain} #{self.n_device}")
        if degraded:
            return
        if self.device_dead:
            # a lost device stays lost for every later primary op
            _raise(FaultDeviceLost, "device_lost", self.n_device,
                   f"device dead (injected) at {domain}")
        s = self._take("device_lost", self.n_device)
        if s is not None:
            self.device_dead = True
            self.dead_device = s.device
            _raise(FaultDeviceLost, "device_lost", self.n_device,
                   f"injected device_lost at {domain} #{self.n_device}"
                   + (f" (device {s.device})" if s.device >= 0 else ""))
        if self._take("device_oom", self.n_device) is not None:
            # the triggering op sets the ceiling to half its own width, so
            # one bisect step deterministically fits; compose multiple
            # device_oom specs to force a deeper walk
            if width:
                self.oom_max_width = max(1, int(width) // 2)
            _raise(FaultDeviceOOM, "device_oom", self.n_device,
                   f"RESOURCE_EXHAUSTED: injected device_oom at {domain} "
                   f"#{self.n_device} (width {width})")
        if (self.oom_max_width is not None and width
                and int(width) > self.oom_max_width):
            _raise(FaultDeviceOOM, "device_oom", self.n_device,
                   f"RESOURCE_EXHAUSTED: width {width} exceeds injected "
                   f"capacity ceiling {self.oom_max_width} at {domain}")
        if domain == "fetch" and self._take("fetch_hang",
                                            self.n_fetch) is not None:
            _raise(FaultHang, "fetch_hang", self.n_fetch,
                   f"injected fetch_hang at fetch #{self.n_fetch}")
        if domain == "dispatch" and self._take(
                "dispatch_error", self.n_dispatch) is not None:
            _raise(FaultDispatchError, "dispatch_error", self.n_dispatch,
                   f"injected dispatch_error at dispatch #{self.n_dispatch}")
        if compiling and self._take("compile_stall",
                                    self.n_compile) is not None:
            _raise(FaultCompileStall, "compile_stall", self.n_compile,
                   f"injected compile_stall at cold-shape op "
                   f"#{self.n_compile}")

    def fleet_spawn(self) -> str | None:
        """Advance the fleet's worker-spawn counter and return the sabotage
        kind for this spawn (``worker_crash`` | ``worker_hang``), or None.
        One-shot like every device kind: a requeued attempt of the same
        shard is a NEW spawn, so it runs clean and the retry path is
        exercised, not an infinite crash loop."""
        self.n_spawn += 1
        for kind in ("worker_crash", "worker_hang", "worker_oom"):
            if self._take(kind, self.n_spawn) is not None:
                return kind
        return None

    def fleet_claim_stall(self) -> bool:
        """Advance the fleet's lease-claim counter; True when this claim's
        heartbeat renewal must stall (the host wedged right after claiming —
        the lease goes stale and any orchestrator may take the shard over)."""
        self.n_claim += 1
        return self._take("lease_stall", self.n_claim) is not None

    def host_rss_check(self) -> bool:
        """Advance the host-watermark counter (the pipeline checks once per
        pile block); True when this check must report hard memory pressure
        (``host_rss:N`` — exercises the backpressure flush without actually
        ballooning the test process)."""
        self.n_rss += 1
        return self._take("host_rss", self.n_rss) is not None

    def feeder_stall_ms(self) -> float:
        """Milliseconds of injected per-pile feeder delay (``feeder_stall:N``
        — N is a DURATION here, see the module doc), 0.0 when the spec is
        absent. Continuous, never marked fired: the profiler A/B needs the
        whole run slowed, and the pipeline books the sleep under the
        ``stall`` stage so the verdict attributes it honestly."""
        for s in self.specs:
            if s.kind == "feeder_stall":
                return float(s.at)
        return 0.0

    def serve_crash_check(self) -> bool:
        """Advance the serve journal-append counter (``serve/journal.py``
        calls this AFTER each append is fsync'd); True when the process must
        now die hard — the journal responds with an ``os._exit(137)``,
        simulating a SIGKILL landing between syscalls. The durable-first
        ordering is the point: every record the journal holds at death is a
        record replay will see, exactly the real-crash contract."""
        self.n_journal += 1
        return self._take("serve_crash", self.n_journal) is not None

    def serve_hang_check(self) -> bool:
        """Advance the serve job-run counter (``serve/jobs.run_job`` calls
        this as a job starts); True when this run must wedge forever — the
        stand-in for a group thread stuck in a solve, exercising the bounded
        drain deadline (jobs journal-marked INTERRUPTED, nonzero exit) and
        the peer takeover of a hung process's lease."""
        self.n_jobrun += 1
        return self._take("serve_hang", self.n_jobrun) is not None

    def io_check(self, domain: str = "") -> "FaultSpec | None":
        """Advance the storage-op counters for one logical aio primitive
        invocation in path class ``domain`` and return the fired ``io_*``
        spec (never ``io_slow`` — that is a duration, see
        :meth:`io_slow_ms`), or None. A domained spec matches only ops of
        its own class and indexes that class's private counter; an
        undomained spec indexes the process-wide op counter. One-shot like
        the device kinds — the retry wrapper's next attempt runs clean,
        which is exactly what makes ``io_eio`` a *transient* class."""
        self.n_io += 1
        cnt = self.n_io_domain.get(domain, 0) + 1
        self.n_io_domain[domain] = cnt
        for s in self.specs:
            if s.kind not in IO_KINDS or s.kind == "io_slow" or s.fired:
                continue
            if s.domain:
                if s.domain == domain and cnt >= s.at:
                    s.fired = True
                    return s
            elif self.n_io >= s.at:
                s.fired = True
                return s
        return None

    def io_slow_ms(self, domain: str = "") -> float:
        """Milliseconds of injected delay for ONE storage op in ``domain``
        (``io_slow:MS[@domain]`` — N is a DURATION, like ``feeder_stall``),
        0.0 when absent. Continuous, never fired-out: a degraded disk is
        slow for the whole run, and sustained slowness — not a one-shot
        blip — is what the saturation verdict and SLO burn must see."""
        for s in self.specs:
            if s.kind == "io_slow" and (not s.domain or s.domain == domain):
                return float(s.at)
        return 0.0

    def has_io_faults(self) -> bool:
        """True while any storage spec could still fire (or an ``io_slow``
        delay applies) — the aio hook's fast-path gate."""
        return any(s.kind in IO_KINDS and (s.kind == "io_slow" or not s.fired)
                   for s in self.specs)

    def net_check(self, domain: str = "") -> "FaultSpec | None":
        """Advance the network-op counters for one HTTP *attempt* in RPC
        class ``domain`` and return the fired ``net_*`` spec (never
        ``net_slow`` — that is a duration, see :meth:`net_slow_ms`), or
        None. A domained spec matches only attempts of its own class and
        indexes that class's private counter; an undomained spec indexes
        the process-wide attempt counter. ``net_torn`` is special: its N is
        a BYTE offset, not an index, so it fires on the FIRST matching
        attempt and the caller reads ``spec.at`` as the truncation point.
        One-shot like the storage kinds — a retry's next attempt runs
        clean, which is what makes reset/refused the *transient* class."""
        self.n_net += 1
        cnt = self.n_net_domain.get(domain, 0) + 1
        self.n_net_domain[domain] = cnt
        for s in self.specs:
            if s.kind not in NET_KINDS or s.kind == "net_slow" or s.fired:
                continue
            if s.domain and s.domain != domain:
                continue
            if s.kind == "net_torn" or (cnt if s.domain
                                        else self.n_net) >= s.at:
                s.fired = True
                return s
        return None

    def net_slow_ms(self, domain: str = "") -> float:
        """Milliseconds of injected delay for ONE HTTP attempt in ``domain``
        (``net_slow:MS[@domain]`` — N is a DURATION, like ``io_slow``), 0.0
        when absent. Continuous, never fired-out: a grey-slow peer is slow
        for the whole run, and sustained slowness — not a one-shot blip —
        is what the hedged-read latency budget must see."""
        for s in self.specs:
            if s.kind == "net_slow" and (not s.domain or s.domain == domain):
                return float(s.at)
        return 0.0

    def has_net_faults(self) -> bool:
        """True while any network spec could still fire (or a ``net_slow``
        delay applies) — the netio hook's fast-path gate."""
        return any(s.kind in NET_KINDS
                   and (s.kind == "net_slow" or not s.fired)
                   for s in self.specs)

    def sdc_check(self) -> "FaultSpec | None":
        """Advance the fetched-result counter and return the ``sdc`` spec
        whose silent corruption applies to THIS result, or None. A ``sdc:N``
        spec is one-shot at result N; ``sdc:*`` (at=0) is continuous —
        every result perturbs, the chaos-storm grammar. A device-pinned
        spec adds its member to :attr:`liar_devices` so attribution probes
        (:meth:`sdc_liars`) re-corrupt that member's answers forever —
        silent by contract: no event, no exception, the supervisor's shadow
        audit is the only thing that can see it."""
        self.n_result += 1
        for s in self.specs:
            if s.kind != "sdc":
                continue
            if s.at == 0 or (not s.fired and self.n_result >= s.at):
                if s.at != 0:
                    s.fired = True
                if s.device >= 0:
                    self.liar_devices.add(s.device)
                return s
        return None

    def sdc_liars(self) -> set:
        """Original mesh-member indexes every fired (or continuous)
        device-pinned ``sdc`` spec named — the members whose attribution-
        probe answers must re-corrupt. Includes continuous specs' members
        even before their first main-stream hit."""
        liars = set(self.liar_devices)
        for s in self.specs:
            if s.kind == "sdc" and s.at == 0 and s.device >= 0:
                liars.add(s.device)
        return liars

    def has_sdc_faults(self) -> bool:
        """True while any ``sdc`` spec could still perturb a result (or a
        liar member exists) — the supervisor's fast-path gate."""
        return bool(self.liar_devices) or any(
            s.kind == "sdc" and (s.at == 0 or not s.fired)
            for s in self.specs)

    def monster_check(self) -> bool:
        """Advance the inspected-pile counter (the monster guard runs once
        per pile, BEFORE the quadratic windowing spend); True when this pile
        must bust the budget (``monster_pile:N``)."""
        self.n_pile += 1
        return self._take("monster_pile", self.n_pile) is not None

    def probe_override(self) -> bool | None:
        """False once device_lost fired (probe must agree the chip is dead);
        None = no opinion, run the real probe."""
        return False if self.device_dead else None

    def has_data_faults(self) -> bool:
        return any(s.kind in DATA_KINDS and not s.fired for s in self.specs)

    def apply_data_faults(self, las_path: str | None = None,
                          db_path: str | None = None) -> list[dict]:
        """Apply every unfired data-corruption spec to the given artifacts
        (one-shot, like the device kinds). Returns one descriptor dict per
        applied corruption, for ``ingest.fault`` event logging."""
        fired: list[dict] = []
        for s in self.specs:
            if s.fired or s.kind not in DATA_KINDS:
                continue
            if s.kind == "las_bitflip" and las_path is not None:
                fired.append(corrupt_las_bitflip(las_path, s.at))
            elif s.kind == "las_truncate" and las_path is not None:
                fired.append(corrupt_las_truncate(las_path, s.at))
            elif s.kind == "db_garbage" and db_path is not None:
                fired.append(corrupt_db_garbage(db_path, s.at))
            else:
                continue
            s.fired = True
        return fired


def maybe_apply_data_faults(las_path: str | None = None,
                            db_path: str | None = None,
                            env=None) -> list[dict]:
    """Entry-point hook: parse ``DACCORD_FAULT`` and apply any data-corruption
    kinds to the run's input artifacts BEFORE they are opened. Device kinds in
    the same spec are untouched (the supervisor reads its own plan). Each
    entry invocation re-parses the env, so a resumed run must clear the var
    (tests do) or the corruption re-applies."""
    plan = FaultPlan.from_env(env)
    if plan is None or not plan.has_data_faults():
        return []
    return plan.apply_data_faults(las_path=las_path, db_path=db_path)


def non_fleet_spec(text: str | None) -> str:
    """``text`` with every fleet kind removed — the ``DACCORD_FAULT`` value a
    fleet orchestrator forwards to its worker subprocesses (device and data
    kinds pass through; the fleet kinds describe the orchestrator itself)."""
    if not text:
        return ""
    return ",".join(p.strip() for p in text.split(",") if p.strip()
                    and p.strip().partition(":")[0] not in FLEET_KINDS)


# ---------------------------------------------------------------------------
# Deterministic artifact corruption (the data-plane twin of the device kinds;
# also callable directly by tests and the tools_pounce.sh corruption-fuzz
# smoke step). All helpers speak aio URLs (mem: fixtures corrupt too).
# ---------------------------------------------------------------------------

#: byte offset of each fixed-header field inside a 40-byte LAS record
LAS_FIELD_OFF = {"tlen": 0, "diffs": 4, "abpos": 8, "bbpos": 12, "aepos": 16,
                 "bepos": 20, "flags": 24, "aread": 28, "bread": 32}


def _read_all(path: str) -> bytes:
    from ..utils import aio

    with aio.open_input(path, "rb") as fh:
        return fh.read()


def _write_all(path: str, data: bytes) -> None:
    from ..utils import aio

    with aio.open_output(path, "wb") as fh:
        fh.write(data)


def _las_record_offsets(data: bytes) -> list[int]:
    """Byte offsets of every record in a CLEAN LAS image (corruption helpers
    run on intact fixtures; a malformed tlen aborts the walk)."""
    import struct as _struct

    import numpy as np

    from ..formats.las import _HDR_FMT, _HDR_SIZE, _REC_SIZE, _trace_dtype

    _novl, tspace = _struct.unpack(_HDR_FMT, data[:_HDR_SIZE])
    tsize = np.dtype(_trace_dtype(tspace)).itemsize
    offs: list[int] = []
    pos = _HDR_SIZE
    while pos + _REC_SIZE <= len(data):
        tlen = _struct.unpack_from("<i", data, pos)[0]
        if tlen < 0:
            break
        offs.append(pos)
        pos += _REC_SIZE + tlen * tsize
    return offs


def corrupt_las_bitflip(path: str, record: int, field: str = "abpos",
                        bit: int = 31) -> dict:
    """Flip one bit in record ``record`` (1-based, clamped). The default —
    the MSB of ``abpos`` — leaves framing intact but blows the coordinate out
    of read bounds; ``field='tlen'`` corrupts the framing field instead
    (absurd trace length), ``field='bread'`` fabricates a read id."""
    data = bytearray(_read_all(path))
    offs = _las_record_offsets(bytes(data))
    if not offs:
        raise ValueError(f"{path}: no records to corrupt")
    if record < 1:
        raise ValueError(f"record index is 1-based, got {record}")
    off = offs[min(record, len(offs)) - 1] + LAS_FIELD_OFF[field]
    data[off + bit // 8] ^= 1 << (bit % 8)
    _write_all(path, bytes(data))
    from ..formats.las import invalidate_index

    invalidate_index(path)  # writer-path sidecar rule: stale offsets must die
    return {"kind": "las_bitflip", "path": path, "record": record,
            "field": field, "bit": bit, "offset": off}


def corrupt_las_truncate(path: str, record: int) -> dict:
    """Cut the file mid-record ``record`` (1-based, clamped): everything from
    that record's 18th header byte on is gone — the torn-write / torn-copy
    failure mode."""
    data = _read_all(path)
    offs = _las_record_offsets(data)
    if not offs:
        raise ValueError(f"{path}: no records to truncate at")
    if record < 1:
        raise ValueError(f"record index is 1-based, got {record}")
    cut = offs[min(record, len(offs)) - 1] + 17
    _write_all(path, data[:cut])
    from ..formats.las import invalidate_index

    invalidate_index(path)  # writer-path sidecar rule: stale offsets must die
    return {"kind": "las_truncate", "path": path, "record": record,
            "offset": cut}


def corrupt_db_garbage(db_path: str, record: int) -> dict:
    """Overwrite read record ``record`` (1-based, clamped) of the DB's .idx
    with 0xFF garbage — rlen/boff become absurd, exercising the validated DB
    decode (``read_db`` strict raise vs ``bad_reads`` quarantine marking)."""
    import os as _os

    from ..formats.dazzdb import _HDR_SIZE, _READ_SIZE, _db_stems

    d, stem = _db_stems(db_path)
    idx = _os.path.join(d, f".{stem}.idx")
    data = bytearray(_read_all(idx))
    n = (len(data) - _HDR_SIZE) // _READ_SIZE
    if n <= 0:
        raise ValueError(f"{idx}: no read records to corrupt")
    if record < 1:
        raise ValueError(f"record index is 1-based, got {record}")
    off = _HDR_SIZE + _READ_SIZE * (min(record, n) - 1)
    data[off : off + _READ_SIZE] = b"\xff" * _READ_SIZE
    _write_all(idx, bytes(data))
    return {"kind": "db_garbage", "path": idx, "record": record, "offset": off}
