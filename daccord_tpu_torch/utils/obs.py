"""Observability: the structured jsonl event log, trace spans, the metrics
registry, the saturation profiler, the per-window ledger, the device probes
and the cold-shape registry.

The port's copy of those parts of ``daccord_tpu/utils/obs.py``:

- :class:`JsonlLogger` stamps every record with a process-relative ``t`` and
  an absolute ``ts``; buffered writers flush the fault and state classes of
  :data:`DURABLE_EVENTS` through at once. ``tools/eventcheck.py`` lints the
  files it writes.
- :class:`Tracer`: hierarchical ``span_open``/``span_close`` spans (run ->
  pile -> batch -> dispatch/fetch/flush), read by ``tools/trace.py``.
- :class:`MetricsRegistry`: counters, gauges and histograms, with periodic
  ``metrics`` snapshot events and the end-of-run rollup a shard commits as
  ``*.metrics.json``; :func:`render_prom` and :func:`parse_prom` are its
  Prometheus text twin and lint.
- The saturation profiler: :class:`StageProfile` (per-stage walls of the
  host feeder), :func:`saturation_gauges` and :func:`bottleneck_verdict`
  (read by ``tools/prof.py``).
- :class:`WindowLedger`: one ``window`` row per solved-or-not window
  (``--ledger``).
- :func:`device_alive`: a CUDA probe in a child process under a timeout (a
  trapped kernel poisons only its own process's context);
  :func:`measure_rtt_s`, the round trip of a tiny copy to the card and back
  (the unit of the supervisor's warm deadline); :func:`device_peak_bytes`,
  the caching allocator's peak.
- The cold-shape registry (:func:`fingerprint_seen`,
  :func:`record_fingerprint`): a shape whose kernels have not been built
  and launched on this host yet is "cold" and gets the supervisor's long
  compile deadline, which covers the nvcc builds at first use. It lives in
  ``daccord_tpu_torch/_build/registry`` unless ``DACCORD_COMPCACHE`` names
  another directory (``DACCORD_NO_COMPCACHE=1``: every shape is cold).
- The content digests of the integrity chain: :func:`sha256_file` (shard
  manifests, the merge gate, ``tools/audit.py``), :func:`result_digest`,
  :func:`row_digests` and :func:`batch_digest`.

- The serve plane's host gauges: :func:`disk_free_mb` (the free-bytes
  watermarks of admission and the disk-pressure governor) and
  :func:`auto_batch_size` (the merged dispatch width ``serve`` uses when
  ``-b`` is not given).

The fleet's and the mesh's parts of the JAX module (the trust registry and
the auto backend probe) are not ported yet.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import threading
import time

#: events a buffered logger writes through at once: faults, state
#: transitions, failover and shadow-audit findings are what a post-mortem
#: reads, so they must reach the file at line granularity
DURABLE_EVENTS = frozenset({
    "sup_fault", "sup_failover", "sup_failback", "sup_state",
    "ingest.fault", "ingest.commit", "ingest.quarantine",
    "governor.classify", "governor.monster",
    "io.fault", "sup_sdc", "trust.state",
    # the serve tier's recovery milestones (the journal fsyncs each record;
    # these are its mirrors in the event stream) and its disk-pressure
    # transitions: what a post-crash investigation reads
    "serve.replay", "serve.takeover", "serve.commit", "serve.abort",
    "disk.pressure", "journal.compact",
})

_TEL_DROPPED = 0


def _note_dropped(n: int) -> None:
    global _TEL_DROPPED
    _TEL_DROPPED += int(n)


def telemetry_dropped_total() -> int:
    """Lines dropped by telemetry writers process-wide (0 = none)."""
    return _TEL_DROPPED


def disk_free_mb(path: str) -> float:
    """Free MiB on the filesystem holding ``path`` (walking up to the
    nearest existing ancestor: a watched directory may not exist yet); -1.0
    when even statvfs fails. The free-bytes gauge of the serve plane's
    disk-pressure watermarks, beside the governor's ``host_rss_mb``."""
    p = os.path.abspath(path or ".")
    while p and not os.path.exists(p):
        parent = os.path.dirname(p)
        if parent == p:
            break
        p = parent
    try:
        st = os.statvfs(p)
    except (OSError, AttributeError):
        return -1.0
    return st.f_bavail * st.f_frsize / float(1 << 20)


def auto_batch_size(backend: str) -> int:
    """The batch when ``-b`` is not given, by the port's backend: the native
    engine pays no shape-scaled cost, so bigger is better (4096); the ladder
    on the card runs 2048 (the TPU's width in the JAX package's mapping),
    on the CPU 512."""
    if backend == "native":
        return 4096
    return 2048 if backend == "cuda" else 512


class JsonlLogger:
    def __init__(self, path: str | None = None, stream=None,
                 buffer_lines: int = 1, flush_s: float = 0.0):
        """``buffer_lines=1`` (default) flushes after every record. Hot-path
        writers (the ledger) pass ``buffer_lines`` > 1 and a ``flush_s``
        bound; records in :data:`DURABLE_EVENTS` always flush through, and
        ``close()`` flushes the tail. ``path='-'`` writes to stderr."""
        self._fh = None
        if path == "-":
            self._fh = stream or sys.stderr
        elif path:
            self._fh = open(path, "at")
        self._t0 = time.time()
        self._buf: list[str] = []
        self._buffer_lines = max(1, int(buffer_lines))
        self._flush_s = flush_s
        self._last_flush = self._t0
        self._lock = threading.Lock()   # the supervisor's watchdog threads log too

    def log(self, event: str, **fields) -> None:
        if self._fh is None:
            return
        with self._lock:
            now = time.time()
            # t = process-relative; ts = absolute epoch, the key that merges
            # several processes' files onto one timeline
            rec = {"t": round(now - self._t0, 3), "ts": round(now, 6),
                   "event": event, **fields}
            self._buf.append(json.dumps(rec) + "\n")
            if (len(self._buf) >= self._buffer_lines
                    or event in DURABLE_EVENTS
                    or (self._flush_s and now - self._last_flush >= self._flush_s)):
                self._flush_locked()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if self._fh is None or not self._buf:
            return
        try:
            from . import aio

            aio.io_gate("sidecar", op="events")
            self._fh.write("".join(self._buf))
            self._fh.flush()
        except (OSError, ValueError):
            # telemetry never raises into the data path: a full or failing
            # volume drops the buffered lines and counts them
            _note_dropped(len(self._buf))
        self._buf.clear()
        self._last_flush = time.time()

    def close(self) -> None:
        self.flush()
        if self._fh is not None and self._fh is not sys.stderr:
            try:
                self._fh.close()
            except OSError:
                _note_dropped(0)
        # a closed logger drops later records instead of raising
        self._fh = None

    def __enter__(self) -> "JsonlLogger":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class NullLogger(JsonlLogger):
    def __init__(self):
        super().__init__(None)


#: process-wide span id counter: several Tracer instances may share one
#: events file, so uniqueness must not depend on which one minted the id
_SPAN_IDS = itertools.count(1)


class Tracer:
    """Hierarchical trace spans over a :class:`JsonlLogger`.

    ``open`` emits ``span_open`` (id, parent, name) and pushes the span on
    the parent stack; ``close`` emits ``span_close`` with the measured wall.
    Ids are ``<pid-hex>-<n>``. Non-nested spans pass ``attach=False`` with
    an explicit ``parent`` so the stack stays well-formed. ``unwind``
    closes every span still open (status=abort), from the owners' ``finally``
    blocks, so every open has a close."""

    def __init__(self, log: JsonlLogger | None):
        self.log = log if log is not None else NullLogger()
        self.enabled = self.log._fh is not None
        self._pid = "%x" % os.getpid()
        self._stack: list[str] = []
        self._open: dict[str, tuple[str, float]] = {}

    def open(self, name: str, parent: str | None = None, attach: bool = True,
             **fields) -> str | None:
        if not self.enabled:
            return None
        sid = f"{self._pid}-{next(_SPAN_IDS)}"
        if parent is None:
            parent = self._stack[-1] if self._stack else ""
        self._open[sid] = (name, time.time())
        if attach:
            self._stack.append(sid)
        self.log.log("span_open", span=sid, parent=parent, name=name, **fields)
        return sid

    def close(self, sid: str | None, **fields) -> None:
        if sid is None:
            return
        name, t0 = self._open.pop(sid, (None, 0.0))
        if name is None:
            return   # unknown or already closed: close is idempotent
        if sid in self._stack:
            self._stack.remove(sid)
        self.log.log("span_close", span=sid, name=name,
                     wall_s=round(time.time() - t0, 6), **fields)

    def span(self, name: str, **fields):
        """Context manager form; closes with ``status=error`` on exception."""
        return _SpanCtx(self, name, fields)

    def current(self) -> str:
        """The innermost attached span still open ("" when none): the
        parent a span opened on another thread names."""
        return self._stack[-1] if self.enabled and self._stack else ""

    def unwind(self, status: str = "abort") -> None:
        """Close every span still open, innermost first."""
        for sid in sorted(self._open, key=lambda s: self._open[s][1], reverse=True):
            self.close(sid, status=status)


class _SpanCtx:
    __slots__ = ("_tr", "_name", "_fields", "sid")

    def __init__(self, tracer: Tracer, name: str, fields: dict):
        self._tr, self._name, self._fields = tracer, name, fields
        self.sid = None

    def __enter__(self):
        self.sid = self._tr.open(self._name, **self._fields)
        return self.sid

    def __exit__(self, et, ev, tb) -> bool:
        if et is None:
            self._tr.close(self.sid)
        else:
            self._tr.close(self.sid, status="error")
        return False


class WindowLedger:
    """Per-window outcome ledger: one ``window`` jsonl row per window the
    pipeline accounted (identity, length, depth, the tier reached, whether
    it solved, its batch's turnaround from dispatch to scatter), through a
    buffered :class:`JsonlLogger`. Rows record the outcome at solve time; a
    later end-trim does not rewrite them. ``job`` (a serve job's tag) joins
    a row only when given, so a batch run's ledger keeps its schema."""

    def __init__(self, path: str):
        self.log = JsonlLogger(path, buffer_lines=256, flush_s=5.0)
        self.rows = 0

    def record(self, aread: int, widx: int, length: int, depth: int,
               tier: int, k: int, solved: bool, stream: str, rescued: bool,
               wall_s: float, job: str | None = None) -> None:
        self.rows += 1
        log = self.log
        if log._fh is None:
            return
        # a hand-built line (fixed schema, scalar fields): the ledger is the
        # highest-volume record, and skipping json.dumps keeps it cheap. The
        # job tag is a client's string, so it is quoted by json.dumps
        jf = ', "job": %s' % json.dumps(job) if job else ""
        now = time.time()
        with log._lock:
            log._buf.append(
                '{"t": %.3f, "ts": %.6f, "event": "window", "aread": %d, '
                '"widx": %d, "len": %d, "depth": %d, "tier": %d, "k": %d, '
                '"solved": %s, "stream": "%s", "rescued": %s, "wall_s": %.6f%s}\n'
                % (now - log._t0, now, aread, widx, length, depth, tier, k,
                   "true" if solved else "false", stream,
                   "true" if rescued else "false", wall_s, jf))
            if (len(log._buf) >= log._buffer_lines
                    or (log._flush_s and now - log._last_flush >= log._flush_s)):
                log._flush_locked()

    def close(self) -> None:
        self.log.close()


class StageProfile:
    """Per-stage wall-clock accounting of the host feeder.

    One ``perf_counter`` pair per timed region (per pile, never per window),
    folded into a dict under a lock, so the feeder threads add to it too.
    ``threads`` records the feeder pool width: with N windowing threads the
    stage walls sum ACROSS threads (CPU-time-like), so they may exceed the
    wall the pile loop blocked on the feeder.
    """

    __slots__ = ("_lock", "walls", "calls", "threads")

    def __init__(self, threads: int = 1):
        self._lock = threading.Lock()
        self.walls: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.threads = max(1, int(threads))

    def add(self, stage: str, wall_s: float, calls: int = 1) -> None:
        with self._lock:
            self.walls[stage] = self.walls.get(stage, 0.0) + float(wall_s)
            self.calls[stage] = self.calls.get(stage, 0) + calls

    def timed(self, stage: str):
        """Context manager form (perf_counter pair around the block)."""
        return _StageTimer(self, stage)

    def wall(self, stage: str) -> float:
        return self.walls.get(stage, 0.0)

    def total(self) -> float:
        """Summed wall over every stage (thread-summed, see class doc)."""
        return sum(self.walls.values())

    def dominant(self) -> tuple[str | None, float]:
        """(stage, wall) of the heaviest stage; (None, 0.0) when empty."""
        if not self.walls:
            return None, 0.0
        name = max(self.walls, key=lambda k: self.walls[k])
        return name, self.walls[name]

    def summary(self) -> dict:
        """``{"threads": n, "stages": {name: {"wall_s", "calls"}}}``."""
        with self._lock:
            return {"threads": self.threads,
                    "stages": {k: {"wall_s": round(self.walls[k], 6),
                                   "calls": self.calls.get(k, 0)}
                               for k in sorted(self.walls)}}


class _StageTimer:
    __slots__ = ("_prof", "_stage", "_t0")

    def __init__(self, prof: StageProfile, stage: str):
        self._prof, self._stage = prof, stage

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._prof.add(self._stage, time.perf_counter() - self._t0)
        return False


_PROBE = ("import torch\n"
          "x = torch.ones(8, 8, device='cuda')\n"
          "torch.cuda.synchronize()\n"
          "print('alive=%d' % int(float((x @ x).sum().item()) == 512.0))\n")


def device_alive(timeout_s: float = 150, device: str = "cuda") -> bool:
    """True iff a fresh child process reaches the card and computes one
    product within ``timeout_s``. A trapped kernel poisons only the CUDA
    context of the process that launched it, so the probe answers whether
    the card itself is usable. The CPU is always alive."""
    if str(device).startswith("cpu"):
        return True
    env = dict(os.environ)
    if ":" in str(device):
        env["CUDA_VISIBLE_DEVICES"] = str(device).split(":", 1)[1]
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                           text=True, timeout=timeout_s, env=env)
    except (subprocess.TimeoutExpired, OSError):
        return False
    return "alive=1" in r.stdout


_COUNT_PROBE = ("import torch\n"
                "print('ndev=%d' % (torch.cuda.device_count() "
                "if torch.cuda.is_available() else 0))\n")


def probe_backend_status(timeout_s: float | None = None) -> tuple[int, str]:
    """(device count, reason) of the card, asked from a throwaway child
    process that imports torch and reads ``torch.cuda.device_count()``: a
    wedged driver then costs at most ``timeout_s``, never the caller. Count
    0 means no usable card; the reason says why (``probe_timeout`` |
    ``init_error`` | ``no_devices`` | ``probe_error``), as in the JAX
    package's probe. ``timeout_s`` defaults to ``DACCORD_PROBE_TIMEOUT_S``
    (150 s; a malformed value reads as 150)."""
    if timeout_s is None:
        timeout_s = env_float("DACCORD_PROBE_TIMEOUT_S", 150.0)
    try:
        r = subprocess.run([sys.executable, "-c", _COUNT_PROBE],
                           capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return 0, "probe_timeout"
    except OSError:
        return 0, "probe_error"
    for line in r.stdout.splitlines():
        if line.startswith("ndev="):
            try:
                n = int(line.split("=", 1)[1])
            except ValueError:
                return 0, "init_error"
            return n, ("ok" if n > 0 else "no_devices")
    return 0, "init_error"


def resolve_auto_backend(device: str | None = None) -> str:
    """``--backend auto`` as the multi-process layer resolves it: ``cuda``
    when the bounded probe sees a card. With no card the port raises: it
    never falls back on its own (the JAX function falls back quietly to the
    native engine or its CPU ladder on a dead device). Only an explicit
    ``device='cpu'`` takes the host: the native engine when the host library
    loads, else the CPU ladder."""
    if device is not None and str(device).startswith("cpu"):
        try:
            from ..native import load

            load()
            return "native"
        except Exception:  # noqa: BLE001 -- no g++: the CPU ladder
            return "cpu"
    n, why = probe_backend_status()
    if n > 0:
        return "cuda"
    raise RuntimeError(f"--backend auto: CUDA is not available (probe: {why}); "
                       "pass --device cpu to run on the host")


def env_float(name: str, default: float) -> float:
    """Float env knob with a silent fall-back on unparseable values (the
    runtime config pattern shared by the supervisor and the governor)."""
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def compcache_dir() -> str | None:
    """The directory of the cold-shape registry and the governor's ratchets:
    ``DACCORD_COMPCACHE``, else ``daccord_tpu_torch/_build/registry`` (None
    with ``DACCORD_NO_COMPCACHE`` set)."""
    if os.environ.get("DACCORD_NO_COMPCACHE"):
        return None
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.environ.get("DACCORD_COMPCACHE") or os.path.join(pkg, "_build", "registry")


def _fingerprint_path() -> str | None:
    d = compcache_dir()
    return os.path.join(d, "daccord_shapes.json") if d else None


def fingerprint_registry() -> dict:
    """The cold-shape registry as ``{key: meta}`` (meta: the first launch's
    wall, its time). Empty when the registry is off or unreadable."""
    p = _fingerprint_path()
    if p is None or not os.path.exists(p):
        return {}
    try:
        with open(p) as fh:
            d = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return {}
    if isinstance(d, dict):
        return {str(k): (v if isinstance(v, dict) else {}) for k, v in d.items()}
    return {}


def fingerprint_seen(key: str) -> bool:
    """True when the shape ``key`` (like ``cuda:B2048xD32xL64``) was built
    and launched on this host before: the supervisor classifies its ops
    warm."""
    return key in fingerprint_registry()


def record_fingerprint(key: str, wall_s: float | None = None,
                       meta: dict | None = None) -> None:
    """Record ``key`` as warm (an atomic rewrite; best-effort: a read-only
    directory never sinks a run). The first recorded wall, the cold one,
    is kept."""
    p = _fingerprint_path()
    if p is None:
        return
    try:
        reg = fingerprint_registry()
        entry = reg.get(key)
        fresh = {}
        if wall_s is not None:
            fresh["wall_s"] = round(float(wall_s), 3)
        if meta:
            fresh.update(meta)
        if entry is None:
            entry = {"ts": round(time.time(), 1), **fresh}
        else:
            added = {k: v for k, v in fresh.items() if k not in entry}
            if not added:
                return
            entry = {**entry, **added}
        reg[key] = entry
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = f"{p}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wt") as fh:
            json.dump(reg, fh)
        os.replace(tmp, p)
    except (OSError, json.JSONDecodeError):
        pass


def expected_compile_wall_s(batch_rows: int) -> float:
    """Expected wall of a cold shape's first ladder call: the nvcc builds of
    the kernels it reaches at first use (one nvcc a source, in parallel;
    ``chip_smoke.py`` prints their seconds) plus the call itself. A patience
    estimate for the ``sup_compile`` event, not a promise; the deadline is
    ``SupervisorConfig.compile_deadline_s``."""
    return 60.0 + 0.01 * max(int(batch_rows), 0)


def sha256_file(path: str, limit: int | None = None, chunk: int = 1 << 20) -> str:
    """Streaming sha256 hex digest of a file's content (its first ``limit``
    bytes when given); paths and ``mem:`` URLs."""
    import hashlib

    from . import aio

    h = hashlib.sha256()
    remaining = limit
    with aio.open_input(path, "rb") as fh:
        while remaining is None or remaining > 0:
            n = chunk if remaining is None else min(chunk, remaining)
            b = fh.read(n)
            if not b:
                break
            h.update(b)
            if remaining is not None:
                remaining -= len(b)
    return h.hexdigest()




def result_digest(out: dict, rows=None) -> str:
    """Canonical sha256 of a solver result dict: each row's ``solved`` flag,
    and a solved row's ``cons_len`` and consensus bytes. ``err``, ``tier``
    and the top-M flag are left out: they steer routing, never output
    bytes, so two engines at byte parity digest equal. ``rows`` restricts
    it to a row subset (the shadow audit's sample)."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    cons = np.asarray(out["cons"])
    cons_len = np.asarray(out["cons_len"])
    solved = np.asarray(out["solved"])
    idx = range(len(cons)) if rows is None else rows
    for i in idx:
        ok = bool(solved[i])
        h.update(b"\x01" if ok else b"\x00")
        if ok:
            cl = int(cons_len[i])
            h.update(cl.to_bytes(4, "little"))
            h.update(np.ascontiguousarray(cons[i, :cl]).tobytes())
    return h.hexdigest()


def row_digests(batch) -> list:
    """Per-window sha256 digests of a ``WindowBatch``'s live content (read
    id, window start, and each segment's length and bytes; pad cells left
    out). A paged batch is unpacked first, so packing, unpacking and row
    slicing must leave every digest as it was."""
    import hashlib

    import numpy as np

    if getattr(batch, "pool", None) is not None:
        batch = batch.to_dense()
    out = []
    for i in range(batch.size):
        h = hashlib.sha256()
        h.update(int(batch.read_ids[i]).to_bytes(8, "little", signed=True))
        h.update(int(batch.wstarts[i]).to_bytes(8, "little", signed=True))
        d = int(batch.nsegs[i])
        h.update(d.to_bytes(4, "little"))
        for di in range(d):
            ln = int(batch.lens[i, di])
            h.update(ln.to_bytes(4, "little"))
            h.update(np.ascontiguousarray(batch.seqs[i, di, :ln]).tobytes())
        out.append(h.hexdigest())
    return out


def batch_digest(batch) -> str:
    """One sha256 over a batch's :func:`row_digests`: the same under every
    re-batching that keeps the rows and their order."""
    import hashlib

    return hashlib.sha256("".join(row_digests(batch)).encode()).hexdigest()


# ---------------------------------------------------------------------------
# The saturation profiler: device starvation gauges and the bottleneck
# verdict over the feeder's StageProfile table.
# ---------------------------------------------------------------------------

#: the feeder's stage names, in pipeline order: ``decode`` (LAS and DB byte
#: decode), ``rank`` (the depth ranking), ``realign`` (trace-point
#: refinement, or the host library's pile call, which also cuts and packs
#: the windows), ``kmer`` and ``tensorize`` (the numpy feeder's window cut
#: and packing), ``pack`` (pad or page-pack at batch assembly), ``stall``
#: (the injected ``feeder_stall`` fault's delay)
FEEDER_STAGES = ("decode", "rank", "realign", "kmer", "tensorize", "pack",
                 "stall")

#: a run is ``device``-bound when the host spends at least this share of the
#: wall blocked on the device; the host side is the bottleneck when the
#: device is idle at least this share; between the two, ``balanced``
VERDICT_BLOCKED_FRAC = 0.40
VERDICT_IDLE_FRAC = 0.40


def saturation_gauges(wall_s: float, blocked_s: float, busy_s: float) -> dict:
    """Device starvation and overlap gauges from three walls: ``blocked_s``
    the host waited on the device (fetch; and dispatch for a synchronous
    engine), ``busy_s`` the device (or an inline engine) had work.
    ``device_idle_frac``: the device's gaps while the host fed it;
    ``host_blocked_frac``: the host waiting on the device;
    ``overlap_frac``: both busy at once."""
    w = max(float(wall_s), 1e-9)
    blocked = min(max(float(blocked_s), 0.0), w)
    busy = min(max(float(busy_s), 0.0), w)
    return {"device_idle_frac": round(max(w - busy, 0.0) / w, 4),
            "host_blocked_frac": round(blocked / w, 4),
            "overlap_frac": round(max(busy - blocked, 0.0) / w, 4)}


def bottleneck_verdict(gauges: dict, stages: dict | None = None) -> dict:
    """The run's bottleneck from :func:`saturation_gauges` and the
    ``StageProfile.summary()['stages']`` table (optional): ``{"verdict":
    'host_feeder'|'device'|'io'|'balanced', "stage": the dominant feeder
    stage or None, **gauges}``. In order: host blocked at least
    :data:`VERDICT_BLOCKED_FRAC` of the wall -> ``device``; device idle at
    least :data:`VERDICT_IDLE_FRAC` -> ``io`` when byte decode dominates the
    feeder, else ``host_feeder``; otherwise ``balanced``."""
    dom = None
    if stages:
        dom = max(stages, key=lambda k: stages[k].get("wall_s", 0.0))
    if gauges.get("host_blocked_frac", 0.0) >= VERDICT_BLOCKED_FRAC:
        verdict = "device"
    elif gauges.get("device_idle_frac", 0.0) >= VERDICT_IDLE_FRAC:
        verdict = "io" if dom == "decode" else "host_feeder"
    else:
        verdict = "balanced"
    return {"verdict": verdict, "stage": dom, **gauges}


# ---------------------------------------------------------------------------
# The metrics registry and its Prometheus text exposition.
# ---------------------------------------------------------------------------

class _Counter:
    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def inc(self, n: int = 1) -> None:
        self.n += n


class _Gauge:
    __slots__ = ("v",)

    def __init__(self):
        self.v = 0.0

    def set(self, v: float) -> None:
        self.v = float(v)


#: the bounded sample (reservoir) behind a histogram's quantiles
_HIST_RESERVOIR = 512


class _Histogram:
    """Count, sum, min and max, coarse log2 buckets, and p50/p95/p99 from a
    bounded reservoir sample. The reservoir's RNG is seeded per instance, so
    the quantiles are a function of the observation sequence."""

    __slots__ = ("count", "total", "vmin", "vmax", "buckets", "samples", "_rng")

    def __init__(self):
        import random

        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None
        self.buckets: dict[int, int] = {}
        self.samples: list[float] = []
        self._rng = random.Random(0xDACC)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        b = max(-30, min(30, int(v).bit_length() if v >= 1
                         else -int(1.0 / max(v, 1e-9)).bit_length()))
        self.buckets[b] = self.buckets.get(b, 0) + 1
        # Vitter's reservoir: past the capacity every observation has the
        # same chance to be in the sample
        if len(self.samples) < _HIST_RESERVOIR:
            self.samples.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < _HIST_RESERVOIR:
                self.samples[j] = v

    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile of the reservoir (exact up to its
        capacity)."""
        if not self.samples:
            return None
        s = sorted(self.samples)
        return s[min(int(q * len(s)), len(s) - 1)]

    def summary(self) -> dict:
        return {"count": self.count, "sum": round(self.total, 6),
                "min": self.vmin, "max": self.vmax,
                "mean": round(self.total / self.count, 6) if self.count else None,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Counters, gauges and histograms. ``snapshot(log)`` writes one
    ``metrics`` event with every current value (the pipeline calls it from
    the pile loop every ``metrics_snapshot_s``); ``rollup()`` is the
    end-of-run dict that ``launch.run_shard`` commits beside the shard
    manifest."""

    def __init__(self):
        self._counters: dict[str, _Counter] = {}
        self._gauges: dict[str, _Gauge] = {}
        self._hists: dict[str, _Histogram] = {}

    def counter(self, name: str) -> _Counter:
        return self._counters.setdefault(name, _Counter())

    def gauge(self, name: str) -> _Gauge:
        return self._gauges.setdefault(name, _Gauge())

    def histogram(self, name: str) -> _Histogram:
        return self._hists.setdefault(name, _Histogram())

    def _counter_view(self) -> dict:
        out = {k: c.n for k, c in sorted(self._counters.items())}
        # the process's dropped telemetry lines ride every snapshot and
        # rollup once there are any
        if _TEL_DROPPED and "telemetry_dropped_total" not in out:
            out["telemetry_dropped_total"] = _TEL_DROPPED
        return out

    def snapshot(self, log: JsonlLogger, **extra) -> None:
        log.log("metrics", counters=self._counter_view(),
                gauges={k: round(g.v, 6) for k, g in sorted(self._gauges.items())},
                hists={k: h.summary() for k, h in sorted(self._hists.items())},
                **extra)

    def rollup(self) -> dict:
        return {"counters": self._counter_view(),
                "gauges": {k: round(g.v, 6) for k, g in sorted(self._gauges.items())},
                "hists": {k: h.summary() for k, h in sorted(self._hists.items())}}


def _prom_name(name: str) -> str:
    """A metric name as a legal Prometheus metric name."""
    import re

    n = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return n if not n[:1].isdigit() else "_" + n


def _prom_labels(labels: dict | None) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{_prom_name(str(k))}={json.dumps(str(v))}"
                          for k, v in sorted(labels.items())) + "}"


def render_prom(rollup: dict, prefix: str = "daccord", labels: dict | None = None) -> str:
    """Prometheus text exposition (format 0.0.4) of a registry rollup
    (:meth:`MetricsRegistry.rollup`, or a committed ``*.metrics.json``):
    counters as ``<prefix>_<name>_total``, gauges as ``<prefix>_<name>``,
    histograms as summaries (``_count``, ``_sum`` and the p50/p95/p99
    ``quantile`` series). ``labels`` (e.g. ``{"shard": 3}``) ride every
    sample. A rollup's ``verdict`` string (the bottleneck verdict) renders
    as ``<prefix>_bottleneck_verdict{verdict="..."} 1``."""
    lab = _prom_labels(labels)
    lines: list[str] = []
    verdict = rollup.get("verdict")
    if isinstance(verdict, str) and verdict:
        mn = f"{_prom_name(prefix)}_bottleneck_verdict"
        vl = _prom_labels(dict(labels or {}, verdict=verdict))
        lines.append(f"# TYPE {mn} gauge")
        lines.append(f"{mn}{vl} 1")
    for name, v in (rollup.get("counters") or {}).items():
        mn = f"{_prom_name(prefix)}_{_prom_name(name)}_total"
        lines.append(f"# TYPE {mn} counter")
        lines.append(f"{mn}{lab} {int(v)}")
    for name, v in (rollup.get("gauges") or {}).items():
        mn = f"{_prom_name(prefix)}_{_prom_name(name)}"
        lines.append(f"# TYPE {mn} gauge")
        lines.append(f"{mn}{lab} {float(v):g}")
    for name, h in (rollup.get("hists") or {}).items():
        mn = f"{_prom_name(prefix)}_{_prom_name(name)}"
        lines.append(f"# TYPE {mn} summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            val = h.get(key)
            if val is None:
                continue
            ql = dict(labels or {}, quantile=q)
            lines.append(f"{mn}{_prom_labels(ql)} {float(val):g}")
        lines.append(f"{mn}_count{lab} {int(h.get('count') or 0)}")
        lines.append(f"{mn}_sum{lab} {float(h.get('sum') or 0.0):g}")
    return "\n".join(lines) + "\n"


def parse_prom(text: str) -> tuple[dict, list[str]]:
    """Parse and lint a Prometheus text exposition: ``({metric_name:
    [(labels_str, value)]}, errors)``. Every sample line must be
    ``name[{labels}] value`` with a finite value, every ``# TYPE`` must
    name a known type, and a typed metric must have a sample."""
    import math
    import re

    samples: dict[str, list] = {}
    errs: list[str] = []
    typed: dict[str, str] = {}
    line_re = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")
    for ln, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) != 4 or parts[3] not in (
                        "counter", "gauge", "summary", "histogram", "untyped"):
                    errs.append(f"line {ln}: malformed TYPE comment")
                else:
                    typed[parts[2]] = parts[3]
            continue
        m = line_re.match(line)
        if m is None:
            errs.append(f"line {ln}: not a sample line: {line[:80]!r}")
            continue
        name, _labels, val = m.groups()
        try:
            fv = float(val)
        except ValueError:
            errs.append(f"line {ln}: {name}: non-numeric value {val!r}")
            continue
        if math.isnan(fv) or math.isinf(fv):
            errs.append(f"line {ln}: {name}: non-finite value {val!r}")
            continue
        samples.setdefault(name, []).append((_labels or "", fv))
    for name, kind in typed.items():
        base = [k for k in samples
                if k == name or (kind in ("summary", "histogram") and k.startswith(name))]
        if not base:
            errs.append(f"TYPE {name} declared but no samples follow")
    return samples, errs


# ---------------------------------------------------------------------------
# Device probes of a run in progress (the card's own, in this process).
# ---------------------------------------------------------------------------

def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph, where a
    synchronize or a copy would break the capture."""
    import torch

    return bool(torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


def device_peak_bytes(device=None) -> int | None:
    """Peak device memory the caching allocator handed out on ``device``
    (``torch.cuda.max_memory_allocated``); None on the CPU, without CUDA,
    while a graph is being captured, or on a context a fault poisoned
    (telemetry never raises into the run)."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    try:
        if not torch.cuda.is_available() or _capturing():
            return None
        return int(torch.cuda.max_memory_allocated(device))
    except Exception:
        return None


def measure_rtt_s(n: int = 3, timeout_s: float = 30.0, device=None) -> float | None:
    """Median of ``n`` round trips to the card: a tiny host-to-device copy,
    back again, and ``torch.cuda.synchronize()``; the fixed cost of one
    fetch, the time unit of the supervisor's warm deadline. It runs on a
    daemon thread and gives up after ``timeout_s`` (a wedged card must not
    hang the caller). None on the CPU, on any error, past the timeout, or
    while a graph is being captured. Not a liveness probe
    (:func:`device_alive` is)."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    try:
        if not torch.cuda.is_available() or _capturing():
            return None
    except Exception:
        return None
    box: list = []

    def work() -> None:
        try:
            host = torch.zeros(8, dtype=torch.int32)
            rtts = []
            for _ in range(n):
                t0 = time.perf_counter()
                host.copy_(host.to(device or "cuda").cpu())
                torch.cuda.synchronize(device)
                rtts.append(time.perf_counter() - t0)
            box.append(sorted(rtts)[len(rtts) // 2])
        except Exception:
            pass

    t = threading.Thread(target=work, daemon=True, name="daccord-rtt-probe")
    t.start()
    t.join(timeout_s)
    return box[0] if box else None
