"""The serve fleet's HTTP choke point: the port's copy of the JAX
package's ``serve/netio.py``.

Every router, autoscaler and client HTTP call goes through here, so the
whole fleet shares

- **per-domain deadlines**: each RPC class (``healthz`` | ``submit`` |
  ``result`` | ``stream`` | ``abort``) carries an explicit timeout — a
  wedged peer socket costs one bounded deadline, never a stalled poll or
  scale loop;
- **bounded retries** with exponential backoff + full jitter, absorbing
  ONLY the transient class (connection reset / refused — the peer never
  processed, or never finished receiving, the request). Non-idempotent
  calls (a submit without an ``idempotency_key``) are never retried: a
  reset after the request left the socket is ambiguous, and only the
  journal-backed key makes the retry exactly-once;
- a per-peer **circuit breaker** (consecutive-failure open → half-open
  probe → close), so a peer in a reset storm stops eating deadlines from
  every caller;
- **hedged reads** for idempotent domains (``result`` / ``healthz``): when
  a peer exceeds its own p99-derived latency budget, a second identical
  request races the first and the earliest answer wins (``net.hedge``);
- **response integrity**: full-body responses carry an end-to-end
  ``X-Daccord-Body-Bytes`` header and chunked streams a
  ``X-Daccord-Stream-Bytes`` trailer (``serve/http.py`` sends both), so a
  torn body — a proxy that died mid-copy, an injected ``net_torn`` — is
  detected (:class:`TornBody`) and retried instead of committed short.

Injected network faults (the ``net_*`` kinds of ``runtime/faults.py``) are
consulted before every attempt: installed explicitly by tests via
:func:`install_faults` or resolved lazily from ``DACCORD_FAULT``. Injected
errors are real ``OSError`` instances with real errnos (ECONNREFUSED /
ECONNRESET) or a real ``TimeoutError``, so callers' handling of the
injected matrix IS their handling of the real thing. The module is the
standard library's alone: no torch, no CUDA.
"""

from __future__ import annotations

import errno
import http.client
import json
import os
import random
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import deque

#: end-to-end integrity headers (survive proxies that re-frame the body,
#: which Content-Length does not)
BODY_BYTES_HEADER = "X-Daccord-Body-Bytes"
STREAM_BYTES_TRAILER = "X-Daccord-Stream-Bytes"

#: default per-domain deadlines (seconds). ``result``/``stream`` are long
#: because ``result?wait=1`` legitimately blocks while a job solves;
#: ``healthz`` is short because the poll loop's cadence rides on it.
DEADLINES = {"healthz": 5.0, "submit": 30.0, "result": 600.0,
             "stream": 600.0, "abort": 10.0}

#: an injected ``net_hang`` spends min(deadline, this) of real wall-clock
#: before surfacing as the deadline timeout — enough to prove the caller
#: bounded the call, without making a chaos soak wait out a production
#: result deadline
_HANG_SLEEP_CAP_S = 2.0


def deadline_for(domain: str) -> float:
    return DEADLINES.get(domain, 30.0)


# ---------------------------------------------------------------------------
# Injected-network-fault hook — the aio plan-resolution pattern verbatim:
# an explicitly installed plan wins, else DACCORD_FAULT is parsed lazily
# and cached per env-string so counters persist across ops.
# ---------------------------------------------------------------------------

_FAULTS = None                     # explicitly installed plan (wins)
_ENV_FAULTS: tuple = (None, None)  # (env text, parsed plan) lazy cache


class InjectedNetFault(OSError):
    """A ``net_*``-injected transport failure; ``fault_kind`` names the
    spec so tests and event logs match the grammar despite the instance
    wearing a real errno."""

    def __init__(self, err: int, msg: str, fault_kind: str):
        super().__init__(err, msg)
        self.fault_kind = fault_kind


class TornBody(OSError):
    """Response-integrity failure: the body ended short of the byte count
    the peer declared (header or stream trailer). Idempotent callers
    retry; nobody commits a short result."""

    def __init__(self, expected: int, got: int, url: str = ""):
        super().__init__(f"torn body: got {got} of {expected} bytes"
                         + (f" from {url}" if url else ""))
        self.expected = expected
        self.got = got


class BreakerOpen(ConnectionError):
    """The peer's circuit breaker is open: fail fast, spend no deadline."""


def install_faults(plan) -> None:
    """Install (or with None, clear) the FaultPlan whose ``net_*`` kinds
    every request consults — counters and one-shot state live on the plan,
    exactly like ``aio.install_faults``."""
    global _FAULTS, _ENV_FAULTS
    _FAULTS = plan
    _ENV_FAULTS = (None, None)


def _net_plan():
    if _FAULTS is not None:
        return _FAULTS if _FAULTS.has_net_faults() else None
    text = os.environ.get("DACCORD_FAULT")
    global _ENV_FAULTS
    if _ENV_FAULTS[0] != text:
        plan = None
        if text:
            try:
                from ..runtime.faults import FaultPlan
                p = FaultPlan.parse(text)
                plan = p if p.has_net_faults() else None
            except ValueError:
                plan = None  # the CLI entry point already rejected it loudly
        _ENV_FAULTS = (text, plan)
    plan = _ENV_FAULTS[1]
    return plan if plan is not None and plan.has_net_faults() else None


def _prelude(domain: str, timeout: float, log_event=None, peer: str = ""):
    """One HTTP attempt: apply any ``net_slow`` delay, then fire and raise
    refused/reset/hang, or return the byte offset of a fired ``net_torn``
    (None = attempt runs clean)."""
    plan = _net_plan()
    if plan is None:
        return None
    ms = plan.net_slow_ms(domain)
    if ms > 0:
        time.sleep(ms / 1000.0)
    spec = plan.net_check(domain)
    if spec is None:
        return None
    if log_event is not None:
        log_event("net.fault", kind=spec.kind, domain=domain, peer=peer)
    if spec.kind == "net_refused":
        raise InjectedNetFault(errno.ECONNREFUSED,
                               f"injected net_refused@{domain}", spec.kind)
    if spec.kind == "net_reset":
        raise InjectedNetFault(errno.ECONNRESET,
                               f"injected net_reset@{domain}", spec.kind)
    if spec.kind == "net_hang":
        time.sleep(min(timeout, _HANG_SLEEP_CAP_S))
        raise TimeoutError(f"injected net_hang@{domain}: deadline "
                           f"{timeout:.1f}s expired")
    return int(spec.at)  # net_torn: truncate the body here


def _is_transient(exc: BaseException) -> bool:
    """The retry-safe class: the connection was refused (nothing sent) or
    reset (the peer tore the conversation down). Deadline timeouts and
    torn bodies are NOT transient-by-default — retrying them is the
    caller's idempotency decision, made via ``request(idempotent=...)``."""
    if isinstance(exc, InjectedNetFault):
        return exc.fault_kind in ("net_refused", "net_reset")
    if isinstance(exc, (ConnectionRefusedError, ConnectionResetError)):
        return True
    if isinstance(exc, urllib.error.URLError):
        return isinstance(getattr(exc, "reason", None),
                          (ConnectionRefusedError, ConnectionResetError))
    return False


def _is_timeout(exc: BaseException) -> bool:
    if isinstance(exc, (TimeoutError, socket.timeout)):
        return True
    if isinstance(exc, urllib.error.URLError):
        return isinstance(getattr(exc, "reason", None),
                          (TimeoutError, socket.timeout))
    return False


# ---------------------------------------------------------------------------
# one bounded attempt
# ---------------------------------------------------------------------------

def _attempt(url: str, domain: str, method: str, body, headers: dict,
             timeout: float, log_event=None, peer: str = ""):
    """One fault-gated HTTP attempt → (status, body, headers). An
    HTTP-level error status (429/503/404...) is a VALID ANSWER — returned,
    never raised: the peer is alive and talking. Only transport failures
    raise."""
    torn_at = _prelude(domain, timeout, log_event, peer)
    req = urllib.request.Request(url, method=method, data=body,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            data = resp.read()
            status, rhead = resp.status, dict(resp.headers)
    except urllib.error.HTTPError as e:
        data = e.read()
        status, rhead = e.code, dict(e.headers)
    if torn_at is not None:
        data = data[:torn_at]
    declared = rhead.get(BODY_BYTES_HEADER)
    if declared is not None and int(declared) != len(data):
        raise TornBody(int(declared), len(data), url)
    return status, data, rhead


# ---------------------------------------------------------------------------
# module-level request: deadline + faults + integrity, no breaker/hedging
# (the autoscaler's drain call, tests, simple clients)
# ---------------------------------------------------------------------------

def request(url: str, domain: str, method: str = "GET",
            body: bytes | None = None, headers: dict | None = None,
            timeout: float | None = None, retries: int = 0,
            idempotent: bool = True, backoff_s: float = 0.05,
            log_event=None, peer: str = ""):
    """One resilient call → (status, body, headers). ``retries`` bounds
    EXTRA attempts, spent only on the transient class and only when
    ``idempotent`` (a submit without an idempotency key must pass
    ``idempotent=False`` — its reset is ambiguous and stays surfaced)."""
    timeout = deadline_for(domain) if timeout is None else timeout
    attempts = 1 + (retries if idempotent else 0)
    last: BaseException | None = None
    for i in range(attempts):
        try:
            return _attempt(url, domain, method, body, dict(headers or {}),
                            timeout, log_event, peer)
        except (TornBody, OSError, urllib.error.URLError,
                http.client.HTTPException) as e:
            last = e
            retryable = _is_transient(e) or (isinstance(e, TornBody)
                                             and idempotent)
            if not retryable or i + 1 >= attempts:
                raise
            # full jitter: a fleet of callers must not retry in lockstep
            time.sleep(random.uniform(0, backoff_s * (2 ** i)))
    raise last  # pragma: no cover — loop always returns or raises


# ---------------------------------------------------------------------------
# streamed reads with trailer verification
# ---------------------------------------------------------------------------

def stream(url: str, domain: str = "stream", headers: dict | None = None,
           timeout: float | None = None, log_event=None, peer: str = ""):
    """Open a chunked response and return ``(status, headers, chunks)``
    where ``chunks`` is a generator of body byte-chunks. The generator
    parses the chunk framing itself (stdlib clients discard trailers) and
    raises :class:`TornBody` at exhaustion when the peer's
    ``X-Daccord-Stream-Bytes`` trailer disagrees with the bytes received —
    a torn stream is an error, never a silently short result. Non-chunked
    responses degrade to one verified read."""
    timeout = deadline_for(domain) if timeout is None else timeout
    torn_at = _prelude(domain, timeout, log_event, peer)
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    path = u.path + (f"?{u.query}" if u.query else "")
    conn.request("GET", path, headers=dict(headers or {}))
    resp = conn.getresponse()
    rhead = dict(resp.headers)
    chunked = (rhead.get("Transfer-Encoding", "").lower() == "chunked")

    def _gen():
        got = 0
        try:
            if not chunked:
                data = resp.read()
                if torn_at is not None:
                    data = data[:torn_at]
                declared = rhead.get(BODY_BYTES_HEADER)
                if declared is not None and int(declared) != len(data):
                    raise TornBody(int(declared), len(data), url)
                if data:
                    yield data
                return
            # manual chunk framing straight off the socket file: the only
            # way to see the trailer (http.client reads and discards it)
            fp = resp.fp
            while True:
                line = fp.readline(65536)
                if not line:
                    raise TornBody(-1, got, url)  # died before terminator
                size = int(line.split(b";")[0].strip() or b"0", 16)
                if size == 0:
                    break
                data = fp.read(size)
                if len(data) != size:
                    raise TornBody(got + size, got + len(data), url)
                fp.read(2)  # chunk CRLF
                if torn_at is not None and got + len(data) >= torn_at:
                    # injected tear: the proxy died mid-copy — bytes stop
                    # and the terminator/trailer never arrives
                    yield data[:max(0, torn_at - got)]
                    raise TornBody(-1, torn_at, url)
                got += len(data)
                yield data
            declared = None
            while True:  # trailer block: header lines until a blank
                line = fp.readline(65536)
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                if k.strip().lower() == STREAM_BYTES_TRAILER.lower():
                    declared = int(v.strip())
            if declared is not None and declared != got:
                raise TornBody(declared, got, url)
        finally:
            conn.close()

    return resp.status, rhead, _gen()


def json_of(body: bytes):
    """The fleet's JSON-body convention in one place."""
    return json.loads(body.decode() or "{}")


# ---------------------------------------------------------------------------
# circuit breaker (per peer)
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Consecutive-failure breaker: ``fails`` transport failures in a row
    open it; after ``open_s`` it half-opens (ONE trial request passes);
    the trial's outcome closes or re-opens it. State probes are pure —
    only :meth:`allow` / :meth:`ok` / :meth:`fail` transition."""

    def __init__(self, fails: int = 3, open_s: float = 5.0,
                 clock=time.monotonic):
        self.fail_threshold = max(1, int(fails))
        self.open_s = float(open_s)
        self._clock = clock
        self._fails = 0
        self._opened_ts: float | None = None
        self._probing = False
        self._lock = threading.Lock()

    def state(self) -> str:
        with self._lock:
            if self._opened_ts is None:
                return "closed"
            if self._clock() - self._opened_ts >= self.open_s:
                return "half-open"
            return "open"

    def allow(self) -> bool:
        """May a request go out now? Open = no; half-open = yes for ONE
        in-flight probe (concurrent callers keep failing fast until the
        probe resolves)."""
        with self._lock:
            if self._opened_ts is None:
                return True
            if self._clock() - self._opened_ts < self.open_s:
                return False
            if self._probing:
                return False
            self._probing = True
            return True

    def ok(self) -> str | None:
        """Record a success; returns the new state when it transitioned
        (for ``router.breaker`` event logging), else None."""
        with self._lock:
            self._fails = 0
            self._probing = False
            if self._opened_ts is not None:
                self._opened_ts = None
                return "closed"
            return None

    def fail(self) -> str | None:
        with self._lock:
            self._fails += 1
            self._probing = False
            if self._opened_ts is None and \
                    self._fails >= self.fail_threshold:
                self._opened_ts = self._clock()
                return "open"
            if self._opened_ts is not None:
                # a failed half-open probe re-arms the full cooldown
                self._opened_ts = self._clock()
            return None


# ---------------------------------------------------------------------------
# NetClient: breakers + hedging + latency memory, per calling process
# ---------------------------------------------------------------------------

#: domains whose reads are side-effect-free on the peer — safe to hedge
HEDGE_DOMAINS = ("result", "healthz")


class NetClient:
    """The router's (or any long-lived caller's) stateful view of the
    fleet's sockets: one :class:`CircuitBreaker` and a recent-latency
    window per peer. ``log_event(kind, **fields)`` receives ``net.fault``
    / ``net.hedge`` / ``router.breaker`` events."""

    def __init__(self, log_event=None, retries: int = 2,
                 backoff_s: float = 0.05, breaker_fails: int = 3,
                 breaker_open_s: float = 5.0, hedge_floor_s: float = 0.25,
                 hedge_min_samples: int = 8):
        self.log_event = log_event
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.breaker_fails = int(breaker_fails)
        self.breaker_open_s = float(breaker_open_s)
        self.hedge_floor_s = float(hedge_floor_s)
        self.hedge_min_samples = int(hedge_min_samples)
        self._breakers: dict[str, CircuitBreaker] = {}
        self._lat: dict[tuple, deque] = {}
        self._lock = threading.Lock()
        self.counters = {"hedges": 0, "hedge_wins": 0, "breaker_opens": 0}

    # -- state accessors ---------------------------------------------------

    def breaker(self, peer: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(peer)
            if b is None:
                b = self._breakers[peer] = CircuitBreaker(
                    self.breaker_fails, self.breaker_open_s)
            return b

    def breaker_state(self, peer: str) -> str:
        with self._lock:
            b = self._breakers.get(peer)
        return b.state() if b is not None else "closed"

    def _note_latency(self, peer: str, domain: str, dt: float) -> None:
        with self._lock:
            q = self._lat.setdefault((peer, domain), deque(maxlen=64))
            q.append(dt)

    def latency_budget(self, peer: str, domain: str) -> float | None:
        """The hedge trigger: ~p99 of this peer+domain's recent latencies,
        floored so cold stats never hedge-storm. None = not enough
        samples to judge the peer slow."""
        with self._lock:
            q = self._lat.get((peer, domain))
            if q is None or len(q) < self.hedge_min_samples:
                return None
            lat = sorted(q)
        p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
        return max(self.hedge_floor_s, 2.0 * p99)

    def _emit(self, event: str, **fields) -> None:
        # param named ``event``, not ``kind``: net.fault carries a field
        # literally called ``kind`` and must not collide with it
        if self.log_event is not None:
            try:
                self.log_event(event, **fields)
            except Exception:  # noqa: BLE001 — telemetry never breaks I/O
                pass

    def _transition(self, peer: str, state: str | None) -> None:
        if state is None:
            return
        if state == "open":
            self.counters["breaker_opens"] += 1
        self._emit("router.breaker", peer=peer, state=state)

    def record_ok(self, peer: str) -> None:
        """Feed the breaker an out-of-band success (e.g. a streamed proxy
        that this client opened through :func:`stream`, which has no
        breaker loop of its own)."""
        self._transition(peer, self.breaker(peer).ok())

    def record_fail(self, peer: str) -> None:
        """Feed the breaker an out-of-band transport failure."""
        self._transition(peer, self.breaker(peer).fail())

    # -- the resilient request ---------------------------------------------

    def request(self, peer: str, url: str, domain: str,
                method: str = "GET", body: bytes | None = None,
                headers: dict | None = None, timeout: float | None = None,
                idempotent: bool = True):
        """(status, body, headers) with the full discipline: breaker gate,
        bounded transient retries, hedged reads on slow idempotent
        domains, integrity verification. Transport failure raises after
        the retry budget; :class:`BreakerOpen` raises immediately while
        the peer's breaker holds."""
        timeout = deadline_for(domain) if timeout is None else timeout
        br = self.breaker(peer)
        attempts = 1 + (self.retries if idempotent else 0)
        last: BaseException | None = None
        for i in range(attempts):
            if not br.allow():
                raise BreakerOpen(f"breaker open for peer {peer}")
            t0 = time.monotonic()
            try:
                out = self._hedged_attempt(peer, url, domain, method, body,
                                           headers, timeout, idempotent)
            except (TornBody, OSError, urllib.error.URLError,
                    http.client.HTTPException) as e:
                self._transition(peer, br.fail())
                last = e
                retryable = _is_transient(e) or (isinstance(e, TornBody)
                                                 and idempotent)
                if not retryable or i + 1 >= attempts:
                    raise
                time.sleep(random.uniform(0, self.backoff_s * (2 ** i)))
                continue
            self._note_latency(peer, domain, time.monotonic() - t0)
            self._transition(peer, br.ok())
            return out
        raise last  # pragma: no cover

    def _hedged_attempt(self, peer, url, domain, method, body, headers,
                        timeout, idempotent):
        """One attempt, hedged when the domain is read-only and the peer
        has a latency history: if the primary outlives the p99-derived
        budget, a second identical request races it."""
        budget = self.latency_budget(peer, domain) \
            if idempotent and domain in HEDGE_DOMAINS else None
        if budget is None or budget >= timeout:
            return _attempt(url, domain, method, body, dict(headers or {}),
                            timeout, self._emit, peer)

        box: list = []
        done = threading.Event()

        def _run(which: str):
            try:
                r = _attempt(url, domain, method, body, dict(headers or {}),
                             timeout, self._emit, peer)
                box.append(("ok", which, r))
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                box.append(("err", which, e))
            done.set()

        t1 = threading.Thread(target=_run, args=("primary",), daemon=True)
        t1.start()
        if not done.wait(budget):
            self.counters["hedges"] += 1
            self._emit("net.hedge", peer=peer, domain=domain,
                       budget_s=round(budget, 4))
            t2 = threading.Thread(target=_run, args=("hedge",), daemon=True)
            t2.start()
        # first completion wins; a straggler's late append is ignored
        while not box:
            done.wait(timeout)
            if not box:  # both wedged past the deadline
                raise TimeoutError(f"hedged {domain} to {peer}: no answer "
                                   f"within {timeout:.1f}s")
        status, which, payload = box[0]
        if status == "err":
            raise payload
        if which == "hedge":
            self.counters["hedge_wins"] += 1
        return payload
