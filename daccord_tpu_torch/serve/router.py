"""Stateless tenant router: the serve fleet's front door, the port's copy
of the JAX package's ``serve/router.py``.

The thin stateless tier in front of several ``serve`` processes:

- **discovery**: peers are read from the takeover group's shared lease dir
  — every ``serve --peer-dir`` process announces its URL at
  ``<peer_dir>/peers/<service_id>.lease`` (``ConsensusService.announce``)
  and renews it on the job-lease heartbeat, so a dead peer's announce goes
  stale on the same clock as its job leases. A lock-free ``/v1/healthz``
  poll (with the ``X-Daccord-Router`` header that arms the peers'
  evict-vs-route grace) layers liveness + the ``ready`` flag on top:
  ``ready`` tells a warm peer from one still building its groups.
- **stickiness**: rendezvous (highest-random-weight) hashing of tenant →
  peer, SHA-256 of ``tenant|peer`` as in the JAX router, so a JAX router
  and a port router send a tenant to the same peer. Warmth — a group's
  ladder tables, its CUDA graphs, its audit workers — lives per peer;
  rendezvous keeps the map stable under peer arrival and departure with
  no state to lose (a restarted router computes the identical map).
- **spill**: when the owner's admission is paused (shed level > 0), it is
  not ready, its SLO burn band is red (>= ``spill_burn``) or its breaker
  is open, the job spills to the least-loaded ready peer.
- **proxying**: submit/result/stream/abort forward verbatim — including
  the client's ``idempotency_key``, which makes a mid-proxy router or peer
  crash exactly-once: the client retries the SAME key and the fleet
  dedupes (journal-backed), whether the retry lands on the same peer or,
  after a takeover, on its successor. The router's job→peer map is a
  cache rebuilt by fan-out on miss.
- **fleet-wide job ids**: each peer numbers its jobs ``jNNNNN`` from one,
  so two peers hold a ``j00002`` each. The router hands the client the
  peer-qualified id ``<peer>.<job>`` (the form a takeover already gives a
  foreign job) and proxies to the named peer with the peer's own id; a
  qualified id whose peer is gone is probed across the live peers as it
  is (the taker of a journaled job knows it by that key). The JAX router
  keys its map on the bare id, so there a GET can reach the other peer's
  job of the same number (ROADMAP Queue 3).
- **network discipline**: every peer call goes through ``serve/netio.py``
  — per-domain deadlines, bounded transient retries, a per-peer circuit
  breaker (``router.breaker``), hedged healthz/result reads and byte-count
  verification that turns a torn proxied stream into a retryable error.
- **partition asymmetry**: an HTTP-unreachable peer whose announce lease
  is still fresh is *partitioned*, not dead (``router.partition``): its
  tenants spill, its jobs keep their leases, and the autoscaler neither
  reaps nor drains it. Only a stale lease declares a peer gone.

The router's own telemetry (``router.events.jsonl``: ``router.*``,
``scale.*`` from the optional autoscaler and ``net.*`` from the choke
point) passes the port's ``eventcheck --strict``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils import lease
from . import netio
from .service import _LockedLogger

# hop-by-hop headers a proxy must not forward (RFC 9110 §7.6.1)
_HOP_HEADERS = {"connection", "keep-alive", "proxy-authenticate",
                "proxy-authorization", "te", "trailer",
                "transfer-encoding", "upgrade", "host", "content-length"}


class _ClientGone(Exception):
    """The DOWNSTREAM client disconnected mid-proxy — a failure of the
    tenant's connection, not of the peer being proxied to. Kept distinct
    so the error paths never blame (mark_dead / breaker-strike) a healthy
    peer for it."""


@dataclass
class RouterConfig:
    workdir: str = "daccord-router"
    peer_dir: str = ""               # the takeover group's shared lease root
    poll_s: float = 1.0              # healthz poll cadence
    lease_ttl_s: float = 15.0        # announce lease older than this = down
    spill_burn: float = 1.0          # owner burn >= this (red band) → spill
    proxy_timeout_s: float = 600.0   # per proxied request (result?wait=1
                                     # legitimately blocks for minutes)
    healthz_timeout_s: float = 5.0   # per poll — the poll loop's cadence
                                     # rides on this being bounded
    probe_timeout_s: float = 5.0     # per fan-out job probe
    breaker_fails: int = 3           # consecutive failures → breaker opens
    breaker_open_s: float = 5.0      # open cooldown before half-open probe
    net_retries: int = 2             # transient-class retry budget
    events_path: str | None = None   # default <workdir>/router.events.jsonl


@dataclass
class Peer:
    name: str                        # service_id (announce lease basename)
    url: str
    alive: bool = False              # lease fresh + healthz answering
    ready: bool = False              # healthz.ready (warm, replay done)
    partitioned: bool = False        # healthz unreachable, lease FRESH —
                                     # alive-but-unroutable, never reaped
    lease_age: float = -1.0          # announce lease age at last scan
    shed_level: int = 0
    queue_depth: int = 0
    burn: float = 0.0
    jobs_active: int = 0             # queued+running (healthz.jobs)
    last_ok_ts: float = 0.0
    health: dict = field(default_factory=dict)

    def load(self) -> tuple:
        """Least-loaded ordering key for spill targets."""
        return (self.jobs_active + self.queue_depth, self.burn)


class Router:
    """Peer table + routing policy + the proxy core. The HTTP tier
    (:func:`start_router`) is a thin shell over :meth:`proxy` /
    :meth:`route`; everything testable lives here."""

    def __init__(self, cfg: RouterConfig, log=None):
        if not cfg.peer_dir:
            raise ValueError("router needs a peer_dir (the takeover "
                             "group's shared lease root) to discover peers")
        self.cfg = cfg
        os.makedirs(cfg.workdir, exist_ok=True)
        ev = cfg.events_path or os.path.join(cfg.workdir,
                                             "router.events.jsonl")
        self.log = log if log is not None else \
            _LockedLogger(ev, buffer_lines=16, flush_s=1.0)
        self._lock = threading.Lock()
        self.peers: dict[str, Peer] = {}
        self._job_map: dict[str, str] = {}    # job id -> peer name (cache)
        self.counters = {"routes": 0, "spills": 0, "proxied": 0,
                         "proxy_errors": 0, "fanouts": 0}
        self.autoscaler = None                # attached by start_router
        self.net = netio.NetClient(log_event=self._net_event,
                                   retries=cfg.net_retries,
                                   breaker_fails=cfg.breaker_fails,
                                   breaker_open_s=cfg.breaker_open_s)
        self._stop = threading.Event()
        self.started_ts = time.time()
        self.log.log("router.start", workdir=cfg.workdir,
                     peer_dir=cfg.peer_dir, pid=os.getpid())
        self._poller = threading.Thread(target=self._poll_loop, daemon=True,
                                        name="daccord-router-poll")
        self._poller.start()

    # ------------------------------------------------------------------
    # discovery: announce leases + healthz polls
    # ------------------------------------------------------------------

    def _net_event(self, event: str, **fields) -> None:
        """netio's event sink: the choke point's net.fault / net.hedge /
        router.breaker milestones land in the router's own sidecar. The
        positional is named ``event`` on purpose — ``net.fault`` carries a
        FIELD named ``kind``, which would collide with a ``kind`` param."""
        try:
            self.log.log(event, **fields)
        except Exception:  # noqa: BLE001 — telemetry never breaks routing
            pass

    def _scan_announces(self) -> dict[str, tuple]:
        """name -> (url, lease_age_s) from fresh announce leases (stale =
        peer presumed dead; its job leases are going stale on the same
        clock and the takeover path owns recovery — the router only stops
        routing there). The age rides along so an HTTP-unreachable peer
        can be reconciled against the shared-FS ground truth: fresh lease
        + dead healthz = partitioned, not dead."""
        import glob as _glob

        out: dict[str, tuple] = {}
        for path in _glob.glob(os.path.join(self.cfg.peer_dir, "peers",
                                            "*.lease")):
            age = lease.stale_s(path)
            if age is None or age > self.cfg.lease_ttl_s:
                continue
            info = lease.read(path)
            if info and info.get("url"):
                name = os.path.basename(path).rsplit(".lease", 1)[0]
                out[name] = (str(info["url"]), float(age))
        return out

    def _poll_one(self, peer: Peer) -> None:
        """One lock-free healthz poll through the choke point — bounded by
        the healthz deadline (a hung peer socket costs one deadline, never
        a stalled poll loop), breaker-gated, hedged once the peer has a
        latency history. The X-Daccord-Router header arms the peer's
        evict-vs-route grace window."""
        try:
            status, body, _h = self.net.request(
                peer.name, peer.url + "/v1/healthz", "healthz",
                headers={"X-Daccord-Router": "1"},
                timeout=self.cfg.healthz_timeout_s)
            if status != 200:
                raise OSError(f"healthz status {status}")
            h = json.loads(body)
        except Exception:
            peer.alive = False
            peer.ready = False
            return
        peer.alive = bool(h.get("ok"))
        peer.ready = bool(h.get("ready"))
        peer.shed_level = int(h.get("shed_level", 0) or 0)
        peer.queue_depth = int(h.get("queue_depth", 0) or 0)
        peer.burn = float(h.get("burn", 0.0) or 0.0)
        jobs = h.get("jobs") or {}
        peer.jobs_active = int(jobs.get("queued", 0)) + \
            int(jobs.get("running", 0))
        peer.last_ok_ts = time.time()
        peer.health = h

    def refresh(self) -> None:
        """One discovery+poll sweep (the poll loop's body; tests call it
        directly for determinism)."""
        announced = self._scan_announces()
        with self._lock:
            known = dict(self.peers)
        for name, (url, age) in announced.items():
            p = known.get(name)
            if p is None:
                p = Peer(name=name, url=url)
                with self._lock:
                    self.peers[name] = p
            p.url = url
            p.lease_age = age
        for name, p in list(known.items()):
            if name not in announced:
                # stale/released announce: the peer is gone — the shared-FS
                # ground truth, strictly stronger than an HTTP verdict
                if p.alive or p.partitioned:
                    self.log.log("router.peer_down", peer=name,
                                 reason="lease_stale")
                with self._lock:
                    self.peers.pop(name, None)
        with self._lock:
            peers = list(self.peers.values())
        for p in peers:
            was = p.alive
            self._poll_one(p)
            if p.alive and not was:
                self.log.log("router.peer_up", peer=p.name, url=p.url,
                             ready=p.ready)
            elif was and not p.alive:
                self.log.log("router.peer_down", peer=p.name,
                             reason="healthz")
            # partition reconciliation: healthz says dead, the announce
            # lease says the peer's heart is beating. Believe the lease —
            # the peer is cut off from US, not from the world: its tenants
            # spill (it is unroutable) but its jobs keep their fresh
            # leases (takeover must not fire) and the autoscaler must not
            # reap or drain it (tick() checks this flag).
            part = not p.alive and p.name in announced
            if part and not p.partitioned:
                self.log.log("router.partition", peer=p.name, state="begin",
                             lease_age_s=round(p.lease_age, 3))
            elif p.partitioned and not part:
                self.log.log("router.partition", peer=p.name, state="end",
                             lease_age_s=round(p.lease_age, 3))
            p.partitioned = part

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.cfg.poll_s):
            try:
                self.refresh()
                if self.autoscaler is not None:
                    self.autoscaler.tick(self.snapshot_peers())
            except Exception as e:  # noqa: BLE001 — the poller must survive
                try:
                    self.log.log("router.proxy_error", peer="-",
                                 error=f"poll:{type(e).__name__}"[:200])
                except Exception:
                    pass

    def snapshot_peers(self) -> list[Peer]:
        with self._lock:
            return list(self.peers.values())

    # ------------------------------------------------------------------
    # routing policy
    # ------------------------------------------------------------------

    @staticmethod
    def _score(tenant: str, peer_name: str) -> int:
        """Rendezvous weight: every router instance (and every restart)
        ranks peers identically from the hash alone — the stateless
        stickiness that keeps a tenant on the peer whose groups are warm."""
        h = hashlib.sha256(f"{tenant}|{peer_name}".encode()).digest()
        return int.from_bytes(h[:8], "big")

    def owner_of(self, tenant: str, peers: list[Peer] | None = None) -> Peer | None:
        """The rendezvous owner among ALIVE peers. Readiness deliberately
        does NOT move ownership (the map must stay stable while a peer is
        briefly mid-compile) — :meth:`route` spills off a not-ready owner
        instead, and comes back when it warms."""
        peers = self.snapshot_peers() if peers is None else peers
        pool = [p for p in peers if p.alive]
        if not pool:
            return None
        return max(pool, key=lambda p: self._score(tenant, p.name))

    def route(self, tenant: str, job: str | None = None) -> Peer | None:
        """The peer ``tenant``'s next job should land on: the rendezvous
        owner unless its admission is pausing (shed), it lost readiness, or
        its burn band is red — then the least-loaded OTHER ready peer
        (spill). Returns None when the fleet is empty/unreachable."""
        peers = self.snapshot_peers()
        owner = self.owner_of(tenant, peers)
        if owner is None:
            return None
        chosen, spilled, reason = owner, False, None
        if not owner.ready:
            reason = "not_ready"
        elif owner.shed_level > 0:
            reason = "shed"
        elif self.cfg.spill_burn and owner.burn >= self.cfg.spill_burn:
            reason = "burn"
        elif self.net.breaker_state(owner.name) == "open":
            # the owner's sockets are in a failure storm: spill past it
            # while the breaker cools (half-open probes re-admit it)
            reason = "breaker"
        if reason is not None:
            others = [p for p in peers if p.ready and p.name != owner.name]
            if others:
                chosen = min(others, key=Peer.load)
                spilled = True
            # nobody to spill to: the owner (alive, maybe shedding) still
            # beats a refusal — its admission plane is the backstop
        self.counters["routes"] += 1
        if spilled:
            self.counters["spills"] += 1
            self.log.log("router.spill", tenant=tenant, owner=owner.name,
                         to=chosen.name, reason=reason)
        self.log.log("router.route", tenant=tenant, peer=chosen.name,
                     spilled=spilled, **({"job": job} if job else {}))
        return chosen

    # ------------------------------------------------------------------
    # proxy core
    # ------------------------------------------------------------------

    def mark_dead(self, peer: Peer, reason: str = "proxy_error") -> None:
        """A proxy just failed against ``peer``: stop routing there NOW
        (the next healthz poll re-checks). Logging the transition here —
        not in the poll loop — keeps ``router.peer_down`` exact when the
        proxy error is what discovered the death."""
        if peer.alive:
            self.log.log("router.peer_down", peer=peer.name, reason=reason)
        peer.alive = False
        peer.ready = False

    def note_job(self, job_id: str, peer_name: str) -> None:
        with self._lock:
            self._job_map[job_id] = peer_name

    @staticmethod
    def qualify(peer_name: str, job_id: str) -> str:
        """The fleet-wide id of a peer's job: ``<peer>.<job>``; an id that is
        qualified already (a taken-over job's) stays as it is."""
        return job_id if "." in job_id else f"{peer_name}.{job_id}"

    def local_id(self, peer: Peer, job_id: str) -> str:
        """The id ``peer`` knows the job by: the bare id when ``job_id`` is
        qualified by that peer's own name, else ``job_id`` as it is."""
        head, sep, tail = job_id.partition(".")
        return tail if sep and head == peer.name else job_id

    def peer_for_job(self, job_id: str) -> Peer | None:
        """The peer owning ``job_id``: the cached mapping when fresh, then
        the live peer the qualified id names, else a fan-out probe of every
        live peer (the cache is just a cache — a restarted router, or a job
        that moved by takeover, rebuilds it)."""
        with self._lock:
            name = self._job_map.get(job_id)
            p = self.peers.get(name) if name else None
            if p is None and "." in job_id:
                p = self.peers.get(job_id.partition(".")[0])
        if p is not None and p.alive:
            return p
        self.counters["fanouts"] += 1
        for p in self.snapshot_peers():
            if not p.alive:
                continue
            try:
                status, _b, _h = self.net.request(
                    p.name, p.url + f"/v1/jobs/{self.local_id(p, job_id)}", "result",
                    timeout=self.cfg.probe_timeout_s)
            except Exception:
                continue
            if status == 200:
                self.note_job(job_id, p.name)
                return p
        return None

    @staticmethod
    def _domain_for(method: str, path: str) -> str:
        """RPC class of a proxied request — the netio deadline/fault key."""
        p = path.split("?")[0]
        if method == "DELETE" or p.endswith("/shutdown"):
            return "abort"
        if method == "POST":
            return "submit"
        if p.endswith("/stream"):
            return "stream"
        return "result"

    def proxy(self, peer: Peer, method: str, path: str,
              body: bytes | None = None, headers: dict | None = None,
              idempotent: bool | None = None) -> tuple[int, bytes, str]:
        """Forward one request through the choke point; returns (status,
        body, content_type). An HTTP-level refusal (429/503/404...) is a
        valid answer and forwards verbatim; transport failure raises (the
        caller maps that to 502 + retryable, and the client's idempotency
        key makes the retry exactly-once). ``idempotent`` gates the
        transient-retry budget: a submit is only retry-safe when the
        client sent an idempotency key — everything else (GET status,
        result, DELETE abort) is safe by construction."""
        domain = self._domain_for(method, path)
        if idempotent is None:
            idempotent = domain != "submit"
        status, data, rhead = self.net.request(
            peer.name, peer.url + path, domain, method=method, body=body,
            headers={k: v for k, v in (headers or {}).items()
                     if k.lower() not in _HOP_HEADERS},
            timeout=min(self.cfg.proxy_timeout_s,
                        netio.deadline_for(domain)),
            idempotent=idempotent)
        self.counters["proxied"] += 1
        return (status, data,
                rhead.get("Content-Type", "application/json"))

    def stats(self) -> dict:
        peers = self.snapshot_peers()
        with self._lock:
            jmap = dict(self._job_map)
        out = {"ok": True, "ready": any(p.ready for p in peers),
               "uptime_s": round(time.time() - self.started_ts, 3),
               "peers": [{"name": p.name, "url": p.url, "alive": p.alive,
                          "ready": p.ready, "shed": p.shed_level,
                          "queue_depth": p.queue_depth, "burn": p.burn,
                          "jobs_active": p.jobs_active,
                          "partitioned": p.partitioned,
                          "lease_age_s": round(p.lease_age, 3),
                          "breaker": self.net.breaker_state(p.name)}
                         for p in sorted(peers, key=lambda p: p.name)],
               "jobs": jmap, **self.counters}
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.stats()
        return out

    def shutdown(self) -> None:
        self._stop.set()
        self._poller.join(timeout=5.0)
        if self.autoscaler is not None:
            self.autoscaler.shutdown()
        self.log.log("router.done",
                     wall_s=round(time.time() - self.started_ts, 3),
                     **self.counters)
        self.log.close()


class RouterHandler(BaseHTTPRequestHandler):
    """The proxy shell: tenant-routed submits, job-mapped result/stream/
    abort forwards, the router's own healthz/stats. HTTP/1.1 with explicit
    Content-Length (keep-alive safe), like the serve handler it fronts."""

    protocol_version = "HTTP/1.1"
    server_version = "daccord-router/0.1"

    @property
    def rt(self) -> Router:
        return self.server.router  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # noqa: A002
        pass

    def _send(self, code: int, obj=None, body: bytes | None = None,
              ctype: str = "application/json") -> None:
        if body is None:
            body = (json.dumps(obj) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        # end-to-end integrity: recomputed here (not forwarded) because
        # the router re-frames the body it proxies
        self.send_header(netio.BODY_BYTES_HEADER, str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0) or 0)
        return self.rfile.read(n) if n > 0 else b""

    def _peer_fail(self, peer, e: BaseException):
        """Transport failure talking to the PEER: a retryable 502, plus
        the peer-table verdict. An open breaker is NOT evidence of death
        (the breaker is the evidence-gatherer; healthz decides), so only
        genuine transport failures de-route the peer."""
        self.rt.counters["proxy_errors"] += 1
        self.rt.log.log("router.proxy_error", peer=peer.name,
                        error=f"{type(e).__name__}: {e}"[:200])
        if not isinstance(e, netio.BreakerOpen):
            self.rt.mark_dead(peer)
        return self._send(502, {"error": f"peer {peer.name} unreachable",
                                "peer": peer.name, "retryable": True})

    def _forward(self, peer, method: str, body: bytes | None = None,
                 job_id: str | None = None):
        """Proxy + map transport failure to a retryable 502 (the client's
        idempotency key carries exactly-once across the retry). A job's
        request goes to the peer under the peer's own id, and the answer's
        ``job`` field comes back qualified."""
        path = self._peer_path(peer, job_id)
        try:
            code, data, ctype = self.rt.proxy(peer, method, path, body,
                                              dict(self.headers))
        except Exception as e:
            return self._peer_fail(peer, e)
        return self._send(code, body=self._qualified(peer, data, ctype), ctype=ctype)

    def _peer_path(self, peer, job_id: str | None) -> str:
        if job_id is None:
            return self.path
        local = self.rt.local_id(peer, job_id)
        return self.path.replace(f"/v1/jobs/{job_id}", f"/v1/jobs/{local}", 1)

    def _qualified(self, peer, data: bytes, ctype: str) -> bytes:
        """A JSON answer whose ``job`` is the peer's own id, re-encoded with
        the fleet-wide id (``Router.qualify``); anything else as it is."""
        if not ctype.startswith("application/json"):
            return data
        try:
            obj = json.loads(data)
        except (ValueError, UnicodeDecodeError):
            return data
        if not isinstance(obj, dict) or not isinstance(obj.get("job"), str):
            return data
        obj["job"] = self.rt.qualify(peer.name, obj["job"])
        return (json.dumps(obj) + "\n").encode()

    def _job_route(self):
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        if len(parts) >= 3 and parts[0] == "v1" and parts[1] == "jobs":
            return parts[2], (parts[3] if len(parts) > 3 else None)
        return None, None

    def do_POST(self) -> None:  # noqa: N802
        path = self.path.split("?")[0]
        if path == "/v1/jobs":
            raw = self._read_body()
            try:
                body = json.loads(raw) if raw else {}
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, json.JSONDecodeError) as e:
                return self._send(400, {"error": f"bad body: {e}"})
            tenant = str(body.get("tenant", "default"))
            peer = self.rt.route(tenant)
            if peer is None:
                return self._send(503, {"error": "no ready peers",
                                        "retryable": True})
            try:
                # a keyed submit is retry-safe (the fleet dedupes on the
                # journal-backed key); a bare one must surface its reset
                code, data, ctype = self.rt.proxy(
                    peer, "POST", self.path, raw, dict(self.headers),
                    idempotent=bool(body.get("idempotency_key")))
            except Exception as e:
                return self._peer_fail(peer, e)
            data = self._qualified(peer, data, ctype)
            if code in (200, 201):
                try:
                    jid = json.loads(data).get("job")
                    if jid:
                        self.rt.note_job(str(jid), peer.name)
                except (ValueError, json.JSONDecodeError):
                    pass
            return self._send(code, body=data, ctype=ctype)
        if path == "/v1/shutdown":
            threading.Thread(target=self._shutdown_later,
                             daemon=True).start()
            return self._send(200, {"state": "draining"})
        self._send(404, {"error": "unknown route"})

    def _shutdown_later(self) -> None:
        self.rt.shutdown()
        self.server.shutdown()  # type: ignore[attr-defined]

    def do_GET(self) -> None:  # noqa: N802
        path = self.path.split("?")[0]
        if path == "/v1/healthz" or path == "/v1/router":
            # the router's own state (daccord-top's ROUTER panel): peer
            # table + ownership cache + spill/scale counters
            return self._send(200, self.rt.stats())
        job_id, sub = self._job_route()
        if job_id is None:
            return self._send(404, {"error": "unknown route"})
        peer = self.rt.peer_for_job(job_id)
        if peer is None:
            return self._send(404, {"error": f"unknown job {job_id!r}"})
        if sub == "stream":
            return self._proxy_stream(peer, job_id)
        return self._forward(peer, "GET", job_id=job_id)

    def do_DELETE(self) -> None:  # noqa: N802
        job_id, _sub = self._job_route()
        if job_id is None:
            return self._send(404, {"error": "unknown route"})
        peer = self.rt.peer_for_job(job_id)
        if peer is None:
            return self._send(404, {"error": f"unknown job {job_id!r}"})
        return self._forward(peer, "DELETE", job_id=job_id)

    def _proxy_stream(self, peer, job_id: str) -> None:
        """Chunked passthrough of a live FASTA stream, byte-verified. The
        peer's ``X-Daccord-Stream-Bytes`` trailer is checked by the netio
        reader: a torn upstream (peer died mid-copy, injected ``net_torn``)
        means the terminal chunk is NEVER sent to the client — the client
        sees a torn stream and re-fetches, instead of committing a short
        result. A CLIENT disconnect mid-proxy is classified separately
        (``router.client_gone``): the peer is healthy and keeps its
        routability — a tenant's flaky connection must not de-ready a
        peer for everyone else."""
        try:
            status, rhead, chunks = netio.stream(
                peer.url + self._peer_path(peer, job_id), "stream",
                timeout=self.rt.cfg.proxy_timeout_s,
                log_event=self.rt._net_event, peer=peer.name)
        except Exception as e:
            self.rt.net.record_fail(peer.name)
            return self._peer_fail(peer, e)
        self.send_response(status)
        self.send_header("Content-Type",
                         rhead.get("Content-Type", "text/x-fasta"))
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Trailer", netio.STREAM_BYTES_TRAILER)
        self.end_headers()
        sent = 0
        client_gone = False
        try:
            for data in chunks:
                try:
                    self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
                except (BrokenPipeError, ConnectionResetError) as e:
                    client_gone = True
                    raise _ClientGone() from e
                sent += len(data)
            # clean end: terminal chunk + end-to-end byte-count trailer,
            # so the CLIENT can verify the full proxied path too
            self.wfile.write(b"0\r\n" + netio.STREAM_BYTES_TRAILER.encode()
                             + b": %d\r\n\r\n" % sent)
            self.rt.net.record_ok(peer.name)
        except _ClientGone:
            # the CLIENT hung up mid-proxy: log it as such and leave the
            # peer's verdict alone — no mark_dead, no breaker strike
            self.rt.log.log("router.client_gone", peer=peer.name,
                            path=self.path.split("?")[0], bytes=sent)
            self.close_connection = True
        except Exception as e:  # noqa: BLE001 — peer-side tear
            self.rt.counters["proxy_errors"] += 1
            self.rt.net.record_fail(peer.name)
            self.rt.log.log("router.proxy_error", peer=peer.name,
                            error=f"{type(e).__name__}: {e}"[:200])
            if not client_gone:
                self.rt.mark_dead(peer, reason="torn_stream")
            # no terminal chunk was written: the client sees a torn
            # stream, never a silently short result
            self.close_connection = True


def start_router(router: Router, host: str = "127.0.0.1", port: int = 0):
    """Bind + start the router front-end on a daemon thread; returns
    ``(httpd, bound_port, thread)`` — the serve tier's start_server shape."""
    httpd = ThreadingHTTPServer((host, port), RouterHandler)
    httpd.daemon_threads = True
    httpd.router = router  # type: ignore[attr-defined]
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="daccord-router-http")
    t.start()
    return httpd, httpd.server_address[1], t
