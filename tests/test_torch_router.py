"""The port's front door (``serve/router.py``, ``serve/autoscale.py``) and
its kernel cache (``serve/aotcache.py``) on the CPU, against the JAX
package's router and autoscaler.

- Ownership: the port's ``Router.owner_of`` equals the JAX one over a grid
  of tenants and peer sets (the same SHA-256 rendezvous, so a JAX router
  and a port router send a tenant to the same peer); spill, discovery and
  the warm state's evict-vs-route guard as in ``tests/test_router.py``.
- The autoscaler on the JAX test's bursty fake-clock trace, and the
  partition cases of ``tests/test_netfaults.py``, give the JAX
  ``Autoscaler``'s sequence of spawns, drains and reaps, event for event.
- The cache's reject taxonomy, its round trip into fresh processes with
  empty build directories (g++-built stand-ins for the nvcc libraries), a
  flipped entry rejected, rebuilt and healed, and the size-capped sweep.
- End to end: two in-process port peers on the native engine behind the
  router, every job byte-identical to the JAX package's solo native run;
  and two ``serve`` processes, the owner SIGKILLed mid-job, the retried
  submit landing exactly once on the survivor with the same bytes.
"""

import hashlib
import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import daccord_tpu.serve.autoscale as jax_asc
import daccord_tpu_torch.serve.autoscale as asc
from daccord_tpu.runtime.faults import FaultPlan as JaxFaultPlan
from daccord_tpu.serve import netio as jax_netio
from daccord_tpu.serve.router import Peer as JaxPeer
from daccord_tpu.serve.router import Router as JaxRouter
from daccord_tpu.sim import SimConfig, make_dataset
from daccord_tpu_torch.runtime.faults import FaultPlan
from daccord_tpu_torch.serve import netio
from daccord_tpu_torch.serve.router import Peer, Router, RouterConfig, start_router

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DACCORD_FAULT", raising=False)
    yield
    netio.install_faults(None)
    jax_netio.install_faults(None)


class _CapLog:
    def __init__(self):
        self.events = []

    def log(self, event, **kw):
        self.events.append((event, kw))

    def __getitem__(self, name):
        return [kw for ev, kw in self.events if ev == name]

    def close(self):
        pass


def _lint(paths):
    from daccord_tpu_torch.tools.eventcheck import validate_events

    for p in paths:
        errs = validate_events(p, strict=True)
        assert not errs, (p, errs[:5])


def _mk_peer(name, cls=Peer, **kw):
    kw.setdefault("alive", True)
    kw.setdefault("ready", True)
    return cls(name=name, url=kw.pop("url", f"http://127.0.0.1:1/{name}"), **kw)


def _mk_router(tmp_path, **kw):
    """A router with its poll thread parked (tests drive refresh/route)."""
    kw.setdefault("poll_s", 3600.0)
    kw.setdefault("peer_dir", str(tmp_path / "fleet"))
    kw.setdefault("workdir", str(tmp_path / "router"))
    os.makedirs(kw["peer_dir"], exist_ok=True)
    return Router(RouterConfig(**kw))


def _events(rt):
    rt.log.flush()
    with open(os.path.join(rt.cfg.workdir, "router.events.jsonl")) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


# ---------------------------------------------------------------------------
# routing policy
# ---------------------------------------------------------------------------

def test_owner_of_equals_the_jax_router_over_a_grid(tmp_path):
    """Every tenant of a grid, over every subset of up to five peers (and
    with dead peers): the port's owner is the JAX router's, and the map is
    stable when a non-owner leaves."""
    from daccord_tpu.serve.router import RouterConfig as JaxRouterConfig

    rt = _mk_router(tmp_path)
    jrt = JaxRouter(JaxRouterConfig(workdir=str(tmp_path / "jaxrouter"),
                                    peer_dir=str(tmp_path / "fleet"), poll_s=3600.0))
    try:
        names = ["peer-a", "peer-b", "serve-0", "serve-1", "autopeer3"]
        tenants = [f"tenant{i}" for i in range(60)] + ["a", "b", "", "t|x"]
        import itertools

        for k in range(1, len(names) + 1):
            for sub in itertools.combinations(names, k):
                for dead in (None, sub[0]):
                    ports = [_mk_peer(n, alive=n != dead) for n in sub]
                    jaxs = [_mk_peer(n, JaxPeer, alive=n != dead) for n in sub]
                    for t in tenants:
                        mine, ref = rt.owner_of(t, ports), jrt.owner_of(t, jaxs)
                        assert (mine and mine.name) == (ref and ref.name), (t, sub, dead)
        for t in tenants:
            assert Router._score(t, "p") == JaxRouter._score(t, "p")
        peers = [_mk_peer(n) for n in names[:4]]
        owners = {t: rt.owner_of(t, peers).name for t in tenants}
        assert set(owners.values()) == set(names[:4])
        for t in tenants:
            for drop in names[:4]:
                if drop != owners[t]:
                    rest = [p for p in peers if p.name != drop]
                    assert rt.owner_of(t, rest).name == owners[t]
        peers[0].ready = False        # readiness does not move ownership
        assert {t: rt.owner_of(t, peers).name for t in tenants} == owners
    finally:
        rt.shutdown()
        jrt.shutdown()
    _lint([os.path.join(str(tmp_path / "router"), "router.events.jsonl")])


def test_route_spills_on_shed_notready_burn_and_breaker(tmp_path):
    rt = _mk_router(tmp_path, spill_burn=1.0)
    try:
        a, b, c = _mk_peer("pa"), _mk_peer("pb"), _mk_peer("pc")
        rt.peers = {"pa": a, "pb": b, "pc": c}
        tenant = next(t for t in (f"t{i}" for i in range(1000))
                      if rt.owner_of(t).name == "pa")
        assert rt.route(tenant).name == "pa"
        a.shed_level = 1
        b.jobs_active, c.jobs_active = 5, 1
        assert rt.route(tenant).name == "pc"
        b.jobs_active = c.jobs_active = 2
        b.burn, c.burn = 0.1, 0.9
        assert rt.route(tenant).name == "pb"
        a.shed_level = 0
        a.ready = False
        assert rt.route(tenant).name in ("pb", "pc")
        a.ready = True
        a.burn = 2.0
        assert rt.route(tenant).name != "pa"
        a.burn = 0.5
        assert rt.route(tenant).name == "pa"
        for _ in range(rt.cfg.breaker_fails):
            rt.net.record_fail("pa")
        assert rt.route(tenant).name != "pa"
        rt.net.record_ok("pa")
        a.shed_level = 2
        rt.peers = {"pa": a}
        assert rt.route(tenant).name == "pa"
        rt.peers = {}
        assert rt.route(tenant) is None
        spills = [e for e in _events(rt) if e["event"] == "router.spill"]
        assert {s["reason"] for s in spills} == {"shed", "not_ready", "burn", "breaker"}
        assert all(s["owner"] == "pa" for s in spills)
        assert rt.counters["spills"] == len(spills)
    finally:
        rt.shutdown()
    _lint([os.path.join(str(tmp_path / "router"), "router.events.jsonl")])


class _FakeHealthz(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802
        self.server.router_headers.append(self.headers.get("X-Daccord-Router"))
        body = json.dumps(self.server.payload).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # noqa: A002
        pass


def _healthz_server(payload):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _FakeHealthz)
    httpd.daemon_threads = True
    httpd.payload = payload
    httpd.router_headers = []
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def test_discovery_announce_up_down_and_partition_cycle(tmp_path):
    """Announce leases and healthz polls: up with the peer's load, down on a
    dead healthz (still discovered), a hung healthz one bounded deadline
    that reconciles a fresh-leased peer to partitioned and back, and a stale
    announce removing the peer."""
    from daccord_tpu_torch.utils import lease

    httpd, url = _healthz_server({"ok": True, "ready": True, "shed_level": 1,
                                  "queue_depth": 3, "burn": 0.25,
                                  "jobs": {"queued": 2, "running": 1}})
    rt = _mk_router(tmp_path, lease_ttl_s=60.0, healthz_timeout_s=0.3)
    lp = os.path.join(rt.cfg.peer_dir, "peers", "peer-x.lease")
    os.makedirs(os.path.dirname(lp), exist_ok=True)
    lease.claim(lp, "peer-x@test", 60.0, extra={"url": url, "service": "peer-x"})
    try:
        rt.refresh()
        p = rt.peers["peer-x"]
        assert p.alive and p.ready and p.shed_level == 1
        assert p.queue_depth == 3 and p.burn == 0.25 and p.jobs_active == 3
        assert httpd.router_headers and httpd.router_headers[0] == "1"

        netio.install_faults(FaultPlan.parse("net_hang:1@healthz"))
        t0 = time.monotonic()
        rt.refresh()
        assert time.monotonic() - t0 < 2.5
        assert not p.alive and p.partitioned and p.lease_age >= 0.0
        netio.install_faults(None)
        rt.refresh()
        assert p.alive and not p.partitioned

        httpd.shutdown()
        rt.refresh()
        assert "peer-x" in rt.peers and not rt.peers["peer-x"].alive
        assert rt.owner_of("anyone") is None
        lease.backdate(lp, 120.0)
        rt.refresh()
        assert "peer-x" not in rt.peers
        evs = _events(rt)
        ups = [e for e in evs if e["event"] == "router.peer_up"]
        downs = [e for e in evs if e["event"] == "router.peer_down"]
        assert ups and ups[0]["peer"] == "peer-x" and ups[0]["ready"]
        assert [e["reason"] for e in downs] == ["healthz", "healthz", "lease_stale"]
        parts = [e["state"] for e in evs if e["event"] == "router.partition"]
        assert parts[:2] == ["begin", "end"]
    finally:
        rt.shutdown()
        httpd.server_close()
    _lint([os.path.join(str(tmp_path / "router"), "router.events.jsonl")])


class _FakeGroup:
    def __init__(self, name):
        self.name = name
        self.refs = 0
        self.last_used = 0.0
        self.closed = False

    def close(self):
        self.closed = True

    def stats(self):
        return {"name": self.name}


def test_warmstate_defers_eviction_for_routed_key():
    from daccord_tpu_torch.serve.state import WarmState

    log = _CapLog()
    ws = WarmState(idle_evict_s=10.0, log=log, route_grace_s=30.0)
    g = ws.acquire("k1", lambda: _FakeGroup("g1"))
    ws.release("k1")
    idle_at = g.last_used + 11.0
    ws.note_router_heartbeat(now=idle_at - 1.0)
    ws.note_route("k1", now=idle_at - 5.0)
    assert ws.evict_idle(now=idle_at) == 0
    assert not g.closed and ws.counters["evict_deferred"] == 1
    defer = log["serve.evict_defer"]
    assert defer and defer[0]["group"] == "g1" and defer[0]["routed_s"] == pytest.approx(5.0)
    late = idle_at + 40.0
    ws.note_router_heartbeat(now=late - 1.0)
    assert ws.evict_idle(now=late) == 1 and g.closed
    assert ws.counters["evicted"] == 1


def test_warmstate_evicts_when_no_router_or_no_route():
    from daccord_tpu_torch.serve.state import WarmState

    ws = WarmState(idle_evict_s=10.0, route_grace_s=30.0)
    g1 = ws.acquire("k1", lambda: _FakeGroup("g1"))
    ws.release("k1")
    assert ws.evict_idle(now=g1.last_used + 11.0) == 1 and g1.closed
    g2 = ws.acquire("k2", lambda: _FakeGroup("g2"))
    ws.release("k2")
    idle_at = g2.last_used + 11.0
    ws.note_router_heartbeat(now=idle_at - 60.0)
    ws.note_route("k2", now=idle_at - 1.0)
    assert ws.evict_idle(now=idle_at) == 1 and g2.closed
    g3 = ws.acquire("k3", lambda: _FakeGroup("g3"))
    ws.release("k3")
    idle_at = g3.last_used + 11.0
    ws.note_router_heartbeat(now=idle_at - 1.0)
    assert ws.evict_idle(now=idle_at) == 1 and g3.closed
    assert ws.counters["evict_deferred"] == 0


# ---------------------------------------------------------------------------
# the autoscaler against the JAX one (fake clock, fake processes)
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def time(self):
        return self.t


class _FakeProc:
    def __init__(self, cmd=None):
        self.pid = 50000
        self.cmd = cmd
        self.rc = None

    def poll(self):
        return self.rc

    def terminate(self):
        self.rc = -signal.SIGTERM

    def kill(self):
        self.rc = -signal.SIGKILL

    def wait(self, timeout=None):
        if self.rc is None:
            raise subprocess.TimeoutExpired("fake", timeout)
        return self.rc


def _scalers(tmp_path, monkeypatch, **kw):
    """A JAX and a port autoscaler on one fake clock and fake Popen; yields
    (clock, [(name, scaler, log, procs, Peer class)])."""
    clock = _Clock(1000.0)
    out = []
    for name, mod, peer_cls in (("jax", jax_asc, JaxPeer), ("port", asc, Peer)):
        procs = []

        class _FakeSub:
            TimeoutExpired = subprocess.TimeoutExpired
            STDOUT = subprocess.STDOUT

            @staticmethod
            def Popen(cmd, env=None, stdout=None, stderr=None, _procs=procs):
                if stdout is not None:
                    stdout.close()
                p = _FakeProc(cmd)
                _procs.append((p, env))
                return p

        monkeypatch.setattr(mod, "subprocess", _FakeSub)
        monkeypatch.setattr(mod, "time", clock)
        log = _CapLog()
        cfg = dict(peer_dir=str(tmp_path / name / "fleet"),
                   root=str(tmp_path / name / "autopeers"), **kw)
        out.append((name, mod.Autoscaler(mod.AutoscaleConfig(**cfg), log), log,
                    procs, peer_cls))
    return clock, out


def _norm(log):
    """The event sequence with the per-package paths and pids dropped."""
    return [(e, {k: v for k, v in kw.items() if k not in ("workdir", "pid")})
            for e, kw in log.events]


def test_autoscaler_bursty_trace_equals_the_jax_autoscaler(tmp_path, monkeypatch):
    """The JAX test's bursty trace: spike, sustained burn, spawn, cooldown,
    the spawn-storm cap, idle clock, activity reset, drain, reap. The port
    autoscaler makes the JAX one's decisions, event for event; its peers are
    the port's serve, on the card unless told otherwise."""
    clock, pair = _scalers(tmp_path, monkeypatch, max_peers=2, min_peers=1,
                           spawn_burn=1.0, sustain_s=2.0, cooldown_s=5.0,
                           idle_ttl_s=4.0, slo_p99_s=0.25,
                           spawn_env={"JAX_PLATFORMS": "cpu"})
    trace = [(1000.0, [("p0", {"burn": 3.0})]), (1001.0, [("p0", {"burn": 3.0})]),
             (1002.5, [("p0", {"burn": 3.0})]), (1003.0, [("p0", {"burn": 3.0})]),
             (1009.0, [("p0", {"burn": 3.0})]),
             (1010.0, [("p0", {"burn": 0.0}), ("autopeer1", {})]),
             (1012.0, [("p0", {}), ("autopeer1", {"jobs_active": 1})]),
             (1013.0, [("p0", {"burn": 0.0}), ("autopeer1", {})]),
             (1016.0, [("p0", {"burn": 0.0}), ("autopeer1", {})]),
             (1017.5, [("p0", {"burn": 0.0}), ("autopeer1", {})]),
             ("exit", None), (1018.0, [("p0", {})])]
    seqs = {}
    for name, sc, log, procs, peer_cls in pair:
        for t, peers in trace:
            if t == "exit":
                procs[0][0].rc = 0
                continue
            clock.t = t
            sc.tick([_mk_peer(n, peer_cls, **kw) for n, kw in peers])
        seqs[name] = (_norm(log), dict(sc.counters), sc.stats()["spawned"])
        sc.shutdown()
    assert seqs["port"] == seqs["jax"]
    evs, counters, spawned = seqs["port"]
    assert counters == {"spawns": 1, "drains": 1, "reaps": 1} and spawned == []
    assert [e for e, _ in evs] == ["scale.burn", "scale.spawn", "scale.burn",
                                   "scale.drain", "scale.reap"]
    port_cmd, port_env = pair[1][3][0][0].cmd, pair[1][3][0][1]
    assert port_cmd[1:4] == ["-m", "daccord_tpu_torch.tools.cli", "serve"]
    assert port_cmd[port_cmd.index("--backend") + 1] == "cuda"
    assert "-b" not in port_cmd and "--peer-dir" in port_cmd and "--slo-p99-s" in port_cmd
    assert port_env["JAX_PLATFORMS"] == "cpu"
    assert port_env["PYTHONPATH"].split(os.pathsep)[0] == ROOT


def test_autoscaler_partition_cases_equal_the_jax_autoscaler(tmp_path, monkeypatch):
    """A partitioned peer is never drained (its idle clock resets, and the
    TTL starts fresh once it heals) and still occupies spawn capacity: the
    port autoscaler's sequence is the JAX one's."""
    clock, pair = _scalers(tmp_path / "drain", monkeypatch, backend="native",
                           max_peers=4, min_peers=1, idle_ttl_s=4.0, cooldown_s=3600.0)
    seqs = {}
    for name, sc, log, procs, P in pair:
        clock.t = 1000.0
        sc.adopt("pp", _FakeProc(), str(tmp_path / "pp"))
        anchor = _mk_peer("p0", P)
        steps = [(1000.0, [anchor, _mk_peer("pp", P, alive=False, partitioned=True)]),
                 (1020.0, [anchor, _mk_peer("pp", P, alive=False, partitioned=True)]),
                 (1020.0, [anchor, _mk_peer("pp", P)]),
                 (1023.9, [anchor, _mk_peer("pp", P)]),
                 (1024.1, [anchor, _mk_peer("pp", P)])]
        drains = []
        for t, peers in steps:
            clock.t = t
            sc.tick(peers)
            drains.append(sc.counters["drains"])
        seqs[name] = (drains, _norm(log))
        sc.disown("pp")
    assert seqs["port"] == seqs["jax"]
    assert seqs["port"][0] == [0, 0, 0, 0, 1]

    clock, pair = _scalers(tmp_path / "cap", monkeypatch, backend="native",
                           max_peers=2, min_peers=1, spawn_burn=1.0, sustain_s=1.0,
                           cooldown_s=0.0, idle_ttl_s=0.0)
    seqs = {}
    for name, sc, log, procs, P in pair:
        hot = _mk_peer("p0", P, burn=3.0)
        part = _mk_peer("pp", P, alive=False, partitioned=True)
        spawns = []
        for t, peers in ((1000.0, [hot, part]), (1002.0, [hot, part]), (1003.0, [hot])):
            clock.t = t
            sc.tick(peers)
            spawns.append(sc.counters["spawns"])
        seqs[name] = (spawns, len(procs), _norm(log))
    assert seqs["port"] == seqs["jax"]
    assert seqs["port"][:2] == ([0, 0, 1], 1)


def test_drain_call_bounded_and_marks_nothing(tmp_path):
    """A drain whose socket wedges costs one ``abort`` deadline and marks
    nothing, as the JAX autoscaler's; a refused one is as silent."""
    out = {}
    for name, mod, Plan, nmod in (("jax", jax_asc, JaxFaultPlan, jax_netio),
                                  ("port", asc, FaultPlan, netio)):
        log = _CapLog()
        sc = mod.Autoscaler(mod.AutoscaleConfig(peer_dir=str(tmp_path / name / "f"),
                                                root=str(tmp_path / name / "r"),
                                                drain_timeout_s=0.3), log)
        nmod.install_faults(Plan.parse("net_hang:1@abort"))
        t0 = time.monotonic()
        sc._drain("pp", "http://127.0.0.1:1")
        bounded = time.monotonic() - t0 < 2.0
        sc._drain("pq", "http://127.0.0.1:1")
        nmod.install_faults(None)
        out[name] = (bounded, sc.counters["drains"], [e for e, _ in log.events])
    assert out["port"] == out["jax"] == (True, 2, ["net.fault", "scale.drain",
                                                   "scale.drain"])


# ---------------------------------------------------------------------------
# the kernel cache (g++-built stand-ins for the nvcc libraries)
# ---------------------------------------------------------------------------

_STANDIN = r'''
import ctypes, hashlib, json, os, subprocess, sys, time
sys.path.insert(0, {root!r})
from daccord_tpu_torch.serve.aotcache import AotCache
src_dir, build_dir, cache_dir = sys.argv[1:4]
built = []

def source(n):
    return os.path.join(src_dir, n + ".c")

def digest_of(n):
    return hashlib.sha256(open(source(n), "rb").read()).hexdigest()[:16]

def library_path(n):
    return os.path.join(build_dir, f"{{n}}-{{digest_of(n)}}.so")

def build_many(names):
    out = {{}}
    for n in names:
        path = library_path(n)
        if os.path.exists(path):
            out[n] = (path, 0.0)
            continue
        os.makedirs(build_dir, exist_ok=True)
        t0 = time.perf_counter()
        tmp = f"{{path}}.tmp.{{os.getpid()}}"
        subprocess.run(["g++", "-shared", "-fPIC", "-O1", "-o", tmp, source(n)], check=True)
        os.replace(tmp, path)
        built.append(n)
        out[n] = (path, time.perf_counter() - t0)
    return out

class Log:
    events = []
    def log(self, event, **kw):
        self.events.append([event, kw])

log = Log()
cache = AotCache(cache_dir, log=log, meta={{"torch": "t", "cuda": "c", "nvcc": "n", "capability": "9.0"}})
names = sorted(f[:-2] for f in os.listdir(src_dir) if f.endswith(".c"))
res = cache.prepare(names, library_path=library_path, digest_of=digest_of, build_many=build_many)
answers = {{n: ctypes.CDLL(library_path(n)).answer() for n in names}}
json.dump({{"res": res, "built": built, "answers": answers, "events": log.events,
           "stats": cache.stats()}}, sys.stdout)
'''


def _standin_sources(d, n=5):
    os.makedirs(d, exist_ok=True)
    names = [f"k{i}" for i in range(n)]
    for i, name in enumerate(names):
        with open(os.path.join(d, name + ".c"), "w") as fh:
            fh.write(f'extern "C" int answer() {{ return {100 + i}; }}\n')
    return names


def _prepare_in_fresh_process(tmp_path, src, build, cache):
    script = str(tmp_path / "standin.py")
    with open(script, "w") as fh:
        fh.write(_STANDIN.format(root=ROOT))
    r = subprocess.run([sys.executable, script, src, build, cache],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout)


def test_aot_kernel_cache_roundtrip_reject_and_heal(tmp_path):
    """Process 1 (empty build dir): five misses, five local builds, five
    publishes. Process 2 (another empty build dir): five hits installed, no
    build, the libraries load and answer. Process 3 after one entry's byte
    is flipped: that entry rejected as corrupt and built locally (and
    re-published, which heals it), the four others hits, the same answers."""
    src = str(tmp_path / "src")
    names = _standin_sources(src)
    cache = str(tmp_path / "aot")
    want = {n: 100 + i for i, n in enumerate(names)}

    one = _prepare_in_fresh_process(tmp_path, src, str(tmp_path / "b1"), cache)
    assert one["res"] == {n: "miss" for n in names} and one["built"] == names
    assert [e for e, _ in one["events"]].count("aot.publish") == 5
    assert one["answers"] == want and one["stats"]["publishes"] == 5

    two = _prepare_in_fresh_process(tmp_path, src, str(tmp_path / "b2"), cache)
    assert two["res"] == {n: "hit" for n in names} and two["built"] == []
    assert [e for e, _ in two["events"]] == ["aot.hit"] * 5
    assert two["answers"] == want and two["stats"]["installed"] == 5

    from daccord_tpu_torch.serve.aotcache import AotCache

    probe = AotCache(cache)
    digest = hashlib.sha256(open(os.path.join(src, "k2.c"), "rb").read()).hexdigest()[:16]
    path = probe._path("k2", digest)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(bytes(blob))
    three = _prepare_in_fresh_process(tmp_path, src, str(tmp_path / "b3"), cache)
    assert three["res"] == {n: ("reject" if n == "k2" else "hit") for n in names}
    assert three["built"] == ["k2"] and three["answers"] == want
    rejects = [kw for e, kw in three["events"] if e == "aot.reject"]
    assert rejects == [{"key": "k2", "reason": "corrupt"}]
    assert [kw["key"] for e, kw in three["events"] if e == "aot.publish"] == ["k2"]
    four = _prepare_in_fresh_process(tmp_path, src, str(tmp_path / "b4"), cache)
    assert four["res"] == {n: "hit" for n in names}          # healed


def test_aot_rejects_corrupt_torn_version_and_foreign_entries(tmp_path):
    from daccord_tpu_torch.serve.aotcache import _MAGIC, AotCache

    meta = {"torch": "t", "cuda": "c", "nvcc": "n", "capability": "9.0"}
    log = _CapLog()
    cache = AotCache(str(tmp_path / "aot"), log=log, meta=meta)
    key, digest = "rescore", "0" * 16
    dest = str(tmp_path / "b" / "rescore.so")

    def write(body, sha=None):
        with open(cache._path(key, digest), "wb") as fh:
            fh.write(_MAGIC + (sha or hashlib.sha256(body).digest()) + body)

    good = pickle.dumps({"key": key, "meta": meta, "payload": b"\x7fELF..."})
    flipped = bytearray(good)
    flipped[-1] ^= 0xFF
    write(bytes(flipped), sha=hashlib.sha256(good).digest())
    assert not cache.load(key, digest, dest)
    with open(cache._path(key, digest), "wb") as fh:
        fh.write(b"DACAOT01trunc")
    assert not cache.load(key, digest, dest)
    write(pickle.dumps({"key": key, "meta": dict(meta, capability="8.0"),
                        "payload": b"x"}))
    assert not cache.load(key, digest, dest)
    write(pickle.dumps({"key": "dp_backtrack", "meta": meta, "payload": b"x"}))
    assert not cache.load(key, digest, dest)
    assert not cache.load("gather_pages", digest, dest)      # a plain miss
    assert [kw["reason"] for kw in log["aot.reject"]] == ["corrupt", "corrupt",
                                                          "version", "corrupt"]
    assert not os.path.exists(dest)
    write(good)
    assert cache.load(key, digest, dest) and open(dest, "rb").read() == b"\x7fELF..."
    with open(dest, "wb") as fh:
        fh.write(b"local")
    assert cache.load(key, digest, dest) and open(dest, "rb").read() == b"local"
    assert cache.stats()["hits"] == 2 and cache.stats()["installed"] == 1


def test_aot_sweep_caps_the_shared_dir_oldest_first(tmp_path):
    from daccord_tpu_torch.serve.aotcache import AotCache

    meta = {"torch": "t", "cuda": "c", "nvcc": "n", "capability": "9.0"}
    log = _CapLog()
    cache = AotCache(str(tmp_path / "aot"), log=log, meta=meta, cap_mb=0.0)
    lib = tmp_path / "lib.so"
    lib.write_bytes(os.urandom(300_000))
    now = time.time()
    for i in range(4):
        assert cache.publish(f"k{i}", "d", str(lib), 0.1)
        os.utime(cache._path(f"k{i}", "d"), (now - 100 + i, now - 100 + i))
    assert cache.sweep() == 0                                # cap 0 = uncapped
    cache.cap_mb = 0.7
    assert cache.publish("k4", "d", str(lib), 0.1)           # 5 x 0.29 MB > 0.7
    left = sorted(os.listdir(str(tmp_path / "aot")))
    assert len(left) == 2 and os.path.basename(cache._path("k4", "d")) in left
    assert os.path.basename(cache._path("k3", "d")) in left
    sweep = log["aot.sweep"]
    assert sweep and sweep[0]["removed"] == 3 and cache.stats()["swept"] == 3


# ---------------------------------------------------------------------------
# end to end: the router in front of port peers on the native engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("router"))
    cfg = SimConfig(genome_len=1500, coverage=10, read_len_mean=500,
                    min_overlap=200, seed=5)
    return make_dataset(d, cfg, name="sv"), d


def _jax_solo_bytes(out, d):
    """The JAX package's solo native run of the job config a native serve
    job builds."""
    import dataclasses

    from daccord_tpu.runtime.pipeline import correct_to_fasta
    from daccord_tpu.serve.jobs import JobSpec, build_job_config

    ref = os.path.join(d, "jax-solo-native.fasta")
    if not os.path.exists(ref):
        spec = JobSpec.from_json({"db": out["db"], "las": out["las"]}, d)
        cfg = build_job_config(spec, "native", True, 64, "fused", d, "solo")
        cfg = dataclasses.replace(cfg, native_solver=True, supervise=True,
                                  events_path=None, ledger_path=None,
                                  job_tag=None, quarantine_path=None)
        correct_to_fasta(out["db"], out["las"], ref, cfg)
    with open(ref, "rb") as fh:
        return fh.read()


def _rreq(port, method, path, body=None, timeout=180):
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        return resp.status, resp.read()


def test_router_e2e_sticky_idempotent_spill(dataset, tmp_path):
    """Two in-process port peers (native) behind the router: a tenant's jobs
    stay on one peer, a replayed key dedupes through the router, result and
    stream proxy the JAX solo native run's bytes, a red burn spills, and an
    unknown job is the router's own 404."""
    from daccord_tpu_torch.serve import ConsensusService, ServeConfig
    from daccord_tpu_torch.serve.http import start_server

    out, d = dataset
    ref = _jax_solo_bytes(out, d)
    peer_dir = str(tmp_path / "fleet")
    svcs, servers = {}, []
    for i in range(2):
        svc = ConsensusService(ServeConfig(
            workdir=str(tmp_path / f"p{i}"), backend="native", backend_explicit=True,
            batch=64, workers=2, flush_lag_s=0.02, peer_dir=peer_dir))
        httpd, port, _ = start_server(svc, "127.0.0.1", 0)
        svc.announce(f"http://127.0.0.1:{port}")
        svcs[f"p{i}"] = svc
        servers.append((svc, httpd))
    rt = Router(RouterConfig(workdir=str(tmp_path / "router"), peer_dir=peer_dir,
                             poll_s=3600.0, spill_burn=1.0))
    rhttpd, rport, _ = start_router(rt)
    try:
        rt.refresh()
        st, raw = _rreq(rport, "GET", "/v1/router")
        rs = json.loads(raw)
        assert rs["ready"] and len(rs["peers"]) == 2
        assert all(p["alive"] and p["ready"] for p in rs["peers"])
        jobs = []
        for i in range(3):
            st, raw = _rreq(rport, "POST", "/v1/jobs",
                            {"db": out["db"], "las": out["las"], "tenant": "alice",
                             "idempotency_key": f"rt-e2e-{i}"})
            assert st == 201, raw
            jobs.append(json.loads(raw)["job"])
        owners = {rt.stats()["jobs"][j] for j in jobs}
        assert len(owners) == 1
        owner = owners.pop()
        assert owner == max(svcs, key=lambda n: JaxRouter._score("alice", n))
        st, raw = _rreq(rport, "POST", "/v1/jobs",
                        {"db": out["db"], "las": out["las"], "tenant": "alice",
                         "idempotency_key": "rt-e2e-0"})
        assert st == 200 and json.loads(raw)["job"] == jobs[0]
        assert json.loads(raw).get("idempotent") is True
        st, body = _rreq(rport, "GET", f"/v1/jobs/{jobs[0]}/result?wait=1")
        assert st == 200 and body == ref
        st, sbody = _rreq(rport, "GET", f"/v1/jobs/{jobs[0]}/stream")
        assert st == 200 and sbody == ref
        for j in jobs[1:]:
            st, body = _rreq(rport, "GET", f"/v1/jobs/{j}/result?wait=1")
            assert st == 200 and body == ref
        # a tenant of the other peer: that peer's first job is a j00001 too;
        # the router's fleet-wide ids keep the two apart (the JAX router's
        # map on bare ids would send both GETs to one peer)
        other = next(t for t in (f"t{i}" for i in range(1000))
                     if max(svcs, key=lambda n: JaxRouter._score(t, n)) != owner)
        st, raw = _rreq(rport, "POST", "/v1/jobs",
                        {"db": out["db"], "las": out["las"], "tenant": other})
        assert st == 201
        jo = json.loads(raw)["job"]
        assert jo.split(".")[-1] == jobs[0].split(".")[-1] == "j00001"
        assert jo != jobs[0] and jo.startswith(f"{rt.stats()['jobs'][jo]}.")
        st, body = _rreq(rport, "GET", f"/v1/jobs/{jo}/result?wait=1")
        assert st == 200 and body == ref
        for j, tenant in ((jo, other), (jobs[0], "alice")):
            st, raw = _rreq(rport, "GET", f"/v1/jobs/{j}")
            assert st == 200 and json.loads(raw)["job"] == j
            assert json.loads(raw)["tenant"] == tenant
        svcs[owner]._slo_burn_last = 5.0
        rt.refresh()
        assert rt.route("alice").name != owner and rt.counters["spills"] >= 1
        svcs[owner]._slo_burn_last = 0.0
        with pytest.raises(urllib.error.HTTPError) as ei:
            _rreq(rport, "GET", "/v1/jobs/j99999")
        assert ei.value.code == 404
    finally:
        rt.shutdown()
        rhttpd.shutdown()
        for svc, httpd in servers:
            svc.shutdown(drain=True)
            httpd.shutdown()
    _lint([os.path.join(str(tmp_path / "router"), "router.events.jsonl"),
           os.path.join(str(tmp_path / "p0"), "serve.events.jsonl"),
           os.path.join(str(tmp_path / "p1"), "serve.events.jsonl")])


def _spawn_peer(workdir, root, tag, peer_dir, fault=None):
    ready = os.path.join(str(root), f"ready-{tag}.json")
    argv = [sys.executable, "-m", "daccord_tpu_torch.tools.cli", "serve",
            "--workdir", str(workdir), "--backend", "native", "-b", "64",
            "--workers", "2", "--port", "0", "--ready-file", ready,
            "--checkpoint-reads", "4", "--flush-lag-ms", "20",
            "--peer-dir", str(peer_dir), "--lease-ttl-s", "600"]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "2"
    if fault:
        env["DACCORD_FAULT"] = fault
    else:
        env.pop("DACCORD_FAULT", None)
    log = open(os.path.join(str(root), f"serve-{tag}.log"), "wb")
    proc = subprocess.Popen(argv, env=env, stdout=log, stderr=log)
    deadline = time.time() + 120
    port = None
    while time.time() < deadline:
        if os.path.exists(ready):
            try:
                port = json.load(open(ready))["port"]
                break
            except (OSError, json.JSONDecodeError, ValueError):
                pass
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    return proc, port


def test_kill_mid_proxy_retry_lands_exactly_once(dataset, tmp_path):
    """Two ``serve`` processes behind the router; the job's owner SIGKILLs
    itself at its first progress append (``serve_crash:3``). The client's
    retry with the same idempotency key rides the router to the survivor
    and lands exactly once, the JAX solo native run's bytes."""
    from daccord_tpu_torch.serve.journal import replay

    out, d = dataset
    ref = _jax_solo_bytes(out, d)
    peer_dir = str(tmp_path / "fleet")
    os.makedirs(peer_dir, exist_ok=True)
    tenant = next(t for t in (f"kt{i}" for i in range(1000))
                  if Router._score(t, "pA") > Router._score(t, "pB"))
    procA, portA = _spawn_peer(tmp_path / "pA", tmp_path, "a", peer_dir,
                               fault="serve_crash:3")
    procB, portB = _spawn_peer(tmp_path / "pB", tmp_path, "b", peer_dir)
    assert portA and portB
    rt = Router(RouterConfig(workdir=str(tmp_path / "router"), peer_dir=peer_dir,
                             poll_s=0.3, lease_ttl_s=600.0))
    rhttpd, rport, _ = start_router(rt)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if sum(1 for p in rt.stats()["peers"] if p["alive"] and p["ready"]) == 2:
                break
            time.sleep(0.1)
        else:
            pytest.fail(f"peers never turned ready: {rt.stats()['peers']}")
        body = {"db": out["db"], "las": out["las"], "tenant": tenant,
                "idempotency_key": "kill-once"}
        st, raw = _rreq(rport, "POST", "/v1/jobs", body)
        assert st == 201
        jid1 = json.loads(raw)["job"]
        assert rt.stats()["jobs"][jid1] == "pA"
        assert procA.wait(timeout=180) == 137
        jid2 = None
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                st, raw = _rreq(rport, "POST", "/v1/jobs", body, timeout=30)
                if st in (200, 201):
                    jid2 = json.loads(raw)["job"]
                    break
            except urllib.error.HTTPError as e:
                assert e.code in (502, 503), (e.code, e.read())
                assert json.loads(e.read()).get("retryable") is True
            except (urllib.error.URLError, OSError):
                pass
            time.sleep(0.3)
        assert jid2 is not None, "retry never landed on the survivor"
        assert rt.stats()["jobs"][jid2] == "pB"
        st, got = _rreq(rport, "GET", f"/v1/jobs/{jid2}/result?wait=1")
        assert st == 200 and got == ref
        st, raw = _rreq(rport, "POST", "/v1/jobs", body)
        assert st == 200 and json.loads(raw)["job"] == jid2
        entsB, _ = replay(os.path.join(str(tmp_path / "pB"), "journal.jsonl"))
        hitsB = [e for e in entsB.values() if e.idem == "kill-once"]
        assert len(hitsB) == 1 and hitsB[0].state == "committed"
        entsA, _ = replay(os.path.join(str(tmp_path / "pA"), "journal.jsonl"))
        committed = [e for e in list(entsA.values()) + list(entsB.values())
                     if e.idem == "kill-once" and e.state == "committed"]
        assert len(committed) == 1
        assert any(e["event"] == "router.peer_down" and e["peer"] == "pA"
                   for e in _events(rt))
    finally:
        rt.shutdown()
        rhttpd.shutdown()
        for proc in (procA, procB):
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
    _lint([os.path.join(str(tmp_path / "router"), "router.events.jsonl"),
           os.path.join(str(tmp_path / "pB"), "serve.events.jsonl")])
