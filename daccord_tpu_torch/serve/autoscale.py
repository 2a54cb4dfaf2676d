"""SLO-burn autoscaler for the serve fleet: the port's copy of the JAX
package's ``serve/autoscale.py``.

Runs inside the router process (the only place with a fleet-wide view) and
is driven by the router's poll loop: every sweep hands it the fresh peer
table and it decides spawn / drain / nothing.

- **signal**: fleet burn = max burn over READY peers. Band changes emit
  ``scale.burn``.
- **scale-out**: burn >= ``spawn_burn`` sustained for ``sustain_s`` AND
  past ``cooldown_s`` since the last spawn AND live < ``max_peers``.
  Spawns one ``python -m daccord_tpu_torch.tools.cli serve`` process with
  the same peer-dir (so it announces itself and joins the takeover group)
  and, with it, the fleet-shared kernel cache beside the leases
  (``<peer-dir>/aotcache``, ``serve/aotcache.py``), so a new peer installs
  the built kernels instead of running nvcc. Its backend defaults to the
  card (``cuda``); ``auto`` resolves by ``utils.obs.resolve_auto_backend``
  in the spawned process, which raises with no card.
- **scale-in**: a peer this autoscaler spawned that has been idle past
  ``idle_ttl_s`` while the fleet holds more than ``min_peers`` gets a
  graceful ``POST /v1/shutdown`` (``scale.drain``). Process exit emits
  ``scale.reap``.
- **partition safety**: a peer whose healthz is unreachable but whose
  announce lease is fresh (``Peer.partitioned``) is never drained, still
  occupies spawn capacity, and a drain call that times out journal-marks
  nothing. The drain call goes through ``serve/netio.py`` with the bounded
  ``abort`` deadline.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

from . import netio

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclass
class AutoscaleConfig:
    peer_dir: str                     # shared lease root (joins the group)
    root: str                         # new peers live at <root>/peer<N>/
    max_peers: int = 4
    min_peers: int = 1
    spawn_burn: float = 1.0           # fleet burn >= this arms the trigger
    sustain_s: float = 5.0            # ... for this long
    cooldown_s: float = 30.0          # min gap between spawns
    idle_ttl_s: float = 120.0         # idle spawned peer older than this
                                      # drains (0 = never scale in)
    drain_timeout_s: float = 10.0     # bound on the graceful-shutdown call
    backend: str = "cuda"
    batch: int | None = None          # None: the peer's own auto batch
    workers: int = 2
    slo_p99_s: float = 0.0            # forwarded so new peers burn-report
    extra_args: tuple = field(default_factory=tuple)
    spawn_env: dict = field(default_factory=dict)


class Autoscaler:
    """Owns the peers it spawned (pid + workdir); everything else in the
    fleet is read-only to it."""

    def __init__(self, cfg: AutoscaleConfig, log):
        self.cfg = cfg
        self.log = log
        os.makedirs(cfg.root, exist_ok=True)
        self._spawned: dict[str, dict] = {}   # peer name -> {proc, ...}
        self._seq = 0
        self._burn_since: float | None = None
        self._last_spawn_ts = 0.0
        self._band = -1
        self._idle_since: dict[str, float] = {}
        self.counters = {"spawns": 0, "drains": 0, "reaps": 0}

    # -- helpers -----------------------------------------------------------

    def _peer_name(self, workdir: str) -> str:
        # must match ConsensusService.service_id (announce lease basename)
        return os.path.basename(os.path.abspath(workdir))

    def _spawn(self) -> None:
        self._seq += 1
        workdir = os.path.join(self.cfg.root, f"autopeer{self._seq}")
        ready = os.path.join(workdir, "ready.port")
        os.makedirs(workdir, exist_ok=True)
        cmd = [sys.executable, "-m", "daccord_tpu_torch.tools.cli", "serve",
               "--workdir", workdir,
               "--backend", self.cfg.backend,
               "--workers", str(self.cfg.workers),
               "--port", "0",
               "--ready-file", ready,
               "--peer-dir", self.cfg.peer_dir]
        if self.cfg.batch:
            cmd += ["-b", str(self.cfg.batch)]
        if self.cfg.slo_p99_s:
            cmd += ["--slo-p99-s", str(self.cfg.slo_p99_s)]
        cmd += list(self.cfg.extra_args)
        env = dict(os.environ, **self.cfg.spawn_env)
        # the peer imports the port from any cwd: its root on PYTHONPATH
        env["PYTHONPATH"] = _PKG_ROOT + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        proc = subprocess.Popen(
            cmd, env=env,
            stdout=open(os.path.join(workdir, "serve.out"), "wb"),
            stderr=subprocess.STDOUT)
        name = self._peer_name(workdir)
        self._spawned[name] = {"proc": proc, "workdir": workdir,
                               "spawn_ts": time.time()}
        self._last_spawn_ts = time.time()
        self.counters["spawns"] += 1
        self.log.log("scale.spawn", peer=name, pid=proc.pid,
                     workdir=workdir, n_spawned=len(self._spawned))

    def adopt(self, name: str, proc, workdir: str) -> None:
        """Take ownership of an externally spawned peer (bench / chaos
        harness escape hatch): it joins the idle-drain and reap sweeps
        exactly as if this autoscaler had spawned it."""
        self._spawned[name] = {"proc": proc, "workdir": workdir,
                               "spawn_ts": time.time()}

    def disown(self, name: str) -> None:
        """Release an adopted peer without draining or reaping it —
        :meth:`shutdown` must not terminate a process the harness intends
        to stop gracefully itself."""
        self._spawned.pop(name, None)
        self._idle_since.pop(name, None)

    def _net_event(self, event: str, **fields) -> None:
        # ``event``, not ``kind``: net.fault carries a field named kind
        try:
            self.log.log(event, **fields)
        except Exception:  # noqa: BLE001 — telemetry never breaks scaling
            pass

    def _drain(self, name: str, url: str) -> None:
        try:
            netio.request(url + "/v1/shutdown", "abort", method="POST",
                          body=b"{}", timeout=self.cfg.drain_timeout_s,
                          log_event=self._net_event, peer=name)
        except Exception:
            # unreachable or timed out: journal-mark NOTHING — the peer's
            # own journal owns its recovery (graceful exit releases its
            # leases; an unclean death goes stale and takeover re-homes
            # the jobs). The reap sweep collects the process if it exits.
            pass
        self.counters["drains"] += 1
        self.log.log("scale.drain", peer=name, reason="idle_ttl")

    def _reap(self) -> None:
        for name, info in list(self._spawned.items()):
            rc = info["proc"].poll()
            if rc is None:
                continue
            del self._spawned[name]
            self._idle_since.pop(name, None)
            self.counters["reaps"] += 1
            self.log.log("scale.reap", peer=name, rc=int(rc),
                         life_s=round(time.time() - info["spawn_ts"], 3))

    # -- the per-sweep decision -------------------------------------------

    def tick(self, peers: list) -> None:
        """One decision pass over the router's freshly-polled peer table
        (``peers`` are router.Peer objects)."""
        now = time.time()
        self._reap()
        ready = [p for p in peers if p.ready]
        live = [p for p in peers if p.alive]
        # a partitioned peer (healthz dead, announce lease fresh) is alive
        # hardware we merely cannot see: it occupies capacity
        present = [p for p in peers
                   if p.alive or getattr(p, "partitioned", False)]

        # burn signal + band audit trail
        burn = max((p.burn for p in ready), default=0.0)
        band = int(min(burn, 5.0) * 10)
        if band != self._band:
            self._band = band
            self.log.log("scale.burn", burn=round(burn, 4), band=band,
                         n_ready=len(ready), n_live=len(live))

        # scale-out: sustained burn, cooled down, under the cap
        if burn >= self.cfg.spawn_burn and ready:
            if self._burn_since is None:
                self._burn_since = now
            sustained = now - self._burn_since >= self.cfg.sustain_s
            cooled = now - self._last_spawn_ts >= self.cfg.cooldown_s
            capacity = len(present) + self._n_pending() < self.cfg.max_peers
            if sustained and cooled and capacity:
                self._spawn()
        else:
            self._burn_since = None

        # scale-in: OUR idle peers past TTL, keeping min_peers alive
        if self.cfg.idle_ttl_s <= 0:
            return
        by_name = {p.name: p for p in peers}
        for name in list(self._spawned):
            p = by_name.get(name)
            if p is None or not p.alive:
                if p is not None and getattr(p, "partitioned", False):
                    # we cannot see a partitioned peer's queue, so we
                    # cannot call it idle — reset its clock, never drain
                    self._idle_since.pop(name, None)
                continue
            idle = p.jobs_active == 0 and p.queue_depth == 0
            if not idle:
                self._idle_since.pop(name, None)
                continue
            first = self._idle_since.setdefault(name, now)
            if now - first >= self.cfg.idle_ttl_s and \
                    len(live) > self.cfg.min_peers:
                self._idle_since.pop(name, None)
                self._drain(name, p.url)

    def _n_pending(self) -> int:
        """Spawned processes that haven't announced/turned ready yet still
        count against max_peers — that's the spawn-storm guard."""
        return sum(1 for i in self._spawned.values()
                   if i["proc"].poll() is None)

    def stats(self) -> dict:
        return {"spawned": sorted(self._spawned),
                "burn_band": self._band, **self.counters}

    def shutdown(self) -> None:
        """Drain every peer we own (router shutdown): graceful stop, then
        a bounded wait; a peer that won't die is left for takeover."""
        for name, info in list(self._spawned.items()):
            proc = info["proc"]
            if proc.poll() is None:
                proc.terminate()
        deadline = time.time() + 15.0
        for info in self._spawned.values():
            proc = info["proc"]
            try:
                proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
        self._reap()
