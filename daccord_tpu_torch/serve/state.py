"""Warm-state manager: solve groups resident across jobs, idle-evicted.

The port's copy of the JAX package's ``serve/state.py``. A server beats
per-invocation ``daccord`` by amortizing cold start: a group's ladder
tables on the card, its CUDA graphs (``kernels/graphs.py``), its
``LadderDispatcher`` thread, its supervisor's cold-shape state and
capacity ratchets, and its audit worker processes all survive from job to
job here. Groups are keyed by solve fingerprint
(``jobs.solve_fingerprint``); a hit means the Nth job starts solving at
once. Idle groups (refcount zero past the TTL) evict, and an evicted
group's ``close`` gives back what it holds (its graphs and buffers on the
card, its threads and its worker processes), so a long-lived server's
memory tracks its live workload mix, not its history.

A front-door router keeps a tenant's jobs on the peer whose groups are
warm, which the idle TTL can defeat by evicting the group the router is
about to route to. While a router heartbeat is live
(``note_router_heartbeat``, set by the proxied ``/v1/healthz`` poll),
eviction consults the last-routed stamps the service records at submit
time (``note_route``): a group whose key was routed within the grace
window survives the sweep. Without a router the TTL alone rules.
"""

from __future__ import annotations

import threading
import time


class WarmState:
    # a router poll within this window counts as "a router is alive" (the
    # default healthz cadence is ~1 s; 10 s tolerates a slow poll loop
    # without keeping grace armed long after the router died)
    ROUTER_FRESH_S = 10.0

    def __init__(self, idle_evict_s: float = 600.0, log=None,
                 route_grace_s: float = 30.0):
        from ..utils.obs import NullLogger

        self.idle_evict_s = float(idle_evict_s)
        self.log = log if log is not None else NullLogger()
        self._lock = threading.Lock()
        self._groups: dict[str, object] = {}
        self.counters = {"hits": 0, "misses": 0, "evicted": 0,
                         "evict_deferred": 0}
        # the evict-vs-route race guard: last router heartbeat +
        # per-key last-routed stamps; grace = how long a routed-to key
        # outlives its idle TTL while a router is alive
        self.route_grace_s = float(route_grace_s)
        self._router_seen_ts = 0.0
        self._last_routed: dict[str, float] = {}

    def acquire(self, key: str, factory):
        """The group for ``key`` (built via ``factory()`` on miss), with its
        refcount taken — callers MUST pair with :meth:`release`.

        The build runs OUTSIDE the cache lock (per-key once-guard): a cold
        group build is seconds of ladder, graph and worker construction, and holding
        the lock through it would stall the ticker's ``groups()`` sweep —
        freezing stale-pool flushes for every already-warm group — plus
        every other job's acquire, warm or not. Concurrent acquirers of
        the SAME key wait on the build event; a failed build clears the
        placeholder so the next acquirer retries."""
        while True:
            with self._lock:
                entry = self._groups.get(key)
                if entry is None:
                    self.counters["misses"] += 1
                    building = threading.Event()
                    self._groups[key] = ("building", building)
                    break
                if isinstance(entry, tuple):
                    building = entry[1]
                else:
                    self.counters["hits"] += 1
                    entry.refs += 1
                    entry.last_used = time.time()
                    return entry
            building.wait()
        try:
            g = factory()
        except BaseException:
            with self._lock:
                self._groups.pop(key, None)
            building.set()
            raise
        with self._lock:
            self._groups[key] = g
            g.refs += 1
            g.last_used = time.time()
        building.set()
        return g

    @staticmethod
    def _built(entry) -> bool:
        # in-progress builds sit in the cache as ("building", Event)
        # placeholders so concurrent acquirers of the same key can wait
        return not isinstance(entry, tuple)

    def release(self, key: str) -> None:
        with self._lock:
            g = self._groups.get(key)
            if g is not None and self._built(g):
                g.refs = max(0, g.refs - 1)
                g.last_used = time.time()

    def note_router_heartbeat(self, now: float | None = None) -> None:
        """A front-door router just polled this peer (the healthz handler
        calls this on the ``X-Daccord-Router`` header) — arm the
        evict-vs-route grace window."""
        self._router_seen_ts = time.time() if now is None else now

    def note_route(self, key: str, now: float | None = None) -> None:
        """A job routed here was admitted for ``key`` — stamp it so the
        idle sweep knows the router's stickiness still points at this
        group even if no solve has touched it yet."""
        with self._lock:
            self._last_routed[key] = time.time() if now is None else now

    def router_live(self, now: float | None = None) -> bool:
        now = time.time() if now is None else now
        return (now - self._router_seen_ts) < self.ROUTER_FRESH_S

    def evict_idle(self, now: float | None = None) -> int:
        """Close and drop groups idle (refcount 0) past the TTL; returns the
        eviction count. A TTL of 0 evicts every idle group (tests/shutdown).

        The evict-vs-route race: between the router choosing this
        peer for a tenant (stickiness = this group is warm HERE) and that
        tenant's next submit arriving, the TTL can expire and this sweep
        would evict the exact group the router is routing to — the next job
        then pays a cold build the whole front door exists to avoid. While a
        router heartbeat is fresh, a key routed within ``route_grace_s``
        therefore survives the sweep (deferred, not exempted: once the
        router dies or the grace lapses, the TTL wins again)."""
        now = time.time() if now is None else now
        n = 0
        router = self.router_live(now)
        gone = []
        with self._lock:
            for key, g in list(self._groups.items()):
                if not self._built(g):
                    continue
                if g.refs == 0 and now - g.last_used >= self.idle_evict_s:
                    routed = self._last_routed.get(key)
                    if (router and routed is not None
                            and now - routed < self.route_grace_s):
                        self.counters["evict_deferred"] += 1
                        self.log.log("serve.evict_defer", group=g.name,
                                     key=key[:16],
                                     routed_s=round(now - routed, 3))
                        continue
                    del self._groups[key]
                    self._last_routed.pop(key, None)
                    self.counters["evicted"] += 1
                    n += 1
                    idle = now - g.last_used
                    self.log.log("serve.evict", group=g.name, key=key[:16],
                                 idle_s=round(idle, 3))
                    gone.append(g)
        # closed outside the lock: a close joins the group's threads and
        # workers, which must not stall every acquire and the ticker
        for g in gone:
            g.close()
        return n

    def building(self) -> int:
        """In-progress group builds (the ``ready`` denominator: a peer with
        a build in flight is up but not warm — the router should not
        rendezvous new tenants onto it)."""
        with self._lock:
            return sum(1 for g in self._groups.values()
                       if not self._built(g))

    def groups(self) -> list:
        with self._lock:
            return [g for g in self._groups.values() if self._built(g)]

    def stats(self) -> dict:
        with self._lock:
            built = [g for g in self._groups.values() if self._built(g)]
            return {**self.counters, "resident": len(built),
                    "groups": [g.stats() for g in built]}

    def close(self) -> None:
        with self._lock:
            gone = [g for g in self._groups.values() if self._built(g)]
            self._groups.clear()
        for g in gone:
            g.close()
