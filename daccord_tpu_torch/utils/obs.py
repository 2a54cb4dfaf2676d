"""Per-stage wall accounting of the host feeder.

The port's copy of ``StageProfile`` from ``daccord_tpu/utils/obs.py``; the
rest of that module (event logs, tracer, metrics registry, device probes)
is not ported.
"""

from __future__ import annotations

import threading
import time


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
