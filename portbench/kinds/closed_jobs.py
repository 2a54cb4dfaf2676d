"""Traffic kind ``closed_jobs``: K concurrent jobs, each a closed loop on a
thread of its own, and the service's ticker.

A job takes the next block of windows from its seeded stream, hands it to
the solve group (``dispatch``), keeps up to ``outstanding`` blocks in
flight (the pipeline's ``max_inflight``) and fetches the oldest, as a
job's pile loop does on a shared card. Each job runs on its own thread, as
``serve`` runs each job on a worker thread of its own, and a ticker thread
calls ``SolveGroup.flush_stale(flush_lag_s)`` every ``flush_lag_s``
seconds, as the service's ticker does (``ServeConfig.flush_lag_s``). The
group is never given a rate: the jobs keep it fed. A block is a run of
consecutive windows of one depth bucket of the pool, the bucket drawn in
proportion to its windows. Every seed sends the same block sizes
(``SIZES`` log-uniform quantiles over ``rows_min``-``rows_max``, each job
in an order of its own) from windows of its own pool; the order in which
the threads win the group's lock is the operating system's.

Parameters (the traffic file): ``jobs``, ``rows_min``, ``rows_max``,
``outstanding``, ``flush_lag_s``, ``warmup_rows`` (rows fetched before
the window opens).
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

SIZES = 256
#: the fields of a fetched block that the check compares
KEEP = ("cons", "cons_len", "solved", "tier", "err")


def block_sizes(lo: int, hi: int, n: int = SIZES) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))).astype(np.int64)


class Stream:
    """One job's blocks: (depth, first row, end row) of the pool."""

    def __init__(self, job: int, sizes: dict, traffic: dict, seed: int):
        self.rng = np.random.default_rng([int(seed), job])
        self.sizes = self.rng.permutation(block_sizes(traffic["rows_min"], traffic["rows_max"]))
        self.depths = sorted(sizes)
        n = np.array([sizes[d] for d in self.depths], np.float64)
        self.prob = n / n.sum()
        self.bucket = dict(sizes)
        self.cursor = {d: int(self.rng.integers(0, sizes[d])) for d in self.depths}
        self.i = 0

    def next(self) -> tuple[int, int, int]:
        n = int(self.sizes[self.i % len(self.sizes)])
        self.i += 1
        d = self.depths[int(self.rng.choice(len(self.depths), p=self.prob))]
        n = min(n, self.bucket[d])
        lo = self.cursor[d]
        if lo + n > self.bucket[d]:
            lo = 0
        self.cursor[d] = lo + n
        return d, lo, lo + n


class Driver:
    """The jobs, one thread each, and the ticker. ``records[j]`` lists job
    j's fetched blocks: (depth, lo, hi, dispatched, fetched, the result's
    :data:`KEEP` fields) on the host clock (``time.perf_counter``); ``sent[j]``
    counts the blocks it dispatched."""

    def __init__(self, group, make_batch, sizes: dict, traffic: dict, seed: int):
        self.group = group
        self.make_batch = make_batch
        self.outstanding = int(traffic["outstanding"])
        self.flush_lag_s = float(traffic["flush_lag_s"])
        self.streams = [Stream(j, sizes, traffic, seed) for j in range(int(traffic["jobs"]))]
        self.records: list[list] = [[] for _ in self.streams]
        self.rows = [0] * len(self.streams)
        self.sent = [0] * len(self.streams)
        self.errors: list[str] = []
        self._stop = threading.Event()
        self._jobs = [threading.Thread(target=self._job, args=(j,), daemon=True, name=f"job{j}")
                      for j in range(len(self.streams))]
        self._ticker = threading.Thread(target=self._tick, daemon=True, name="ticker")

    def start(self) -> None:
        for t in self._jobs:
            t.start()
        self._ticker.start()

    def fetched_rows(self) -> int:
        return sum(self.rows)

    def stop(self) -> None:
        """No job dispatches a new block from now on; each fetches what it
        has in flight."""
        self._stop.set()

    def join(self, timeout: float) -> bool:
        end = time.monotonic() + timeout
        for t in self._jobs + [self._ticker]:
            t.join(max(0.0, end - time.monotonic()))
        return not any(t.is_alive() for t in self._jobs + [self._ticker])

    def _job(self, j: int) -> None:
        q: deque = deque()
        stream, name = self.streams[j], f"job{j}"
        try:
            while not self._stop.is_set():
                d, lo, hi = stream.next()
                batch = self.make_batch(d, lo, hi)
                t = time.perf_counter()
                q.append((self.group.dispatch(name, batch), d, lo, hi, t))
                self.sent[j] += 1
                if len(q) >= self.outstanding:
                    self._fetch(j, q.popleft())
            while q:
                self._fetch(j, q.popleft())
        except Exception as e:  # noqa: BLE001 - a failed block is counted, not raised
            self.errors.append(f"{name}: {type(e).__name__}: {e}"[:300])

    def _tick(self) -> None:
        try:
            while not self._stop.wait(self.flush_lag_s):
                self.group.flush_stale(self.flush_lag_s)
        except Exception as e:  # noqa: BLE001 - counted, not raised
            self.errors.append(f"ticker: {type(e).__name__}: {e}"[:300])

    def _fetch(self, j: int, item) -> None:
        h, d, lo, hi, t = item
        out = self.group.fetch(h)
        t_done = time.perf_counter()
        # the rows a job keeps, copied out as its scatter copies them: a
        # result's arrays may view the pinned buffer of its ladder call,
        # which must go back to the allocator's cache
        self.records[j].append((d, lo, hi, t, t_done,
                                {k: np.array(out[k]) for k in KEEP}))
        self.rows[j] += hi - lo
