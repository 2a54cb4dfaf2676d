"""The shadow audit's reference solves in a process of their own.

On the card, the supervisor (``runtime/supervisor.py``) sends each
dispatched batch's sampled rows here and compares the rows that come back
when it fetches the batch. The reference is the port's CPU ladder in numpy
(``audit/ladder.py``, byte-equal to ``kernels.tiers.audit_reference``). On
the pipeline's thread a reference solve holds the interpreter lock that the
ladder dispatcher needs; in another process it shares no lock with either.

The workers (:data:`PROCESSES` of them, dealt the samples in turn, a
large sample in parts over several of them) are fresh interpreters
(``python -m daccord_tpu_torch.audit.worker``; no ``fork`` of a process
that holds a CUDA context), started once a process (:func:`shared`),
before the ingest scan of the first run that audits in them; later runs
send them their own ladder and reuse them, so only the first run pays
their start. They are started again when one has died, and closed when
the process exits. They import numpy and this package only: no torch (a
worker that imported it took 9-12 s to start on an H100 host, longer than
a small run) and no CUDA. A worker drains every sample pending when it wakes and
solves those of one tile shape together, oldest first, up to
:data:`CALL_WINDOWS` windows a ladder call, split back per ticket
afterwards, each call's rows sent as soon as it ends. That is exact
because windows solve independently (the premise of
``audit_reference``); small samples share a call's fixed cost, and the
cap keeps a backlog (the samples queued while the worker starts) from
holding back the oldest sample's rows, which the next fetch waits for.

A paged sample travels as it was dispatched: its rows' page table and the
pool pages those rows name (:func:`sample_pages`), unpacked to the dense
rows in the worker (``utils.pages.unpack_pages``, which
``PagedWindowBatch.to_dense`` calls too), so the pipeline's thread pays a
table slice and a page gather per audited batch, not the unpack. It takes
the rows in one pass of the host library with the interpreter lock held
(:func:`take_rows`): the numpy take (:func:`take_rows_plain`) sorts the
pages the rows name, and each of its ops may give the lock up to the
feeder threads and wait to get it back.

A worker that fails to start or answer raises :class:`AuditWorkerError`
from :meth:`AuditWorker.result`; the supervisor then logs
``audit.disabled`` and the run goes on without the audit.

Run as a program, the module is the worker: ``python -m
daccord_tpu_torch.audit.worker FD_IN FD_OUT PARENT_PID SPAWN_TIME``.
"""

from __future__ import annotations

import atexit
import itertools
import os
import queue
import subprocess
import sys
import threading
import time
from multiprocessing.connection import Connection, wait


#: worker processes. The samples' solves are the run's tail: its last
#: fetches wait for them, and with the ladder's CUDA graphs a 20 kb run's
#: card work is a fraction of the workers' (1.1 s of their solves in a
#: 1.7 s run on an 8-core H100 host). So a sample of at least two parts'
#: worth of windows is dealt over the workers in parts of at least
#: PART_WINDOWS windows
PROCESSES = 4
PART_WINDOWS = 8

#: the most windows a ladder call of the worker takes (two samples of a
#: 2048-window batch at 1/64); the numpy ladder's cost a window is about
#: the same at 32 windows as at 256, so larger calls only delay rows
CALL_WINDOWS = 64


class AuditWorkerError(RuntimeError):
    """The audit worker died, failed to start or gave no verdict in time."""


def sample_pages(batch, rows):
    """The ``rows`` of a paged batch (``PagedWindowBatch``) as a sample the
    workers unpack: those rows' table, lens and nsegs, and the pool pages
    the table names (page 0, the all-PAD sentinel, kept first), with the
    table renumbered into them. In numpy: the plain version of
    :func:`take_rows`'s paged take."""
    import dataclasses

    import numpy as np

    idx = np.asarray(rows, dtype=np.int64)
    table = batch.table[idx]
    used = np.union1d(table, [0])
    return dataclasses.replace(
        batch, pool=batch.pool[used],
        table=np.searchsorted(used, table).astype(batch.table.dtype),
        lens=batch.lens[idx], nsegs=batch.nsegs[idx],
        read_ids=batch.read_ids[idx], wstarts=batch.wstarts[idx])


def take_rows_plain(batch, rows):
    """Row-subset copy of a batch in numpy: a dense ``WindowBatch``'s rows,
    or a paged batch's as :func:`sample_pages` (the plain version of
    :func:`take_rows`)."""
    import dataclasses

    import numpy as np

    if hasattr(batch, "to_dense"):
        return sample_pages(batch, rows)
    idx = np.asarray(rows, dtype=np.int64)
    return dataclasses.replace(
        batch, seqs=batch.seqs[idx], lens=batch.lens[idx],
        nsegs=batch.nsegs[idx], read_ids=batch.read_ids[idx],
        wstarts=batch.wstarts[idx])


def take_rows(batch, rows):
    """:func:`take_rows_plain`'s copy, byte for byte, made by the host
    library's ``take_rows`` and ``take_pages`` with the interpreter lock held
    (``native.held``), one call an array."""
    import dataclasses
    import math

    import numpy as np

    from ..native import held

    lib = held()
    rows = [int(r) for r in rows]
    n_rows = len(batch.nsegs)
    if rows and (min(rows) < 0 or max(rows) >= n_rows):
        raise IndexError(f"audit rows {min(rows)}..{max(rows)} of a batch of {n_rows}")
    idx = np.asarray(rows, dtype=np.int64)
    k = len(idx)

    def take(a):
        a = np.ascontiguousarray(a)
        out = np.empty((k, *a.shape[1:]), a.dtype)
        lib.take_rows(a.ctypes.data, a.itemsize * math.prod(a.shape[1:]),
                      idx.ctypes.data, k, out.ctypes.data)
        return out

    if not hasattr(batch, "to_dense"):
        return dataclasses.replace(
            batch, seqs=take(batch.seqs), lens=take(batch.lens),
            nsegs=take(batch.nsegs), read_ids=take(batch.read_ids),
            wstarts=take(batch.wstarts))
    table = np.ascontiguousarray(batch.table, dtype=np.int32)
    pool = np.ascontiguousarray(batch.pool)
    pages, page_bytes = table.shape[1], pool.itemsize * math.prod(pool.shape[1:])
    out_table = np.empty((k, pages), np.int32)
    out_pool = np.empty((k * pages + 1, *pool.shape[1:]), pool.dtype)
    n = lib.take_pages(table.ctypes.data, pages, idx.ctypes.data, k, pool.ctypes.data,
                       len(pool), page_bytes, out_table.ctypes.data, out_pool.ctypes.data)
    if n < 0:
        raise IndexError(f"the page table of audit rows {rows} names a page outside "
                         f"the pool's {len(pool)}")
    return dataclasses.replace(
        batch, pool=out_pool[:n], table=out_table.astype(batch.table.dtype, copy=False),
        lens=take(batch.lens), nsegs=take(batch.nsegs), read_ids=take(batch.read_ids),
        wstarts=take(batch.wstarts))


def _dense(sample: tuple) -> tuple:
    """A part as (seqs, lens, nsegs): a paged part (pool, table, lens, nsegs,
    geometry) is unpacked first."""
    if len(sample) == 3:
        return sample
    from ..utils.pages import unpack_pages

    pool, table, lens, nsegs, geo = sample
    return unpack_pages(pool, table, lens, *geo), lens, nsegs


def solve_grouped(solve, items: list, call_windows: int = CALL_WINDOWS):
    """Solve ``items`` = [(ticket, (seqs, lens, nsegs))] with ``solve``, the
    samples of one tile shape (D, L) together, shapes in first-seen order,
    oldest first, at most ``call_windows`` windows a call (a larger sample
    alone). Yields each call's [(ticket, result)] and seconds as it ends;
    each result holds the rows of its own sample only (and the solve's
    scalars)."""
    import numpy as np

    groups: dict[tuple, list] = {}
    for ticket, sample in items:
        groups.setdefault(tuple(sample[0].shape[1:]), []).append((ticket, sample))
    for members in groups.values():
        while members:
            n, take = 0, 0
            while take < len(members) and (take == 0 or n + len(members[take][1][2])
                                           <= call_windows):
                n += len(members[take][1][2])
                take += 1
            call, members = members[:take], members[take:]
            t0 = time.perf_counter()
            parts = [s for _, s in call]
            whole = parts[0] if len(parts) == 1 else tuple(
                np.concatenate([p[i] for p in parts]) for i in range(3))
            res = solve(*whole)
            out, lo = [], 0
            for ticket, s in call:
                hi = lo + len(s[2])
                out.append((ticket, {k: v[lo:hi] if np.ndim(v) else v
                                     for k, v in res.items()}))
                lo = hi
            yield out, time.perf_counter() - t0


def _main(fd_in: int, fd_out: int, parent: int, t_spawn: float) -> None:
    """The worker's loop: one ``build`` message, then ``solve`` messages
    drained in bulk until ``stop`` (or until the parent is gone)."""
    req = Connection(fd_in, writable=False)
    res = Connection(fd_out, readable=False)
    try:
        t_boot = time.time() - t_spawn          # the interpreter's start
        t0 = time.perf_counter()
        from . import ladder

        t_import = time.perf_counter() - t0     # numpy and the ladder
        spec = None
        while True:
            if not req.poll(1.0):
                if os.getppid() != parent:
                    return
                continue
            msgs = [req.recv()]
            while req.poll(0):
                msgs.append(req.recv())
            items = []
            for m in msgs:
                if m[0] == "stop":
                    return
                if m[0] == "build":
                    spec = m[1]
                    leaked = sorted(n for n in sys.modules
                                    if n.split(".")[0] in ("jax", "daccord_tpu", "torch"))
                    res.send(("ready", leaked, dict(boot_s=t_boot, import_s=t_import)))
                else:
                    items.append((m[1], _dense(m[2]), m[3]))
            if items and spec is None:
                raise AuditWorkerError("a sample arrived before the ladder")
            # Stream A samples (tier 0 alone) and whole-ladder samples
            # solve apart, each kind oldest first
            for tier0 in dict.fromkeys(t0 for _, _, t0 in items):
                for done, secs in solve_grouped(
                        lambda s, ln, ns: ladder.solve_ladder(spec, s, ln, ns, tier0),
                        [(t, smp) for t, smp, t0 in items if t0 == tier0]):
                    res.send(("done", done, secs, time.time(),
                              sum(len(r["solved"]) for _, r in done)))
    except EOFError:
        return                                  # the parent closed its end
    except BaseException as e:  # noqa: BLE001 - relayed to the parent
        try:
            res.send(("error", f"{type(e).__name__}: {e}"))
        except Exception:
            pass
        os._exit(1)


def _spawn() -> tuple:
    """One worker process and the parent's ends of its two pipes."""
    r_req, w_req = os.pipe()
    r_res, w_res = os.pipe()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "daccord_tpu_torch.audit.worker", str(r_req),
             str(w_res), str(os.getpid()), repr(time.time())],
            pass_fds=(r_req, w_res), env=env, stdin=subprocess.DEVNULL)
    except BaseException:
        for fd in (r_req, w_req, r_res, w_res):
            os.close(fd)
        raise
    os.close(r_req)
    os.close(w_res)
    return proc, Connection(w_req, readable=False), Connection(r_res, writable=False)


class AuditWorker:
    """The parent's side: start :data:`PROCESSES` worker processes, send
    them the ladder and the samples to solve (in turn, by ticket), and
    collect their verdicts by ticket.

    ``worker_s`` sums the workers' own solve wall, ``calls`` their ladder
    calls; :meth:`anatomy` reads the run's log of parts and calls (which
    worker, how many windows, when sent, solved and back); ``startup`` holds the slowest one's start walls once all are
    ready (``boot_s``: from the start to its first line, the interpreter's
    start; ``import_s``: numpy and the ladder); ``leaked`` is what of jax,
    ``daccord_tpu`` or torch they had imported then (nothing)."""

    def __init__(self, processes: int = PROCESSES):
        self._procs, self._reqs, self._ress = [], [], []
        try:
            for _ in range(max(1, processes)):
                proc, req, res = _spawn()
                self._procs.append(proc)
                self._reqs.append(req)
                self._ress.append(res)
        except BaseException:
            self._stop()
            raise
        # sends go through a thread, so a full pipe never blocks the caller
        self._out: queue.Queue = queue.Queue()
        self._sender = threading.Thread(target=self._send_loop, daemon=True,
                                        name="audit-send")
        self._sender.start()
        self._tickets = itertools.count()
        self._floor = 0              # tickets of runs that ended are below it
        self._parts: dict[int, int] = {}        # ticket -> its parts
        self._done: dict[tuple, dict] = {}      # (ticket, part) -> rows
        self._dropped: set[int] = set()
        self._next = 0               # the worker the next part goes to
        # the run's parts, (ticket, part) -> [worker, windows, sent, solved],
        # and calls, (worker, start, end, windows): wall clock (time.time)
        self._part_log: dict[tuple, list] = {}
        self._call_log: list[tuple] = []
        self._ready = 0
        self.ready = False
        self.leaked: list[str] = []
        self.startup: dict = {}
        self.error: str | None = None
        self._lost: str | None = None   # a broken pipe, noted by the sender
        self.worker_s = 0.0
        self.calls = 0

    def _send_loop(self) -> None:
        while True:
            item = self._out.get()
            if item is None:
                return
            to, msg = item
            try:
                for i in to:
                    self._reqs[i].send(msg)
            except (OSError, ValueError) as e:
                # recorded by _drain, after what the worker sent before it
                # went: its own error, if it sent one, wins
                self._lost = self._lost or f"an audit worker stopped reading: {e}"
                return

    def build(self, spec: tuple) -> None:
        """Send the ladder, ``TierLadder.spec()``'s plain values."""
        self._out.put((range(len(self._reqs)), ("build", spec)))

    def submit(self, sample, tier0_only: bool = False) -> int:
        """Queue one sample for the whole ladder (tier 0 alone with
        ``tier0_only``): a dense ``WindowBatch``, or a paged one made by
        :func:`sample_pages` (each part carries its pool, unpacked in the
        worker); returns its ticket. Never blocks."""
        import numpy as np

        t = next(self._tickets)
        paged = getattr(sample, "pool", None) is not None
        rows = (sample.table, sample.lens, sample.nsegs) if paged else (
            sample.seqs, sample.lens, sample.nsegs)
        arrays = tuple(np.ascontiguousarray(a) for a in rows)
        extra = ()
        if paged:
            extra = (np.ascontiguousarray(sample.pool), (
                sample.shape.depth, sample.shape.seg_len, sample.family.page_len))
        n, nw = len(arrays[2]), len(self._reqs)
        k = max(1, min(nw, n // PART_WINDOWS))
        cuts = np.linspace(0, n, k + 1).astype(int)
        self._parts[t] = k
        now = time.time()
        for i in range(k):
            part = tuple(np.ascontiguousarray(a[cuts[i]:cuts[i + 1]]) for a in arrays)
            if paged:
                part = (extra[0], *part, extra[1])
            to = (self._next + i) % nw
            self._part_log[(t, i)] = [to, int(cuts[i + 1] - cuts[i]), now, None]
            self._out.put(((to,), ("solve", (t, i), part, bool(tier0_only))))
        self._next = (self._next + k) % nw
        return t

    def alive(self) -> bool:
        """Whether every worker runs and none has reported an error."""
        self._drain(0)
        return self.error is None and all(p.poll() is None for p in self._procs)

    def forget(self) -> None:
        """End a run: drop the rows it did not take, and those still on
        their way (tickets below the next one are ignored when they come)."""
        self._floor = next(self._tickets)
        self._tickets = itertools.count(self._floor)
        self._parts.clear()
        self._done.clear()
        self._dropped.clear()
        self._part_log.clear()
        self._call_log.clear()

    def discard(self, ticket: int) -> None:
        """Forget a ticket whose batch will not be compared."""
        for i in range(self._parts.pop(ticket, 0)):
            self._done.pop((ticket, i), None)
        self._dropped.add(ticket)

    def _take(self, msg, worker: int) -> None:
        kind = msg[0]
        if kind == "ready":
            self._ready += 1
            self.ready = self._ready == len(self._procs)
            self.leaked = sorted(set(self.leaked) | set(msg[1]))
            self.startup = {k: max(v, self.startup.get(k, v)) for k, v in msg[2].items()}
        elif kind == "done":
            _, done, secs, t_end, n = msg
            self.worker_s += secs
            self.calls += 1
            self._call_log.append((worker, t_end - secs, t_end, n))
            for (t, i), r in done:
                if t >= self._floor and t not in self._dropped:
                    self._done[(t, i)] = r
                    if (t, i) in self._part_log:
                        self._part_log[(t, i)][3] = t_end
        else:
            self.error = msg[1]

    def _drain(self, timeout: float) -> None:
        """Take every message that arrives within ``timeout``; note a
        worker that is gone. A worker writes its error and then exits, so
        its exit (or a pipe it no longer reads) can be seen after a wait
        that found its message not yet there: every pipe is then read to
        its end before the exit is recorded, and the worker's own error is
        the one kept."""
        try:
            while True:
                ready = wait(self._ress, timeout)
                if not ready:
                    break
                for conn in ready:
                    self._take(conn.recv(), self._ress.index(conn))
                timeout = 0
        except (EOFError, OSError):
            pass
        gone = [proc.returncode for proc in self._procs if proc.poll() is not None]
        if gone or self._lost is not None:
            for i, conn in enumerate(self._ress):
                try:
                    while conn.poll(0):
                        self._take(conn.recv(), i)
                except (EOFError, OSError):
                    pass
            if self.error is None:
                self.error = self._lost or f"an audit worker exited (code {gone[0]})"

    def _wait(self, until, deadline_s: float) -> None:
        """Receive messages until ``until()`` holds. Raises
        :class:`AuditWorkerError` when the worker reported an error, exited
        or stayed silent past ``deadline_s``."""
        t0 = time.perf_counter()
        while not until():
            if self.error is not None:
                raise AuditWorkerError(self.error)
            left = deadline_s - (time.perf_counter() - t0)
            if left <= 0:
                raise AuditWorkerError(f"no answer within {deadline_s:.0f} s")
            self._drain(min(left, 0.5))

    def _back(self, ticket: int) -> bool:
        return all((ticket, i) in self._done for i in range(self._parts[ticket]))

    def done(self, ticket: int) -> bool:
        """Whether ``ticket``'s rows are back (or the worker failed, so
        :meth:`result` will not wait), without waiting."""
        self._drain(0)
        return self._back(ticket) or self.error is not None

    def result(self, ticket: int, deadline_s: float) -> dict:
        """The reference rows of ``ticket``'s sample (numpy, the keys of
        ``tiers.unpack_result``), waiting for them if need be."""
        import numpy as np

        self._wait(lambda: self._back(ticket), deadline_s)
        parts = [self._done.pop((ticket, i)) for i in range(self._parts.pop(ticket))]
        return {k: (np.concatenate([p[k] for p in parts]) if np.ndim(v)
                    else max(p[k] for p in parts)) for k, v in parts[0].items()}

    def anatomy(self, since: float) -> dict:
        """The audit's tail from ``since`` (wall clock, the moment a run's
        final flush began): each worker's backlog then (the windows sent to
        it and not back), the call it was running then (its windows, how
        long it had run and had left), and the seconds from send to solved
        of each part sent since (None: never back)."""
        nw = len(self._procs)
        queued = [0] * nw
        for wk, n, sent, back in self._part_log.values():
            if sent < since and (back is None or back > since):
                queued[wk] += n
        running = [None] * nw
        for wk, t0, t1, n in self._call_log:
            if t0 <= since < t1:
                running[wk] = {"windows": n, "ran_s": round(since - t0, 4),
                               "left_s": round(t1 - since, 4)}
        tail = sorted((sent - since, wk, n, None if back is None else back - sent)
                      for wk, n, sent, back in self._part_log.values() if sent >= since)
        return {"queued_windows": queued, "running": running,
                "tail_parts": [{"sent_s": round(a, 4), "worker": wk, "windows": n,
                                "back_s": None if b is None else round(b, 4)}
                               for a, wk, n, b in tail]}

    def close(self) -> None:
        """Stop the workers (``stop``, then a kill after two seconds) and
        release their pipes."""
        self._out.put((range(len(self._reqs)), ("stop",)))
        self._out.put(None)
        self._sender.join(2.0)
        self._stop()

    def _stop(self) -> None:
        t0 = time.perf_counter()
        for proc in self._procs:
            try:
                proc.wait(max(0.0, 2.0 - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(5.0)
        for conn in self._reqs + self._ress:
            conn.close()


_shared: AuditWorker | None = None
_shared_lock = threading.Lock()


def shared() -> AuditWorker:
    """The process's audit workers: they start at the first run that audits
    in workers and serve every later run, and are started again when one
    has died or failed. They are closed when the process exits."""
    global _shared
    with _shared_lock:
        if _shared is not None and not _shared.alive():
            _shared.close()
            _shared = None
        if _shared is None:
            _shared = AuditWorker()
        return _shared


@atexit.register
def close_shared() -> None:
    """Stop the process's audit workers (at exit; the next :func:`shared`
    starts new ones)."""
    global _shared
    with _shared_lock:
        if _shared is not None:
            _shared.close()
            _shared = None


if __name__ == "__main__":
    _main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4]))
