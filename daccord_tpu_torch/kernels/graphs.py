"""The ladder's stages as CUDA graphs, captured once per shape and replayed.

A ladder call (``kernels/tiers.py``) runs up to three stages, each of fixed
shape and free of host syncs: tier 0 over the batch (a paged batch's page
gather first), the wide overflow rescue at a width EW, and the escalation
tiers at a width E. Eagerly a dense 2048-window call issued about 880
kernels from Python, and the card was busy for about a sixth of the call.
Here each stage is captured as a CUDA graph the first time its shape comes
and replayed from then on: one host call a stage. A call reads one count
after tier 0 (and one after the wide rescue) to pick E and EW from
:func:`widths` and to skip a stage with nothing to do: at most two host
syncs a call. ``torch.cuda.CUDAGraph`` is the port's counterpart of the
JAX package's ``jit`` of the whole ladder.

The graphs live in one cache for the process (:data:`CACHE`), keyed by the
batch's shape and the ladder's parameters, so a second run in the process
captures nothing. Each key owns its static buffers: the uploads land in
them (``non_blocking`` from the host arrays), the stages read them and the
ladder's tables (copied in when the ladder changes), and write the state
and the packed result, which the call clones before it lets another call
in. Every cross-stage value lives in those buffers, never in a graph's own
memory, so all graphs share one memory pool: calls run one at a time (a
lock, and an event that the next call's stream waits on), and a graph's
intermediates are dead once it ends.

The first batch of a shape runs the stage eagerly on the caller's stream
(the warm-up torch asks for before a capture, and that call's result), then
captures it on a side stream that nothing else uses; the replays run on the
caller's stream. Not on the caller's own: on an H100 a capture on the
ladder dispatcher's stream failed with "invalid argument" while the
pipeline's thread ran on, most likely because a pinned host block freed
there records an event on the stream of its last copy (the caching host
allocator's rule), and a record on a capturing stream breaks the capture.
The kernel
wrappers count launches in Python, which a replay does not run: a capture
records what its stage added to the counts, takes it off again (a capture
launches nothing), and each replay adds it. A failed capture or replay
raises; nothing falls back to the eager ladder.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

#: escalation and wide-rescue widths below the batch; the batch is the last
WIDTH_STEPS = (128, 512)


def widths(B: int) -> tuple[int, ...]:
    """The widths a stage may run at for a batch of ``B`` rows."""
    return tuple(w for w in WIDTH_STEPS if w < B) + (B,)


def pick_width(n: int, B: int) -> int:
    """The narrowest of :func:`widths` that holds ``n`` windows."""
    return next(w for w in widths(B) if n <= w or w == B)


def _counter_modules() -> tuple:
    from . import dp_backtrack, gather_pages, heaviest_path, position_weights, rescore

    return (dp_backtrack, heaviest_path, gather_pages, rescore, position_weights)


def launch_counts() -> dict:
    """Every kernel wrapper's counts: {module: (launches, by shape,
    windows by shape)}."""
    return {m: (m.launches, dict(m.launches_by_shape),
                dict(getattr(m, "windows_by_shape", {})))
            for m in _counter_modules()}


def _counts_delta(after: dict, before: dict) -> dict:
    def sub(a: dict, b: dict) -> dict:
        return {k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}

    return {m: (after[m][0] - before[m][0], sub(after[m][1], before[m][1]),
                sub(after[m][2], before[m][2])) for m in after}


def _add_counts(delta: dict, sign: int = 1) -> None:
    for m, (n, by_shape, windows) in delta.items():
        if not n:
            continue
        with m._count_lock:
            m.launches += sign * n
            for k, v in by_shape.items():
                m.launches_by_shape[k] = m.launches_by_shape.get(k, 0) + sign * v
            if windows:
                for k, v in windows.items():
                    m.windows_by_shape[k] = m.windows_by_shape.get(k, 0) + sign * v


class _Graph:
    """One captured stage and the kernel launches a replay stands for."""

    __slots__ = ("graph", "counts")

    def __init__(self, graph, counts: dict):
        self.graph = graph
        self.counts = counts

    def replay(self) -> None:
        try:
            self.graph.replay()
        except torch.cuda.OutOfMemoryError:
            raise
        except RuntimeError as e:
            raise _graph_error("replay", e) from e
        _add_counts(self.counts)


def _graph_error(what: str, e: BaseException):
    """A failed capture or replay as ``KernelError``: deterministic, raised to
    the caller, never retried or failed over, unless its message names an
    error that poisoned the context (the supervisor reads it)."""
    from .nvcc import KernelError

    return KernelError(f"CUDA graph {what} failed: {type(e).__name__}: {e}")


class _Shape:
    """The static buffers of one batch shape and ladder, and its graphs by
    stage: the uploads (``inputs``), the dense tile, lens and nsegs the
    stages read, the ladder's tables, the state (``tiers.new_state``) and
    the packed result."""

    def __init__(self, arrays: tuple, seg_len: int | None, ladder, dev: torch.device):
        from .tiers import new_state

        self.inputs = tuple(torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                                        device=dev) for a in arrays)
        self.lens, self.nsegs = self.inputs[-2], self.inputs[-1]
        B, D = self.lens.shape
        p0 = ladder.params[0]
        self.B = B
        # a paged batch's tile is gathered into a buffer of its own
        self.seqs = (self.inputs[0] if seg_len is None else
                     torch.empty((B, D, seg_len), dtype=torch.int8, device=dev))
        self.tables = {k: torch.empty_like(t) for k, t in ladder.tables.items()}
        self.source = None          # the tables dict last copied in
        self.state = new_state(B, p0.cons_len, dev)
        words = (p0.cons_len + 3) // 4
        self.packed = torch.empty((B, words + 3), dtype=torch.int32, device=dev)
        self.graphs: dict = {}


class GraphCache:
    """The process's ladder graphs by shape (see the module docstring).
    ``capture_s``, ``captures`` and ``replays`` count what it did since it
    was made; :meth:`clear` drops every graph (after a device loss, whose
    poisoned context no graph can run on again)."""

    def __init__(self):
        self._shapes: dict = {}
        self._lock = threading.Lock()
        self._pools: dict = {}
        self._side: dict = {}
        self._last = None            # event after the last call's work
        self._retired: list = []     # what clear() dropped
        self.capture_s = 0.0
        self.captures = 0
        self.replays = 0

    def clear(self) -> None:
        # no lock: a call that hangs on a lost card may hold it forever. The
        # graphs and buffers are kept, not freed: after a kernel trap the
        # context is poisoned, and freeing a graph's memory pool there
        # raises where nothing can catch it
        self._retired.append((self._shapes, self._pools, self._side))
        self._shapes = {}
        self._pools = {}
        self._side = {}
        self._last = None

    def run(self, batch, ladder, tier0_only: bool = False, esc_cap: int | None = None,
            log=None) -> torch.Tensor:
        """The packed result of one ladder call (tier 0 alone with
        ``tier0_only``) over the host ``batch`` on the ladder's card, on the
        current stream, as a tensor of its own. ``esc_cap`` fixes the wide
        rescue at the batch and the escalation at ``esc_cap`` slots and
        reads no count (no host sync at all). ``log`` (a ``JsonlLogger``)
        gets one ``graph.capture`` event a capture."""
        from .tiers import run_ladder, upload_arrays

        dev = ladder.device
        arrays = tuple(np.ascontiguousarray(a) for a in upload_arrays(batch))
        paged = getattr(batch, "pool", None) is not None
        key = (str(dev), ladder.route, tuple(ladder.params), ladder.wide_p0,
               (batch.family.page_len, batch.shape.seg_len) if paged else None,
               tuple((a.shape, a.dtype.str) for a in arrays),
               tuple(sorted((k, tuple(t.shape)) for k, t in ladder.tables.items())))
        with self._lock:
            cur = torch.cuda.current_stream(dev)
            if self._last is not None:
                cur.wait_event(self._last)
            sh = self._shapes.get(key)
            if sh is None:
                sh = self._shapes[key] = _Shape(
                    arrays, batch.shape.seg_len if paged else None, ladder, dev)
            self._load(sh, arrays, ladder)
            run_ladder(lambda name, width: self._stage(sh, ladder, batch, name, width,
                                                      log, key),
                       lambda: self._read_counts(sh), sh.B,
                       1 if tier0_only else len(ladder.params),
                       ladder.wide_p0 is not None and not tier0_only, esc_cap)
            out = sh.packed.clone()
            ev = torch.cuda.Event()
            ev.record(cur)
            self._last = ev
        return out

    # ---- one call ----------------------------------------------------------

    @staticmethod
    def _load(sh: _Shape, arrays: tuple, ladder) -> None:
        """The batch's arrays into the static inputs, and the ladder's
        tables when they are not the last ones copied. The host arrays are
        copied from pageable memory (the driver stages them and returns),
        not through the pinned allocator: a pinned block records CUDA
        events when it is freed, and on a context a kernel trap poisoned
        that record throws where nothing can catch it (a trapped run on an
        H100 aborted so)."""
        for t, a in zip(sh.inputs, arrays):
            t.copy_(torch.from_numpy(a), non_blocking=True)
        if sh.source is not ladder.tables:
            for k, t in ladder.tables.items():
                sh.tables[k].copy_(t)
            sh.source = ladder.tables

    @staticmethod
    def _solve(sh: _Shape, ladder, batch, name: str, width) -> None:
        """One stage over the shape's buffers (a paged batch's gather
        first), then the packed result."""
        from .tiers import pack_result, run_stage, state_result

        if name == "tier0" and getattr(batch, "pool", None) is not None:
            from .paging import gather_windows

            sh.seqs.copy_(gather_windows(sh.inputs[0], sh.inputs[1], sh.lens,
                                         page_len=batch.family.page_len,
                                         seg_len=batch.shape.seg_len))
        params = tuple(ladder.params)
        run_stage(sh.state, name, width, sh.seqs, sh.lens, sh.nsegs,
                  tuple(sh.tables[p.k] for p in params), params, ladder.wide_p0,
                  route=ladder.route)
        sh.packed.copy_(pack_result(state_result(sh.state, sh.B)))

    @staticmethod
    def _read_counts(sh: _Shape) -> list[int]:
        """The call's host sync: the state's two counts to the host."""
        return sh.state["counts"].cpu().tolist()

    def _stage(self, sh: _Shape, ladder, batch, name: str, width, log, key) -> None:
        stage = name if width is None else (name, width)
        g = sh.graphs.get(stage)
        if g is not None:
            g.replay()
            self.replays += 1
            return
        fn = lambda: self._solve(sh, ladder, batch, name, width)   # noqa: E731
        fn()                 # the warm-up, and this call's result
        t0 = time.perf_counter()
        sh.graphs[stage] = self._capture(fn, ladder.device)
        secs = time.perf_counter() - t0
        self.capture_s += secs
        self.captures += 1
        if log is not None:
            log.log("graph.capture", stage=str(stage), key=_describe(key, sh),
                    wall_s=round(secs, 6))

    def _capture(self, fn, dev: torch.device) -> _Graph:
        # the warm-up's errors surface here, before a capture starts: a
        # capture begun on a poisoned context leaves the allocator in
        # capture mode, and its next free aborts the process
        torch.cuda.synchronize(dev)
        if dev not in self._pools:
            self._pools[dev] = torch.cuda.graph_pool_handle()
            self._side[dev] = torch.cuda.Stream(dev)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._side[dev]):
            graph.capture_begin(pool=self._pools[dev], capture_error_mode="thread_local")
            try:
                fn()
            except BaseException as e:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass    # the capture the error invalidated; raise the error
                if isinstance(e, RuntimeError) and not isinstance(
                        e, torch.cuda.OutOfMemoryError):
                    raise _graph_error("capture", e) from e
                raise
            try:
                graph.capture_end()
            except torch.cuda.OutOfMemoryError:
                raise
            except RuntimeError as e:
                raise _graph_error("capture", e) from e
        delta = _counts_delta(launch_counts(), before)
        _add_counts(delta, -1)
        return _Graph(graph, delta)


def _describe(key: tuple, sh: _Shape) -> str:
    shapes = "x".join(str(n) for n in sh.seqs.shape)
    return f"{key[0]}:B{shapes}{':pg' if key[4] else ''}:{key[1]}"


#: the process's graph cache
CACHE = GraphCache()
