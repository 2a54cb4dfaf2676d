"""One run of one cell: set-up, the measured window, the check, the line.

The window drives ``daccord_tpu_torch.serve.batcher.SolveGroup``, the
port's cross-job batcher over the pipeline's supervised solve path (the
ladder dispatcher, the supervisor with its shadow audit in worker
processes, the ladder's CUDA graphs and the hand-written kernels), with the
settings of the cell's configuration. The cell's traffic kind
(``kinds/<kind>.py``) drives it from its traffic file; each metric is a
reader in ``metrics/<name>.py``. After the window the group is closed, the
reference (``reference/``) solves every window of the pool and each row a
job fetched is compared with it.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import threading
import time

import numpy as np

from . import gen, trace
from .reference import check, tables

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "daccord_tpu")
TRACE_LEAD_S = 0.3      # share of the window before the traced slice
TRACE_SLICE_S = 2.0     # seconds a profiler session covers
JOIN_S = 120.0          # the longest the jobs may take to fetch what they sent


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The cell's metrics: its end-to-end ones untraced, its per-layer ones
    traced (a metric with ``workloads`` only in the cells it names)."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in bench[key] if workload in m.get("workloads", [workload])]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def leaked() -> list[str]:
    """Modules of JAX or of the JAX package this process holds, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def group_reading(group) -> tuple[dict, int]:
    """The group's counters and the rows its pools hold, read under its
    lock so that the two agree."""
    with group._lock:
        return dict(group.counters), sum(p.rows for p in group._pools.values())


class Sampler:
    """Once a second through the window, what the process and the group
    did: this process's cores in use, the wall the group's drains waited in
    the solve path's fetch, the audit workers' solve wall. Read on standard
    error beside the rate of each second, to tell where a slow second went."""

    def __init__(self, group, worker):
        self.group, self.worker = group, worker
        self.rows: list[tuple] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="sampler")

    def _read(self):
        t = os.times()
        return (time.perf_counter(), t.user + t.system,
                self.group.sat["fetch_blocked_s"],
                self.worker.worker_s if self.worker is not None else 0.0)

    def _run(self):
        last = self._read()
        while not self._stop.wait(1.0):
            now = self._read()
            dt = now[0] - last[0]
            procs = len(self.worker._procs) if self.worker is not None else 1
            self.rows.append(((now[1] - last[1]) / dt, (now[2] - last[2]) / dt,
                              100 * (now[3] - last[3]) / (dt * procs)))
            last = now

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(5.0)

    def lines(self) -> list[str]:
        names = ("this process, cores", "the drains' wait in fetch, s/s",
                 "audit workers busy %")
        return [f"{n} each second: " + " ".join(f"{r[i]:.2f}" for r in self.rows)
                for i, n in enumerate(names)]


def program_config(cfg: dict, backend: str, width: int):
    """The port's PipelineConfig and GroupConfig as the configuration
    states them."""
    from daccord_tpu_torch.oracle.consensus import ConsensusConfig
    from daccord_tpu_torch.oracle.dbg import DBGParams
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig
    from daccord_tpu_torch.serve.batcher import GroupConfig

    cons = ConsensusConfig(w=cfg["w"], adv=cfg["adv"],
                           tiers=tuple(tuple(t) for t in cfg["tiers"]),
                           dbg=DBGParams(**cfg["dbg"]))
    pcfg = PipelineConfig(consensus=cons, batch_size=width, depth=cfg["depth"],
                          seg_len=cfg["seg_len"], max_kmers=cfg["max_kmers"],
                          rescue_max_kmers=cfg["rescue_max_kmers"],
                          overflow_rescue=cfg["overflow_rescue"],
                          depth_buckets=tuple(cfg["depth_buckets"]),
                          max_inflight=cfg["max_inflight"], dp_route=cfg["dp_route"],
                          device=backend, audit_rate=cfg["audit_rate"])
    gcfg = GroupConfig(backend=backend, batch=width, max_inflight=cfg["max_inflight"],
                       dp_route=cfg["dp_route"], audit_rate=cfg["audit_rate"])
    return pcfg, gcfg


def run(root: str, workload: str, seed: int, seconds: float, traced: bool, t_start: float,
        backend: str = "cuda", width: int | None = None, pool_windows: int | None = None,
        ref_processes: int | None = None, log=print, fault=None,
        traffic_over: dict | None = None) -> dict:
    """One run; returns the result line's fields. ``width``,
    ``pool_windows``, ``traffic_over`` (traffic parameters replaced) and
    ``fault`` (a function that wraps the group's solve path) are for the
    CPU tests."""
    bench = load_json(root, "BENCHMARK.json")
    cell = cell_of(bench, workload)
    cfg = load_json(HERE, "configs", f"{cell['config']}.json")
    if pool_windows:
        cfg = dict(cfg, pool_windows=pool_windows)
    traffic = dict(load_json(HERE, "traffic", f"{cell['traffic']}.json"), **(traffic_over or {}))
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    width = width or cfg["batch"]

    import torch

    from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch
    from daccord_tpu_torch.oracle.profile import ErrorProfile
    from daccord_tpu_torch.serve.batcher import SolveGroup

    cuda = backend == "cuda"
    if cuda:
        torch.cuda.init()
        if traced:
            # the process's first profiler session, which now and then
            # records nothing, is set-up's
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
                torch.cuda.synchronize()
    pool = gen.make_pool(cfg, seed)
    pcfg, gcfg = program_config(cfg, backend, width)
    group = SolveGroup("portbench", ErrorProfile(**pool.profile), pcfg, gcfg,
                       name=workload)
    tap = None
    if traced:
        tap = group.path = trace.PathTap(group.path)
    if fault is not None:
        group.path = fault(group.path)
    shape = {d: BatchShape(depth=d, seg_len=cfg["seg_len"], wlen=cfg["w"])
             for d in pool.buckets}

    def make_batch(d, lo, hi):
        b = pool.buckets[d]
        return WindowBatch(seqs=b.seqs[lo:hi], lens=b.lens[lo:hi], nsegs=b.nsegs[lo:hi],
                           shape=shape[d], read_ids=b.read_ids[lo:hi],
                           wstarts=b.wstarts[lo:hi])

    drv = kind.Driver(group, make_batch, {d: b.size for d, b in pool.buckets.items()},
                      traffic, seed)
    worker = group.worker
    joined = False
    sampler = None
    try:
        drv.start()
        while drv.fetched_rows() < traffic["warmup_rows"] and not drv.errors:
            time.sleep(0.005)
        g0, pooled0 = group_reading(group)
        w0 = worker.worker_s if worker is not None else 0.0
        sampler = Sampler(group, worker)
        t0 = time.perf_counter()
        sampler.start()
        setup_s = t0 - t_start
        sl = None
        if traced:
            sl = trace.Slice(cfg, os.path.join(root, "portbench", ".out"))
            time.sleep(TRACE_LEAD_S * seconds)
            parsed = None
            for _ in range(trace.SESSIONS):
                if t0 + seconds - time.perf_counter() < TRACE_SLICE_S:
                    break
                parsed = sl.run(TRACE_SLICE_S)
                if parsed is not None:
                    break
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        t1 = time.perf_counter()
        wall_t1 = time.time()
        w1 = worker.worker_s if worker is not None else 0.0
        g1, pooled1 = group_reading(group)
        sampler.stop()
        drv.stop()
        joined = drv.join(JOIN_S)
        audit = None
        if worker is not None:
            # the parts sent before the close and back after it
            audit = dict(processes=len(worker._procs), worker_s0=w0, worker_s1=w1,
                         queued=sum(worker.anatomy(wall_t1)["queued_windows"]))
    finally:
        if sampler is not None:
            sampler.stop()
        drv.stop()
        drv.join(JOIN_S)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        group.close()
    del group
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    blocks = [rec for recs in drv.records for rec in recs]
    window = []
    for d, lo, hi, ts, te, out in blocks:
        if t0 <= te <= t1:
            sol = np.asarray(out["solved"])
            window.append(dict(latency_s=te - ts, rows=hi - lo, done=te - t0,
                               bases=int(np.asarray(out["cons_len"])[sol].sum())))
    failed = sum(drv.sent) - len(blocks) + (0 if joined else 1)
    attempted = len(window) + failed

    # the reference, once the program's state is gone
    t_ref = time.perf_counter()
    spec = tables.ladder_spec(cfg, pool.profile)
    procs = ref_processes if ref_processes is not None else min(8, os.cpu_count() or 1)
    ref = check.solve_pool(spec, pool.buckets, procs)
    cmp = check.compare([(d, lo, hi, out) for d, lo, hi, _, _, out in blocks], ref)
    ref_s = time.perf_counter() - t_ref

    tctx = None
    if traced and parsed is None:
        log("the profiler recorded no device event in any session")
    if traced and sl is not None and parsed is not None:
        busy_s, _ = trace.busy(parsed["device"])
        calls = tap.calls[sl.calls0:sl.calls1]
        recs, note = trace.launches(parsed, calls, cfg)
        if note:
            log(f"kernel launches: {note}")
        tctx = dict(parsed=parsed, wall_s=sl.wall_s, busy_s=busy_s,
                    calls=sl.calls1 - sl.calls0, launches=recs)
    ctx = dict(cfg=cfg, traffic=traffic, window_s=t1 - t0, setup_s=setup_s,
               window_blocks=window, group0=g0, group1=g1, pooled0=pooled0, pooled1=pooled1,
               width=width, audit=audit,
               trace=tctx, memory_peak_bytes=peak)
    metrics = {}
    for m in metrics_of(bench, workload, traced):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    lat = np.array([b["latency_s"] for b in window]) * 1e3
    if len(lat):
        log(f"blocks in the window: {len(lat)}, latency median {np.median(lat):.3f} ms, "
            f"p95 {np.percentile(lat, 95):.3f} ms, rows {sum(b['rows'] for b in window)}")
        per_s = np.bincount(np.array([int(b["done"]) for b in window]),
                            weights=[b["bases"] for b in window])
        log(f"consensus bases in each second of the window (M): "
            f"{' '.join(f'{x / 1e6:.2f}' for x in per_s)}")
        for line in sampler.lines():
            log(line)
    log(f"pool: {pool.size} windows {({d: b.size for d, b in pool.buckets.items()})} from "
        f"{pool.piles} piles of {pool.reads} reads, profile {pool.profile}; reference "
        f"{ref_s:.2f} s on {procs} processes")
    if drv.errors:
        log(f"job errors: {drv.errors[:4]}")
    if cmp.first:
        log(f"first difference: {cmp.first}")
    checks = {"windows_differing": {"value": cmp.windows, "limit": check.WINDOWS_LIMIT,
                                    "rule": "at most"},
              "err_rel_gap": {"value": cmp.err_gap if np.isfinite(cmp.err_gap) else "inf",
                              "limit": check.ERR_LIMIT, "rule": "at most"},
              "blocks_failed": {"value": failed, "limit": 0, "rule": "at most"},
              "rows_compared": {"value": cmp.rows, "limit": 1, "rule": "at least"}}
    correct = (cmp.windows <= check.WINDOWS_LIMIT and cmp.err_gap <= check.ERR_LIMIT
               and failed == 0 and cmp.rows >= 1 and not drv.errors)
    res = dict(correct=bool(correct), attempted=int(attempted), failed=int(failed),
               metrics=metrics, peak=peak, checks=checks)
    if tctx is not None:
        res["busy_s"], res["window_s"] = tctx["busy_s"], tctx["wall_s"]
        res["breakdown"] = trace.breakdown(parsed)
    return res
