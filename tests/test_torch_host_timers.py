"""The solve group's host timers and the tracer they share their
boundaries with, on the CPU.

``utils/obs.py Tracer``: each thread parents its spans under its own open
span; with no log nothing is kept or written; a span's start lies on the
Unix clock a torch profiler's exported trace uses. ``serve/batcher.py
SolveGroup``: driven by four closed-loop job threads and a ticker over a
CPU ladder group (windows of the port's simulator), its time counters keep
their invariants with the events log off and on; with it on, the events
file passes ``tools/trace.py --check`` and every record of a merged batch
carries the batch's id. ``JsonlLogger``: threads that log durable records,
span records and flushes at once neither deadlock nor lose or reorder a
record.
"""

import json
import os
import sys
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch

from daccord_tpu_torch.tools import trace as ttrace
from daccord_tpu_torch.utils import obs


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _records(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


def test_spans_opened_on_eight_threads_get_their_own_threads_parents(tmp_path):
    ev = str(tmp_path / "ev.jsonl")
    log = obs.JsonlLogger(ev, buffer_lines=16, flush_s=1.0)
    tr = obs.Tracer(log)
    start = threading.Barrier(8)
    mine: dict[int, tuple] = {}

    def work(i):
        start.wait()
        outer = tr.open(f"outer{i}")
        kids = []
        for k in range(50):
            with tr.span(f"inner{i}", k=k) as sid:
                assert tr.current() == sid
                kids.append(sid)
            assert tr.current() == outer
            time.sleep(0)
        tr.close(outer)
        assert tr.current() == ""
        mine[i] = (outer, kids)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    log.close()
    recs = _records(ev)
    opens = {r["span"]: r for r in recs if r["event"] == "span_open"}
    assert len(opens) == 8 * 51
    for i, (outer, kids) in mine.items():
        assert opens[outer]["parent"] == "" and opens[outer]["name"] == f"outer{i}"
        assert all(opens[k]["parent"] == outer and opens[k]["name"] == f"inner{i}"
                   for k in kids)
    ts = [r["t"] for r in recs]
    assert ts == sorted(ts)
    assert ttrace.trace_main([ev, "--check", "--no-timeline"]) == 0


def test_unwind_closes_every_threads_open_spans(tmp_path):
    ev = str(tmp_path / "ev.jsonl")
    log = obs.JsonlLogger(ev)
    tr = obs.Tracer(log)
    t = threading.Thread(target=lambda: tr.open("left.open"))
    t.start()
    t.join()
    tr.open("here")
    tr.unwind()
    log.close()
    closes = [r for r in _records(ev) if r["event"] == "span_close"]
    assert sorted(r["name"] for r in closes) == ["here", "left.open"]
    assert all(r["status"] == "abort" for r in closes)
    assert ttrace.trace_main([ev, "--check", "--no-timeline"]) == 0


def test_durable_records_spans_and_flushes_on_many_threads_neither_deadlock_nor_reorder(
        tmp_path):
    """Six threads log durable records (each flushes through) between span
    records on a buffered logger while two more call ``flush()`` over and
    over, the interpreter switching threads every 10 µs: all end, and the
    file holds every record once, in stamping order."""
    ev = str(tmp_path / "ev.jsonl")
    log = obs.JsonlLogger(ev, buffer_lines=16, flush_s=0.001)
    tr = obs.Tracer(log)
    stop = threading.Event()

    def logger(i):
        for k in range(200):
            with tr.span(f"work{i}", k=k):
                if k % 2:
                    log.log("io.fault", domain="sidecar", op=f"t{i}", error=str(k))
                else:
                    log.log("serve.commit", job=f"t{i}", fragments=k, bytes=k)

    def flusher():
        while not stop.is_set():
            log.flush()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        flushers = [threading.Thread(target=flusher, daemon=True) for _ in range(2)]
        loggers = [threading.Thread(target=logger, args=(i,), daemon=True) for i in range(6)]
        for t in flushers + loggers:
            t.start()
        for t in loggers:
            t.join(60)
        stop.set()
        for t in flushers:
            t.join(60)
        assert not any(t.is_alive() for t in flushers + loggers)
    finally:
        stop.set()
        sys.setswitchinterval(old)
    log.close()
    recs = _records(ev)
    assert sum(r["event"] in ("io.fault", "serve.commit") for r in recs) == 6 * 200
    assert sum(r["event"] == "span_close" for r in recs) == 6 * 200
    assert [r["t"] for r in recs] == sorted(r["t"] for r in recs)
    assert [r["ts"] for r in recs] == sorted(r["ts"] for r in recs)
    assert ttrace.trace_main([ev, "--check", "--no-timeline"]) == 0


def test_without_a_log_no_span_is_kept_and_nothing_is_written(monkeypatch, windows):
    recorded = []
    monkeypatch.setattr(obs.JsonlLogger, "span_record",
                        lambda self, *a: recorded.append(a))
    tr = obs.Tracer(None)
    assert not tr.enabled
    assert tr.open("x") is None and tr.past("y", 10) is None
    with tr.span("z") as sid:
        assert sid is None and tr.current() == ""
    assert tr._open == {} and tr.log._buf == [] and recorded == []
    group = _group(windows, None)
    try:
        _drive(group, windows[2], seconds=1.0)
    finally:
        group.close()
    assert group.tracer._open == {} and group.log._buf == [] and recorded == []
    assert group.counters["batches"] > 0 and group.counters["flush_ns"] > 0


def test_a_span_start_lies_within_a_millisecond_of_its_profiler_mirror(tmp_path):
    ev = str(tmp_path / "ev.jsonl")
    log = obs.JsonlLogger(ev)
    tr = obs.Tracer(log)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(8).sum()
        with tr.span("host.span.mirrored"):
            torch.ones(64).cumsum(0)
            time.sleep(0.002)
    log.close()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    tj = json.load(open(path))
    base = int(tj.get("baseTimeNanoseconds", 0))
    ranges = [e for e in tj["traceEvents"] if e.get("name") == "host.span.mirrored"
              and e.get("ph") == "X"]
    assert len(ranges) == 1
    start_ns = base + float(ranges[0]["ts"]) * 1000
    op = next(r for r in _records(ev) if r["event"] == "span_open")
    assert abs(op["ts"] * 1e9 - start_ns) < 1e6
    assert not obs._profiling()


def test_a_session_of_every_thread_shows_another_threads_spans(tmp_path):
    """With the port's all-thread session (``obs.profile_all_threads``) a
    span opened on a thread the session did not start on is mirrored too."""
    tr = obs.Tracer(obs.JsonlLogger(str(tmp_path / "ev.jsonl")))

    def work():
        with tr.span("dispatcher.side"):
            torch.ones(16).sum()

    with obs.profile_all_threads([torch.profiler.ProfilerActivity.CPU]) as prof:
        assert obs._profiling()
        t = threading.Thread(target=work)
        t.start()
        t.join()
    tr.log.close()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    names = [e.get("name") for e in json.load(open(path))["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names == ["dispatcher.side"]


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """The profile, the job config (the CPU ladder at width 64) and the
    tensorized sampled windows of a small simulated set (the port's own
    simulator)."""
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.kernels.tensorize import BatchShape, tensorize_windows
    from daccord_tpu_torch.runtime.pipeline import _sample_windows, estimate_profile_for_shard
    from daccord_tpu_torch.serve.jobs import JobSpec, build_job_config
    from daccord_tpu_torch.sim import SimConfig, make_dataset

    d = str(tmp_path_factory.mktemp("timers"))
    out = make_dataset(d, SimConfig(genome_len=1500, coverage=10, read_len_mean=500,
                                    min_overlap=200, seed=5), name="tm")
    db, las = read_db(out["db"]), LasFile(out["las"])
    spec = JobSpec.from_json({"db": out["db"], "las": out["las"]}, d)
    cfg = build_job_config(spec, "cpu", True, 64, "fused", d, "timers")
    profile = estimate_profile_for_shard(db, las, cfg)
    _, ws = _sample_windows(db, las, cfg, None, None)
    assert len(ws) >= 80, "sample too small"
    shape = BatchShape(depth=cfg.depth, seg_len=cfg.seg_len, wlen=cfg.consensus.w)
    return profile, cfg, tensorize_windows([(0, w) for w in ws], shape)


def _group(windows, log):
    """A CPU ladder group at width 64, 8 batches in flight, auditing 1/64
    of each batch, over ``windows``."""
    from daccord_tpu_torch.serve.batcher import GroupConfig, SolveGroup

    profile, cfg, _ = windows
    return SolveGroup("k", profile, cfg, GroupConfig(backend="cpu", batch=64, max_inflight=8,
                                                     audit_rate=1 / 64), log=log)


def _drive(group, full, seconds: float, jobs: int = 4, min_batches: int = 8) -> None:
    """``jobs`` closed-loop job threads (blocks of 4-40 consecutive rows of
    ``full``, 4 outstanding each, the oldest fetched) and a 50 ms
    ``flush_stale`` ticker over the group for ``seconds`` and until it has
    flushed ``min_batches`` batches (a loaded machine solves slowly), then
    every row drained."""
    from daccord_tpu_torch.kernels.tensorize import slice_batch

    stop = threading.Event()
    errors: list = []

    def job(i):
        rng = np.random.default_rng(i)
        q: deque = deque()
        try:
            while not stop.is_set():
                n = int(rng.integers(4, 41))
                lo = int(rng.integers(0, full.size - n + 1))
                q.append((group.dispatch(f"job{i}", slice_batch(full, lo, lo + n)), n))
                if len(q) >= 4:
                    h, n = q.popleft()
                    assert len(group.fetch(h)["solved"]) == n
            while q:
                h, n = q.popleft()
                assert len(group.fetch(h)["solved"]) == n
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"job{i}: {e!r}")

    def tick():
        while not stop.wait(0.05):
            group.flush_stale(0.05)

    threads = [threading.Thread(target=job, args=(i,)) for i in range(jobs)]
    threads.append(threading.Thread(target=tick))
    for t in threads:
        t.start()
    time.sleep(seconds)
    end = time.monotonic() + 120
    while group.counters["batches"] < min_batches and time.monotonic() < end:
        time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads) and not errors, errors[:3]
    group.drain_all()


@pytest.mark.parametrize("events", [False, True], ids=["no_log", "events_log"])
def test_a_cpu_group_under_four_job_threads_keeps_its_timer_invariants(tmp_path, windows,
                                                                       events):
    ev = str(tmp_path / "g.events.jsonl")
    log = obs.JsonlLogger(ev, buffer_lines=16, flush_s=1.0) if events else None
    t0 = time.perf_counter_ns()
    group = _group(windows, log)
    try:
        _drive(group, windows[2], seconds=2.0)
        with group._lock:
            c, sat = dict(group.counters), dict(group.sat)
    finally:
        group.close()
    wall = time.perf_counter_ns() - t0
    assert c["batches"] > 4 and c["lock_acquires"] > c["batches"]
    assert 0 < c["lock_held_ns"] <= wall
    assert 0 < c["lock_wait_ns"] <= 4 * wall
    assert 0 < c["flush_ns"] <= c["lock_held_ns"]
    assert c["drain_card_wait_ns"] > 0 and c["drain_audit_wait_ns"] > 0
    assert c["drain_card_wait_ns"] + c["drain_audit_wait_ns"] <= c["drain_wait_ns"]
    # one pair of clock reads for both: within a microsecond a drain
    assert abs(c["drain_wait_ns"] / 1e9 - sat["fetch_blocked_s"]) <= 1e-6 * c["batches"]
    assert 0 < c["scatter_ns"] <= c["lock_held_ns"]
    # every call drained, one count read each (no wide rescue)
    assert c["dispatcher_calls"] == c["batches"]
    assert 0 < c["count_reads"] <= c["dispatcher_calls"] and c["count_read_ns"] > 0
    assert 0 < c["dispatcher_idle_ns"] <= wall
    assert 0 < c["build_ns"] < wall
    assert c["ticker_skips"] >= 0
    if not events:
        assert not os.path.exists(ev)
        return
    assert ttrace.trace_main([ev, "--check", "--no-timeline"]) == 0
    recs = _records(ev)
    opens = {r["span"]: r for r in recs if r["event"] == "span_open"}
    closes = {r["span"]: r for r in recs if r["event"] == "span_close"}
    names = {}
    for r in opens.values():
        names.setdefault(r["name"], []).append(r)
    flushes = {r["span"] for r in names["group.flush"]}
    assert len(flushes) == c["batches"]
    # every record of a merged batch carries its id, one of each a batch
    for name in ("ladder.queue", "ladder.call", "ladder.count_read", "ladder.wait",
                 "audit", "group.scatter"):
        ids = [r.get("batch") for r in names[name]]
        assert sorted(ids) == sorted(flushes), name
    # each span's parent is its own thread's open span
    parent = {r["span"]: opens.get(r["parent"], {}).get("name", "") for r in opens.values()}
    assert {parent[r["span"]] for r in names["ladder.call"]} == {"group.flush"}
    assert {parent[r["span"]] for r in names["ladder.count_read"]} == {"ladder.call"}
    assert {parent[r["span"]] for r in names["group.scatter"]} == {"group.drain"}
    assert {parent[r["span"]] for r in names["audit"]} == {"group.drain"}
    assert {parent[r["span"]] for r in names["ladder.wait"]} == {"group.drain"}
    assert {parent[r["span"]] for r in names["group.drain"]} <= {"job.fetch", ""}
    assert [parent[r["span"]] for r in names["group.build"]] == [""]
    assert {r["name"] for r in opens.values() if parent[r["span"]] == "group.build"} == {
        "ladder.build", "solve_path.build"}
    # a job's fetch that waited lists the batches its rows went into
    fetches = [closes[r["span"]] for r in names["job.fetch"]]
    assert fetches and all(set(f["batches"]) <= flushes and f["batches"] for f in fetches)
    assert all(f["lock_wait_us"] >= 0 for f in fetches)
    drains = [r for r in names["group.drain"]]
    assert {r["cause"] for r in drains} <= {"dispatch", "fetch", "ticker", "final"}
