"""The readers of the solve group's host timers, from hand-built
readings: the window's deltas of ``SolveGroup.counters``, and None where
the divisor is 0 or the program keeps no such counter (a parent without
the timers). Then the same readers over a CPU group with the benchmark's
configuration, driven by the cell's closed-loop jobs: the counters they
read keep the invariants the readers rely on, and the shares lie in
0-100."""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import gen, harness  # noqa: E402
from portbench.kinds import closed_jobs  # noqa: E402

G0 = dict(batches=10, lock_held_ns=1_000_000_000, flush_ns=30_000_000,
          drain_wait_ns=2_000_000_000, drain_audit_wait_ns=500_000_000,
          dispatcher_idle_ns=4_000_000_000, count_read_ns=20_000_000, count_reads=10,
          build_ns=7_250_000_000)
G1 = dict(batches=110, lock_held_ns=31_000_000_000, flush_ns=530_000_000,
          drain_wait_ns=12_000_000_000, drain_audit_wait_ns=6_500_000_000,
          dispatcher_idle_ns=24_000_000_000, count_read_ns=220_000_000, count_reads=90,
          build_ns=7_250_000_000)


@pytest.mark.parametrize("name,want", [
    ("group_lock_held_frac", 100.0 * 30.0 / 50.0),
    ("flush_ms", 500.0 / 100),
    ("drain_audit_wait_frac", 100.0 * 6.0 / 10.0),
    ("dispatcher_idle_frac", 100.0 * 20.0 / 50.0),
    ("count_read_ms", 200.0 / 80),
    ("group_build_s", 7.25),
])
def test_a_host_timer_reader_takes_the_windows_deltas(name, want):
    got = harness.reader(name)(dict(group0=G0, group1=G1, window_s=50.0))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["group_lock_held_frac", "flush_ms", "drain_audit_wait_frac",
                                  "dispatcher_idle_frac", "count_read_ms", "group_build_s"])
def test_a_host_timer_reader_reads_nothing_where_there_is_nothing(name):
    read = harness.reader(name)
    # a program without the counters: the parent of the timers
    old = dict(batches=10, rows=100)
    assert read(dict(group0=old, group1=dict(old, batches=20), window_s=50.0)) is None
    # divisors of 0: no window, no batch, no drain wait, no count read, no build
    zero = dict(G0, build_ns=0)
    assert read(dict(group0=zero, group1=zero, window_s=0.0)) is None


def test_the_readers_over_a_cpu_group_driven_by_the_cells_jobs():
    from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch
    from daccord_tpu_torch.oracle.profile import ErrorProfile
    from daccord_tpu_torch.serve.batcher import SolveGroup

    n_threads = torch.get_num_threads()
    torch.set_num_threads(min(n_threads, 2))
    cfg = dict(harness.load_json(ROOT, "portbench", "configs", "ecoli_clr_100x.json"),
               pool_windows=256)
    pool = gen.make_pool(cfg, 2**31 + 5)
    pcfg, gcfg = harness.program_config(cfg, "cpu", 64)
    shape = {d: BatchShape(depth=d, seg_len=cfg["seg_len"], wlen=cfg["w"])
             for d in pool.buckets}

    def make_batch(d, lo, hi):
        b = pool.buckets[d]
        return WindowBatch(seqs=b.seqs[lo:hi], lens=b.lens[lo:hi], nsegs=b.nsegs[lo:hi],
                           shape=shape[d], read_ids=b.read_ids[lo:hi],
                           wstarts=b.wstarts[lo:hi])

    traffic = dict(harness.load_json(ROOT, "portbench", "traffic", "jobs8.json"),
                   jobs=4, rows_min=4, rows_max=40, outstanding=4)
    t0 = time.perf_counter_ns()
    group = SolveGroup("k", ErrorProfile(**pool.profile), pcfg, gcfg)
    try:
        drv = closed_jobs.Driver(group, make_batch,
                                 {d: b.size for d, b in pool.buckets.items()}, traffic, 3)
        drv.start()
        time.sleep(0.5)
        g0, _ = harness.group_reading(group)
        w0 = time.perf_counter()
        time.sleep(1.5)
        g1, _ = harness.group_reading(group)
        window_s = time.perf_counter() - w0
        drv.stop()
        assert drv.join(120) and not drv.errors, drv.errors[:3]
        group.drain_all()
        with group._lock:
            c, sat = dict(group.counters), dict(group.sat)
    finally:
        group.close()
        torch.set_num_threads(n_threads)
    wall = time.perf_counter_ns() - t0
    assert 0 < c["lock_held_ns"] <= wall and 0 < c["build_ns"] < wall
    assert 0 < c["drain_card_wait_ns"] + c["drain_audit_wait_ns"] <= c["drain_wait_ns"]
    assert abs(c["drain_wait_ns"] / 1e9 - sat["fetch_blocked_s"]) <= 1e-6 * c["batches"]
    assert 0 < c["count_reads"] <= c["dispatcher_calls"] == c["batches"]
    ctx = dict(group0=g0, group1=g1, window_s=window_s)
    got = {name: harness.reader(name)(ctx) for name in (
        "group_lock_held_frac", "flush_ms", "drain_audit_wait_frac", "dispatcher_idle_frac",
        "count_read_ms", "group_build_s")}
    assert all(v is not None for v in got.values()), got
    for name in ("group_lock_held_frac", "drain_audit_wait_frac", "dispatcher_idle_frac"):
        assert 0 <= got[name] <= 100, (name, got[name])
    assert got["flush_ms"] > 0 and got["count_read_ms"] > 0
    assert got["group_build_s"] == c["build_ns"] / 1e9
