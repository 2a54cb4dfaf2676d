"""The reader of the drain rule's share (``metrics/drain_kept_share.py``),
from hand-built readings: the window's deltas of ``SolveGroup.counters``,
and None where the drains met no batch or the program keeps no such counter
(a parent without the rule). Then over a CPU group with the benchmark's
configuration, driven by the cell's closed-loop jobs: the rule engages, and
the share lies in 0-100."""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import gen, harness  # noqa: E402
from portbench.kinds import closed_jobs  # noqa: E402


def test_the_share_takes_the_windows_deltas():
    g0 = dict(batches=10, drain_batches=40, drain_kept=100)
    g1 = dict(batches=110, drain_batches=340, drain_kept=800)
    got = harness.reader("drain_kept_share")(dict(group0=g0, group1=g1, window_s=50.0))
    assert got == pytest.approx(100.0 * 700 / (700 + 300), rel=1e-12)


def test_the_share_reads_nothing_where_there_is_nothing():
    read = harness.reader("drain_kept_share")
    # a program without the counters: the parent of the rule
    old = dict(batches=10, rows=100, lock_held_ns=5)
    assert read(dict(group0=old, group1=dict(old, batches=20), window_s=50.0)) is None
    # no drain met a batch in the window
    g = dict(batches=10, drain_batches=4, drain_kept=2)
    assert read(dict(group0=g, group1=g, window_s=50.0)) is None
    # drains that took the whole deque every time
    assert read(dict(group0=g, group1=dict(g, drain_batches=9), window_s=50.0)) == 0.0


def test_the_share_over_a_cpu_group_driven_by_the_cells_jobs():
    from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch
    from daccord_tpu_torch.oracle.profile import ErrorProfile
    from daccord_tpu_torch.serve.batcher import SolveGroup

    n_threads = torch.get_num_threads()
    torch.set_num_threads(min(n_threads, 2))
    cfg = dict(harness.load_json(ROOT, "portbench", "configs", "ecoli_clr_100x.json"),
               pool_windows=256)
    pool = gen.make_pool(cfg, 2**31 + 7)
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
    group = SolveGroup("k", ErrorProfile(**pool.profile), pcfg, gcfg)
    try:
        drv = closed_jobs.Driver(group, make_batch,
                                 {d: b.size for d, b in pool.buckets.items()}, traffic, 5)
        drv.start()
        time.sleep(0.5)
        g0, _ = harness.group_reading(group)
        time.sleep(1.5)
        g1, _ = harness.group_reading(group)
        drv.stop()
        assert drv.join(120) and not drv.errors, drv.errors[:3]
        group.drain_all()
        with group._lock:
            c = dict(group.counters)
    finally:
        group.close()
        torch.set_num_threads(n_threads)
    # every batch flushed was drained once
    assert c["drain_batches"] == c["batches"] and c["drain_kept"] > 0
    got = harness.reader("drain_kept_share")(dict(group0=g0, group1=g1, window_s=1.5))
    assert got is not None and 0 <= got <= 100
