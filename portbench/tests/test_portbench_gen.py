"""The generator and the traffic: one seed gives the same inputs, another
seed other inputs of the same shape; every seed sends the same block
sizes."""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import gen  # noqa: E402
from portbench.kinds import closed_jobs  # noqa: E402


def config(name: str, windows: int = 1024) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as fh:
        return dict(json.load(fh), pool_windows=windows)


def same(p, q) -> bool:
    return (p.buckets.keys() == q.buckets.keys() and p.profile == q.profile
            and all(np.array_equal(getattr(p.buckets[d], f), getattr(q.buckets[d], f))
                    for d in p.buckets for f in ("seqs", "lens", "nsegs", "read_ids", "wstarts")))


@pytest.mark.parametrize("name", ["ecoli_clr_100x"])
def test_one_seed_one_pool_and_another_seed_another(name):
    cfg = config(name)
    big = 2**31 + 77
    a, b, c = gen.make_pool(cfg, big), gen.make_pool(cfg, big), gen.make_pool(cfg, big + 1)
    assert same(a, b)
    assert not same(a, c)
    assert a.size == c.size == cfg["pool_windows"]


@pytest.mark.parametrize("name", ["ecoli_clr_100x"])
def test_windows_hold_the_read_and_route_to_the_smallest_bucket(name):
    cfg = config(name)
    pool = gen.make_pool(cfg, 5)
    depths = sorted(pool.buckets)
    for d, b in pool.buckets.items():
        assert b.seqs.shape[1:] == (d, cfg["seg_len"])
        assert (b.nsegs >= cfg["dbg"]["min_depth"]).all() and (b.nsegs <= d).all()
        lower = [x for x in depths if x < d]
        assert not lower or (b.nsegs > max(lower)).all()
        # the A read's own 40 bases lead every window; the rest is padded
        assert (b.lens[:, 0] == cfg["w"]).all()
        filled = np.arange(d)[None, :] < b.nsegs[:, None]
        assert ((b.lens > 0) == filled).all()
        pos = np.arange(cfg["seg_len"])[None, None, :]
        assert ((b.seqs == gen.PAD) == (pos >= b.lens[:, :, None])).all()
    # the measured rates are the simulator's CLR mix
    assert abs(pool.profile["p_del"] - cfg["p_del"]) < 0.005
    assert abs(pool.profile["p_sub"] - cfg["p_sub"]) < 0.005


def test_every_seed_sends_the_same_block_sizes_in_its_own_order():
    traffic = dict(rows_min=16, rows_max=1024)
    sizes = {16: 500, 32: 30000}
    a = closed_jobs.Stream(0, sizes, traffic, 2**31 + 3)
    b = closed_jobs.Stream(0, sizes, traffic, 2**31 + 3)
    c = closed_jobs.Stream(0, sizes, traffic, 9)
    blocks = [a.next() for _ in range(600)]
    assert blocks == [b.next() for _ in range(600)]
    assert sorted(a.sizes) == sorted(c.sizes) and list(a.sizes) != list(c.sizes)
    assert abs(closed_jobs.block_sizes(16, 1024).mean() - 242) < 1
    for d, lo, hi in blocks:
        assert 0 <= lo < hi <= sizes[d]

