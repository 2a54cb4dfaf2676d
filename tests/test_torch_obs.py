"""The port's metrics registry, saturation profiler, Prometheus exposition
and content digests (``daccord_tpu_torch/utils/obs.py``) against the JAX
package's (``daccord_tpu/utils/obs.py``), on the same inputs made from a
seed: both must give the same gauges, verdicts, rollups, text and digests.
"""

import numpy as np
import pytest

from daccord_tpu.kernels import paging as jax_paging
from daccord_tpu.kernels import tensorize as jax_tensorize
from daccord_tpu.utils import obs as jax_obs
from daccord_tpu_torch.kernels import paging, tensorize
from daccord_tpu_torch.utils import obs

WALLS = (0.0, 1e-12, 0.5, 3.0, 10.0)


@pytest.mark.parametrize("wall", WALLS)
def test_saturation_and_verdict_equal_the_jax_functions(wall):
    """A grid of blocked/busy walls at each run wall, 0 and walls over the
    total included, with and without a stage table (decode-dominated,
    realign-dominated, stall-dominated)."""
    tables = (None, {}, {"decode": {"wall_s": 2.0}, "realign": {"wall_s": 1.0}},
              {"realign": {"wall_s": 5.0}, "pack": {"wall_s": 0.5}},
              {"stall": {"wall_s": 4.0}, "decode": {"wall_s": 0.1}})
    for blocked in (0.0, 0.2, 1.0, 4.0, 12.0, -1.0):
        for busy in (0.0, 0.3, 2.5, 9.0, 25.0):
            g = obs.saturation_gauges(wall, blocked, busy)
            assert g == jax_obs.saturation_gauges(wall, blocked, busy)
            for st in tables:
                assert obs.bottleneck_verdict(g, st) == jax_obs.bottleneck_verdict(g, st)
    assert (obs.VERDICT_BLOCKED_FRAC, obs.VERDICT_IDLE_FRAC, obs.FEEDER_STAGES) == (
        jax_obs.VERDICT_BLOCKED_FRAC, jax_obs.VERDICT_IDLE_FRAC, jax_obs.FEEDER_STAGES)


def _fill(reg, rng, n_obs: int) -> None:
    """One fixed sequence of registry operations, driven by ``rng``."""
    for i in range(n_obs):
        reg.counter("dispatches").inc()
        if i % 3 == 0:
            reg.counter("fetch_calls").inc(int(rng.integers(1, 4)))
        reg.gauge("rss_mb").set(float(rng.uniform(100, 900)))
        reg.histogram("batch_turnaround_s").observe(float(rng.exponential(0.05)))
        if i % 7 == 0:
            reg.histogram("flush_rows").observe(int(rng.integers(1, 2048)))
    reg.gauge("windows_per_sec").set(12345.678)
    reg.histogram("empty_s")


@pytest.mark.parametrize("n_obs", [0, 5, 600, 2000])
def test_registry_rollup_equals_the_jax_registry(n_obs, tmp_path):
    """Up to 2000 observations: past the 512-sample reservoir the seeded
    replacement draws must match too, so the quantiles stay equal."""
    port, jax = obs.MetricsRegistry(), jax_obs.MetricsRegistry()
    _fill(port, np.random.default_rng(11), n_obs)
    _fill(jax, np.random.default_rng(11), n_obs)
    assert port.rollup() == jax.rollup()
    h, jh = port.histogram("batch_turnaround_s"), jax.histogram("batch_turnaround_s")
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    assert h.buckets == jh.buckets
    # the metrics snapshot event carries the same dicts
    a, b = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    with obs.JsonlLogger(str(a)) as la, jax_obs.JsonlLogger(str(b)) as lb:
        port.snapshot(la, final=True)
        jax.snapshot(lb, final=True)
    import json

    ra, rb = json.loads(a.read_text()), json.loads(b.read_text())
    for rec in (ra, rb):
        rec.pop("t"), rec.pop("ts")
    assert ra == rb


@pytest.mark.parametrize("labels", [None, {"shard": 3}, {"shard": 0, "host": "a\"b"}])
def test_render_prom_is_byte_equal_to_the_jax_rendering(labels):
    reg = obs.MetricsRegistry()
    _fill(reg, np.random.default_rng(5), 40)
    roll = reg.rollup()
    roll["counters"]["weird name!"] = 2
    roll["hists"]["lat_s"] = {"count": 3, "sum": 1.5, "p50": 0.4, "p95": 0.9, "p99": None}
    for verdict in (None, "", "host_feeder", "device"):
        r = dict(roll)
        if verdict is not None:
            r["verdict"] = verdict
        text = obs.render_prom(r, labels=labels)
        assert text == jax_obs.render_prom(r, labels=labels)
        assert text == obs.render_prom(r, prefix="daccord", labels=labels)
        assert obs.render_prom(r, prefix="x-y") == jax_obs.render_prom(r, prefix="x-y")
        samples, errs = obs.parse_prom(text)
        assert errs == [] and samples == jax_obs.parse_prom(text)[0]
        if verdict:
            lab, val = samples["daccord_bottleneck_verdict"][0]
            assert f'verdict="{verdict}"' in lab and val == 1.0


@pytest.mark.parametrize("text", [
    # the JAX test's malformed exposition
    "daccord_x 1.5\nnot a sample line at all\ndaccord_y NaN\n# TYPE daccord_ghost gauge\n",
    "# TYPE daccord_x gauge\ndaccord_x 1.5\n",
    "daccord_x one-point-five\n",
    "# TYPE a\n# TYPE b sometype\nb 1\nc{l=\"1\"} inf\nd{l=\"2\"} -3e-4\n# HELP d x\n\n",
])
def test_parse_prom_equals_the_jax_parser(text):
    assert obs.parse_prom(text) == jax_obs.parse_prom(text)


def _batch(rng, pkg_tensorize, B=24, D=8, L=32):
    seqs = rng.integers(0, 4, size=(B, D, L)).astype(np.int8)
    lens = rng.integers(0, L + 1, size=(B, D)).astype(np.int32)
    nsegs = rng.integers(0, D + 1, size=B).astype(np.int32)
    for i in range(B):
        lens[i, nsegs[i]:] = 0
        for d in range(D):
            seqs[i, d, lens[i, d]:] = 4
    return pkg_tensorize.WindowBatch(
        seqs=seqs, lens=lens, nsegs=nsegs,
        shape=pkg_tensorize.BatchShape(depth=D, seg_len=L, wlen=40),
        read_ids=rng.integers(0, 1000, size=B).astype(np.int64),
        wstarts=rng.integers(0, 5000, size=B).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_digests_equal_the_jax_digests(seed):
    b = _batch(np.random.default_rng(seed), tensorize)
    jb = _batch(np.random.default_rng(seed), jax_tensorize)
    assert obs.row_digests(b) == jax_obs.row_digests(jb)
    assert obs.batch_digest(b) == jax_obs.batch_digest(jb)
    # paging keeps every row's digest (the port's pack against the JAX one)
    fam = paging.ShapeFamily(depth=8, pages=16, page_len=16)
    jfam = jax_paging.ShapeFamily(depth=8, pages=16, page_len=16)
    assert obs.row_digests(paging.pack_paged(b, fam)) == jax_obs.row_digests(
        jax_paging.pack_paged(jb, jfam)) == obs.row_digests(b)
    rng = np.random.default_rng(seed + 100)
    out = {"cons": rng.integers(0, 4, size=(24, 48)).astype(np.int8),
           "cons_len": rng.integers(30, 49, size=24).astype(np.int32),
           "solved": rng.random(24) < 0.8}
    assert obs.result_digest(out) == jax_obs.result_digest(out)
    assert obs.result_digest(out, rows=[0, 5, 7]) == jax_obs.result_digest(out, rows=[0, 5, 7])
    moved = dict(out, cons=out["cons"].copy())
    j = int(np.nonzero(out["solved"])[0][0])
    moved["cons"][j, 0] ^= 1
    assert obs.result_digest(moved) != obs.result_digest(out)


def test_device_probes_are_none_on_the_cpu():
    assert obs.device_peak_bytes("cpu") is None
    assert obs.measure_rtt_s(device="cpu") is None
