"""The traced slice's reading, on a made-up trace shaped as the profiler's
chrome trace of two ladder calls (one with an escalation)."""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import roofline, trace  # noqa: E402

W = "void position_weights_kernel<2, 256>(int const*)"
DP64 = "void dp_backtrack_kernel<2, 32, 2>(float const*)"
DP256 = "void dp_backtrack_kernel<2, 128, 4>(float const*)"
RS = "void rescore_kernel<1, 3>(signed char const*)"
OTHER = "void at::native::vectorized_elementwise_kernel<4>(int)"


def cfg() -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", "ecoli_clr_100x.json")) as fh:
        return json.load(fh)


def events():
    ev, t = [], [0.0]

    def k(name, corr, grid, dur=10.0, cat="kernel", **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": 1e6 + t[0], "dur": dur,
                   "args": {"stream": 7, "correlation": corr, "grid": [grid, 1, 1], **args}})
        t[0] += dur + 1.0

    def api(name, corr):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": name, "ts": 1e6, "dur": 1.0,
                   "args": {"correlation": corr}})

    for corr, esc in ((10, None), (20, 21)):
        k("Memcpy HtoD (Pageable -> Device)", corr - 1, 1, cat="gpu_memcpy", bytes=4194304)
        api("cudaMemcpyAsync", corr - 1)
        api("cudaGraphLaunch", corr)
        k(OTHER, corr, 100)
        k(W, corr, 792)
        k(DP64, corr, 2048, dur=160.0)
        k(RS, corr, 512)
        t[0] += 500.0          # an idle gap: the count read
        if esc:
            api("cudaGraphLaunch", esc)
            for dp in (DP64, DP64, DP256):
                k(W, esc, 128)
                k(dp, esc, 128, dur=30.0)
                k(RS, esc, 32)
    return ev


def test_launches_are_attributed_to_calls_and_tiers():
    parsed = trace.parse(events())
    tiers = np.array([0] * 1990 + [1] * 5 + [3] * 3 + [-1] * 2, np.int32)
    calls = [dict(depth=32, width=2048, real=2000, seg_bases=np.full(2000, 1000, np.int64),
                  tier=tiers) for _ in range(2)]
    ls, why = trace.launches(parsed, calls, cfg())
    assert why == "" and len(ls) == 3 + 3 + 9
    assert [x["tier"] for x in ls] == [0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3]
    dp = [x for x in ls if x["kernel"] == "dp_backtrack"]
    assert [(x["M"], x["P"], x["B"]) for x in dp] == [(64, 41, 2048), (64, 41, 2048),
                                                       (64, 39, 128), (64, 37, 128),
                                                       (256, 41, 128)]
    # tier 0's rescore needs every real row's bases; tier 3's the rows no
    # earlier tier solved (tier 3 and the failures)
    rs = [x for x in ls if x["kernel"] == "rescore"]
    want0 = roofline.least_s(roofline.rescore_bytes(2048, 32, 64, 3, 48),
                             roofline.rescore_ops(3, 48, 2000 * 1000))
    want3 = roofline.least_s(roofline.rescore_bytes(128, 32, 64, 3, 48),
                             roofline.rescore_ops(3, 48, 5 * 1000))
    assert rs[0]["least_s"] == pytest.approx(want0) and rs[-1]["least_s"] == pytest.approx(want3)
    for name in ("dp_backtrack", "rescore", "position_weights"):
        assert 0 < roofline.share(ls, name) < 100


def test_calls_that_do_not_line_up_take_the_mean_or_read_nothing():
    parsed = trace.parse(events())
    rec = dict(depth=32, width=2048, real=10, seg_bases=np.ones(10, np.int64),
               tier=np.zeros(10, np.int32))
    # one call counted for the trace's two: both take its depth and bases
    ls, note = trace.launches(parsed, [rec], cfg())
    assert note and len(ls) == 15 and {x["D"] for x in ls} == {32}
    for calls in ([], [dict(rec, tier=None)], [rec, dict(rec, width=512)]):
        ls, why = trace.launches(parsed, calls, cfg())
        assert ls is None and why


def test_busy_time_gaps_and_breakdown():
    parsed = trace.parse(events())
    busy, gaps = trace.busy(parsed["device"])
    dev = parsed["device"]
    span = dev[-1]["end"] - dev[0]["ts"]
    assert 0 < busy < span
    assert busy + sum(e - s for s, e, _ in gaps) == pytest.approx(span)
    b = trace.breakdown(parsed)
    assert b["device_ops"][0][0] == "dp_backtrack_kernel<2, 32, 2>"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert {name for name, _ in b["idle_gaps"]} <= {"before cudaMemcpyAsync",
                                                     "before cudaGraphLaunch"}
