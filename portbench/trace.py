"""The traced slice of a ``--trace 1`` run: a ``torch.profiler`` session
over a few seconds of the window, read into per-launch records.

The slice starts and ends with the card drained, under the graph cache's
lock (``kernels/graphs.py CACHE.lock``, which the ladder dispatcher holds
around each call: CUPTI's stop has deadlocked beside a graph replay), so
the program's launch counters read at its two ends count exactly the calls
whose kernels the trace holds. The solve path is wrapped (:class:`PathTap`)
so that each ladder call's merged batch is known (the k-th call the card
runs is the k-th dispatched: one dispatcher thread runs them in order): its
depth, its real rows, their segment bases and, once fetched, the tier each
row solved at. The kernels of a graph replay share its launch's correlation
id: a replay with one DP launch is a call's tier 0, one with a DP launch
for each later tier is that call's escalation; within a replay a W launch
belongs to the tier of the DP launch after it and a rescore launch to the
tier of the DP launch before it. A profiler session now and then records no
device event (``tools/timing.py``): the slice is tried again, up to
:data:`SESSIONS` times while the window lasts.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from . import roofline

SESSIONS = 3
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNELS = ("dp_backtrack_kernel", "rescore_kernel", "position_weights_kernel")


class PathTap:
    """Stands in for a solve group's ``path``: forwards every attribute,
    and records each dispatched batch (:meth:`dispatch`, in the order the
    dispatcher runs them) and its rows' tiers (:meth:`fetch_many`)."""

    def __init__(self, path):
        self._path = path
        self.calls: list[dict] = []
        self._by_handle: dict[int, dict] = {}

    def __getattr__(self, name):
        return getattr(self._path, name)

    def dispatch(self, batch):
        h = self._path.dispatch(batch)
        real = int((batch.nsegs > 0).sum())
        rec = dict(depth=int(batch.shape.depth), width=int(batch.size), real=real,
                   seg_bases=batch.lens[:real].sum(axis=1).astype(np.int64), tier=None)
        self.calls.append(rec)
        self._by_handle[id(h)] = rec
        return h

    def fetch_many(self, handles):
        outs = self._path.fetch_many(handles)
        for h, out in zip(handles, outs):
            rec = self._by_handle.pop(id(h), None)
            if rec is not None:
                rec["tier"] = np.asarray(out["tier"][:rec["real"]])
        return outs


def _tier0_calls(cfg: dict) -> tuple[int, int]:
    """The launch-counter key of tier 0's DP: (M, P)."""
    k = cfg["tiers"][0][0]
    return cfg["max_kmers"], cfg["w"] - k + 1 + cfg["dbg"]["len_slack"]


def dp_calls_done(cfg: dict) -> int:
    """Ladder calls the card has run since the counters were set: tier 0's
    DP launches (the program's ``dp_backtrack.launches_by_shape``)."""
    from daccord_tpu_torch.kernels import dp_backtrack

    return int(dp_backtrack.launches_by_shape.get(_tier0_calls(cfg), 0))


class Slice:
    """One profiler session over part of the window."""

    def __init__(self, cfg: dict, out_dir: str):
        self.cfg = cfg
        self.out_dir = out_dir
        self.wall_s = 0.0
        self.calls0 = self.calls1 = 0

    def _drained(self):
        import torch

        from daccord_tpu_torch.kernels import graphs

        lock = graphs.CACHE.lock
        lock.acquire()
        torch.cuda.synchronize()
        return lock

    def run(self, seconds: float) -> dict | None:
        """Profile ``seconds`` of the window; the parsed trace, or None
        when the session recorded no device event."""
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts)
        lock = self._drained()
        try:
            self.calls0 = dp_calls_done(self.cfg)
            prof.start()
            t0 = time.perf_counter()
        finally:
            lock.release()
        time.sleep(seconds)
        lock = self._drained()
        try:
            prof.stop()
            self.wall_s = time.perf_counter() - t0
            self.calls1 = dp_calls_done(self.cfg)
        finally:
            lock.release()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        prof.export_chrome_trace(path)
        try:
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.remove(path)
        parsed = parse(events)
        return parsed if parsed["device"] else None


def parse(events: list) -> dict:
    """Device events (ts, end in seconds, name, category, stream, grid,
    bytes, correlation) in time order, and the host's runtime calls."""
    dev, host = [], []
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X":
            continue
        a = e.get("args", {})
        if cat in DEVICE_CATS:
            ts = float(e["ts"]) * 1e-6
            dev.append(dict(ts=ts, end=ts + float(e.get("dur", 0.0)) * 1e-6,
                            name=e.get("name", ""), cat=cat, stream=a.get("stream"),
                            grid=a.get("grid"), bytes=a.get("bytes"),
                            corr=a.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            host.append(dict(name=e.get("name", ""), corr=a.get("correlation")))
    dev.sort(key=lambda d: d["ts"])
    return dict(device=dev, host=host)


def busy(dev: list) -> tuple[float, list]:
    """Seconds in which some device operation ran (the union of their
    intervals), and the idle gaps between (start, end, event after)."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for d in dev:
        if cur_e is None:
            cur_s, cur_e = d["ts"], d["end"]
        elif d["ts"] > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, d["ts"], d))
            cur_s, cur_e = d["ts"], d["end"]
        else:
            cur_e = max(cur_e, d["end"])
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def _short(name: str) -> str:
    name = name[5:] if name.startswith("void ") else name
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:96]


def breakdown(parsed: dict) -> dict:
    """The ten device operations that took most time, and the ten longest
    kinds of idle gap, named by the host call that issued the operation
    which ended the gap."""
    by_op: dict[str, float] = {}
    for d in parsed["device"]:
        by_op[_short(d["name"])] = by_op.get(_short(d["name"]), 0.0) + d["end"] - d["ts"]
    api = {h["corr"]: h["name"] for h in parsed["host"] if h["corr"] is not None}
    by_gap: dict[str, float] = {}
    for s, e, d in busy(parsed["device"])[1]:
        key = "before " + api.get(d["corr"], _short(d["name"]))
        by_gap[key] = by_gap.get(key, 0.0) + e - s
    top = lambda m: sorted(([k, v] for k, v in m.items()), key=lambda x: -x[1])[:10]  # noqa: E731
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def _call_work(rec: dict, n_tiers: int) -> dict:
    """A fetched call's depth and, for each tier, the segment bases of the
    rows it solves: every real row at tier 0, then those no earlier tier
    solved."""
    t = rec["tier"]
    need = [int(rec["seg_bases"].sum())] + [
        int(rec["seg_bases"][(t >= i) | (t < 0)].sum()) for i in range(1, n_tiers)]
    return dict(depth=rec["depth"], width=rec["width"], need=need)


def launches(parsed: dict, calls: list, cfg: dict) -> tuple[list[dict] | None, str]:
    """One record for each DP, W and rescore launch of the slice: kernel,
    tier, the shapes, device seconds and the least seconds its shapes and
    rows need. ``calls`` are the merged batches of the slice's ladder calls,
    in order, and the trace's tier-0 replays are matched to them one for
    one. Where the two counts differ (a lost record), every replay takes
    the calls' mean depth and bases instead, and the note says so.
    Returns (records, note), or (None, why) when nothing can be read."""
    # a graph replay's kernels carry its launch's correlation id: one stage
    # of one call a group, tier 0 (one DP launch) or the escalation (one a
    # tier past the first)
    groups: dict = {}
    for d in parsed["device"]:
        if d["cat"] == "kernel" and any(n in d["name"] for n in KERNELS):
            groups.setdefault(d["corr"], []).append(d)
    stages = sorted(groups.values(), key=lambda g: g[0]["ts"])
    L, C = cfg["seg_len"], cfg["dbg"]["n_candidates"]
    CL = cfg["w"] + cfg["dbg"]["len_slack"]
    tiers = []
    for k, mc, _ in cfg["tiers"]:
        M = cfg["rescue_max_kmers"] if mc <= 1 else cfg["max_kmers"]
        tiers.append((k, M, cfg["w"] - k + 1 + cfg["dbg"]["len_slack"],
                      roofline.t_range(k, cfg["w"], cfg["dbg"]["len_slack"])))
    work = [_call_work(c, len(tiers)) for c in calls if c["tier"] is not None]
    if not work:
        return None, "no fetched call in the slice"
    n_dp = [sum("dp_backtrack_kernel" in d["name"] for d in g) for g in stages]
    note = ""
    if n_dp.count(1) != len(work) or len(work) != len(calls):
        note = (f"{n_dp.count(1)} calls in the trace, {len(calls)} counted: "
                "each takes the calls' mean depth and bases")
        mean = dict(depth=float(np.mean([w["depth"] for w in work])), width=None,
                    need=list(np.mean([w["need"] for w in work], axis=0)))
    out = []
    ci = -1
    for g, nd in zip(stages, n_dp):
        if nd == 1:
            ci, first = ci + 1, 0          # a new call's tier 0
        elif nd == len(tiers) - 1 and ci >= 0:
            first = 1                      # the escalation of call ci
        else:
            return None, f"a graph replay with {nd} DP launches after call {ci}"
        rec = mean if note else work[ci]
        dps = [d for d in g if "dp_backtrack_kernel" in d["name"]]
        if first == 0 and rec["width"] is not None and int(dps[0]["grid"][0]) != rec["width"]:
            return None, f"call {ci}: tier 0 ran {dps[0]['grid'][0]} rows, not {rec['width']}"
        seen = 0
        for d in g:
            name = d["name"]
            if "dp_backtrack_kernel" in name:
                ti, seen = first + seen, seen + 1
            elif "position_weights_kernel" in name:
                ti = first + seen
            else:
                ti = first + seen - 1
            if not first <= ti < first + nd:
                return None, f"call {ci}: a {_short(name)} launch outside its tiers"
            k, M, P, (t_lo, t_hi) = tiers[ti]
            B, D = int(dps[ti - first]["grid"][0]), rec["depth"]
            if "dp_backtrack_kernel" in name:
                kernel = "dp_backtrack"
                nb, ops = roofline.dp_backtrack(B, M, P, C, CL, t_hi - t_lo + 1)
            elif "position_weights_kernel" in name:
                kernel = "position_weights"
                nb, ops = roofline.position_weights(B, D, L, k, M, P, cfg["w"] + 16)
            else:
                kernel = "rescore"
                nb = roofline.rescore_bytes(B, D, L, C, CL)
                ops = roofline.rescore_ops(C, CL, rec["need"][ti])
            out.append(dict(kernel=kernel, tier=ti, M=M, P=P, B=B, D=D,
                            dur_s=d["end"] - d["ts"], least_s=roofline.least_s(nb, ops)))
    return out, note
