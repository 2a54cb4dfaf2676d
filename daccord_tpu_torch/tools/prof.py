"""daccord-prof: saturation-profiler reader — stage flame table, checks, diffs.

The port's copy of ``daccord_tpu/tools/prof.py``.

The pipeline's always-on saturation profiler stamps every run
with a per-stage host-feeder decomposition (``shard_done.stages`` + periodic
``stage.profile`` events), device starvation gauges (``device_idle_frac``,
``host_blocked_frac``, ``overlap_frac``), and a committed bottleneck verdict
(``host_feeder | device | io | balanced`` with the dominant feeder sub-stage
named). This tool is the one reader of all of it:

- **Flame table** (default): per-source stage walls with share-of-host bars,
  the starvation gauges, and the verdict — the "where does the wall-clock
  go" screen. The table renderer (:func:`stage_table`) is shared with
  ``daccord-trace``'s wall decomposition, so the two tools can never print
  different numbers for the same run.

- **Reconciliation** (``--check``, exit 1 on violation — the pounce gate):
  stage sums must agree with the run's own anchors within 5% / 50 ms —
  the feeder sub-stages against the pipeline-visible blocked-on-feeder wall
  (scaled by the feeder thread count: a pool's thread-summed walls
  legitimately exceed the overlapped wall), the full stage sum against
  ``host_s``, and ``host_s + device_s`` against ``wall_s``. Honest
  telemetry reconciles by construction; a drifted timer or a torn sidecar
  does not.

- **Diff** (``--diff A B``): stage-by-stage wall/share deltas between two
  runs — how the ROADMAP item-2 device-ingest PR proves its win against
  the committed baseline with the same tool that measured it.

Inputs: events jsonl files (``shard_done`` is authoritative; an aborted
run's last ``stage.profile`` snapshot is the fallback), committed
``*.metrics.json`` rollups (``stage_<name>_s`` gauges), bench/feeder
sidecars (``BENCH_*.json`` / ``FEEDER_r*.json``, wrapper or bare), or
directories of any of them.

Usage::

    daccord-prof out/                      # flame table per shard
    daccord-prof --check run.events.jsonl  # pounce reconciliation gate
    daccord-prof --diff base.events.jsonl fast.events.jsonl
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from .trace import _read_jsonl, _segments

#: stages that decompose the FEEDER span (the block-iterator __next__):
#: everything the StageProfile books except `pack`, which runs at dispatch
#: assembly in the pile loop, outside the feeder wall
FEEDER_SUBSTAGES = ("decode", "rank", "realign", "kmer", "tensorize",
                    "stall")

#: reconciliation tolerance: 5% of the anchor, floored at 50 ms (the
#: acceptance bound) — near-zero anchors (a toy corpus's 20 ms feeder) must
#: not flag on timer granularity
TOL_FRAC = 0.05
TOL_ABS = 0.05

#: staged-dispatch sub-walls: host-only decomposition of the
#: dispatch wall — pad/pack assembly, per-device shard transfer, jit call.
#: Like `pack` they are NOT feeder sub-stages (staging runs on its own
#: thread, outside the feeder wall); they reconcile against dispatch_s.
DISPATCH_SUBWALLS = ("pack_s", "stage_s", "launch_s")


def _tol(anchor: float) -> float:
    return max(TOL_FRAC * max(anchor, 0.0), TOL_ABS)


def _dispatch_walls(payload: dict) -> dict | None:
    """The pack/stage/launch sub-wall dict carried by a shard_done record or
    a MULTICHIP bench rung payload, or None when the run predates (or never
    ran) the staged dispatch path."""
    dw = {k: float(payload[k]) for k in DISPATCH_SUBWALLS
          if isinstance(payload.get(k), (int, float))}
    return dw or None


def profile_from_events(records: list[dict], src: str = "") -> dict | None:
    """Normalized profile of one events file's LAST completed segment
    (``shard_done`` authoritative), falling back to the segment's last
    ``stage.profile`` snapshot for aborted runs. None when the file carries
    neither (fleet/bench sidecars)."""
    for seg in reversed(_segments(records)):
        done = next((r for r in reversed(seg)
                     if r.get("event") == "shard_done"), None)
        snap = next((r for r in reversed(seg)
                     if r.get("event") == "stage.profile"), None)
        if done is None and snap is None:
            continue
        if done is not None and isinstance(done.get("stages"), dict):
            bn = done.get("bottleneck") or {}
            return {"src": src, "partial": False,
                    "wall_s": done.get("wall_s"),
                    "device_s": done.get("device_s"),
                    "host_s": done.get("host_s"),
                    "feeder_s": done.get("feeder_s"),
                    "dispatch_s": done.get("dispatch_s"),
                    "dispatch_walls": _dispatch_walls(done),
                    "threads": int(done.get("stage_threads") or 1),
                    "stages": {k: float(v)
                               for k, v in done["stages"].items()},
                    "verdict": done.get("verdict"),
                    "stage": bn.get("stage"),
                    "gauges": {k: bn.get(k) for k in
                               ("device_idle_frac", "host_blocked_frac",
                                "overlap_frac") if k in bn}}
        if snap is not None:
            stages = {k: float(v.get("wall_s", 0.0))
                      for k, v in (snap.get("stages") or {}).items()}
            return {"src": src, "partial": True,
                    "wall_s": None, "device_s": None, "host_s": None,
                    "feeder_s": snap.get("feeder_s"),
                    "dispatch_s": snap.get("dispatch_s"),
                    "threads": int(snap.get("threads") or 1),
                    "stages": stages, "verdict": snap.get("verdict"),
                    "stage": snap.get("stage") or None,
                    "gauges": {k: snap.get(k) for k in
                               ("device_idle_frac", "host_blocked_frac",
                                "overlap_frac") if k in snap}}
    return None


def profile_from_rollup(path: str) -> dict | None:
    """Normalized profile from a committed ``*.metrics.json`` rollup (the
    ``stage_<name>_s`` gauges + saturation gauges + verdict)."""
    try:
        with open(path) as fh:
            d = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(d, dict):
        return None
    if isinstance(d.get("metrics"), dict):   # serve.metrics.json nesting
        inner = d["metrics"]
    else:
        inner = d
    gauges = inner.get("gauges") or {}
    stages = {k[len("stage_"):-2]: float(v) for k, v in gauges.items()
              if k.startswith("stage_") and k.endswith("_s")}
    threads = int(gauges.get("stage_threads") or 1)
    if not stages and "verdict" not in inner and "verdict" not in d:
        return None
    sat = {k: gauges.get(k) for k in ("device_idle_frac",
                                      "host_blocked_frac", "overlap_frac")
           if k in gauges}
    return {"src": os.path.basename(path), "partial": False,
            "wall_s": d.get("wall_s"), "device_s": d.get("device_s"),
            "host_s": d.get("host_s"), "feeder_s": gauges.get("feeder_s"),
            "dispatch_s": gauges.get("dispatch_s"),
            "threads": threads, "stages": stages,
            "verdict": inner.get("verdict") or d.get("verdict"),
            "stage": None, "gauges": sat}


def profile_from_bench(payload: dict, name: str) -> dict | None:
    """Normalized profile from a bench/feeder sidecar payload (already
    unwrapped from the ``{"parsed": {...}}`` r-series format)."""
    rungs = payload.get("rungs")
    if isinstance(rungs, list) and rungs and isinstance(rungs[-1], dict):
        # MULTICHIP sidecar: profile the final (mesh-N) rung — the subject
        # of the scaling claim; the mesh-1 rung is its control. Older
        # sidecars carry verdict/saturation only per rung (or not at all);
        # newer ones also commit them top-level, which the rung inherits.
        rung = dict(rungs[-1])
        if rung.get("verdict") is None and payload.get("verdict") is not None:
            rung["verdict"] = payload["verdict"]
        sub = profile_from_bench(rung, f"{name}:mesh{rung.get('mesh')}")
        if sub is not None:
            return sub
    stages = payload.get("stages")
    sat = payload.get("saturation") or {}
    if not isinstance(stages, dict) and not sat \
            and "verdict" not in payload \
            and not ("mesh" in payload
                     and isinstance(payload.get("dispatch_s"), (int, float))):
        return None
    if isinstance(stages, dict) and stages and \
            isinstance(next(iter(stages.values())), dict):
        stages = {k: float(v.get("wall_s", 0.0)) for k, v in stages.items()}
    return {"src": name, "partial": False,
            "wall_s": payload.get("wall_s"), "device_s": None,
            "host_s": None, "feeder_s": payload.get("feeder_s"),
            "dispatch_s": payload.get("dispatch_s"),
            "dispatch_walls": _dispatch_walls(payload),
            "threads": int(payload.get("stage_threads")
                           or payload.get("threads") or 1),
            "stages": stages if isinstance(stages, dict) else {},
            "verdict": payload.get("verdict"),
            "stage": (payload.get("bottleneck") or {}).get("stage"),
            "gauges": {k: sat.get(k) for k in
                       ("device_idle_frac", "host_blocked_frac",
                        "overlap_frac") if k in sat}}


def load_profiles(paths: list[str]) -> tuple[list[dict], list[str]]:
    """(profiles, warnings) for every recognized input. Directories
    contribute their ``*.events.jsonl`` + ``*.metrics.json`` + bench/feeder
    sidecars. A profile-less file is a warning only when it was named
    EXPLICITLY (under ``--check`` that warning is a violation — the gate
    exists to catch a run that silently stopped committing its profile);
    directory sweeps skip profile-less files quietly (a fleet orchestrator
    sidecar legitimately has no shard_done)."""
    from .sentinel import load_bench

    files: list[tuple[str, bool]] = []   # (path, explicit)
    for p in paths:
        if os.path.isdir(p):
            swept: list[str] = []
            swept.extend(sorted(glob.glob(os.path.join(p, "*.events.jsonl"))))
            swept.extend(sorted(glob.glob(os.path.join(p, "*.metrics.json"))))
            for pat in ("BENCH_*.json", "MULTICHIP_*.json",
                        "FEEDER_r*.json"):
                swept.extend(sorted(glob.glob(os.path.join(p, pat))))
            files.extend((f, False) for f in swept)
        else:
            files.append((p, True))
    profiles: list[dict] = []
    warns: list[str] = []
    for path, explicit in files:
        base = os.path.basename(path)
        d = None
        if path.endswith(".metrics.json"):
            d = profile_from_rollup(path)
        elif path.endswith(".json"):
            payload = load_bench(path)
            if payload is None:
                try:
                    with open(path) as fh:
                        payload = json.load(fh)
                except (OSError, json.JSONDecodeError):
                    payload = None
            if isinstance(payload, dict):
                if isinstance(payload.get("parsed"), dict):
                    payload = payload["parsed"]
                d = profile_from_bench(payload, base)
        else:
            recs = _read_jsonl(path)
            d = profile_from_events(recs,
                                    base.replace(".events.jsonl", ""))
        if d is None:
            if explicit:
                warns.append(f"{path}: no stage profile found")
        else:
            profiles.append(d)
    return profiles, warns


def stage_table(stages: dict, total_s: float | None = None,
                width: int = 28) -> list[str]:
    """THE stage flame-table renderer (one source of truth, shared with
    ``daccord-trace``): one line per stage, heaviest first, with wall,
    share of ``total_s`` (the host/feeder anchor), and a proportional
    bar."""
    if not stages:
        return ["  (no stage walls recorded)"]
    tot = total_s if total_s and total_s > 0 else sum(stages.values())
    tot = max(tot, 1e-9)
    lines = []
    for name in sorted(stages, key=lambda k: -stages[k]):
        w = float(stages[name])
        share = w / tot
        bar = "#" * max(int(share * width + 0.5), 1 if w > 0 else 0)
        lines.append(f"  {name:<10} {w:9.3f}s {100 * share:5.1f}%  {bar}")
    return lines


def render_profile(d: dict) -> str:
    """One source's full screen block: header anchors, gauges + verdict,
    and the stage flame table."""
    out = [f"{d['src']}:" + ("  [partial: no shard_done]"
                             if d.get("partial") else "")]
    anchors = []
    for key in ("wall_s", "host_s", "device_s", "feeder_s", "dispatch_s"):
        v = d.get(key)
        if isinstance(v, (int, float)):
            anchors.append(f"{key.replace('_s', '')} {v:.3f}s")
    if d.get("threads", 1) > 1:
        anchors.append(f"feeder x{d['threads']} threads")
    if anchors:
        out.append("  " + "  ".join(anchors))
    g = d.get("gauges") or {}
    if g:
        out.append("  device_idle {:.0%}  host_blocked {:.0%}  "
                   "overlap {:.0%}".format(
                       float(g.get("device_idle_frac") or 0.0),
                       float(g.get("host_blocked_frac") or 0.0),
                       float(g.get("overlap_frac") or 0.0)))
    dw = d.get("dispatch_walls")
    if dw:
        out.append("  dispatch: " + "  ".join(
            f"{k.replace('_s', '')} {dw[k]:.3f}s"
            for k in DISPATCH_SUBWALLS if k in dw))
    v = d.get("verdict")
    if v:
        dom = d.get("stage")
        out.append(f"  verdict: {v.upper()}"
                   + (f" (dominant stage: {dom})" if dom else ""))
    out.extend(stage_table(d.get("stages") or {},
                           d.get("host_s") or d.get("feeder_s")))
    return "\n".join(out)


def check_profile(d: dict) -> list[str]:
    """Reconciliation findings for one profile (the ``--check`` rules).

    The committed numbers must be internally consistent within 5% / 50 ms:

    - every stage wall finite and non-negative, and a verdict committed;
    - feeder sub-stage sum vs the blocked-on-feeder wall (``feeder_s``):
      equal within tolerance for a SERIAL feeder (the sub-stages are
      exactly what the pile loop blocked on). Under a feeder pool
      (``threads > 1``) the pool works in the background of the pile loop,
      so thread-summed walls carry no fixed relation to the blocked wall —
      only the host envelope below constrains them;
    - total stage sum (per-thread) must fit inside ``host_s``;
    - ``host_s + device_s`` must equal ``wall_s`` (anchor integrity).
    """
    errs: list[str] = []
    src = d["src"]
    stages = d.get("stages") or {}
    for name, w in stages.items():
        if not isinstance(w, (int, float)) or w != w or w < 0:
            errs.append(f"{src}: stage {name!r} wall is not a finite "
                        f"non-negative number: {w!r}")
    if not d.get("verdict"):
        errs.append(f"{src}: no bottleneck verdict committed")
    threads = max(int(d.get("threads") or 1), 1)
    feeder = d.get("feeder_s")
    sub = sum(float(stages.get(s, 0.0)) for s in FEEDER_SUBSTAGES)
    if isinstance(feeder, (int, float)) and threads <= 1:
        if abs(sub - float(feeder)) > _tol(float(feeder)):
            errs.append(
                f"{src}: feeder sub-stage sum {sub:.3f}s does not "
                f"reconcile with the blocked-on-feeder wall "
                f"{float(feeder):.3f}s (tolerance "
                f"{_tol(float(feeder)):.3f}s)")
    host = d.get("host_s")
    if isinstance(host, (int, float)):
        per_thread = sum(float(v) for v in stages.values()) / threads
        if per_thread > float(host) + _tol(float(host)):
            errs.append(
                f"{src}: stage sum {per_thread:.3f}s (per thread) exceeds "
                f"host_s {float(host):.3f}s (tolerance "
                f"{_tol(float(host)):.3f}s)")
    dw = d.get("dispatch_walls")
    disp = d.get("dispatch_s")
    if dw and isinstance(disp, (int, float)):
        # staged dispatch: the committed sub-walls must rebuild
        # the host-only dispatch wall — a sub-wall that silently swallowed
        # a synchronous solve (the MULTICHIP_r06 double-count) cannot
        sub_sum = sum(dw.values())
        if abs(sub_sum - float(disp)) > _tol(float(disp)):
            errs.append(
                f"{src}: dispatch sub-wall sum {sub_sum:.3f}s "
                f"(pack+stage+launch) does not reconcile with dispatch_s "
                f"{float(disp):.3f}s (tolerance {_tol(float(disp)):.3f}s)")
    wall, dev = d.get("wall_s"), d.get("device_s")
    if all(isinstance(x, (int, float)) for x in (wall, host, dev)):
        if abs((float(host) + float(dev)) - float(wall)) > _tol(float(wall)):
            errs.append(
                f"{src}: host_s {float(host):.3f}s + device_s "
                f"{float(dev):.3f}s does not reconcile with wall_s "
                f"{float(wall):.3f}s")
    return errs


def diff_profiles(a: dict, b: dict) -> list[str]:
    """Stage-by-stage diff lines (B relative to A) — wall delta and
    share-of-total delta per stage, plus gauge and verdict changes."""
    lines = [f"stage diff: {a['src']} -> {b['src']}"]
    sa, sb = a.get("stages") or {}, b.get("stages") or {}
    ta = max(sum(sa.values()), 1e-9)
    tb = max(sum(sb.values()), 1e-9)
    for name in sorted(set(sa) | set(sb),
                       key=lambda k: -(sb.get(k, 0.0) + sa.get(k, 0.0))):
        wa, wb = float(sa.get(name, 0.0)), float(sb.get(name, 0.0))
        d_share = wb / tb - wa / ta
        pct = f"{100 * (wb - wa) / wa:+.0f}%" if wa > 1e-9 else "new"
        lines.append(f"  {name:<10} {wa:9.3f}s -> {wb:9.3f}s  ({pct}, "
                     f"share {d_share:+.1%})")
    # staged-dispatch decomposition: the blocked-dispatch wall
    # plus its host-only sub-walls — how the async pipeline PR proves the
    # host pack/shard/transfer left the critical path ("new" on the B side
    # when the baseline predates the split)
    da, db = a.get("dispatch_s"), b.get("dispatch_s")
    if isinstance(da, (int, float)) and isinstance(db, (int, float)):
        pct = f"{100 * (db - da) / da:+.0f}%" if da > 1e-9 else "new"
        lines.append(f"  {'dispatch_s':<10} {da:9.3f}s -> {db:9.3f}s  ({pct})")
    dwa, dwb = a.get("dispatch_walls") or {}, b.get("dispatch_walls") or {}
    for k in DISPATCH_SUBWALLS:
        if k in dwa or k in dwb:
            wa, wb = float(dwa.get(k, 0.0)), float(dwb.get(k, 0.0))
            pct = f"{100 * (wb - wa) / wa:+.0f}%" if wa > 1e-9 else "new"
            lines.append(f"  {k:<10} {wa:9.3f}s -> {wb:9.3f}s  ({pct})")
    ga, gb = a.get("gauges") or {}, b.get("gauges") or {}
    for k in ("device_idle_frac", "host_blocked_frac", "overlap_frac"):
        va, vb = ga.get(k), gb.get(k)
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            lines.append(f"  {k:<18} {va:.1%} -> {vb:.1%}")
    if a.get("verdict") != b.get("verdict"):
        lines.append(f"  verdict: {a.get('verdict')} -> {b.get('verdict')}")
    else:
        lines.append(f"  verdict: {a.get('verdict')} (unchanged)")
    return lines


def prof_main(argv=None) -> int:
    """daccord-prof: render/check/diff the saturation profiler's committed
    stage tables, starvation gauges, and bottleneck verdicts."""
    p = argparse.ArgumentParser(prog="daccord-prof",
                                description=prof_main.__doc__)
    p.add_argument("paths", nargs="+",
                   help="events jsonl, *.metrics.json, bench/feeder "
                        "sidecars, or directories of them")
    p.add_argument("--check", action="store_true",
                   help="reconcile stage sums against the run's own "
                        "feeder_s/host_s/device_s anchors (5%%/50 ms "
                        "tolerance); exit 1 on any violation — the pounce "
                        "pre-chip gate")
    p.add_argument("--diff", action="store_true",
                   help="diff exactly two inputs stage-by-stage (baseline "
                        "first)")
    p.add_argument("--json", action="store_true",
                   help="emit the normalized profiles (and findings) as "
                        "one JSON line on stdout")
    args = p.parse_args(argv)

    profiles, warns = load_profiles(args.paths)
    out = sys.stderr
    errs: list[str] = []
    if args.check:
        # an input that SHOULD carry a profile but doesn't is a violation
        # in check mode, not a warning — the gate exists to catch exactly
        # that silent regression
        errs.extend(warns)
        for d in profiles:
            errs.extend(check_profile(d))
    if args.diff:
        if len(profiles) != 2:
            print(f"daccord-prof: --diff needs exactly 2 profiled inputs "
                  f"(got {len(profiles)})", file=out)
            return 2
        for ln in diff_profiles(profiles[0], profiles[1]):
            print(ln, file=out)
    elif not args.json:
        for d in profiles:
            print(render_profile(d), file=out)
    if args.json:
        print(json.dumps({"profiles": profiles, "errors": errs,
                          "warnings": warns}))
    for w in warns if not args.check else []:
        print(f"daccord-prof: warn: {w}", file=out)
    for e in errs:
        print(f"daccord-prof: {e}", file=out)
    print(f"daccord-prof: {len(profiles)} profile(s): "
          + ("OK" if not errs else f"{len(errs)} error(s)"), file=out)
    return 1 if errs else 0


if __name__ == "__main__":
    raise SystemExit(prof_main())
