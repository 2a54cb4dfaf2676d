"""daccord-top: one-screen live health snapshot of a run, fleet, or server.

The port's copy of ``daccord_tpu/tools/top.py``. The event log records
everything and the serve plane reports p50/p99 after the fact; this shows
what is happening *now*. ``daccord-top`` tails the live events/metrics sidecars of
any telemetry-producing directory (a shard run, a fleet outdir, a
daccord-serve workdir) and renders a refreshing one-screen snapshot:

- **SHARDS** — per-source throughput (windows/sec, bases/sec), supervisor
  state, in-flight depth, rescue-pool density, RSS, and the last
  ``shard_done`` outcome;
- **MESH** — the per-device flight recorder: state (ok / lost /
  dropped), trust verdict + strike count (ratchet, from the latest
  ``trust.state``/``trust.load``), dispatch count + wall, rows, HBM peak,
  and the capacity rung per device index, from the latest ``mesh.device``
  rows;
- **SERVE** — job states, queue depth, shed level, SLO burn
  (rolling p99 vs target), and latency quantiles from the latest snapshot;
- **GOVERNOR** — active capacity ratchets (shape key → width);
- **FAULTS** — recent supervisor faults / failovers / mesh shrinks, plus
  the SDC defense plane's milestones (``sup_sdc`` audit divergence,
  ``audit.attrib`` culprit attribution, ``trust.state`` verdicts).

``--once`` renders a single snapshot and exits (tests, CI, cron health
checks); the default loop refreshes every ``--interval`` seconds. ``--json``
emits the raw snapshot dict for scripting. Reads are tail-bounded (the last
``--tail-kb`` of each events file), so a 100-GB fleet sidecar costs the same
as a toy run's.

Usage::

    daccord-top out/                 # fleet outdir: orchestrator + workers
    daccord-top srv/ --once          # serve workdir, one-shot
    daccord-top run.events.jsonl --json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time


def _tail_lines(path: str, tail_kb: int = 256) -> list[str]:
    """The last ``tail_kb`` KiB of ``path`` as complete lines (the first,
    possibly torn, line after a mid-file seek is dropped)."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as fh:
            if size > tail_kb * 1024:
                fh.seek(size - tail_kb * 1024)
                fh.readline()   # discard the torn line
            data = fh.read()
    except OSError:
        return []
    return data.decode(errors="replace").splitlines()


def _tail_records(path: str, tail_kb: int) -> list[dict]:
    out = []
    for ln in _tail_lines(path, tail_kb):
        ln = ln.strip()
        if not ln:
            continue
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


def _load_json(path: str) -> dict | None:
    try:
        with open(path) as fh:
            d = json.load(fh)
        return d if isinstance(d, dict) else None
    except (OSError, json.JSONDecodeError):
        return None


def _expand_sources(paths: list[str]) -> tuple[list[str], list[str], list[str]]:
    """(event files, json sidecars, lease files) the snapshot reads: a
    directory contributes its ``*.events.jsonl``, the durable
    metrics/fleet/serve JSON sidecars, and any ``leases/*.lease`` beneath it
    (a fleet outdir or a serve peer dir — the per-process ownership
    state)."""
    events: list[str] = []
    sidecars: list[str] = []
    leases: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            events.extend(sorted(glob.glob(os.path.join(p, "*.events.jsonl"))))
            sidecars.extend(sorted(glob.glob(os.path.join(p, "*.metrics.json"))))
            for name in ("fleet.json", "serve.metrics.json"):
                fp = os.path.join(p, name)
                if os.path.exists(fp) and fp not in sidecars:
                    sidecars.append(fp)
            leases.extend(sorted(glob.glob(os.path.join(p, "leases",
                                                        "*.lease"))))
            # announce leases: a peer dir's peers/*.lease rows
            # are the router's discovery inputs — same LEASE panel
            leases.extend(sorted(glob.glob(os.path.join(p, "peers",
                                                        "*.lease"))))
        elif p.endswith(".lease"):
            leases.append(p)
        elif p.endswith(".json"):
            sidecars.append(p)
        else:
            events.append(p)
    return events, sidecars, leases


def collect(paths: list[str], tail_kb: int = 256) -> dict:
    """Build the snapshot dict ``render`` draws: one ``sources`` row per
    events file (latest metrics/state/outcome), the merged mesh device
    table, the latest serve health, active governor ratchets, and recent
    fault milestones."""
    events, sidecars, lease_files = _expand_sources(paths)
    snap: dict = {"ts": time.time(), "sources": [], "mesh": {},
                  "serve": None, "ratchets": {}, "faults": [],
                  "slo": None, "fleet": None, "leases": [], "router": None}
    # per-process lease/ownership state: who holds which
    # shard/job right now, and how stale each heartbeat is — the takeover
    # question ("is anyone going to pick this up?") answered at a glance
    now = time.time()
    for lp in lease_files:
        info = _load_json(lp) or {}
        try:
            age = now - os.path.getmtime(lp)
        except OSError:
            continue
        unit = info.get("job") if info.get("job") is not None else \
            info.get("shard")
        snap["leases"].append(
            {"name": os.path.basename(lp).rsplit(".lease", 1)[0],
             "holder": str(info.get("host", "?")),
             "unit": "-" if unit is None else str(unit),
             "age_s": round(age, 1)})
    for path in events:
        recs = _tail_records(path, tail_kb)
        src = os.path.basename(path).replace(".events.jsonl", "")
        row: dict = {"src": src, "state": None, "metrics": None,
                     "done": None, "slo": None, "shed": None,
                     "inflight": None, "pool": None, "verdict": None}
        for rec in recs:
            ev = rec.get("event")
            if ev == "stage.profile":
                # saturation profiler: the live verdict — a
                # later shard_done (committed form) overwrites it below
                row["verdict"] = rec.get("verdict")
            elif ev == "metrics":
                row["metrics"] = rec
                mesh = rec.get("mesh")
                if isinstance(mesh, dict):
                    # carry event-sourced trust verdicts across:
                    # the metrics snapshot knows utilization, not trust
                    old = (snap.get("mesh") or {}).get("devices") or {}
                    snap["mesh"] = mesh
                    devs = mesh.setdefault("devices", {})
                    for k, v in old.items():
                        if "trust" in v:
                            devs.setdefault(k, {}).update(
                                {kk: v[kk] for kk in ("trust", "strikes")
                                 if kk in v})
            elif ev == "mesh.device":
                d = rec.get("device")
                if isinstance(d, int):
                    devs = snap["mesh"].setdefault("devices", {})
                    trust = devs.get(str(d), {}).get("trust")
                    devs[str(d)] = {k: v for k, v in rec.items()
                                    if k not in ("t", "ts", "event", "device")}
                    if trust is not None:
                        devs[str(d)]["trust"] = trust
            elif ev in ("trust.state", "trust.load"):
                # device trust ratchet: latest verdict per member
                d = rec.get("device")
                if isinstance(d, int):
                    devs = snap["mesh"].setdefault("devices", {})
                    drow = devs.setdefault(str(d), {})
                    drow["trust"] = rec.get("state_to") or rec.get("state")
                    drow["strikes"] = rec.get("strikes")
                if ev == "trust.state":
                    # a verdict transition is also a fault-panel milestone
                    snap["faults"].append(
                        {"src": src, "event": ev,
                         **{k: v for k, v in rec.items()
                            if k in ("device", "state_from", "state_to",
                                     "strikes")}})
            elif ev == "sup_state":
                row["state"] = rec.get("state_to")
            elif ev == "sup_init":
                row["state"] = row["state"] or "HEALTHY"
                row["engine"] = rec.get("primary")
            elif ev == "shard_done":
                row["done"] = rec
                if rec.get("verdict"):
                    row["verdict"] = rec.get("verdict")
            elif ev == "batch":
                row["inflight"] = rec.get("inflight")
                row["pool"] = rec.get("pool")
            elif ev == "governor.ratchet":
                snap["ratchets"][rec.get("key")] = rec.get("width")
            elif ev == "governor.restore" and rec.get("ok"):
                snap["ratchets"].pop(rec.get("key"), None)
            elif ev == "serve.slo":
                snap["slo"] = rec
            elif ev == "serve.shed":
                row["shed"] = rec.get("level")
            elif isinstance(ev, str) and (ev.startswith("router.")
                                          or ev.startswith("scale.")):
                # front door: fold the router's event stream
                # into the ROUTER panel — peer table (up/down + ready),
                # tenant ownership map, spill/scale tallies
                r = snap["router"]
                if r is None:
                    r = snap["router"] = {"peers": {}, "owners": {},
                                          "routes": 0, "spills": 0,
                                          "proxy_errors": 0, "scale": []}
                if ev == "router.peer_up":
                    r["peers"][rec.get("peer")] = {
                        "up": True, "ready": rec.get("ready"),
                        "url": rec.get("url")}
                elif ev == "router.peer_down":
                    p_ = r["peers"].setdefault(rec.get("peer"), {})
                    p_["up"] = False
                    p_["ready"] = False
                    p_["reason"] = rec.get("reason")
                elif ev == "router.route":
                    r["routes"] += 1
                    r["owners"][rec.get("tenant")] = rec.get("peer")
                elif ev == "router.spill":
                    r["spills"] += 1
                elif ev == "router.proxy_error":
                    r["proxy_errors"] += 1
                elif ev == "router.breaker":
                    # network fault matrix: per-peer breaker
                    # state rides the peer table
                    p_ = r["peers"].setdefault(rec.get("peer"), {})
                    p_["breaker"] = rec.get("state")
                elif ev == "router.partition":
                    p_ = r["peers"].setdefault(rec.get("peer"), {})
                    p_["partitioned"] = rec.get("state") == "begin"
                elif ev in ("scale.spawn", "scale.drain", "scale.reap"):
                    r["scale"].append(
                        {"event": ev, "peer": rec.get("peer"),
                         **{k: v for k, v in rec.items()
                            if k in ("rc", "reason", "n_spawned")}})
                    r["scale"] = r["scale"][-6:]
            elif ev in ("sup_fault", "sup_failover", "sup_failback",
                        "mesh.shrink", "mesh.degrade", "mesh.restore",
                        "fleet.poison", "fleet.capacity",
                        "governor.classify",
                        # crash-durable serve tier: recovery
                        # milestones belong on the operator screen
                        "serve.replay", "serve.takeover",
                        # storage fault matrix: disk refusals
                        # and pressure transitions are operator events
                        "io.fault", "disk.pressure", "journal.compact",
                        # network fault matrix: socket refusals
                        # and partition transitions likewise
                        "net.fault", "router.partition",
                        # SDC defense plane: audit divergence
                        # and culprit attribution (trust.state milestones
                        # are appended by the ratchet branch above)
                        "sup_sdc", "audit.attrib", "audit.disabled"):
                snap["faults"].append(
                    {"src": src, "event": ev,
                     **{k: v for k, v in rec.items()
                        if k in ("kind", "reason", "key", "nd_from", "nd_to",
                                 "culprit", "shard", "op", "job",
                                 "prev_host", "stale_s", "orphans",
                                 "finished", "domain", "error", "level",
                                 "free_mb", "before", "after",
                                 "peer", "state", "device", "divergent",
                                 "sampled", "state_from", "state_to",
                                 "strikes")}})
                if ev == "disk.pressure":
                    snap["disk"] = {"level": rec.get("level"),
                                    "src": rec.get("src"),
                                    "free_mb": rec.get("free_mb")}
        snap["sources"].append(row)
    for path in sidecars:
        d = _load_json(path)
        if d is None:
            continue
        base = os.path.basename(path)
        if base == "serve.metrics.json":
            snap["serve"] = d
        elif base == "fleet.json":
            snap["fleet"] = d
        else:
            # shardNNNN.metrics.json: attach the durable rollup to its row
            src = base.replace(".metrics.json", "")
            for row in snap["sources"]:
                if row["src"] == src and row["metrics"] is None:
                    row["metrics"] = {"gauges": d.get("gauges", {}),
                                      "counters": d.get("counters", {}),
                                      "hists": d.get("hists", {})}
    snap["faults"] = snap["faults"][-8:]
    return snap


def _pct(v) -> str:
    """A 0..1 fraction as a percent cell ('-' when unreported)."""
    if not isinstance(v, (int, float)):
        return "-"
    return f"{100.0 * float(v):.0f}"


def _fmt(v, nd: int = 1) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if abs(v) >= 1e6:
            return f"{v / 1e6:.1f}M"
        if abs(v) >= 1e4:
            return f"{v / 1e3:.1f}k"
        return f"{v:.{nd}f}"
    return str(v)


def render(snap: dict) -> str:
    """The one-screen text snapshot (plain fixed-width — it must read the
    same in a tmux pane, a CI log, and a golden test)."""
    out: list[str] = []
    t = time.strftime("%H:%M:%S", time.localtime(snap["ts"]))
    out.append(f"daccord-top  {t}  ({len(snap['sources'])} source(s))")
    if snap["sources"]:
        out.append("")
        # IDLE%/BLK%/OVR%/VERDICT = the saturation column: device
        # idle fraction, host-blocked-on-device fraction, host/device
        # overlap fraction (a starving staged pipeline shows a
        # falling OVR% live), and the committed (or live) bottleneck verdict
        out.append(f"  {'SOURCE':<18}{'STATE':<10}{'WIN/S':>8}{'BASES/S':>10}"
                   f"{'RSS MB':>8}{'INFL':>6}{'POOL':>6}{'IDLE%':>7}"
                   f"{'BLK%':>6}{'OVR%':>6}  {'VERDICT':<12}OUTCOME")
        for row in snap["sources"]:
            g = (row["metrics"] or {}).get("gauges", {})
            done = row["done"]
            outcome = "-"
            if done is not None:
                outcome = (f"done {done.get('windows', '?')}w "
                           f"{_fmt(done.get('windows_per_sec'))}w/s"
                           + (" DEGRADED" if done.get("degraded") else ""))
            out.append(
                f"  {row['src']:<18}{(row['state'] or '-'):<10}"
                f"{_fmt(g.get('windows_per_sec')):>8}"
                f"{_fmt(g.get('bases_per_sec')):>10}"
                f"{_fmt(g.get('rss_mb')):>8}"
                f"{_fmt(row['inflight'], 0):>6}{_fmt(row['pool'], 0):>6}"
                f"{_pct(g.get('device_idle_frac')):>7}"
                f"{_pct(g.get('host_blocked_frac')):>6}"
                f"{_pct(g.get('overlap_frac')):>6}"
                f"  {(row.get('verdict') or '-'):<12}{outcome}")
    mesh = snap.get("mesh") or {}
    devs = mesh.get("devices") or {}
    if devs:
        out.append("")
        nd = mesh.get("nd")
        nd0 = mesh.get("nd0")
        hdr = f"  MESH {nd}/{nd0}" if nd is not None else "  MESH"
        rung = mesh.get("rung_rows_per_device")
        if rung is not None:
            hdr += f"  rung {rung} rows/device"
        out.append(hdr)
        out.append(f"  {'DEV':>5} {'PLAT':<6}{'STATE':<9}{'TRUST':<13}"
                   f"{'DISP':>7}"
                   f"{'WALL S':>9}{'ROWS':>9}{'HBM PEAK':>10}{'IDLE%':>7}"
                   f"{'OVR%':>6}")
        for k in sorted(devs, key=lambda x: int(x)):
            d = devs[k]
            trust = d.get("trust") or "-"
            if trust != "-" and d.get("strikes") is not None:
                trust = f"{trust}:{d['strikes']}"
            out.append(
                f"  {k:>5} {str(d.get('platform', '?')):<6}"
                f"{str(d.get('state', '?')):<9}"
                f"{trust:<13}"
                f"{_fmt(d.get('dispatches'), 0):>7}"
                f"{_fmt(d.get('dispatch_wall_s'), 2):>9}"
                f"{_fmt(d.get('rows'), 0):>9}"
                f"{_fmt(d.get('hbm_peak_bytes'), 0):>10}"
                f"{_pct(d.get('idle_frac')):>7}"
                f"{_pct(d.get('overlap_frac')):>6}")
    serve = snap.get("serve")
    slo = snap.get("slo")
    if serve is not None or slo is not None:
        out.append("")
        line = "  SERVE"
        if serve is not None:
            jobs = serve.get("jobs", {})
            line += ("  jobs " + " ".join(f"{k}:{v}"
                                          for k, v in sorted(jobs.items()))
                     if jobs else "")
            if "queue_depth" in serve:
                line += f"  queue {serve['queue_depth']}"
            if "shed_level" in serve:
                line += f"  shed {serve['shed_level']}"
            if serve.get("disk_free_mb") is not None:
                line += f"  disk {_fmt(serve['disk_free_mb'])}MB"
                if serve.get("disk_pressure"):
                    line += " PRESSURE"
            if serve.get("verdict"):
                line += f"  verdict {serve['verdict']}"
            if serve.get("peer"):
                line += (f"  peer {serve['peer']}"
                         f"  owns {len(serve.get('leases') or [])}")
        out.append(line)
        if slo is not None:
            out.append(f"    SLO burn {slo.get('burn')} "
                       f"(p99 {slo.get('p99_s', '-')}s vs target "
                       f"{slo.get('target_s')}s, n={slo.get('n')})")
        if serve is not None:
            h = ((serve.get("metrics") or {}).get("hists") or {}).get(
                "job_latency_s")
            if h:
                out.append(f"    latency p50 {_fmt(h.get('p50'), 3)}s "
                           f"p95 {_fmt(h.get('p95'), 3)}s "
                           f"p99 {_fmt(h.get('p99'), 3)}s "
                           f"({h.get('count')} jobs)")
    router = snap.get("router")
    if router is not None:
        # front door: peer table + tenant ownership + spill and
        # scale tallies from router.events.jsonl
        out.append("")
        out.append(f"  ROUTER  routes {router['routes']} "
                   f"spills {router['spills']} "
                   f"proxy-errs {router['proxy_errors']}")
        if router["peers"]:
            out.append(f"    {'PEER':<26}{'UP':<5}{'READY':<7}"
                       f"{'NET':<13}URL")
            for name in sorted(router["peers"]):
                d = router["peers"][name]
                ready = d.get("ready")
                # network column: partition verdict beats the
                # breaker state — a partitioned peer is the operator event
                net = "PARTITIONED" if d.get("partitioned") else \
                    (d.get("breaker") or "-")
                out.append(
                    f"    {str(name):<26}"
                    f"{('yes' if d.get('up') else 'NO'):<5}"
                    f"{('yes' if ready else ('-' if ready is None else 'NO')):<7}"
                    f"{net:<13}"
                    f"{d.get('url') or d.get('reason') or '-'}")
        if router["owners"]:
            owners = " ".join(f"{t}->{p_}" for t, p_ in
                              sorted(router["owners"].items()))
            out.append(f"    owners: {owners}"[:100])
        for s in router["scale"]:
            detail = " ".join(f"{k}={v}" for k, v in s.items()
                              if k not in ("event", "peer"))
            out.append(f"    {s['event']} {s.get('peer')} {detail}".rstrip())
    fleet = snap.get("fleet")
    if fleet is not None:
        out.append("")
        out.append(f"  FLEET  done {len(fleet.get('done', []))} "
                   f"poison {len(fleet.get('poison', []))} "
                   f"capacity-requeued {len(fleet.get('capacity_requeued', []))}")
    if snap.get("leases"):
        # per-process ownership: which process holds which
        # job/shard, and how stale each heartbeat is — a row past its TTL
        # is takeover bait
        out.append("")
        out.append(f"  {'LEASE':<28}{'HOLDER':<24}{'UNIT':<14}{'AGE S':>7}")
        for l in snap["leases"]:
            out.append(f"  {l['name']:<28}{l['holder']:<24}"
                       f"{l['unit']:<14}{_fmt(l['age_s']):>7}")
    if snap["ratchets"]:
        out.append("")
        out.append("  GOVERNOR ratchets:")
        for k, w in sorted(snap["ratchets"].items()):
            out.append(f"    {k} -> {w}")
    if snap["faults"]:
        out.append("")
        out.append("  RECENT FAULTS:")
        for f in snap["faults"]:
            detail = " ".join(f"{k}={v}" for k, v in f.items()
                              if k not in ("src", "event"))
            out.append(f"    [{f['src']}] {f['event']} {detail}"[:100])
    return "\n".join(out) + "\n"


def top_main(argv=None) -> int:
    """daccord-top: refreshing one-screen health snapshot from live
    events/metrics sidecars (run dir, fleet outdir, or serve workdir)."""
    p = argparse.ArgumentParser(prog="daccord-top",
                                description=top_main.__doc__)
    p.add_argument("paths", nargs="+",
                   help="run/fleet/serve directories or events files")
    p.add_argument("--once", action="store_true",
                   help="render one snapshot and exit (tests/CI)")
    p.add_argument("--json", action="store_true",
                   help="emit the raw snapshot dict instead of the screen")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh cadence in seconds (loop mode)")
    p.add_argument("--tail-kb", type=int, default=256,
                   help="read only the last N KiB of each events file")
    args = p.parse_args(argv)
    while True:
        snap = collect(args.paths, tail_kb=args.tail_kb)
        if args.json:
            print(json.dumps(snap, default=str))
        else:
            if not args.once:
                # ANSI clear + home: the refresh contract of a top-alike
                sys.stdout.write("\x1b[2J\x1b[H")
            sys.stdout.write(render(snap))
            sys.stdout.flush()
        if args.once or args.json:
            return 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    raise SystemExit(top_main())
