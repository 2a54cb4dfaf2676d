"""eventcheck: validate a jsonl events file against the event schema.

The port's copy of ``daccord_tpu/tools/eventcheck.py``, the same schema.
The supervisor (``runtime/supervisor.py``) and the pipeline emit structured
jsonl events (``daccord --events``), a machine-readable "compiling vs
wedged vs dead" record of a run; the tests lint the events their runs
write. ``--strict`` also checks that the supervisor's state transitions
follow the legal machine (HEALTHY -> SUSPECT -> COMPILING|RETRYING -> LOST
-> DEGRADED -> FAILBACK) and that relative timestamps are monotonic.

Usage: ``python -m daccord_tpu_torch.tools.eventcheck [--strict] FILE...``
"""

from __future__ import annotations

import argparse
import json
import sys

_NUM = (int, float)

#: required fields (name -> allowed types) per event. Events not listed are
#: accepted as long as they carry the base fields — the schema constrains the
#: machine-consumed events, it does not forbid new informational ones.
BASE_FIELDS = {"t": _NUM, "ts": _NUM, "event": str}
EVENT_FIELDS: dict[str, dict] = {
    # telemetry spine: trace spans, metrics snapshots, the
    # per-window outcome ledger, and the per-run stream boundary
    "shard_start": {"start": int, "end": int, "pid": int},
    "span_open": {"span": str, "parent": str, "name": str},
    "span_close": {"span": str, "name": str, "wall_s": _NUM},
    "metrics": {"counters": dict, "gauges": dict, "hists": dict},
    "window": {"aread": int, "widx": int, "len": int, "depth": int,
               "tier": int, "k": int, "solved": bool, "stream": str,
               "rescued": bool, "wall_s": _NUM},
    "sup_init": {"primary": str, "op_deadline_s": _NUM,
                 "compile_deadline_s": _NUM},
    # (ts moved to BASE_FIELDS: the logger stamps every record)
    "sup_state": {"state_from": str, "state_to": str, "reason": str},
    "sup_compile": {"key": str, "expected_wall_s": _NUM},
    # the measured counterpart: cold dispatch wall ~= compile
    # wall (jit compiles synchronously at call time); also folded into the
    # compile-fingerprint registry for daccord-sentinel's drift bands
    "sup_compile_done": {"key": str, "wall_s": _NUM},
    # opt-in jax.profiler capture bracket (DACCORD_PROFILE_DIR)
    "profile.capture": {"dir": str, "dispatch": int, "state": str},
    "sup_heartbeat": {"op": str, "key": str, "waited_s": _NUM,
                      "deadline_s": _NUM},
    # cls = retry class (timeout | transient): budgets apply per class, and
    # deterministic classes (capacity) never appear here at all — they skip
    # straight to their remedy (governor ladder / failover)
    "sup_retry": {"op": str, "attempt": int, "cls": str, "delay_s": _NUM,
                  "reason": str},
    "sup_probe": {"alive": bool, "wall_s": _NUM},
    "sup_fault": {"kind": str, "op": str, "n": int},
    "sup_failover": {"reason": str, "fallback": str},
    "sup_failback": {},
    "sup_done": {"state": str, "degraded": bool},
    "batch": {"windows": int, "solved": int},
    # ragged paged window batching (kernels/paging.py): one
    # paging.family row per derived shape family at shard start, one
    # batch.paged row per paged dispatch (pages = live pages shipped,
    # pool_pages = the family's static pool budget, occupancy = their
    # ratio, table_cells = the page table's transfer cost in cell units)
    "paging.family": {"family": str, "bucket": int, "depth": int,
                      "pages": int, "page_len": int, "pool_pages": int},
    "batch.paged": {"windows": int, "bucket": int, "family": str,
                    "pages": int, "pool_pages": int, "table_cells": int,
                    "occupancy": _NUM},
    # mesh-native solve path (parallel/mesh.py): one mesh.init per built
    # sharded solver; mesh.shrink = the partial-mesh degradation rung
    # (N -> N/2 on declared device loss, run stays on the smaller primary;
    # culprit = attributed dead member index, -1 unknown); mesh.restore =
    # failback rebuilt the full mesh; mesh.degrade = no smaller mesh exists
    # (width 1) — whole-program failover follows. mesh.device is
    # the per-chip flight-recorder row: one per member at snapshot cadence
    # (state ok + wall/rows/HBM gauges) and one the moment a shrink flips a
    # member to lost/dropped — the record that makes a partial-mesh
    # degradation attributable to a single device index.
    "mesh.init": {"nd": int, "devices": str, "esc_cap": int},
    "mesh.shrink": {"nd_from": int, "nd_to": int, "culprit": int,
                    "reason": str},
    "mesh.restore": {"nd_from": int, "nd_to": int},
    "mesh.degrade": {"nd": int, "reason": str},
    "mesh.device": {"device": int, "state": str},
    # silent-data-corruption defense plane: sup_sdc = a sampled
    # shadow audit caught a row whose device bytes diverge from the trusted
    # reference (culprit = attributed mesh member, -1 unknown/non-mesh);
    # audit.attrib = the per-member single-window re-dispatch that
    # attributed it; audit.disabled = the reference engine failed to build
    # (auditing off for the run, never fatal); trust.state / trust.load =
    # the per-device trust ratchet (TRUSTED -> SUSPECT -> QUARANTINED,
    # persisted in the trust registry beside the compile/capacity ones)
    "sup_sdc": {"key": str, "rows": int, "sampled": int, "divergent": int,
                "row": int, "culprit": int},
    "audit.attrib": {"row": int, "culprit": int, "nd": int},
    "audit.disabled": {"error": str},
    "trust.state": {"device": int, "state_from": str, "state_to": str,
                    "strikes": int},
    "trust.load": {"device": int, "state": str, "strikes": int},
    # two-stream tier ladder: one row per Stream B rescue dispatch
    # (rows = live rescue windows, slots = padded batch width, reason =
    # full | lag | final | pressure — the last is a host-watermark
    # force-flush)
    "ladder.flush": {"rows": int, "slots": int, "reason": str},
    # CUDA graphs of the ladder's stages (kernels/graphs.py): one row per
    # capture (stage = tier0 | ('wide', EW) | ('esc', E), key = the batch
    # shape, wall_s = the capture's wall, not the warm-up solve's)
    "graph.capture": {"stage": str, "key": str, "wall_s": _NUM},
    # staged dispatch pipeline: dispatch.pipeline announces the
    # double buffer once per run; dispatch.stage is one row per staged batch
    # (host pad/pack + per-device shard-transfer sub-walls, measured on the
    # staging thread but EMITTED by the pipeline thread so the sidecar keeps
    # one monotonic writer); dispatch.launch is the jit-call row, whose
    # trace span pairs under the ordinary span_open/span_close rule.
    "dispatch.pipeline": {"depth": int, "solver": str},
    "dispatch.stage": {"rows": int, "pack_s": _NUM, "stage_s": _NUM},
    "dispatch.launch": {"rows": int, "launch_s": _NUM},
    # capacity governor (runtime/governor.py): memory faults walk a
    # byte-identical degradation ladder instead of the transient retry ladder
    "governor.classify": {"key": str, "width": int, "reason": str},
    "governor.shrink": {"key": str, "width_from": int, "width_to": int},
    "governor.clamp": {"key": str, "width": int, "esc_cap": int},
    "governor.ratchet": {"key": str, "width": int},
    "governor.restore": {"key": str, "width": int, "ok": bool},
    "governor.backpressure": {"level": str, "rss_mb": _NUM},
    "governor.monster": {"aread": int, "overlaps": int, "budget": int},
    # saturation profiler: stage.profile is the periodic
    # per-stage feeder snapshot (stages = StageProfile.summary()['stages'],
    # feeder_s = the pipeline-visible blocked-on-feeder wall, verdict = the
    # live bottleneck attribution); shard_done carries the committed final
    # form (stages wall table, verdict string, bottleneck gauge dict)
    "stage.profile": {"stages": dict, "feeder_s": _NUM, "verdict": str},
    "shard_done": {"reads": int, "windows": int, "solved": int,
                   "wall_s": _NUM, "degraded": bool,
                   "verdict": str, "bottleneck": dict, "stages": dict},
    # ingest integrity layer (formats/ingest.py)
    "ingest.scan": {"path": str, "records": int, "piles": int, "issues": int,
                    "policy": str},
    "ingest.issue": {"kind": str, "offset": int, "aread": int, "detail": str},
    "ingest.quarantine": {"kind": str, "offset": int, "aread": int},
    "ingest.commit": {"emitted": int, "fasta_bytes": int},
    "ingest.fault": {"kind": str, "path": str, "record": int},
    # shard fleet orchestrator (parallel/fleet.py)
    "fleet.init": {"nshards": int, "workers": int, "host": str},
    "fleet.spawn": {"shard": int, "attempt": int, "pid": int},
    "fleet.heartbeat": {"shard": int, "emitted": int},
    "fleet.takeover": {"shard": int, "prev_host": str, "stale_s": _NUM},
    "fleet.retry": {"shard": int, "attempt": int, "delay_s": _NUM,
                    "reason": str},
    "fleet.poison": {"shard": int, "attempts": int, "reason": str},
    "fleet.speculate": {"shard": int, "throughput": _NUM, "median": _NUM},
    "fleet.done": {"shard": int, "reads": int, "degraded": bool},
    # OOM-killed worker requeued once at a reduced batch (not poison credit)
    "fleet.capacity": {"shard": int, "batch": int},
    "fleet.fault": {"kind": str, "shard": int},
    "fleet.demote": {"shard": int, "new_host": str},
    "fleet.finish": {"done": int, "poison": int, "wall_s": _NUM},
    # serving plane (daccord_tpu/serve): service lifecycle,
    # admission decisions, cross-job merged batches, per-job commits. The
    # serve.batch row is the batcher's accounting unit: `jobs` counts the
    # distinct jobs cohabiting the merged batch (>= 2 = cross-job batching
    # happened), `windows` the live rows, `width` the padded dispatch width
    "serve.start": {"workdir": str, "backend": str, "batch": int,
                    "workers": int, "pid": int},
    "serve.job": {"job": str, "state": str, "tenant": str},
    "serve.admit": {"tenant": str, "job": str, "bytes": int, "queued": int},
    "serve.reject": {"tenant": str, "reason": str, "job": str, "bytes": int},
    "serve.batch": {"windows": int, "jobs": int, "stream": str, "width": int,
                    "reason": str, "job": str},
    "serve.commit": {"job": str, "fragments": int, "bytes": int},
    "serve.abort": {"job": str, "reason": str},
    "serve.shed": {"level": int, "rss_mb": _NUM},
    "serve.group": {"group": str, "key": str, "backend": str, "batch": int},
    "serve.evict": {"group": str, "key": str, "idle_s": _NUM},
    "serve.done": {"jobs": int, "done": int, "wall_s": _NUM},
    # SLO burn tracking: rolling p99-vs-target over the serve
    # latency window — burn = p99/target (>= the shed fraction drives the
    # batch-width shed ladder BEFORE breach; >= 1 is a breach), n = jobs in
    # the window. Emitted by the serve ticker when burn changes band.
    "serve.slo": {"target_s": _NUM, "burn": _NUM, "n": int},
    # crash-durable serve tier: serve.journal mirrors each
    # write-ahead journal append (rec = admitted | running | progress |
    # committing | committed | aborted | failed | interrupted | replayed |
    # demoted) into the events stream; serve.replay summarizes a restart's
    # journal fold (orphans re-admitted through the quota path, finished =
    # commits recovered without a re-run, torn = tolerated torn-tail
    # lines); serve.takeover is a peer claiming a dead process's stale
    # per-job lease and finishing its journaled job.
    "serve.journal": {"rec": str, "job": str},
    "serve.replay": {"jobs": int, "orphans": int, "finished": int,
                     "torn": int},
    "serve.takeover": {"job": str, "prev_host": str, "stale_s": _NUM},
    # front door. serve.announce = a peer publishing its URL as
    # an announce lease for router discovery; serve.evict_defer = the idle
    # sweep deferring a warm-group eviction because a live router's
    # stickiness still points a recently-routed tenant at it (the
    # evict-vs-route race fix).
    "serve.announce": {"url": str, "peer": str},
    "serve.evict_defer": {"group": str, "key": str, "routed_s": _NUM},
    # fleet-shared AOT executable cache (serve/aotcache.py): hit = a warm
    # load (memory or deserialize) skipping a jit compile, publish = a
    # fresh compile serialized for the fleet, reject = a cache entry
    # refused (reason = corrupt | version | deserialize | ...) with cold
    # fallback — a reject on a registry-held fingerprint is a sentinel
    # finding, never a correctness event.
    "aot.hit": {"key": str, "wall_s": _NUM},
    "aot.miss": {"key": str},
    "aot.publish": {"key": str, "bytes": int, "wall_s": _NUM},
    "aot.reject": {"key": str, "reason": str},
    # storage fault matrix. io.fault = one observed disk refusal
    # (domain = journal | lease | manifest | spool | sidecar | aot, real or
    # injected; error = errno text or grace-beat accounting). disk.pressure
    # = the governor's state transitions (level = enter | clear |
    # spawn_floor; src = journal | watermark | probe | fleet; free_mb = -1
    # when the volume was unreadable). journal.compact = one ONLINE journal
    # compaction (before/after bytes, kept = live + idempotency-keyed jobs,
    # torn = tolerated unparseable lines). aot.sweep = the shared AOT dir's
    # size-capped LRU eviction (freed/total in bytes).
    "io.fault": {"domain": str, "op": str, "error": str},
    "disk.pressure": {"level": str, "src": str, "free_mb": _NUM,
                      "detail": str},
    "journal.compact": {"before": int, "after": int, "kept": int,
                        "torn": int},
    "aot.sweep": {"removed": int, "freed": int, "total": int,
                  "cap_mb": _NUM},
    # stateless tenant router (serve/router.py): route = one admission
    # decision (spilled = stickiness overridden), spill = why + where,
    # peer_up/peer_down = discovery transitions (announce lease + healthz),
    # proxy_error = transport failure answered 502-retryable (the client's
    # idempotency key makes the retry exactly-once).
    "router.start": {"workdir": str, "peer_dir": str, "pid": int},
    "router.route": {"tenant": str, "peer": str, "spilled": bool},
    "router.spill": {"tenant": str, "owner": str, "to": str, "reason": str},
    "router.proxy_error": {"peer": str, "error": str},
    "router.peer_up": {"peer": str, "url": str, "ready": bool},
    "router.peer_down": {"peer": str, "reason": str},
    "router.done": {"wall_s": _NUM, "routes": int, "spills": int},
    # network fault matrix. net.fault = one injected socket
    # fault observed at the serve/netio.py choke point (kind = net_* per
    # the DACCORD_FAULT grammar, domain = healthz|submit|result|stream|
    # abort). net.hedge = a hedged read fired because the peer exceeded
    # its p99-derived latency budget. router.breaker = a per-peer circuit
    # breaker transition (state = open | half-open | closed).
    # router.partition = asymmetry reconciliation: healthz unreachable but
    # the announce lease is fresh (state = begin | end) — the peer spills
    # but is never reaped or takeover-claimed. router.client_gone = the
    # DOWNSTREAM client disconnected mid-proxied-stream (classified apart
    # from peer failures so a healthy peer is not blamed).
    "net.fault": {"kind": str, "domain": str, "peer": str},
    "net.hedge": {"peer": str, "domain": str, "budget_s": _NUM},
    "router.breaker": {"peer": str, "state": str},
    "router.partition": {"peer": str, "state": str, "lease_age_s": _NUM},
    "router.client_gone": {"peer": str, "path": str, "bytes": int},
    # SLO-burn autoscaler (serve/autoscale.py): burn = fleet band change
    # audit trail, spawn/drain/reap = the bounded scale-out/in lifecycle.
    "scale.burn": {"burn": _NUM, "band": int, "n_ready": int, "n_live": int},
    "scale.spawn": {"peer": str, "pid": int, "workdir": str,
                    "n_spawned": int},
    "scale.drain": {"peer": str, "reason": str},
    "scale.reap": {"peer": str, "rc": int, "life_s": _NUM},
    "bench_start": {"batch": int},
    "bench_compile": {"batch": int, "cached": bool, "expected_wall_s": _NUM},
    # self-staging bench ladder: one row per completed rung (sidecar
    # committed the moment the rung lands — see bench.py ladder mode).
    # pad_waste rides every rung so paged-vs-dense is attributable per rung
    "bench_rung": {"batch": int, "bases_per_sec": _NUM, "fallback": bool,
                   "pad_waste": _NUM},
    "bench_drain": {"fetched": int, "inflight": int},
    "bench_done": {"wall_s": _NUM},
}

_STATES = ("HEALTHY", "COMPILING", "SUSPECT", "RETRYING", "LOST",
           "DEGRADED", "FAILBACK")

# device trust ratchet: tightens within a run (self-loops are
# repeat strikes under a >2 threshold); QUARANTINED -> SUSPECT is the one
# loosening edge — the registry-load probation demotion
_TRUST_STATES = ("TRUSTED", "SUSPECT", "QUARANTINED")
_TRUST_TRANSITIONS = {
    "TRUSTED": {"SUSPECT", "QUARANTINED"},
    "SUSPECT": {"SUSPECT", "QUARANTINED"},
    "QUARANTINED": {"QUARANTINED", "SUSPECT"},
}


def validate_events(path: str, strict: bool = False) -> list[str]:
    """Errors found in the events file (empty list = valid)."""
    from ..runtime.supervisor import TRANSITIONS

    errs: list[str] = []
    state = None
    last_t = None
    open_spans: set[str] = set()
    in_shard_segment = False
    try:
        with open(path) as fh:
            lines = fh.readlines()
    except OSError as e:
        return [f"{path}: unreadable ({e})"]
    for ln, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            errs.append(f"line {ln}: not JSON ({e})")
            continue
        if not isinstance(rec, dict):
            errs.append(f"line {ln}: not an object")
            continue
        fields = dict(BASE_FIELDS)
        fields.update(EVENT_FIELDS.get(rec.get("event", ""), {}))
        for name, types in fields.items():
            tt = types if isinstance(types, tuple) else (types,)
            if name not in rec:
                errs.append(f"line {ln}: {rec.get('event', '?')} missing "
                            f"field {name!r}")
                continue
            val = rec[name]
            # bool is an int subclass; only accept it where bool is declared
            ok = isinstance(val, tt) and (bool in tt
                                          or not isinstance(val, bool))
            if not ok:
                errs.append(f"line {ln}: {rec.get('event', '?')}.{name} has "
                            f"type {type(val).__name__}")
        if not strict:
            continue
        ev_name = rec.get("event")
        if ev_name == "shard_start" or (
                # serve.start joins the boundary set: a restarted
                # daccord-serve appends to the same serve.events.jsonl
                # with a fresh relative clock (same contract as a
                # requeued shard's sidecar)
                # router.start likewise: a restarted daccord-router
                # appends to the same router.events.jsonl
                ev_name in ("sup_init", "bench_start", "serve.start",
                            "router.start")
                and not in_shard_segment):
            # stream boundary: JsonlLogger appends with a per-process
            # relative clock, so a rerun against the same --events path (or
            # a resumed shard) legitimately restarts t and the state chain.
            # Spans reset too — a killed attempt's unclosed spans must not
            # poison the next attempt's pairing (daccord-trace --check is
            # the stricter per-segment lint). Inside a shard_start-opened
            # segment the mid-run sup_init is NOT a boundary (the telemetry
            # spine emits shard_start first; spans opened before the
            # supervisor exists must stay tracked) — bench and pre-spine
            # files, which have no shard_start, keep the old reset points.
            last_t = None
            state = None
            open_spans = set()
            in_shard_segment = ev_name == "shard_start"
        t = rec.get("t")
        if (isinstance(t, _NUM) and not isinstance(t, bool)
                # shard-level commit/fault rows are stamped by launch.py's
                # logger, whose relative clock starts earlier than the
                # pipeline logger appending to the same file — exempt them
                # from monotonicity rather than flag healthy runs
                and rec.get("event") not in ("ingest.commit", "ingest.fault")):
            if last_t is not None and t < last_t:
                errs.append(f"line {ln}: t went backwards "
                            f"({t} < {last_t})")
            last_t = t
        if rec.get("event") == "span_open":
            sid = rec.get("span")
            if isinstance(sid, str):
                if sid in open_spans:
                    errs.append(f"line {ln}: span {sid!r} opened twice")
                open_spans.add(sid)
        elif rec.get("event") == "span_close":
            sid = rec.get("span")
            if isinstance(sid, str):
                if sid not in open_spans:
                    errs.append(f"line {ln}: span_close {sid!r} without a "
                                "matching span_open")
                open_spans.discard(sid)
        if rec.get("event") == "sup_state":
            f, to = rec.get("state_from"), rec.get("state_to")
            if f not in _STATES or to not in _STATES:
                errs.append(f"line {ln}: unknown supervisor state "
                            f"{f!r} -> {to!r}")
            elif to not in TRANSITIONS.get(f, set()):
                errs.append(f"line {ln}: illegal transition {f} -> {to}")
            elif state is not None and f != state:
                errs.append(f"line {ln}: transition from {f} but supervisor "
                            f"was {state}")
            state = to
        if rec.get("event") == "trust.state":
            f, to = rec.get("state_from"), rec.get("state_to")
            if f not in _TRUST_STATES or to not in _TRUST_STATES:
                errs.append(f"line {ln}: unknown trust state {f!r} -> {to!r}")
            elif to not in _TRUST_TRANSITIONS.get(f, set()):
                errs.append(f"line {ln}: illegal trust transition {f} -> {to}")
    return errs


def eventcheck_main(argv=None) -> int:
    """eventcheck: lint a jsonl events file against the event schema."""
    p = argparse.ArgumentParser(prog="eventcheck",
                                description=eventcheck_main.__doc__)
    p.add_argument("files", nargs="+", help="events jsonl file(s)")
    p.add_argument("--strict", action="store_true",
                   help="also enforce supervisor transition legality and "
                        "monotonic timestamps")
    p.add_argument("--max-report", type=int, default=20)
    args = p.parse_args(argv)
    bad = 0
    for path in args.files:
        errs = validate_events(path, strict=args.strict)
        for e in errs[: args.max_report]:
            print(f"{path}: {e}", file=sys.stderr)
        if len(errs) > args.max_report:
            print(f"{path}: ... {len(errs) - args.max_report} more",
                  file=sys.stderr)
        n = sum(1 for ln in open(path) if ln.strip()) if not errs else 0
        print(f"{path}: {'OK (%d events)' % n if not errs else 'BAD (%d errors)' % len(errs)}",
              file=sys.stderr)
        bad += bool(errs)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(eventcheck_main())
