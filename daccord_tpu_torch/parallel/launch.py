"""Checkpointed LAS byte-range shards on one host, and their validating
merge.

The port's copy of ``daccord_tpu/parallel/launch.py`` (``daccord-shard``,
``daccord-merge``): shard ``i`` of ``n`` streams LAS byte range ``i``
(aread-aligned) and writes its own FASTA and a JSON manifest, so a rerun of
the same command is idempotent and a crashed run resumes (the ``-J i,n``
array-job model of the upstream tool). With ``checkpoint_every`` a progress
manifest records the emitted piles, the FASTA size and the error profile
every N reads, so a restarted run truncates the partial tail and resumes mid
shard, byte-identical to an uninterrupted run. The merge gate checks every
manifest, the byte-range coverage and each shard's counts and sha256 before
the merged FASTA commits. :func:`init_distributed` forms a
``torch.distributed`` process group when several processes (hosts) share a
run, as the JAX module's ``jax.distributed`` does: each corrects its own
byte range on its local cards (``--mesh`` over them), and no correction
traffic crosses processes.
"""

from __future__ import annotations

import json
import os

from ..formats.dazzdb import read_db
from ..formats.las import LasFile, index_las, shard_ranges
from ..runtime.pipeline import PipelineConfig, correct_shard, correct_to_fasta


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device: str = "cuda") -> tuple[int, int]:
    """Join a ``torch.distributed`` process group when running several
    processes; a no-op otherwise. Returns ``(rank, world_size)``.

    ``coordinator`` (``host:port`` of rank 0, default ``DACCORD_COORDINATOR``)
    None or empty: one process, ``(0, 1)``. Otherwise the group is formed
    over ``tcp://coordinator`` with ``num_processes`` and ``process_id``
    (default ``DACCORD_NUM_PROCESSES`` and ``DACCORD_PROCESS_ID``; nothing
    is discovered from a cluster), on gloo for ``device='cpu'`` and NCCL on
    cuda. A process already in a group gets its rank and size back."""
    import torch.distributed as dist

    if coordinator is None:
        coordinator = os.environ.get("DACCORD_COORDINATOR")
    if not coordinator:
        return 0, 1
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if num_processes is None and os.environ.get("DACCORD_NUM_PROCESSES"):
        num_processes = int(os.environ["DACCORD_NUM_PROCESSES"])
    if process_id is None and os.environ.get("DACCORD_PROCESS_ID"):
        process_id = int(os.environ["DACCORD_PROCESS_ID"])
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: a coordinator needs num_processes and "
                         "process_id (or DACCORD_NUM_PROCESSES, DACCORD_PROCESS_ID)")
    dist.init_process_group(backend="gloo" if device == "cpu" else "nccl",
                            init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id))
    return dist.get_rank(), dist.get_world_size()


def shard_paths(outdir: str, shard: int) -> dict:
    return {
        "fasta": os.path.join(outdir, f"shard{shard:04d}.fasta"),
        "manifest": os.path.join(outdir, f"shard{shard:04d}.json"),
        "progress": os.path.join(outdir, f"shard{shard:04d}.progress.json"),
        "quarantine": os.path.join(outdir, f"shard{shard:04d}.quarantine.jsonl"),
        # sidecars: structured events (and trace spans), the per-window
        # outcome ledger, and the end-of-run metrics rollup
        "events": os.path.join(outdir, f"shard{shard:04d}.events.jsonl"),
        "ledger": os.path.join(outdir, f"shard{shard:04d}.ledger.jsonl"),
        "metrics": os.path.join(outdir, f"shard{shard:04d}.metrics.json"),
    }


def _write_manifest_durable(path: str, obj: dict) -> None:
    """Manifest commit through :func:`aio.durable_write`: a crash leaves the
    old manifest (or none), never a torn JSON that wedges every later rerun,
    and a failed commit leaves no tmp file."""
    from ..utils.aio import durable_write

    durable_write(path, lambda fh: json.dump(obj, fh), mode="wt", domain="manifest")


def load_shard_manifest(outdir: str, shard: int) -> tuple[dict | None, str | None]:
    """``(manifest, issue)`` — the shard's manifest iff it is trustworthy.

    A manifest only counts when the FASTA it references still exists and (for
    manifests new enough to record ``fasta_bytes``) still has the committed
    byte size; a deleted or truncated FASTA under a valid-looking manifest
    must trigger recomputation (``run_shard``) or a merge-gate refusal, never
    a silent short-circuit over missing output. Returns ``(None, None)`` when
    the manifest is absent or torn (a torn JSON counts as never written),
    ``(None, reason)`` when it is present but belied by the FASTA.
    """
    paths = shard_paths(outdir, shard)
    if not os.path.exists(paths["manifest"]):
        return None, None
    try:
        with open(paths["manifest"]) as fh:
            m = json.load(fh)
    except (json.JSONDecodeError, OSError):
        # a torn manifest (disk damage) must not wedge the idempotent rerun:
        # it counts as absent
        return None, None
    if not isinstance(m, dict):
        return None, None
    if not os.path.exists(paths["fasta"]):
        return None, "manifest present but its FASTA is missing"
    fb = m.get("fasta_bytes")
    if fb is not None:
        size = os.path.getsize(paths["fasta"])
        if size != fb:
            return None, (f"FASTA is {size} bytes, manifest committed {fb} "
                          "(truncated or tampered)")
    return m, None


def run_shard(db_path: str, las_path: str, outdir: str, shard: int, nshards: int,
              cfg: PipelineConfig | None = None, force: bool = False,
              checkpoint_every: int = 0) -> dict:
    """Correct one LAS byte-range shard to its own FASTA + manifest.

    Idempotent: an existing manifest (unless ``force``) short-circuits, so a
    failed multi-host run is resumed by re-submitting the same command.

    With ``checkpoint_every=N`` the shard also checkpoints every N emitted
    reads: a progress JSON records the count of fully-emitted piles, the
    FASTA byte size at that point and the error profile. A crashed run
    restarted with the same command truncates the partial FASTA tail and
    resumes mid-shard instead of redoing the whole byte range.
    """
    os.makedirs(outdir, exist_ok=True)
    paths = shard_paths(outdir, shard)
    if not force:
        # the short-circuit must validate, not just exist: a cached manifest
        # whose FASTA was deleted (or truncated — fasta_bytes catches that)
        # would otherwise satisfy the rerun while the merge reads nothing
        cached, _ = load_shard_manifest(outdir, shard)
        if cached is not None:
            return cached
    if force:
        # --force means recompute from scratch, not resume the old run —
        # the progress manifest, the quarantine sidecar, and the outcome
        # ledger all reset
        for key in ("progress", "quarantine", "ledger"):
            if os.path.exists(paths[key]):
                os.remove(paths[key])
    cfg = cfg or PipelineConfig()
    if cfg.ingest_policy == "quarantine" and cfg.quarantine_path is None:
        import dataclasses

        cfg = dataclasses.replace(cfg, quarantine_path=paths["quarantine"])
    # shard_ranges skips the aread index for nshards<=1, so single-shard
    # quarantine runs over a damaged LAS work without a repair pass
    ranges = shard_ranges(las_path, nshards)
    start, end = ranges[shard]
    if not checkpoint_every:
        # (correct_to_fasta starts a fresh ledger sidecar itself: whole-range
        # runs never append)
        stats = correct_to_fasta(db_path, las_path, paths["fasta"], cfg,
                                 start=start, end=end)
        counters = {"reads": stats.n_reads, "windows": stats.n_windows,
                    "solved": stats.n_solved, "bases_out": stats.bases_out,
                    # FASTA-record count: `reads` counts emitted piles, which
                    # the merge gate cannot reconcile with the file (a pile
                    # may legitimately emit zero fragments)
                    "fragments": stats.n_fragments,
                    "wall_s": stats.wall_s, **_final_counters(stats)}
    else:
        counters = _run_shard_checkpointed(db_path, las_path, paths, start, end,
                                           cfg, checkpoint_every)
    # the metrics rollup commits beside the manifest, not inside it: the
    # merge gate and the idempotent rerun stay blind to metrics
    metrics_rollup = counters.pop("_metrics", None)
    manifest = {
        "shard": shard, "nshards": nshards, "byte_range": [start, end],
        **counters, "fasta": paths["fasta"],
        # committed output size: lets the stale-manifest short-circuit and
        # the merge gate catch a truncated FASTA, not just a missing one
        "fasta_bytes": os.path.getsize(paths["fasta"]),
    }
    # content digest: the merge gate verifies it before concatenating (a
    # corrupting device writes the right number of wrong bytes)
    from ..utils.obs import sha256_file

    manifest["fasta_sha256"] = sha256_file(paths["fasta"])
    _write_manifest_durable(paths["manifest"], manifest)
    if metrics_rollup:
        _write_manifest_durable(paths["metrics"], {
            "shard": shard, "wall_s": counters.get("wall_s"),
            "device_s": counters.get("device_s"),
            "host_s": counters.get("host_s"), **metrics_rollup})
        # the same rollup as a shard-labelled Prometheus text exposition
        from ..utils.aio import durable_write
        from ..utils.obs import render_prom

        prom = render_prom(metrics_rollup, labels={"shard": shard})
        durable_write(paths["metrics"][: -len(".json")] + ".prom",
                      lambda fh: fh.write(prom), mode="wt", domain="manifest")
    if os.path.exists(paths["progress"]):
        os.remove(paths["progress"])
    return manifest


def _run_shard_checkpointed(db_path: str, las_path: str, paths: dict,
                            start: int, end: int, cfg: PipelineConfig | None,
                            every: int) -> dict:
    """Stream one shard with periodic progress checkpoints; resumes from an
    existing progress file (piles emit in input order, so `emitted` piles map
    1:1 onto the first `emitted` pile offsets of the byte range)."""
    import time

    from ..formats.fasta import FastaRecord, write_fasta
    from dataclasses import astuple

    from ..oracle.profile import ErrorProfile
    from ..runtime.faults import maybe_apply_data_faults
    from ..runtime.pipeline import estimate_profile_for_shard
    from ..utils.bases import ints_to_seq
    from ..utils.obs import JsonlLogger

    cfg = cfg or PipelineConfig()
    t0 = time.time()
    fired = maybe_apply_data_faults(las_path=las_path, db_path=db_path)
    if fired and cfg.events_path:
        # short-lived logger: the abort paths below (strict scan failure,
        # resume refusal) must not leak a held fd per retry attempt
        with JsonlLogger(cfg.events_path) as _fl:
            for f in fired:
                _fl.log("ingest.fault", kind=f["kind"], path=f["path"],
                        record=f["record"], offset=f.get("offset", -1))

    emitted = 0
    base = {"reads": 0, "windows": 0, "solved": 0, "bases_out": 0,
            "fragments": 0, "wall_s": 0.0}
    fasta_bytes = 0
    resumed = None
    prog = None
    if os.path.exists(paths["progress"]):
        try:
            with open(paths["progress"]) as fh:
                prog = json.load(fh)
        except (json.JSONDecodeError, OSError):
            # a torn progress manifest (disk damage): a fresh run of the
            # shard, the FASTA rewritten, never spliced onto an untrusted tail
            prog = None
        # a progress file is only valid for the same byte range (resharding
        # with a different n would map `emitted` onto different piles) and
        # only while its FASTA prefix still exists
        if prog is not None and prog.get("byte_range") != [start, end]:
            prog = None
        elif prog is not None and not os.path.exists(paths["fasta"]):
            prog = None
        elif prog is not None and \
                os.path.getsize(paths["fasta"]) < prog.get("fasta_bytes", 0):
            # a FASTA shorter than the checkpoint claims cannot be resumed:
            # truncate(fasta_bytes) on the shorter file would zero-fill the
            # hole and splice new output onto NULs — recompute instead
            prog = None
        if prog is not None:
            emitted = prog["emitted"]
            base = prog["counters"]
            fasta_bytes = prog["fasta_bytes"]
            resumed = emitted
    if not emitted:
        # fresh (non-resume) shard run: reset the sidecars so a recompute
        # (e.g. after a torn manifest) cannot accumulate duplicate rows —
        # resumes append deliberately (ledger dedupe key: aread+widx)
        for p in (cfg.quarantine_path, cfg.ledger_path):
            if p and os.path.exists(p):
                os.remove(p)

    db = read_db(db_path, strict=cfg.ingest_policy == "strict")
    las = LasFile(las_path)
    # pre-flight ingest scan (the pipeline rescans its own byte range — this
    # header-only pass is cheap): the checkpointed path must know about
    # corruption BEFORE it samples piles (index_las rightly rejects a
    # corrupt file) and before it trusts the emitted-pile resume mapping
    clean_piles = None
    if cfg.ingest_policy != "off":
        from ..formats.ingest import scan_with_db

        rep = scan_with_db(db, las, start, end)
        if rep.issues:
            if cfg.ingest_policy == "strict":
                raise rep.error()
            if emitted:
                # quarantine markers need not emit a read, so `emitted`
                # no longer maps 1:1 onto pile offsets — resuming would
                # re-emit (duplicate) or skip reads silently
                raise SystemExit(
                    f"{paths['progress']}: cannot resume mid-shard over a "
                    "corrupt LAS under the quarantine policy (contained "
                    "piles break the emitted-pile offset mapping) — rerun "
                    "the shard with --force")
            clean_piles = rep.pile_ranges
    if emitted:
        # pile-aligned offsets are only needed on resume (index_las is a full
        # file scan; a fresh run skips it)
        idx = index_las(las_path)
        offs = [int(o) for _, o in idx if start <= o < end] + [end]
        resume_off = offs[min(emitted, len(offs) - 1)]
    else:
        resume_off = start

    # the error profile is estimated once (from the shard's own start) and
    # persisted with every field (the hp model too), so a resumed run
    # writes the uninterrupted run's bytes instead of re-estimating from the
    # resume point
    if prog is not None and "profile" in prog:
        profile = ErrorProfile(*prog["profile"])
    else:
        profile = estimate_profile_for_shard(db, las, cfg, start, end,
                                             pile_ranges=clean_piles)
    prof_row = list(astuple(profile))
    counters = dict(base)
    # a progress file without the fragment count cannot give it: the
    # counter is left out rather than committed wrong
    frag_base = base.get("fragments")
    nfrag = 0
    # truncate any partial tail past the last checkpoint, then append
    mode = "r+t" if emitted else "wt"
    last_st = None
    with open(paths["fasta"], mode) as out:
        out.truncate(fasta_bytes)
        out.seek(fasta_bytes)
        since = 0
        for rid, frags, st in correct_shard(db, las, cfg, resume_off, end,
                                            profile=profile):
            last_st = st
            write_fasta(out, [FastaRecord(f"read{rid}/{fi}", ints_to_seq(f))
                              for fi, f in enumerate(frags)])
            emitted += 1
            since += 1
            nfrag += len(frags)
            # st counters are cumulative over this run; add the pre-resume base
            counters = {"reads": base["reads"] + emitted - (resumed or 0),
                        "windows": base["windows"] + st.n_windows,
                        "solved": base["solved"] + st.n_solved,
                        "bases_out": base["bases_out"] + st.bases_out,
                        "wall_s": round(base["wall_s"] + (time.time() - t0), 3)}
            if frag_base is not None:
                counters["fragments"] = frag_base + nfrag
            if since >= every:
                # crash-durable commit ordering: (1) the FASTA
                # bytes the manifest will reference reach the platter, (2)
                # the manifest tmp's content does, (3) the rename publishes
                # it. A checkpoint can then never point past durable FASTA
                # bytes — a kill between any two fsync points resumes with
                # no lost or duplicated reads (the stale manifest's prefix
                # is durable by step 1; the partial tail truncates on resume)
                out.flush()
                os.fsync(out.fileno())
                _write_manifest_durable(
                    paths["progress"],
                    {"emitted": emitted, "fasta_bytes": out.tell(),
                     "counters": counters, "profile": prof_row,
                     "byte_range": [start, end]})
                if cfg.events_path:
                    # short-lived append (noise next to the two fsyncs):
                    # no held fd to leak when an abort path unwinds
                    with JsonlLogger(cfg.events_path) as _cl:
                        _cl.log("ingest.commit", emitted=emitted,
                                fasta_bytes=out.tell())
                since = 0
    counters["wall_s"] = round(base["wall_s"] + (time.time() - t0), 3)
    if resumed is not None:
        counters["resumed_at_read"] = resumed
    if last_st is not None:
        # the degraded state is final only once the shard's generator is
        # exhausted (failover can happen in the last drain). On a resume
        # these cover the resumed run alone; wall_s alone is cumulative
        counters.update(_final_counters(last_st))
    return counters


def _final_counters(st) -> dict:
    """The manifest's end-of-run fields of a shard's ``PipelineStats``, and
    its metrics rollup (``_metrics``, committed beside the manifest)."""
    return {"quarantined": st.n_quarantined,
            "ingest_issues": st.n_ingest_issues,
            # a shard that finished on the failover engine is correct
            # output, but the manifest says so: the merge gate refuses it
            # without --allow-degraded
            "degraded": st.degraded, "fallback_reason": st.fallback_reason,
            # a ratcheted governor degrades speed, never bytes, so it is not
            # `degraded`: the merge gate accepts it
            "batch_effective": st.batch_effective,
            "capacity_events": st.n_capacity_events,
            "governor": st.governor_ratchet or None,
            # the wall decomposition's anchors (tools/trace.py)
            "device_s": round(st.device_s, 4), "host_s": round(st.host_s, 4),
            "_metrics": st.metrics}


class MergeGateError(ValueError):
    """The merge gate refused to concatenate: one message per violation in
    ``issues`` (missing/stale manifests, coverage gaps, count mismatches,
    degraded shards without ``allow_degraded``)."""

    def __init__(self, issues: list):
        self.issues = list(issues)
        super().__init__("; ".join(self.issues))


def merge_shards(outdir: str, nshards: int, out_fasta: str,
                 allow_degraded: bool = False) -> int:
    """Validating merge gate and crash-durable concatenation.

    Before a single byte is written every shard manifest is checked: present
    and trustworthy (:func:`load_shard_manifest` — FASTA exists with the
    committed ``fasta_bytes``), indexed consistently (``shard``/``nshards``
    fields), and byte-range coverage is gapless across the shards. Shards
    that finished degraded (failover engine) or with quarantined piles are
    refused unless ``allow_degraded``; with it, missing shards are also
    skipped rather than fatal, and the merge covers the surviving byte
    ranges only. While concatenating, each healthy shard's
    emitted read and base counts are cross-checked against its manifest
    instead of silently trusting the files. The output commits through
    :func:`aio.durable_write` (tmp + fsync + rename): a crash mid-merge can
    never leave a valid-looking truncated FASTA, and a failed count check
    aborts before publishing anything. Returns the fragment count.
    """
    from ..utils.aio import durable_write

    manifests: dict[int, dict] = {}
    missing: list[int] = []
    degraded: list[int] = []
    corrupt: list[int] = []
    issues: list[str] = []
    for s in range(nshards):
        m, why = load_shard_manifest(outdir, s)
        if m is None:
            if why:
                # present-but-belied manifests are corruption, never skippable
                issues.append(f"shard {s}: {why}")
            else:
                missing.append(s)
            continue
        if m.get("shard") not in (None, s):
            issues.append(f"shard {s}: manifest claims shard {m.get('shard')}")
        if m.get("nshards") not in (None, nshards):
            issues.append(f"shard {s}: manifest was written for a "
                          f"{m.get('nshards')}-way split, merging {nshards}")
        # capacity-degraded shards (manifest `batch_effective` below the
        # configured batch / a non-empty `governor` ratchet) pass WITHOUT
        # --allow-degraded by design: the governor degrades dispatch width,
        # never bytes — unlike engine failover (`degraded`) or quarantined
        # piles, whose output genuinely differs from the healthy run
        if m.get("degraded") or m.get("quarantined"):
            degraded.append(s)
        # the committed digest must match the bytes on disk: byte counts
        # pass under silent corruption, the digest does not (a manifest
        # without one verifies by counts only)
        sha = m.get("fasta_sha256")
        if sha is not None:
            from ..utils.obs import sha256_file

            if sha256_file(shard_paths(outdir, s)["fasta"]) != sha:
                corrupt.append(s)
        manifests[s] = m
    if corrupt and not allow_degraded:
        issues.append(f"shard(s) {corrupt}: FASTA content digest mismatches "
                      "the committed manifest (silent corruption) — rerun "
                      "them, or pass --allow-degraded to merge the bytes on "
                      "disk anyway")
    if missing and not allow_degraded:
        issues.append(f"missing shard output(s) {missing} — rerun them or "
                      "pass --allow-degraded to merge without them")
    if degraded and not allow_degraded:
        issues.append(f"shard(s) {degraded} completed degraded/quarantined — "
                      "pass --allow-degraded to merge anyway")
    if not missing:
        # byte-range coverage: gapless, non-overlapping, in shard order.
        # (With explicitly allowed missing shards the gaps are the point.)
        for a, b in zip(sorted(manifests), sorted(manifests)[1:]):
            ra, rb = manifests[a].get("byte_range"), manifests[b].get("byte_range")
            if ra and rb and ra[1] != rb[0]:
                issues.append(f"byte-range gap between shard {a} (ends {ra[1]}) "
                              f"and shard {b} (starts {rb[0]})")
    if issues:
        raise MergeGateError(issues)

    def _concat(out) -> int:
        frags = 0
        for s in sorted(manifests):
            m = manifests[s]
            reads: set[str] = set()
            bases = 0
            frag_count = 0
            with open(shard_paths(outdir, s)["fasta"]) as fh:
                for line in fh:
                    out.write(line)
                    if line.startswith(">"):
                        frag_count += 1
                        reads.add(line[1:].split("/", 1)[0].strip())
                    else:
                        bases += len(line.rstrip("\n"))
            # count cross-check (healthy shards only: quarantined piles may
            # legitimately emit no read, so their counters do not reconcile)
            if not m.get("quarantined"):
                errs = []
                if (m.get("fragments") is not None
                        and frag_count != m["fragments"]):
                    errs.append(f"shard {s}: FASTA holds {frag_count} "
                                f"fragments, manifest says {m['fragments']}")
                # a pile may legitimately emit zero fragments, so distinct
                # read ids can run BELOW the manifest's pile count — but
                # never above it
                if m.get("reads") is not None and len(reads) > m["reads"]:
                    errs.append(f"shard {s}: FASTA holds {len(reads)} reads, "
                                f"manifest says {m['reads']}")
                if m.get("bases_out") is not None and bases != m["bases_out"]:
                    errs.append(f"shard {s}: FASTA holds {bases} bases, "
                                f"manifest says {m['bases_out']}")
                if errs:
                    # raising here aborts durable_write BEFORE the rename —
                    # no partial merged FASTA is ever published
                    raise MergeGateError(errs)
            frags += frag_count
        return frags

    return durable_write(out_fasta, _concat, mode="wt", domain="manifest")
