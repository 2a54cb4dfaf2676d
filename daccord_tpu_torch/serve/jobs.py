"""Job lifecycle: spec parsing, CLI-default config parity, the runner.

The port's copy of the JAX package's ``serve/jobs.py``. A serve job's bytes
equal a solo ``daccord`` run with the same inputs and flags, so
:func:`build_job_config` builds the pipeline config the way the port's
``tools/cli.py`` does (the tier ladder from ``k``, the DBG parameters from
``candidates``/``max_err``, the hp default by backend, the device from the
backend); any drift here is a byte-parity bug, and the serve tests compare
against the real solo path to catch it.

Jobs arrive as JSON: server-local ``db``/``las`` paths, or uploaded files
(``files``: name -> base64) spooled into the job's work directory. The
ingest gate validates at admission (``scan_with_db``): a strict-policy job
with integrity violations is rejected with the structured report before it
costs a queue slot, and the runner hands its own scan to ``correct_shard``
so the validation is not paid twice.

The runner streams fragments to its part file as they emit (the HTTP layer
live-streams that file), then commits durably: fsync -> rename -> manifest
through ``aio.durable_write``.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time
from dataclasses import dataclass, field

# job states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
ABORTED = "aborted"


@dataclass
class JobSpec:
    db: str
    las: str
    tenant: str = "default"
    # solve-semantics knobs (CLI flag parity; defaults == daccord defaults)
    w: int = 40
    adv: int = 10
    k: int = 8
    depth: int = 32
    seg_len: int = 64
    max_kmers: int = 64
    candidates: int = 3
    max_err: float = 0.3
    mode: str = "split"
    overflow_rescue: bool = False
    hp_rescue: bool | None = None    # None = backend-keyed default (CLI rule)
    hp_vote: str = "median"
    hp_accept: str = "rescore"
    end_trim: bool = True
    qv_track: str | None = "inqual"
    ingest_policy: str = "strict"
    profile_sample_piles: int = 4
    nbytes: int = 0                  # admission accounting (db + las bytes)
    uploaded: bool = False

    @classmethod
    def from_json(cls, body: dict, jobdir: str) -> "JobSpec":
        """Parse a submission body; uploaded files spool into ``jobdir``.
        Raises ValueError on a malformed spec (HTTP 400)."""
        body = dict(body)
        files = body.pop("files", None)
        uploaded = False
        if files:
            from ..utils import aio

            os.makedirs(jobdir, exist_ok=True)
            for name, b64 in files.items():
                name = os.path.basename(str(name))
                if not name:
                    raise ValueError("files: empty file name")
                # spool through the aio fault hook (``@spool`` domain): an
                # ENOSPC here raises out of admission, which releases the
                # tenant's quota charge and rmtree's the spool dir — a
                # refused upload leaves no disk residue (see _submit_new)
                with aio.open_output(os.path.join(jobdir, name), "wb",
                                     domain="spool") as fh:
                    fh.write(base64.b64decode(b64))
            uploaded = True
            for key in ("db", "las"):
                if key not in body:
                    raise ValueError(f"upload job needs {key!r} naming the "
                                     "uploaded entry")
                body[key] = os.path.join(jobdir,
                                         os.path.basename(str(body[key])))
        for key in ("db", "las"):
            if key not in body:
                raise ValueError(f"job spec missing {key!r}")
        known = set(cls.__dataclass_fields__) - {"nbytes", "uploaded"}
        unknown = set(body) - known
        if unknown:
            raise ValueError(f"unknown job fields: {sorted(unknown)}")
        # type-check the simple fields at the boundary: dataclasses don't,
        # and a wrong-typed knob accepted here would surface later as an
        # opaque FAILED job instead of a 400 (bool is an int subclass —
        # reject it for numeric fields explicitly)
        _types = {"db": str, "las": str, "tenant": str, "w": int, "adv": int,
                  "k": int, "depth": int, "seg_len": int, "max_kmers": int,
                  "candidates": int, "max_err": (int, float), "mode": str,
                  "overflow_rescue": bool, "hp_rescue": (bool, type(None)),
                  "hp_vote": str, "hp_accept": str, "end_trim": bool,
                  "qv_track": (str, type(None)), "ingest_policy": str,
                  "profile_sample_piles": int}
        for name, want in _types.items():
            if name not in body:
                continue
            v = body[name]
            ok = isinstance(v, want)
            if ok and want in (int, (int, float)) and isinstance(v, bool):
                ok = False
            if not ok:
                raise ValueError(f"job field {name!r}: expected "
                                 f"{getattr(want, '__name__', want)}, got "
                                 f"{type(v).__name__}")
        spec = cls(**body)
        spec.uploaded = uploaded
        if spec.ingest_policy not in ("strict", "quarantine", "off"):
            raise ValueError(f"bad ingest_policy {spec.ingest_policy!r}")
        if not (4 <= spec.k <= 11):
            raise ValueError(f"k {spec.k}: supported range is 4..11")
        for p in (spec.db, spec.las):
            if not (os.path.exists(p) or os.path.exists(p + ".db")):
                raise ValueError(f"input not found: {p}")
        spec.nbytes = sum(os.path.getsize(p) for p in (spec.db, spec.las)
                          if os.path.exists(p))
        return spec


def build_job_config(spec: JobSpec, backend: str, backend_explicit: bool,
                     batch: int, ladder_mode: str, jobdir: str,
                     job_id: str):
    """The job's PipelineConfig, by the port CLI's defaults (see the module
    docstring). ``backend`` is the port's: ``cuda`` (the ladder on the
    card), ``cpu`` (the ladder on the CPU) or ``native`` (the host
    library's tier ladder). The group's cross-job solver replaces the job's
    own solve path, and the group's supervisor owns faults, retries,
    failover and the capacity ladder for every job it serves, so the job's
    pipeline runs unsupervised."""
    from ..oracle.consensus import ConsensusConfig
    from ..oracle.dbg import DBGParams
    from ..runtime.pipeline import PipelineConfig

    if backend not in ("cuda", "cpu", "native"):
        raise ValueError(f"backend {backend!r}: expected cuda, cpu or native")
    k = spec.k
    tiers = ((k, 2, 2), (k + 2, 2, 2), (k + 4, 2, 2), (k, 1, 1))
    hp = spec.hp_rescue
    if hp is None:
        # the CLI's rule: the hp rescue is on by default only for a host
        # engine the operator named (an auto-resolved one follows the card)
        hp = backend in ("native", "cpu") and backend_explicit
    ccfg = ConsensusConfig(w=spec.w, adv=spec.adv, mode=spec.mode,
                           tiers=tiers,
                           dbg=DBGParams(n_candidates=spec.candidates,
                                         max_err=spec.max_err),
                           hp_rescue=hp, hp_vote=spec.hp_vote,
                           hp_accept=spec.hp_accept)
    return PipelineConfig(
        consensus=ccfg, batch_size=batch, depth=spec.depth,
        seg_len=spec.seg_len, max_kmers=spec.max_kmers,
        overflow_rescue=spec.overflow_rescue,
        end_trim=spec.end_trim, qv_track=spec.qv_track or None,
        profile_sample_piles=spec.profile_sample_piles,
        ingest_policy=spec.ingest_policy,
        quarantine_path=os.path.join(jobdir, "quarantine.jsonl"),
        events_path=os.path.join(jobdir, "events.jsonl"),
        ledger_path=os.path.join(jobdir, "ledger.jsonl"),
        job_tag=job_id,
        device="cuda" if backend == "cuda" else "cpu",
        native_solver=backend == "native",
        # the group's supervisor is the device authority for every job it
        # serves; a job's own would consume fault injections twice and wrap
        # the dispatch seam twice
        supervise=False,
        ladder_mode=ladder_mode)


def solve_fingerprint(profile, cfg, backend: str) -> str:
    """Key under which jobs may share device batches: everything that can
    change a window's bytes (the profile's floats, the consensus and ladder
    semantics, the engine family) and nothing that cannot (batch width,
    shapes, telemetry paths, job identity). Full-precision float reprs: two
    jobs share a group only when their solve semantics are bit-identical.
    The engine key is ``native`` or the device type the ladder runs on
    (``cuda``, ``cpu``)."""
    import hashlib

    c = cfg.consensus
    payload = {
        "backend": "native" if backend == "native" else backend,
        "profile": [repr(float(profile.p_ins)), repr(float(profile.p_del)),
                    repr(float(profile.p_sub)), repr(float(profile.hp_slope)),
                    repr(float(profile.hp_base)), int(profile.hp_cap)],
        "w": c.w, "adv": c.adv, "tiers": list(map(list, c.tiers)),
        "mode": c.mode, "min_fragment": c.min_fragment,
        "dbg": [c.dbg.n_candidates, repr(float(c.dbg.max_err)),
                c.dbg.min_depth],
        "hp": [c.hp_rescue, repr(float(c.hp_err)), c.hp_min_run,
               repr(float(c.hp_margin)), c.hp_vote, c.hp_accept,
               repr(float(c.hp_lambda_c))],
        "max_kmers": cfg.max_kmers, "rescue_max_kmers": cfg.rescue_max_kmers,
        "overflow_rescue": cfg.overflow_rescue,
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:24]


@dataclass
class Job:
    id: str
    tenant: str
    spec: JobSpec
    dir: str
    state: str = QUEUED
    submitted_ts: float = field(default_factory=time.time)
    started_ts: float | None = None
    first_emit_ts: float | None = None
    done_ts: float | None = None
    error: str | None = None
    reads: int = 0
    windows: int = 0
    fragments: int = 0
    bases_out: int = 0
    group: str | None = None
    # the crash-durable tier: a watch job is one a live PEER holds
    # (its lease is fresh) — registered so clients polling this process see
    # it, never queued or quota-charged here; the ticker flips it DONE when
    # the peer's manifest lands, or re-admits it if the peer's lease goes
    # stale
    watch: bool = False
    # True while a local run_job thread is executing this job: the takeover
    # scan must never re-queue a job whose demoted straggler is still
    # unwinding (it will exit at its next abort_event check; the reclaim
    # waits for that — two threads on one job would race the commit)
    running_local: bool = False
    # the CURRENT attempt's private part file (set by run_job): every
    # attempt writes its own file, so a demoted straggler's O_APPEND
    # writes can never splice into a taker's (or a reclaimer's) stream —
    # the resume path COPIES the checkpointed prefix instead of sharing
    # the inode. None = the pre-run default name (streaming falls back).
    part_path: str | None = None
    abort_event: threading.Event = field(default_factory=threading.Event)
    # set once the job's last effects are done (a local run's releases of
    # its group, quota and lease, its latency histograms and outcome
    # counter): the state turns terminal a moment before, and
    # ConsensusService.wait waits for both, so a reader of the service's
    # stats after a wait sees the job whole
    settled: threading.Event = field(default_factory=threading.Event)

    @property
    def fasta_part(self) -> str:
        return self.part_path or os.path.join(self.dir, "out.fasta.part")

    @property
    def fasta(self) -> str:
        return os.path.join(self.dir, "out.fasta")

    @property
    def progress_path(self) -> str:
        """Per-job pipeline checkpoint: emitted-read count + the
        durable ``out.fasta.part`` byte size at that point — the resume
        point a journal replay (or peer takeover) restarts the run from."""
        return os.path.join(self.dir, "progress.json")

    def status(self) -> dict:
        now = time.time()
        lat = {
            "queue_s": round((self.started_ts or now) - self.submitted_ts, 4),
            "first_result_s": (round(self.first_emit_ts - self.submitted_ts, 4)
                               if self.first_emit_ts else None),
            "total_s": (round(self.done_ts - self.submitted_ts, 4)
                        if self.done_ts else None),
        }
        return {"job": self.id, "tenant": self.tenant, "state": self.state,
                "reads": self.reads, "windows": self.windows,
                "fragments": self.fragments, "bases_out": self.bases_out,
                "group": self.group, "error": self.error, "latency": lat}


def run_job(job: Job, service) -> None:
    """Execute one admitted job end to end (worker thread). ``service`` is
    the owning :class:`~.service.ConsensusService` (warm state, events,
    metrics). State transitions and the durable commit happen here; the
    byte-producing pipeline is the stock ``correct_shard``."""
    from ..formats.dazzdb import read_db
    from ..formats.fasta import write_fasta
    from ..formats.ingest import scan_with_db
    from ..formats.las import LasFile
    from ..runtime.pipeline import correct_shard, estimate_profile_for_shard
    from ..utils.aio import durable_write
    from ..utils.bases import ints_to_seq

    scfg = service.cfg
    if os.path.exists(os.path.join(job.dir, "manifest.json")):
        # a peer (or a prior incarnation) already committed this job
        # durably — the exactly-once contract says never run it again
        # (reachable when a takeover claim raced the committer's last
        # milliseconds: the claim won, the manifest still landed)
        job.state = DONE
        job.done_ts = time.time()
        service.journal_mark("committed", job.id, by="manifest")
        service.log_event("serve.job", job=job.id, state=DONE,
                          tenant=job.tenant)
        service.admission.release(job.tenant, job.spec.nbytes)
        service.release_job_lease(job.id)
        return
    job.state = RUNNING
    job.started_ts = time.time()
    job.running_local = True
    service.journal_mark("running", job.id)
    service.log_event("serve.job", job=job.id, state=RUNNING,
                      tenant=job.tenant)
    if service.faults is not None and service.faults.serve_hang_check():
        # injected wedge: the stand-in for a group thread stuck
        # in a solve — ignores aborts and shutdown, exactly like the real
        # thing. The bounded drain deadline (journal INTERRUPTED + nonzero
        # exit) and the peer lease takeover are what recover from this.
        service.log_event("serve.job", job=job.id, state="hang",
                          tenant=job.tenant)
        while True:
            time.sleep(0.25)
    key = None
    group = None
    gen = None
    try:
        cfg = build_job_config(job.spec, scfg.backend, scfg.backend_explicit,
                               scfg.batch, scfg.group_ladder_mode(), job.dir,
                               job.id)
        db = read_db(job.spec.db, strict=cfg.ingest_policy == "strict")
        las = LasFile(job.spec.las)
        report = None
        if cfg.ingest_policy != "off":
            # the ingest gate at the job boundary; strict violations were
            # already rejected at admission — this is the (cheap) re-scan
            # guard for TOCTOU on server-local paths, reused by the pipeline
            report = scan_with_db(db, las, None, None)
            if report.issues and cfg.ingest_policy == "strict":
                raise report.error()
        kw = (dict(pile_ranges=report.pile_ranges)
              if report is not None and report.issues else {})
        profile = estimate_profile_for_shard(db, las, cfg, **kw)
        key = solve_fingerprint(profile, cfg, scfg.backend)
        group = service.warm.acquire(
            key, lambda: service.build_group(key, profile, cfg))
        service.note_tenant_key(job.tenant, key)
        job.group = group.name
        solver = group.job_solver(job.id)
        t_first = None
        # per-job checkpoint resume: a replayed (or taken-over)
        # job resumes from its progress manifest. Every attempt writes its
        # OWN part file (pid+tid-named) and the resume COPIES the
        # checkpointed prefix into it — sharing the inode would let a
        # demoted straggler's O_APPEND writes splice into this attempt's
        # stream. The first `skip` reads re-solve without re-writing
        # (emission order is deterministic, so the committed bytes are
        # identical to an uninterrupted run; torn progress JSON reads as
        # absent, like every manifest in the repo).
        skip = part_pos = 0
        ck_every = int(getattr(scfg, "checkpoint_reads", 0) or 0)
        prior_part = None
        try:
            with open(job.progress_path) as ph:
                prog = json.load(ph)
            emitted = int(prog.get("emitted", 0))
            pb = int(prog.get("part_bytes", 0))
            pp = os.path.join(job.dir, os.path.basename(
                str(prog.get("part", "out.fasta.part"))))
            if emitted > 0 and os.path.exists(pp) \
                    and os.path.getsize(pp) >= pb:
                skip, part_pos, prior_part = emitted, pb, pp
        except (OSError, json.JSONDecodeError, ValueError, TypeError):
            pass
        my_part = os.path.join(
            job.dir,
            f"out.fasta.part.{os.getpid()}.{threading.get_ident()}")
        if prior_part is not None:
            with open(prior_part, "rb") as src, open(my_part, "wb") as dst:
                dst.write(src.read(part_pos))
        job.part_path = my_part
        with open(my_part, "at" if part_pos else "wt") as fh:
            fh.seek(0, os.SEEK_END)
            gen = correct_shard(db, las, cfg, profile=profile, solver=solver,
                                ingest_report=report)
            n_seen = 0
            for rid, frags, st in gen:
                if job.abort_event.is_set():
                    # checked BEFORE writing: a demoted straggler must not
                    # emit one more read after losing ownership
                    raise JobAbortRequested()
                n_seen += 1
                if n_seen > skip:
                    if t_first is None and frags:
                        t_first = time.time()
                        job.first_emit_ts = t_first
                    write_fasta(fh, [(f"read{rid}/{fi}", ints_to_seq(f))
                                     for fi, f in enumerate(frags)])
                    fh.flush()
                job.reads = st.n_reads
                job.windows = st.n_windows
                job.fragments = st.n_fragments
                job.bases_out = st.bases_out
                if ck_every and n_seen > skip and n_seen % ck_every == 0:
                    # the checkpoint ordering contract: the part bytes
                    # fsync FIRST, then the manifest that points at them
                    # commits durably — a checkpoint never points past the
                    # durable bytes
                    os.fsync(fh.fileno())
                    part_sz = fh.tell()
                    try:
                        durable_write(
                            job.progress_path,
                            lambda mh, n=n_seen, b=part_sz: json.dump(
                                {"emitted": n, "part_bytes": b,
                                 "part": os.path.basename(my_part)}, mh),
                            mode="wt", domain="manifest")
                    except OSError as ce:
                        # a refused CHECKPOINT must not fail a healthy run:
                        # it only widens the resume window (the prior
                        # checkpoint — or read zero — still bounds the
                        # recompute). The run itself keeps going; the
                        # commit path is where a full disk becomes fatal.
                        service.log_event(
                            "io.fault", domain="manifest", op="checkpoint",
                            error=f"{type(ce).__name__}: {ce}"[:200])
                    else:
                        service.journal_mark("progress", job.id,
                                             emitted=n_seen, bytes=part_sz,
                                             part=os.path.basename(my_part))
            fh.flush()
            os.fsync(fh.fileno())
            if not service.still_owns(job.id):
                # our lease was taken over while we solved (heartbeat
                # stalled past the TTL under load): the taker owns the
                # commit — stand down and watch its manifest instead of
                # double-committing
                job.watch = True
                job.abort_event.set()
                raise JobAbortRequested()
            # the WAL commit point: after this record the bytes are durable
            # and replay finishes the rename/manifest WITHOUT re-running —
            # the mid-commit crash window (fsync'd FASTA, un-renamed part)
            # recovers to the identical committed output
            # the committing record carries the content digest of the
            # fsync'd bytes: a replay/takeover finalize verifies
            # it before the publishing rename, so a part file silently
            # corrupted between crash and recovery re-solves instead of
            # publishing wrong bytes
            from ..utils.obs import sha256_file

            service.journal_mark("committing", job.id, bytes=fh.tell(),
                                 part=os.path.basename(my_part),
                                 sha=sha256_file(my_part, limit=fh.tell()))
        os.replace(my_part, job.fasta)
        job.done_ts = time.time()
        job.state = DONE
        durable_write(os.path.join(job.dir, "manifest.json"),
                      lambda mh: json.dump(
                          {**job.status(),
                           "fasta": job.fasta,
                           "fasta_bytes": os.path.getsize(job.fasta),
                           "fasta_sha256": sha256_file(job.fasta)}, mh),
                      mode="wt", domain="manifest")
        import glob as _glob

        for leftover in (job.progress_path,
                         *_glob.glob(os.path.join(job.dir,
                                                  "out.fasta.part*"))):
            # prior attempts' private part files are orphans now (deleting
            # an open file is safe — a straggler's fd stays valid until it
            # stands down)
            try:
                os.remove(leftover)
            except OSError:
                pass
        # commit EVENT before the terminal journal record: a crash between
        # the two leaves a committing+manifest orphan whose replay re-emits
        # a recovery commit (fragments=-1) — so every done job has >= 1
        # commit event and <= 1 REAL-run one, the soak's exactly-once form.
        # (serve.commit is a DURABLE_EVENTS flush-through, so once logged
        # it survives the very next crash.)
        service.log_event("serve.commit", job=job.id,
                          fragments=job.fragments,
                          bytes=os.path.getsize(job.fasta))
        service.journal_mark("committed", job.id)
        service.observe_latency(job)
    except JobAbortRequested:
        if job.watch:
            # lease ownership lost mid-run (serve._lease_tick demoted us):
            # the taker owns the job now — this run stands down and the
            # registry entry reverts to watching the taker's manifest (the
            # journal already holds the demoted record, never an abort)
            job.state = RUNNING
        else:
            job.state = ABORTED
            job.done_ts = time.time()
            service.journal_mark("aborted", job.id, reason="client")
            service.log_event("serve.abort", job=job.id, reason="client")
    except BaseException as e:  # noqa: BLE001 — job isolation boundary
        # ABORTED only when the CLIENT asked (abort event): a JobAborted
        # surfacing without it means the shared solve path died under this
        # job's rows (drain failure) — that is a FAILURE with a reason,
        # not an abort
        if job.watch and job.abort_event.is_set():
            job.state = RUNNING    # demoted (see JobAbortRequested above)
        elif job.abort_event.is_set():
            job.state = ABORTED
            service.journal_mark("aborted", job.id, reason="client")
            service.log_event("serve.abort", job=job.id,
                              reason="client")
        else:
            job.state = FAILED
            job.error = f"{type(e).__name__}: {e}"[:500]
            service.journal_mark("failed", job.id, error=job.error[:200])
            service.log_event("serve.job", job=job.id, state=FAILED,
                              tenant=job.tenant, error=job.error)
        job.done_ts = time.time()
        if not isinstance(e, Exception):
            raise   # KeyboardInterrupt/SystemExit must still unwind
    finally:
        job.running_local = False
        if gen is not None:
            gen.close()     # unwinds the pipeline's telemetry bundle
        if group is not None:
            group.release_job(job.id)
            service.warm.release(key)
        service.admission.release(job.tenant, job.spec.nbytes)
        service.release_job_lease(job.id)
        if job.state == DONE:
            service.log_event("serve.job", job=job.id, state=DONE,
                              tenant=job.tenant)


class JobAbortRequested(Exception):
    """Internal: the runner noticed the job's abort event between
    emissions."""
