"""The port's serving plane (``daccord_tpu_torch/serve``) against the JAX
package's, on the CPU: cross-job batching byte parity under the fault and
capacity matrix, admission control, warm state, latency quantiles, the
job-tagged ledger and the HTTP front end.

Each test of ``tests/test_serve.py`` that is not marked slow has a
counterpart of the same name here. The byte contract: N concurrent jobs
multiplexed into shared batches each write the FASTA of their solo run.
On the native engine (the fast tier, as in the JAX package) every job's
FASTA is also byte-identical to the JAX service's job FASTA and to the JAX
solo run on the same inputs; on the port's CPU ladder (fused, split and
paged groups) each is byte-identical to the port's solo run.

The JAX serve tests race their own threads under load: the runner turns a
job ``done`` before it releases its group and quota and observes its
latency, and those tests read the service's stats right after a poll sees
``done``. The port's ``ConsensusService.wait`` waits for ``Job.settled``,
set after the last of those effects, and every wait here ends on it (or
another event) with a timeout; no assertion depends on which thread wins a
race.
"""

import base64
import dataclasses
import glob
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from daccord_tpu.sim import SimConfig, make_dataset

WAIT_S = 300.0


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tserve"))
    cfg = SimConfig(genome_len=1500, coverage=10, read_len_mean=500,
                    min_overlap=200, seed=5)
    return make_dataset(d, cfg, name="sv"), d


def _solo_bytes(out, d, backend="native", batch=64):
    """The port's solo run: ``build_job_config``'s own config (the CLI's
    defaults by construction) through the stock pipeline, supervised."""
    from daccord_tpu_torch.runtime.pipeline import correct_to_fasta
    from daccord_tpu_torch.serve.jobs import JobSpec, build_job_config

    ref = os.path.join(d, f"port-solo-{backend}-{batch}.fasta")
    if not os.path.exists(ref):
        spec = JobSpec.from_json({"db": out["db"], "las": out["las"]}, d)
        cfg = build_job_config(spec, backend, True, batch, "fused", d, "solo")
        cfg = dataclasses.replace(cfg, supervise=True, events_path=None,
                                  ledger_path=None, job_tag=None,
                                  quarantine_path=None)
        correct_to_fasta(out["db"], out["las"], ref, cfg)
    with open(ref, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def jax_native(dataset):
    """The JAX package's solo native run and its service's job FASTA on the
    same inputs (one job; read once the job's FASTA is committed)."""
    from daccord_tpu.runtime.pipeline import correct_to_fasta
    from daccord_tpu.serve import ConsensusService, ServeConfig
    from daccord_tpu.serve.jobs import JobSpec, build_job_config

    out, d = dataset
    spec = JobSpec.from_json({"db": out["db"], "las": out["las"]}, d)
    cfg = build_job_config(spec, "native", True, 64, "fused", d, "solo")
    cfg = dataclasses.replace(cfg, native_solver=True, supervise=True,
                              events_path=None, ledger_path=None, job_tag=None,
                              quarantine_path=None)
    solo = os.path.join(d, "jax-solo-native.fasta")
    correct_to_fasta(out["db"], out["las"], solo, cfg)
    svc = ConsensusService(ServeConfig(workdir=os.path.join(d, "jax-srv"),
                                       backend="native", backend_explicit=True,
                                       batch=64, workers=1, flush_lag_s=0.02))
    try:
        j = svc.submit({"db": out["db"], "las": out["las"]})
        st = svc.wait(j["job"], WAIT_S)
        assert st["state"] == "done", st
        served = open(os.path.join(svc.cfg.workdir, "jobs", j["job"], "out.fasta"),
                      "rb").read()
    finally:
        svc.shutdown()
    return {"solo": open(solo, "rb").read(), "served": served}


def _svc(workdir, backend="native", **kw):
    from daccord_tpu_torch.serve import ConsensusService, ServeConfig

    kw.setdefault("batch", 64)
    kw.setdefault("workers", 2)
    kw.setdefault("flush_lag_s", 0.02)
    return ConsensusService(ServeConfig(workdir=str(workdir), backend=backend,
                                        backend_explicit=True, **kw))


def _job_fasta(svc, j):
    return open(os.path.join(svc.cfg.workdir, "jobs", j["job"], "out.fasta"), "rb").read()


def _lint(paths):
    from daccord_tpu_torch.tools.eventcheck import validate_events

    assert paths
    for p in paths:
        errs = validate_events(p, strict=True)
        assert not errs, (p, errs[:5])


def _events(workdir) -> list[str]:
    return (glob.glob(os.path.join(str(workdir), "*.events.jsonl"))
            + glob.glob(os.path.join(str(workdir), "jobs", "*", "events.jsonl")))


def test_two_jobs_byte_parity(dataset, jax_native, tmp_path):
    """Two concurrent jobs through shared batches == two solo runs == the
    JAX service's job and the JAX solo run, with a warm-group hit for the
    second job, both latencies in the rollup and lint-clean telemetry."""
    out, d = dataset
    ref = _solo_bytes(out, d)
    assert ref == jax_native["solo"] == jax_native["served"]
    svc = _svc(tmp_path / "srv")
    j1 = svc.submit({"db": out["db"], "las": out["las"], "tenant": "a"})
    j2 = svc.submit({"db": out["db"], "las": out["las"], "tenant": "b"})
    s1 = svc.wait(j1["job"], WAIT_S)
    s2 = svc.wait(j2["job"], WAIT_S)
    st = svc.stats()
    svc.shutdown()
    assert s1["state"] == "done" and s2["state"] == "done", (s1, s2)
    assert _job_fasta(svc, j1) == ref
    assert _job_fasta(svc, j2) == ref
    # one solve fingerprint, one group: the second job was a warm hit
    assert st["warm"]["misses"] == 1 and st["warm"]["hits"] == 1
    h = st["metrics"]["hists"]["job_latency_s"]
    assert h["count"] == 2 and h["p50"] is not None and h["p99"] is not None
    _lint(_events(svc.cfg.workdir))


def _unit_blocks(out, d, tmp_path):
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.kernels.tensorize import BatchShape, slice_batch, tensorize_windows
    from daccord_tpu_torch.runtime.pipeline import _sample_windows, estimate_profile_for_shard
    from daccord_tpu_torch.serve.jobs import JobSpec, build_job_config

    db = read_db(out["db"])
    las = LasFile(out["las"])
    spec = JobSpec.from_json({"db": out["db"], "las": out["las"]}, str(d))
    cfg = build_job_config(spec, "native", True, 64, "fused", str(tmp_path), "unit")
    profile = estimate_profile_for_shard(db, las, cfg)
    _, windows = _sample_windows(db, las, cfg, None, None)
    assert len(windows) >= 80, "sample too small for the unit"
    shape = BatchShape(depth=cfg.depth, seg_len=cfg.seg_len, wlen=cfg.consensus.w)
    full = tensorize_windows([(0, ws) for ws in windows[:80]], shape)
    return profile, cfg, slice_batch(full, 0, 40), slice_batch(full, 40, 80)


def test_cross_job_merged_batch_unit(dataset, tmp_path):
    """Deterministic mixing: two jobs each pool a block below the width;
    the flush merges them into one batch (jobs=2) and each handle's result
    is byte-identical to solving its rows alone."""
    from daccord_tpu_torch.serve.batcher import GroupConfig, SolveGroup

    out, d = dataset
    profile, cfg, a, b = _unit_blocks(out, d, tmp_path)
    group = SolveGroup("k", profile, cfg, GroupConfig(backend="native", batch=64))
    solo = SolveGroup("k2", profile, cfg, GroupConfig(backend="native", batch=64))
    try:
        sa, sb = group.job_solver("jobA"), group.job_solver("jobB")
        ha = sa.dispatch(a)          # 40 rows pooled, below the width
        assert group.counters["batches"] == 0
        hb = sb.dispatch(b)          # 80 rows: one 64-row merged flush
        assert group.counters["batches"] == 1
        assert group.counters["mixed_batches"] == 1
        ra, rb = sa.fetch(ha), sb.fetch(hb)
        assert len(ra["solved"]) == 40 and len(rb["solved"]) == 40
        # solo control: a second group solves each block alone
        ss = solo.job_solver("solo")
        for blk, res in ((a, ra), (b, rb)):
            ctrl = ss.fetch(ss.dispatch(blk))
            for k in ("solved", "tier", "cons_len", "err"):
                np.testing.assert_array_equal(np.asarray(ctrl[k]), np.asarray(res[k]),
                                              err_msg=k)
            for i in range(blk.size):
                n = int(ctrl["cons_len"][i])
                np.testing.assert_array_equal(np.asarray(ctrl["cons"][i][:n]),
                                              np.asarray(res["cons"][i][:n]))
    finally:
        group.close()
        solo.close()


def test_device_oom_bisects_mixed_batches(dataset, tmp_path, monkeypatch):
    """An injected device OOM classifies on the shared supervisor and the
    governor bisects merged (mixed-job) batches: the bytes do not move."""
    out, d = dataset
    ref = _solo_bytes(out, d)
    monkeypatch.setenv("DACCORD_FAULT", "device_oom:2")
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc"))
    svc = _svc(tmp_path / "srv")
    j1 = svc.submit({"db": out["db"], "las": out["las"], "tenant": "a"})
    j2 = svc.submit({"db": out["db"], "las": out["las"], "tenant": "b"})
    s1 = svc.wait(j1["job"], WAIT_S)
    s2 = svc.wait(j2["job"], WAIT_S)
    st = svc.stats()
    svc.shutdown()
    assert s1["state"] == "done" and s2["state"] == "done", (s1, s2)
    g = st["warm"]["groups"][0]
    assert g["governor"]["classify"] >= 1 and g["governor"]["shrink"] >= 1
    assert not g["degraded"], "capacity must degrade, never fail over"
    assert _job_fasta(svc, j1) == ref
    assert _job_fasta(svc, j2) == ref


def test_device_lost_fails_over_all_jobs(dataset, tmp_path, monkeypatch):
    """A declared device loss mid-serve: the shared supervisor replays every
    merged batch in flight on the fallback engine; every job's bytes hold."""
    out, d = dataset
    ref = _solo_bytes(out, d)
    monkeypatch.setenv("DACCORD_FAULT", "device_lost:2")
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc"))
    svc = _svc(tmp_path / "srv")
    j1 = svc.submit({"db": out["db"], "las": out["las"]})
    j2 = svc.submit({"db": out["db"], "las": out["las"]})
    s1 = svc.wait(j1["job"], WAIT_S)
    s2 = svc.wait(j2["job"], WAIT_S)
    st = svc.stats()
    svc.shutdown()
    assert s1["state"] == "done" and s2["state"] == "done", (s1, s2)
    assert st["warm"]["groups"][0]["degraded"]
    assert _job_fasta(svc, j1) == ref
    assert _job_fasta(svc, j2) == ref


def test_abort_does_not_poison_cohabitants(dataset, tmp_path):
    """A client abort mid-run drops the job without changing one byte of
    the other job's output. The abort fires from the first emitted read of
    job a (an event its runner sets), whichever job runs ahead."""
    out, d = dataset
    ref = _solo_bytes(out, d)
    svc = _svc(tmp_path / "srv")
    ja = svc.submit({"db": out["db"], "las": out["las"], "tenant": "a"})
    jb = svc.submit({"db": out["db"], "las": out["las"], "tenant": "b"})
    job_a = svc.jobs[ja["job"]]
    fired = threading.Event()

    def chase():
        # ends on job a's first emission, or on its end, whichever comes
        while not job_a.settled.wait(0.01):
            if job_a.first_emit_ts is not None:
                svc.abort(ja["job"])
                fired.set()
                return

    t = threading.Thread(target=chase)
    t.start()
    sa = svc.wait(ja["job"], WAIT_S)
    sb = svc.wait(jb["job"], WAIT_S)
    t.join(WAIT_S)
    svc.shutdown()
    assert sb["state"] == "done", sb
    assert sa["state"] in ("aborted", "done"), sa   # the abort may come late
    assert _job_fasta(svc, jb) == ref
    if sa["state"] == "aborted":
        assert fired.is_set()
        assert not os.path.exists(os.path.join(svc.cfg.workdir, "jobs", ja["job"],
                                               "out.fasta"))


def test_admission_quotas_and_pressure():
    """The port's admission verdicts, step by step, equal the JAX
    package's on the same sequence of requests."""
    from daccord_tpu.runtime.faults import FaultPlan as JaxFaultPlan
    from daccord_tpu.serve import admission as jax_admission
    from daccord_tpu_torch.runtime.faults import FaultPlan
    from daccord_tpu_torch.serve import AdmissionConfig, AdmissionController, AdmissionReject

    def steps(mod, plan):
        cfg = mod.AdmissionConfig(tenant_max_queued=1, tenant_max_bytes=100,
                                  max_queued_jobs=3)
        ctl = mod.AdmissionController(cfg)
        ctl2 = mod.AdmissionController(mod.AdmissionConfig(),
                                       faults=plan.parse("host_rss:1"))
        seq = [(ctl, "a", 10, "j1"), (ctl, "a", 10, "j2"), (ctl, "b", 1000, "j3"),
               ("release", "a", 10), (ctl, "a", 10, "j4"), (ctl2, "a", 1, "j5"),
               (ctl2, "a", 1, "j6"), ("drain",), (ctl, "c", 1, "j7")]
        got = []
        for step in seq:
            if step[0] == "release":
                ctl.release(step[1], step[2])
                continue
            if step[0] == "drain":
                ctl.drain()
                continue
            c, tenant, n, job = step
            try:
                c.admit(tenant, n, job=job)
                got.append("ok")
            except mod.AdmissionReject as e:
                got.append((e.reason, e.retryable))
        return got, ctl.stats()

    got, st = steps(__import__("daccord_tpu_torch.serve.admission",
                               fromlist=["x"]), FaultPlan)
    jgot, jst = steps(jax_admission, JaxFaultPlan)
    assert got == jgot == ["ok", ("quota_jobs", True), ("quota_bytes", True), "ok",
                           ("pressure", True), "ok", ("draining", False)]
    assert st == jst
    assert st["rejected"] == 3 and st["admitted"] == 2
    assert AdmissionController is not None and AdmissionConfig is not None
    assert issubclass(AdmissionReject, Exception)


def test_restart_never_reuses_job_ids(dataset, tmp_path):
    """A restarted server on the same workdir resumes the job-id sequence
    past the existing job dirs: reusing jNNNNN would serve or clobber the
    first run's committed result."""
    out, d = dataset
    svc = _svc(tmp_path / "srv", workers=1)
    j1 = svc.submit({"db": out["db"], "las": out["las"]})
    assert svc.wait(j1["job"], WAIT_S)["state"] == "done"
    svc.shutdown()
    assert j1["job"] == "j00001"
    svc2 = _svc(tmp_path / "srv", workers=1)
    j2 = svc2.submit({"db": out["db"], "las": out["las"]})
    assert svc2.wait(j2["job"], WAIT_S)["state"] == "done"
    svc2.shutdown()
    assert j2["job"] == "j00002"
    assert os.path.exists(os.path.join(str(tmp_path / "srv"), "jobs", "j00001",
                                       "out.fasta"))


def test_rejected_submit_leaves_no_residue(dataset, tmp_path):
    """A refused submission (quota or bad spec) releases its admission
    charge and leaves no spooled upload behind."""
    from daccord_tpu_torch.serve import AdmissionConfig, AdmissionReject

    out, d = dataset
    svc = _svc(tmp_path / "srv", workers=1,
               admission=AdmissionConfig(tenant_max_queued=0))
    up = {"db": "u.db", "las": "u.las",
          "files": {"u.db": base64.b64encode(b"x" * 64).decode(),
                    "u.las": base64.b64encode(b"y" * 64).decode()}}
    with pytest.raises(AdmissionReject):
        svc.submit(up)
    assert os.listdir(os.path.join(svc.cfg.workdir, "jobs")) == []
    assert svc.admission.stats()["queued"] == 0
    svc2 = _svc(tmp_path / "srv2", workers=1)
    with pytest.raises(ValueError):
        svc2.submit({"db": out["db"], "las": out["las"], "bogus": 1})
    assert os.listdir(os.path.join(svc2.cfg.workdir, "jobs")) == []
    assert svc2.admission.stats()["queued"] == 0
    svc.shutdown()
    svc2.shutdown()


def test_warm_state_reuse_and_eviction(dataset, tmp_path):
    """Two jobs one after the other share one group (a miss, then a hit);
    with the TTL at 0 the idle group evicts, and its close runs (its
    supervisor gone). Either the test's sweep or the ticker's may evict it:
    the counter is read, not the return."""
    out, d = dataset
    svc = _svc(tmp_path / "srv", idle_evict_s=3600.0, workers=1)
    j1 = svc.submit({"db": out["db"], "las": out["las"]})
    assert svc.wait(j1["job"], WAIT_S)["state"] == "done"
    j2 = svc.submit({"db": out["db"], "las": out["las"]})
    assert svc.wait(j2["job"], WAIT_S)["state"] == "done"
    assert svc.warm.counters == {"hits": 1, "misses": 1, "evicted": 0,
                                 "evict_deferred": 0}
    groups = svc.warm.groups()
    assert len(groups) == 1 and groups[0].refs == 0
    svc.warm.idle_evict_s = 0.0
    svc.warm.evict_idle()
    assert svc.warm.counters["evicted"] == 1
    assert not svc.warm.groups()
    assert groups[0].sup is None
    svc.shutdown()


def test_histogram_quantiles():
    """The port's latency histogram gives the JAX package's quantiles on
    the same observations (the reservoir is seeded alike)."""
    from daccord_tpu.utils.obs import _Histogram as JaxHistogram
    from daccord_tpu_torch.utils.obs import MetricsRegistry, _Histogram

    h = _Histogram()
    assert h.summary()["p50"] is None
    for v in range(1, 101):
        h.observe(float(v))
    s = h.summary()
    assert s["p50"] == 51.0 and s["p95"] == 96.0 and s["p99"] == 100.0
    assert s["count"] == 100 and s["min"] == 1.0 and s["max"] == 100.0
    h2, j2 = _Histogram(), JaxHistogram()
    for v in range(10_000):
        h2.observe(float(v))
        j2.observe(float(v))
    s2 = h2.summary()
    assert 3_000 < s2["p50"] < 7_000, s2
    assert {k: s2[k] for k in ("p50", "p95", "p99", "count")} == {
        k: j2.summary()[k] for k in ("p50", "p95", "p99", "count")}
    reg = MetricsRegistry()
    reg.histogram("lat").observe(2.0)
    roll = reg.rollup()
    assert roll["hists"]["lat"]["p50"] == 2.0
    assert roll["hists"]["lat"]["p99"] == 2.0


def test_ledger_job_field(dataset, tmp_path):
    """Ledger rows carry the job tag (as the JAX package's do, row for row);
    the trace's reconciliation dedupes on (job, aread, widx), so two jobs'
    ledgers concatenated do not collapse."""
    from daccord_tpu.runtime.pipeline import correct_to_fasta as jax_correct_to_fasta
    from daccord_tpu.serve.jobs import build_job_config as jax_build_job_config
    from daccord_tpu_torch.runtime.pipeline import correct_to_fasta
    from daccord_tpu_torch.serve.jobs import JobSpec, build_job_config
    from daccord_tpu_torch.tools.trace import ledger_rows

    out, d = dataset
    led = str(tmp_path / "a.ledger.jsonl")
    spec = JobSpec.from_json({"db": out["db"], "las": out["las"]}, str(d))
    cfg = build_job_config(spec, "native", True, 64, "fused", str(tmp_path), "jobA")
    cfg = dataclasses.replace(cfg, supervise=True, events_path=None,
                              ledger_path=led, quarantine_path=None)
    st = correct_to_fasta(out["db"], out["las"], str(tmp_path / "a.fasta"), cfg)
    rows = [json.loads(ln) for ln in open(led)]
    assert rows and all(r["job"] == "jobA" for r in rows)
    assert len(rows) == st.n_windows
    from daccord_tpu.serve.jobs import JobSpec as JaxJobSpec

    jled = str(tmp_path / "jax.ledger.jsonl")
    jcfg = jax_build_job_config(JaxJobSpec.from_json({"db": out["db"], "las": out["las"]},
                                                     str(d)),
                                "native", True, 64, "fused", str(tmp_path), "jobA")
    jcfg = dataclasses.replace(jcfg, native_solver=True, supervise=True,
                               events_path=None, ledger_path=jled, quarantine_path=None)
    jax_correct_to_fasta(out["db"], out["las"], str(tmp_path / "j.fasta"), jcfg)
    keys = ("job", "aread", "widx", "len", "depth", "tier", "k", "solved", "stream")
    assert (sorted(tuple(r[k] for k in keys) for r in rows)
            == sorted(tuple(r[k] for k in keys)
                      for r in (json.loads(ln) for ln in open(jled))))
    merged = str(tmp_path / "m.ledger.jsonl")
    with open(merged, "wt") as fh:
        for ln in open(led):
            fh.write(ln)
        for ln in open(led):
            fh.write(ln.replace('"job": "jobA"', '"job": "jobB"'))
    total, distinct = ledger_rows(merged)
    assert total == 2 * st.n_windows and distinct == 2 * st.n_windows


def test_job_spec_validation(tmp_path, dataset):
    """The port's spec parser refuses what the JAX package's refuses, with
    the same messages, and spools uploads alike."""
    from daccord_tpu.serve.jobs import JobSpec as JaxJobSpec
    from daccord_tpu_torch.serve.jobs import JobSpec

    out, d = dataset
    bad = [({"las": out["las"]}, "missing 'db'"),
           ({"db": out["db"], "las": out["las"], "bogus": 1}, "unknown job fields"),
           ({"db": out["db"], "las": out["las"], "k": 99}, "supported range"),
           ({"db": out["db"], "las": "/nope.las"}, "not found"),
           ({"db": out["db"], "las": out["las"], "k": "8"}, "expected int")]
    for body, msg in bad:
        with pytest.raises(ValueError, match=msg) as ei:
            JobSpec.from_json(body, str(tmp_path))
        with pytest.raises(ValueError) as ej:
            JaxJobSpec.from_json(body, str(tmp_path))
        assert str(ei.value) == str(ej.value)
    payload = {"db": "up.db", "las": "up.las",
               "files": {"up.db": base64.b64encode(b"x").decode(),
                         "up.las": base64.b64encode(b"y").decode()}}
    spec = JobSpec.from_json(payload, str(tmp_path / "spool"))
    assert spec.uploaded and os.path.exists(spec.db)
    assert open(spec.las, "rb").read() == b"y"
    jspec = JaxJobSpec.from_json(payload, str(tmp_path / "jspool"))
    assert {k: v for k, v in dataclasses.asdict(spec).items() if k not in ("db", "las")} == \
        {k: v for k, v in dataclasses.asdict(jspec).items() if k not in ("db", "las")}


#: the fields the JAX package's build_job_config sets
JOB_CONFIG_FIELDS = ("consensus", "batch_size", "depth", "seg_len", "max_kmers",
                     "overflow_rescue", "end_trim", "qv_track", "profile_sample_piles",
                     "ingest_policy", "quarantine_path", "events_path", "ledger_path",
                     "job_tag", "supervise", "ladder_mode")


def test_build_job_config_and_fingerprint_match_the_jax_packages(dataset, tmp_path):
    """``build_job_config`` gives the JAX package's config, field by field
    over every field the JAX function sets (the port's ``cuda`` where the
    JAX package says ``tpu``; the port sets ``device`` and ``native_solver``
    for its backends besides), and ``solve_fingerprint`` equals the JAX
    package's up to the engine key: equal on the native engine, and the
    ladder's keys differ from the native one only there."""
    from daccord_tpu.oracle.profile import ErrorProfile as JaxErrorProfile
    from daccord_tpu.serve.jobs import JobSpec as JaxJobSpec
    from daccord_tpu.serve.jobs import build_job_config as jax_build
    from daccord_tpu.serve.jobs import solve_fingerprint as jax_fp
    from daccord_tpu_torch.oracle.profile import ErrorProfile
    from daccord_tpu_torch.serve.jobs import JobSpec, build_job_config, solve_fingerprint

    out, d = dataset
    body = {"db": out["db"], "las": out["las"], "k": 7, "max_err": 0.25,
            "hp_vote": "posterior", "overflow_rescue": True}
    spec, jspec = JobSpec.from_json(body, str(d)), JaxJobSpec.from_json(body, str(d))
    prof = dict(p_ins=0.051, p_del=0.047, p_sub=0.021, hp_slope=0.37, hp_base=0.02,
                hp_cap=6)
    for backend, jbackend in (("native", "native"), ("cpu", "cpu"), ("cuda", "tpu")):
        for explicit in (True, False):
            cfg = build_job_config(spec, backend, explicit, 128, "split", str(tmp_path), "j1")
            jcfg = jax_build(jspec, jbackend, explicit, 128, "split", str(tmp_path), "j1")
            for name in JOB_CONFIG_FIELDS:
                a, b = getattr(cfg, name), getattr(jcfg, name)
                if dataclasses.is_dataclass(a):
                    a, b = dataclasses.asdict(a), dataclasses.asdict(b)
                assert a == b, (backend, explicit, name, a, b)
            assert cfg.device == ("cuda" if backend == "cuda" else "cpu")
            assert cfg.native_solver == (backend == "native")
    cfg = build_job_config(spec, "native", True, 64, "fused", str(tmp_path), "j")
    jcfg = jax_build(jspec, "native", True, 64, "fused", str(tmp_path), "j")
    fp = solve_fingerprint(ErrorProfile(**prof), cfg, "native")
    assert fp == jax_fp(JaxErrorProfile(**prof), jcfg, "native")
    keys = {solve_fingerprint(ErrorProfile(**prof), cfg, b) for b in ("native", "cpu", "cuda")}
    assert len(keys) == 3
    # a byte-changing knob changes the key; the batch width does not
    assert solve_fingerprint(ErrorProfile(**{**prof, "p_sub": 0.022}), cfg, "cuda") != \
        solve_fingerprint(ErrorProfile(**prof), cfg, "cuda")
    assert solve_fingerprint(ErrorProfile(**prof), dataclasses.replace(cfg, batch_size=8),
                             "cuda") == solve_fingerprint(ErrorProfile(**prof), cfg, "cuda")
    with pytest.raises(ValueError, match="backend"):
        build_job_config(spec, "tpu", True, 64, "fused", str(tmp_path), "j")


def _req(base, method, path, body=None, timeout=WAIT_S):
    r = urllib.request.Request(
        base + path, method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        return resp.status, resp.read()


def test_http_end_to_end(dataset, tmp_path):
    """The real HTTP surface: submit, wait, result parity, the streamed
    FASTA with its byte trailer, metrics with quantiles and the prom text,
    DELETE abort, graceful shutdown."""
    from daccord_tpu_torch.serve.http import start_server
    from daccord_tpu_torch.utils.obs import parse_prom

    out, d = dataset
    ref = _solo_bytes(out, d)
    svc = _svc(tmp_path / "srv")
    httpd, port, thread = start_server(svc, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{port}"
    try:
        code, b = _req(base, "POST", "/v1/jobs", {"db": out["db"], "las": out["las"]})
        assert code == 201
        j = json.loads(b)["job"]
        code, fasta = _req(base, "GET", f"/v1/jobs/{j}/result?wait=1")
        assert code == 200 and fasta == ref
        with urllib.request.urlopen(f"{base}/v1/jobs/{j}/stream", timeout=WAIT_S) as r:
            assert r.read() == ref
        for body, path in (({"las": out["las"]}, "/v1/jobs"),
                           ({"db": out["db"], "las": out["las"], "k": "8"}, "/v1/jobs")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _req(base, "POST", path, body)
            assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base, "GET", f"/v1/jobs/{j}/result?wait=1&timeout=abc")
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base, "GET", "/v1/jobs/nope")
        assert ei.value.code == 404
        code, m = _req(base, "GET", "/v1/metrics")
        m = json.loads(m)
        assert m["metrics"]["hists"]["job_latency_s"]["p50"] is not None
        code, prom = _req(base, "GET", "/v1/metrics?format=prom")
        samples, errs = parse_prom(prom.decode())
        assert not errs and any(k.startswith("daccord_serve_") for k in samples)
        code, h = _req(base, "GET", "/v1/healthz")
        assert json.loads(h)["ok"] is True
        # a second job, aborted over the wire
        code, b = _req(base, "POST", "/v1/jobs", {"db": out["db"], "las": out["las"]})
        j2 = json.loads(b)["job"]
        _req(base, "DELETE", f"/v1/jobs/{j2}")
        assert svc.wait(j2, WAIT_S)["state"] in ("aborted", "done")
        code, _ = _req(base, "POST", "/v1/shutdown")
        assert code == 200
        # the drain ends by stopping the listener: serve_forever returns
        thread.join(WAIT_S)
        assert not thread.is_alive()
        assert svc.admission.stats()["draining"]
    finally:
        httpd.server_close()


def test_strict_ingest_rejected_at_admission(dataset, tmp_path):
    """A corrupt LAS under the strict policy is refused at submit with the
    structured report: it never costs a queue slot."""
    import shutil

    from daccord_tpu_torch.runtime import faults

    out, d = dataset
    bad_las = str(tmp_path / "bad.las")
    shutil.copy(out["las"], bad_las)
    for ext in (".db", ".idx", ".bps"):
        src = out["db"][:-3] + ext if out["db"].endswith(".db") else out["db"] + ext
        if os.path.exists(src):
            shutil.copy(src, str(tmp_path / ("bad" + ext)))
    stem = os.path.basename(out["db"])[:-3]
    for hidden in glob.glob(os.path.join(os.path.dirname(out["db"]), f".{stem}.*")):
        shutil.copy(hidden, str(tmp_path / os.path.basename(hidden).replace(stem, "bad")))
    faults.corrupt_las_bitflip(bad_las, 4)
    svc = _svc(tmp_path / "srv", workers=1)
    with pytest.raises(ValueError, match="ingest validation"):
        svc.submit({"db": str(tmp_path / "bad.db"), "las": bad_las})
    assert svc.admission.stats()["queued"] == 0
    svc.shutdown()


@pytest.mark.parametrize("mode", ["fused", "split", "paged"])
def test_cpu_ladder_arm_byte_parity(dataset, tmp_path, mode):
    """Cross-job batching through the port's ladder on the CPU behind the
    group's dispatcher thread: fused dense, split two-stream (stream-routed
    pools) and the paged wire format, each job byte-identical to the port's
    solo CPU run. The paged group packs its merged batches (its families
    are logged)."""
    out, d = dataset
    ref = _solo_bytes(out, d, backend="cpu", batch=32)
    svc = _svc(tmp_path / "srv", backend="cpu", batch=32,
               ladder_mode="split" if mode == "split" else "fused",
               paged=mode == "paged", flush_lag_s=0.05)
    j1 = svc.submit({"db": out["db"], "las": out["las"]})
    j2 = svc.submit({"db": out["db"], "las": out["las"]})
    s1 = svc.wait(j1["job"], WAIT_S)
    s2 = svc.wait(j2["job"], WAIT_S)
    st = svc.stats()
    svc.shutdown()
    assert s1["state"] == "done" and s2["state"] == "done", (s1, s2)
    assert _job_fasta(svc, j1) == ref
    assert _job_fasta(svc, j2) == ref
    g = st["warm"]["groups"][0]
    assert g["batches"] > 0 and not g["degraded"]
    gev = [json.loads(ln) for ln in open(os.path.join(svc.cfg.workdir, "g0.events.jsonl"))]
    streams = {r["stream"] for r in gev if r["event"] == "serve.batch"}
    assert streams == ({"tier0", "rescue"} if mode == "split" else {"full"})
    assert any(r["event"] == "paging.family" for r in gev) == (mode == "paged")
    _lint(_events(svc.cfg.workdir))


def test_serve_cli_refuses_a_card_it_does_not_have_and_unported_flags(tmp_path, capsys):
    """``serve --backend cuda`` (and ``auto``, which follows ``--device``,
    cuda by default) exits at startup on a box with no card: nothing falls
    back to the CPU. ``--mesh`` is not a flag of the port's serve;
    ``--aot-cache`` is (the fleet-shared kernel cache)."""
    from daccord_tpu_torch.tools import cli

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for argv in (["--backend", "cuda"], [], ["--device", "cuda"],
                 ["--aot-cache", str(tmp_path / "aot")]):
        with pytest.raises(SystemExit, match="CUDA is not available"):
            cli.main(["serve", "--workdir", str(tmp_path / "w"), *argv])
    for flag in (["--mesh", "2"],):
        with pytest.raises(SystemExit) as ei:
            cli.main(["serve", "--workdir", str(tmp_path / "w"), "--backend", "native",
                      *flag])
        assert ei.value.code == 2
    with pytest.raises(SystemExit) as ei:
        cli.main(["serve", "--help"])
    assert ei.value.code == 0 and "--aot-cache" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="contradicts"):
        cli.main(["serve", "--workdir", str(tmp_path / "w"), "--backend", "native",
                  "--device", "cuda"])
    assert not os.path.exists(str(tmp_path / "w"))


class _Recorder:
    """A custom solver of the async duck type, recording what it is sent."""

    def __init__(self, solve, ladder=None, partial=False, streams=False):
        self._solve = solve
        self.ladder = ladder
        self.accepts_partial = partial
        self.routes_streams = streams
        self.seen = []

    def dispatch(self, b):
        self.seen.append((b.size, int((b.nsegs > 0).sum()), b.stream, b.job))
        return self._solve(b)

    def fetch(self, h):
        return h

    def fetch_many(self, hs):
        return [self.fetch(h) for h in hs]


def test_correct_shard_solver_rules_follow_the_jax_package(dataset, tmp_path):
    """``correct_shard(solver=...)`` by the JAX package's rules: a custom
    solver replaces the run's solve path; its batches carry the job tag;
    one with ``accepts_partial`` gets them unpadded (else padded to the
    batch); ``--ladder split`` stays on only for a solver with
    ``routes_streams`` (else fused). The bytes are the solo run's."""
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.kernels.tiers import TierLadder, fetch, stream_dispatcher
    from daccord_tpu_torch.runtime.pipeline import (_build_native_fallback, correct_shard,
                                                    estimate_profile_for_shard)
    from daccord_tpu_torch.serve.jobs import JobSpec, build_job_config
    from daccord_tpu_torch.utils.bases import ints_to_seq

    out, d = dataset
    db, las = read_db(out["db"]), LasFile(out["las"])
    spec = JobSpec.from_json({"db": out["db"], "las": out["las"]}, str(d))

    def run(backend, ladder_mode, solver_of):
        cfg = build_job_config(spec, backend, True, 32, ladder_mode, str(tmp_path), "jobX")
        cfg = dataclasses.replace(cfg, events_path=None, ledger_path=None,
                                  quarantine_path=None)
        prof = estimate_profile_for_shard(db, las, cfg)
        solver = solver_of(prof, cfg)
        recs = [(r, [ints_to_seq(f) for f in fr])
                for r, fr, _ in correct_shard(db, las, cfg, profile=prof, solver=solver)]
        return recs, solver.seen

    ref_native = [(r, [ints_to_seq(f) for f in fr]) for r, fr, _ in correct_shard(
        db, las, dataclasses.replace(build_job_config(spec, "native", True, 32, "fused",
                                                      str(tmp_path), "solo"),
                                     supervise=True, events_path=None, ledger_path=None,
                                     quarantine_path=None, job_tag=None))]
    for partial in (False, True):
        recs, seen = run("native", "fused", lambda p, c, pa=partial: _Recorder(
            _build_native_fallback(p, c), partial=pa))
        assert recs == ref_native
        assert seen and all(s[2] == "full" and s[3] == "jobX" for s in seen)
        if partial:
            assert all(size == live for size, live, _, _ in seen)
            assert any(size < 32 for size, _, _, _ in seen)
        else:
            assert all(size == 32 for size, _, _, _ in seen)

    def ladder_solver(streams):
        def make(p, c):
            lad = TierLadder.from_config(p, c.consensus, max_kmers=c.max_kmers,
                                         rescue_max_kmers=c.rescue_max_kmers,
                                         overflow_rescue=c.overflow_rescue, device="cpu")
            disp = stream_dispatcher(lad)
            return _Recorder(lambda b: fetch(disp(b)), ladder=lad, streams=streams)
        return make

    from daccord_tpu_torch.formats.fasta import read_fasta

    _solo_bytes(out, d, backend="cpu", batch=32)
    want = [(rec.name, rec.seq) for rec in read_fasta(
        os.path.join(d, "port-solo-cpu-32.fasta"))]
    for streams in (True, False):
        recs, seen = run("cpu", "split", ladder_solver(streams))
        assert [(f"read{r}/{i}", s) for r, fr in recs for i, s in enumerate(fr)] == want
        assert {s[2] for s in seen} == ({"tier0", "rescue"} if streams else {"full"})


def test_group_under_thread_stress_gives_every_job_its_own_rows(dataset, tmp_path):
    """Twelve job threads (more than the cores) dispatch and fetch blocks of
    one window set through one group at once, the interpreter switching
    threads every 10 µs: every handle gets back exactly its own rows'
    results (a lost or misrouted part would break the equality), and no
    row is left pooled or in flight."""
    import sys

    from daccord_tpu_torch.kernels.tensorize import slice_batch
    from daccord_tpu_torch.serve.batcher import GroupConfig, SolveGroup

    out, d = dataset
    profile, cfg, a, b = _unit_blocks(out, d, tmp_path)
    group = SolveGroup("k", profile, cfg, GroupConfig(backend="native", batch=64,
                                                      max_inflight=3))
    solo = SolveGroup("k2", profile, cfg, GroupConfig(backend="native", batch=64))
    ss = solo.job_solver("solo")
    ctrl = {name: ss.fetch(ss.dispatch(blk)) for name, blk in (("a", a), ("b", b))}
    cuts = [(0, 7), (7, 23), (23, 40)]
    errors: list = []

    def job(i: int) -> None:
        try:
            sv = group.job_solver(f"job{i}")
            name, blk = ("a", a) if i % 2 else ("b", b)
            handles = [(lo, hi, sv.dispatch(slice_batch(blk, lo, hi))) for lo, hi in cuts]
            for lo, hi, h in handles:
                got = sv.fetch(h)
                for k in ("solved", "tier", "cons_len"):
                    if not np.array_equal(np.asarray(got[k]), np.asarray(ctrl[name][k][lo:hi])):
                        errors.append((i, lo, k))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append((i, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=job, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        group.close()
        solo.close()
    assert not errors, errors[:5]
    st = group.counters
    assert st["rows"] == 12 * 40 and st["mixed_batches"] >= 1
    assert not group._inflight and not any(p.rows for p in group._pools.values())
