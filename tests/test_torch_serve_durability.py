"""The port's crash-durable serve tier against the JAX package's, on the
CPU: the write-ahead job journal, replay, peer lease takeover, the bounded
drain and the kill matrix.

Each test of ``tests/test_serve_durability.py`` that is not marked slow has
a counterpart of the same name here. The contract: a ``serve`` process that
dies at any lifecycle point loses no admitted job. On restart the journal
replays (orphans re-admit through the normal quota path and resume from
their per-job checkpoints; a mid-commit crash finalizes without recompute;
a duplicate submission with a seen idempotency key dedupes onto the
existing job), and with a shared ``peer_dir`` a live peer finishes the dead
one's job instead. Every FASTA is byte-identical to the solo run. The
journal units also hold the two packages' journals to one file format (each
replays the other's). The kill matrix runs real ``python -m
daccord_tpu_torch.tools.cli serve`` subprocesses; the two-process chaos soak
is the slow arm, as in the JAX package.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from daccord_tpu.sim import SimConfig, make_dataset

WAIT_S = 180.0


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tservedur"))
    cfg = SimConfig(genome_len=1500, coverage=10, read_len_mean=500,
                    min_overlap=200, seed=5)
    return make_dataset(d, cfg, name="sv"), d


def _solo_bytes(out, d):
    from daccord_tpu_torch.runtime.pipeline import correct_to_fasta
    from daccord_tpu_torch.serve.jobs import JobSpec, build_job_config

    ref = os.path.join(d, "port-solo-native.fasta")
    if not os.path.exists(ref):
        spec = JobSpec.from_json({"db": out["db"], "las": out["las"]}, d)
        cfg = build_job_config(spec, "native", True, 64, "fused", d, "solo")
        cfg = dataclasses.replace(cfg, supervise=True, events_path=None,
                                  ledger_path=None, job_tag=None, quarantine_path=None)
        correct_to_fasta(out["db"], out["las"], ref, cfg)
    with open(ref, "rb") as fh:
        return fh.read()


def _svc(workdir, fault=None, **kw):
    """An in-process service; ``fault`` sets DACCORD_FAULT for this
    service's FaultPlan only (cleared right after construction)."""
    from daccord_tpu_torch.serve import ConsensusService, ServeConfig

    kw.setdefault("backend", "native")
    kw.setdefault("backend_explicit", True)
    kw.setdefault("batch", 64)
    kw.setdefault("workers", 2)
    kw.setdefault("flush_lag_s", 0.02)
    kw.setdefault("checkpoint_reads", 4)
    old = os.environ.pop("DACCORD_FAULT", None)
    if fault:
        os.environ["DACCORD_FAULT"] = fault
    try:
        return ConsensusService(ServeConfig(workdir=str(workdir), **kw))
    finally:
        os.environ.pop("DACCORD_FAULT", None)
        if old is not None:
            os.environ["DACCORD_FAULT"] = old


def _wait_for(pred, timeout=WAIT_S, step=0.02):
    """Wait until ``pred()`` is true (polled), at most ``timeout``."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return bool(pred())


def _lint(paths):
    from daccord_tpu_torch.tools.eventcheck import validate_events

    for p in paths:
        errs = validate_events(p, strict=True)
        assert not errs, (p, errs[:5])


def _journal(workdir):
    from daccord_tpu_torch.serve.journal import replay

    return replay(os.path.join(str(workdir), "journal.jsonl"))


def _serve_events(workdir) -> list[dict]:
    return [json.loads(ln) for ln in open(os.path.join(str(workdir), "serve.events.jsonl"))
            if ln.strip()]


def _hung(svc, job_id):
    """The serve_hang fault wedged this job's run: its hang event is out."""
    def seen():
        svc.events.flush()
        return any(e["event"] == "serve.job" and e.get("job") == job_id
                   and e.get("state") == "hang"
                   for e in _serve_events(svc.cfg.workdir))
    return seen


# ---------------------------------------------------------------------------
# journal units
# ---------------------------------------------------------------------------

def _entries_view(ents):
    return {k: dataclasses.asdict(v) for k, v in ents.items()}


def test_journal_append_replay_units(tmp_path):
    """The port's journal folds its records as the JAX package's does, and
    each package replays the other's file to the same entries."""
    from daccord_tpu.serve.journal import JobJournal as JaxJobJournal
    from daccord_tpu.serve.journal import replay as jax_replay
    from daccord_tpu_torch.serve.journal import JobJournal, replay

    got = {}
    for tag, J in (("port", JobJournal), ("jax", JaxJobJournal)):
        p = str(tmp_path / f"{tag}.journal.jsonl")
        j = J(p)
        j.append("admitted", "j00001", tenant="a", nbytes=100,
                 spec={"db": "x", "las": "y"}, dir="/tmp/j1", idem="k1")
        j.append("running", "j00001")
        j.append("progress", "j00001", emitted=8, bytes=512)
        j.append("admitted", "j00002", tenant="b", nbytes=7, spec={})
        j.append("committing", "j00001", bytes=900, part="out.fasta.part.1.2", sha="ab")
        j.append("aborted", "j00002")
        j.close()
        got[tag] = p
    ents, torn = replay(got["port"])
    assert torn == 0 and set(ents) == {"j00001", "j00002"}
    e1 = ents["j00001"]
    assert e1.state == "committing" and e1.part_bytes == 900
    assert e1.part_name == "out.fasta.part.1.2" and e1.part_sha == "ab"
    assert e1.tenant == "a" and e1.nbytes == 100 and e1.idem == "k1"
    assert e1.dir == "/tmp/j1" and not e1.terminal
    assert ents["j00002"].terminal and ents["j00002"].state == "aborted"
    for p in got.values():
        assert _entries_view(replay(p)[0]) == _entries_view(jax_replay(p)[0]) \
            == _entries_view(ents)


def test_journal_torn_tail_tolerated(tmp_path):
    """A crash mid-append tears the last line; replay trusts exactly the
    records fsync'd before it, in both packages."""
    from daccord_tpu.serve.journal import replay as jax_replay
    from daccord_tpu_torch.serve.journal import JobJournal, replay

    p = str(tmp_path / "journal.jsonl")
    j = JobJournal(p)
    j.append("admitted", "j00001", tenant="a", nbytes=1, spec={})
    j.append("running", "j00001")
    j.close()
    with open(p, "ab") as fh:
        fh.write(b'{"rec": "committed", "job": "j000')   # torn mid-write
    ents, torn = replay(p)
    assert torn == 1
    assert ents["j00001"].state == "running"   # the torn commit never counts
    jents, jtorn = jax_replay(p)
    assert jtorn == torn and _entries_view(jents) == _entries_view(ents)


def test_journal_compact_keeps_idem_memory(tmp_path):
    """Compaction collapses terminal jobs to their idempotency memory and
    drops keyless terminal jobs: the file stays bounded while duplicate
    submissions keep deduping. The JAX package replays the compacted file
    to the same entries."""
    from daccord_tpu.serve.journal import replay as jax_replay
    from daccord_tpu_torch.serve.journal import JobJournal, compact, replay

    p = str(tmp_path / "journal.jsonl")
    j = JobJournal(p)
    j.append("admitted", "j00001", tenant="a", nbytes=1, spec={}, idem="k1")
    j.append("committed", "j00001")
    j.append("admitted", "j00002", tenant="a", nbytes=1, spec={})
    j.append("committed", "j00002")
    j.append("admitted", "j00003", tenant="a", nbytes=1, spec={})
    j.append("running", "j00003")
    j.close()
    ents, _ = replay(p)
    compact(p, ents)
    ents2, torn = replay(p)
    assert torn == 0
    assert set(ents2) == {"j00001", "j00003"}    # j00002: terminal, keyless
    assert ents2["j00001"].terminal and ents2["j00001"].idem == "k1"
    assert ents2["j00003"].state == "running"    # live jobs keep their state
    assert _entries_view(jax_replay(p)[0]) == _entries_view(ents2)


def test_serve_fault_kinds_parse_and_count():
    from daccord_tpu_torch.runtime.faults import FaultPlan, non_fleet_spec

    plan = FaultPlan.parse("serve_crash:3,serve_hang:2")
    assert not plan.serve_crash_check()        # append 1
    assert not plan.serve_crash_check()        # append 2
    assert plan.serve_crash_check()            # append 3 fires
    assert not plan.serve_crash_check()        # one-shot
    assert not plan.serve_hang_check()
    assert plan.serve_hang_check()
    assert not plan.serve_hang_check()
    assert non_fleet_spec("serve_crash:1,worker_hang:2") == "serve_crash:1"


# ---------------------------------------------------------------------------
# replay + idempotency + bounded drain (in-process)
# ---------------------------------------------------------------------------

def test_replay_requeues_and_resumes(dataset, tmp_path):
    """A dead service's queued and running jobs replay on restart: the
    running orphan resumes from its per-job checkpoint, the queued one runs
    fresh, both byte-identical; the quota balances restore, the idempotency
    key survives the restart, and each job commits once. The first
    service's worker wedges on job 1 (serve_hang); the test waits for the
    wedge's event, not for a sleep."""
    out, d = dataset
    ref = _solo_bytes(out, d)
    w = tmp_path / "srv"
    svc1 = _svc(w, fault="serve_hang:1", workers=1)
    j1 = svc1.submit({"db": out["db"], "las": out["las"], "tenant": "a",
                      "idempotency_key": "k1"})
    j2 = svc1.submit({"db": out["db"], "las": out["las"], "tenant": "b"})
    assert _wait_for(_hung(svc1, j1["job"]))
    dup = svc1.submit({"db": out["db"], "las": out["las"], "tenant": "a",
                       "idempotency_key": "k1"})
    assert dup["job"] == j1["job"] and dup.get("idempotent")
    svc1._stop.set()     # "crash": no drain, no journal close
    svc2 = _svc(w)
    s1 = svc2.wait(j1["job"], WAIT_S)
    s2 = svc2.wait(j2["job"], WAIT_S)
    assert s1["state"] == "done" and s2["state"] == "done", (s1, s2)
    for j in (j1, j2):
        got = open(os.path.join(str(w), "jobs", j["job"], "out.fasta"), "rb").read()
        assert got == ref
    dup2 = svc2.submit({"db": out["db"], "las": out["las"], "idempotency_key": "k1"})
    assert dup2["job"] == j1["job"] and dup2.get("idempotent")
    st = svc2.stats()
    for t in st["admission"]["tenants"].values():
        assert t["queued"] == 0 and t["bytes"] == 0
    assert svc2.shutdown() is True
    ev = _serve_events(w)
    assert any(e["event"] == "serve.replay" and e["orphans"] == 2 for e in ev)
    commits = [e for e in ev if e["event"] == "serve.commit"]
    assert sorted(e["job"] for e in commits) == sorted([j1["job"], j2["job"]])
    _lint([os.path.join(str(w), "serve.events.jsonl")]
          + glob.glob(os.path.join(str(w), "g*.events.jsonl")))
    ents, torn = _journal(w)
    assert torn == 0
    assert sorted(os.listdir(os.path.join(str(w), "jobs"))) == sorted(
        [j1["job"], j2["job"]])


def _rewind_commit(out, w, job_id, sha: bool):
    """A finished job rewound to the mid-commit window: its FASTA back to a
    part file, no manifest, a journal ending at ``committing``."""
    import hashlib

    from daccord_tpu_torch.serve.jobs import JobSpec
    from daccord_tpu_torch.serve.journal import JobJournal

    jobdir = os.path.join(str(w), "jobs", job_id)
    fasta = os.path.join(jobdir, "out.fasta")
    data = open(fasta, "rb").read()
    os.replace(fasta, os.path.join(jobdir, "out.fasta.part"))
    os.remove(os.path.join(jobdir, "manifest.json"))
    spec = JobSpec.from_json({"db": out["db"], "las": out["las"]}, jobdir)
    jj = JobJournal(os.path.join(str(w), "journal.jsonl"))
    jj.append("admitted", job_id, tenant="a", nbytes=1,
              spec=dataclasses.asdict(spec), dir=jobdir)
    jj.append("running", job_id)
    jj.append("committing", job_id, bytes=len(data),
              **({"sha": hashlib.sha256(data).hexdigest()} if sha else {}))
    jj.close()
    return jobdir, fasta, data


def test_mid_commit_crash_finalizes_without_rerun(dataset, tmp_path):
    """A ``committing`` record and an intact part file: the crash landed
    between the FASTA fsync and the publishing rename. Replay finishes the
    commit in place (rename + manifest, no recompute) at construction."""
    out, d = dataset
    ref = _solo_bytes(out, d)
    w = tmp_path / "srv"
    svc1 = _svc(w)
    j1 = svc1.submit({"db": out["db"], "las": out["las"], "tenant": "a"})
    assert svc1.wait(j1["job"], WAIT_S)["state"] == "done"
    assert svc1.shutdown() is True
    jobdir, fasta, data = _rewind_commit(out, w, j1["job"], sha=False)
    svc2 = _svc(w)
    assert os.path.exists(fasta) and open(fasta, "rb").read() == data == ref
    man = json.load(open(os.path.join(jobdir, "manifest.json")))
    assert man.get("recovered") is True
    ents, _ = _journal(w)
    assert ents[j1["job"]].state == "committed"
    assert svc2.shutdown() is True


def test_mid_commit_digest_mismatch_resolves_instead(dataset, tmp_path):
    """The ``committing`` record carries the sha256 of the fsync'd part. A
    part corrupted between crash and recovery (same size, one base flipped)
    is not renamed into place: finalize refuses (``io.fault``), the orphan
    re-admits and re-solves to the reference bytes."""
    out, d = dataset
    ref = _solo_bytes(out, d)
    w = tmp_path / "srv"
    svc1 = _svc(w)
    j1 = svc1.submit({"db": out["db"], "las": out["las"], "tenant": "a"})
    assert svc1.wait(j1["job"], WAIT_S)["state"] == "done"
    assert svc1.shutdown() is True
    jobdir, fasta, data = _rewind_commit(out, w, j1["job"], sha=True)
    part = os.path.join(jobdir, "out.fasta.part")
    seq_at = data.index(b"\n") + 1
    flip = b"C" if data[seq_at:seq_at + 1] != b"C" else b"G"
    with open(part, "r+b") as fh:
        fh.seek(seq_at)
        fh.write(flip)
    svc2 = _svc(w)
    assert not os.path.exists(fasta)
    st = svc2.wait(j1["job"], WAIT_S)
    assert st["state"] == "done"
    assert open(fasta, "rb").read() == ref
    refusals = [r for r in _serve_events(w) if r.get("event") == "io.fault"
                and r.get("op") == "finalize"]
    assert refusals and "digest" in refusals[0]["error"]
    assert svc2.shutdown() is True
    _lint([os.path.join(str(w), "serve.events.jsonl")])


def test_bounded_drain_marks_interrupted_and_resumes(dataset, tmp_path):
    """A wedged job no longer hangs shutdown: past the drain deadline the
    job is journal-marked INTERRUPTED and shutdown reports unclean; the next
    incarnation replays it to a byte-identical commit."""
    out, d = dataset
    ref = _solo_bytes(out, d)
    w = tmp_path / "srv"
    svc1 = _svc(w, fault="serve_hang:1", workers=1, drain_deadline_s=0.5)
    j1 = svc1.submit({"db": out["db"], "las": out["las"], "tenant": "a"})
    assert _wait_for(_hung(svc1, j1["job"]))
    t0 = time.time()
    assert svc1.shutdown() is False          # bounded: unclean, not hung
    assert time.time() - t0 < 30
    ents, _ = _journal(w)
    assert ents[j1["job"]].state == "interrupted"
    svc2 = _svc(w)
    assert svc2.wait(j1["job"], WAIT_S)["state"] == "done"
    got = open(os.path.join(str(w), "jobs", j1["job"], "out.fasta"), "rb").read()
    assert got == ref
    assert svc2.shutdown() is True


def test_peer_takeover_finishes_dead_peers_job(dataset, tmp_path):
    """A peer on the shared FS sees the dead process's stale per-job lease,
    claims the journaled job and finishes it byte-identically (a
    ``serve.takeover`` event, the ``takeovers`` counter); the owner's restart
    then finds the peer's manifest and runs nothing again."""
    from daccord_tpu_torch.utils import lease

    out, d = dataset
    ref = _solo_bytes(out, d)
    peer = str(tmp_path / "peer")
    a = _svc(tmp_path / "srvA", fault="serve_hang:1", workers=1, peer_dir=peer,
             lease_ttl_s=2.0, heartbeat_s=0.2)
    j = a.submit({"db": out["db"], "las": out["las"], "tenant": "a"})
    assert _wait_for(_hung(a, j["job"]))
    a._stop.set()      # A "dies": its heartbeats stop
    a._ticker.join(WAIT_S)
    lp = glob.glob(os.path.join(peer, "leases", "*.lease"))
    assert len(lp) == 1 and lp[0].endswith(f"srvA.{j['job']}.lease")
    lease.backdate(lp[0], 10.0)   # stale now, without waiting out the TTL
    b = _svc(tmp_path / "srvB", workers=2, peer_dir=peer, lease_ttl_s=2.0,
             heartbeat_s=0.2)
    key = f"srvA.{j['job']}"
    assert _wait_for(lambda: b.status(key) is not None)
    st = b.wait(key, WAIT_S)
    assert st and st["state"] == "done", st
    got = open(os.path.join(str(tmp_path / "srvA"), "jobs", j["job"], "out.fasta"),
               "rb").read()
    assert got == ref
    c = _svc(tmp_path / "srvA", workers=1, peer_dir=peer, lease_ttl_s=2.0,
             heartbeat_s=0.2)
    rep = [e for e in _serve_events(tmp_path / "srvA") if e["event"] == "serve.replay"]
    assert rep and rep[-1]["finished"] == 1 and rep[-1]["orphans"] == 0
    assert b.shutdown() is True and c.shutdown() is True
    roll = json.load(open(os.path.join(str(tmp_path / "srvB"), "serve.metrics.json")))
    assert roll["metrics"]["counters"].get("takeovers") == 1
    tk = [e for e in _serve_events(tmp_path / "srvB") if e["event"] == "serve.takeover"]
    assert len(tk) == 1 and tk[0]["job"] == key
    assert tk[0]["prev_host"].startswith("srvA@")   # service@host:pid
    _lint([os.path.join(str(tmp_path / "srvB"), "serve.events.jsonl"),
           os.path.join(str(tmp_path / "srvA"), "serve.events.jsonl")])


# ---------------------------------------------------------------------------
# the kill matrix (real subprocesses of the port's CLI)
# ---------------------------------------------------------------------------

def _spawn_serve(workdir, root, tag, fault=None, checkpoint_reads=4, extra=()):
    ready = os.path.join(str(root), f"ready-{tag}.json")
    argv = [sys.executable, "-m", "daccord_tpu_torch.tools.cli", "serve",
            "--workdir", str(workdir), "--backend", "native", "-b", "64",
            "--workers", "2", "--port", "0", "--ready-file", ready,
            "--checkpoint-reads", str(checkpoint_reads), "--flush-lag-ms", "20",
            *extra]
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "2"
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(__import__("daccord_tpu_torch").__file__)))
    env["PYTHONPATH"] = pkg_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    if fault:
        env["DACCORD_FAULT"] = fault
    else:
        env.pop("DACCORD_FAULT", None)
    log = open(os.path.join(str(root), f"serve-{tag}.log"), "wb")
    proc = subprocess.Popen(argv, env=env, stdout=log, stderr=log)
    ok = _wait_for(lambda: os.path.exists(ready) or proc.poll() is not None,
                   timeout=120, step=0.05)
    port = None
    if ok and os.path.exists(ready):
        try:
            port = json.load(open(ready))["port"]
        except (OSError, json.JSONDecodeError, ValueError):
            pass
    return proc, port


def _req(port, method, path, body=None, timeout=120):
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        return resp.status, resp.read()


@pytest.mark.parametrize("point,fault,ck,stream", [
    # journal appends run in lifecycle order, so serve_crash:N pins the kill
    # to one point: 1 = the admitted append (the 201 may never reach the
    # client), 3 with a 4-read checkpoint stride = the first progress
    # append (running mid-batch; also the mid-stream client arm), 3 with
    # checkpoints off = the committing append (between the FASTA fsync and
    # the rename)
    ("post_admit", "serve_crash:1", 4, False),
    ("running_mid_batch", "serve_crash:3", 4, True),
    ("mid_commit", "serve_crash:3", 0, False),
])
def test_kill_matrix_sigkill_restart_parity(dataset, tmp_path, point, fault, ck, stream):
    out, d = dataset
    ref = _solo_bytes(out, d)
    w = tmp_path / "srv"
    proc, port = _spawn_serve(w, tmp_path, "a", fault=fault, checkpoint_reads=ck)
    try:
        assert port is not None or proc.poll() is not None
        job_id = None
        if port is not None:
            try:
                code, raw = _req(port, "POST", "/v1/jobs",
                                 {"db": out["db"], "las": out["las"],
                                  "idempotency_key": f"km-{point}"}, timeout=60)
                job_id = json.loads(raw)["job"]
            except (urllib.error.URLError, ConnectionError, OSError):
                pass   # post_admit: the kill can beat the 201; the key recovers it
            if stream and job_id:
                import http.client

                try:
                    urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/v1/jobs/{job_id}/stream",
                        timeout=5).read()
                except (urllib.error.URLError, ConnectionError, OSError,
                        TimeoutError, http.client.HTTPException):
                    pass
        rc = proc.wait(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 137, f"{point}: expected the injected kill, got {rc}"
    proc2, port2 = _spawn_serve(w, tmp_path, "b", fault=None, checkpoint_reads=ck)
    try:
        assert port2 is not None
        code, raw = _req(port2, "POST", "/v1/jobs",
                         {"db": out["db"], "las": out["las"],
                          "idempotency_key": f"km-{point}"})
        st = json.loads(raw)
        if job_id is None:
            job_id = st["job"]
        assert st["job"] == job_id
        assert code == 200 and st.get("idempotent"), (code, st)
        # ?wait=1 returns once the job is settled: its quota released too
        code, raw = _req(port2, "GET", f"/v1/jobs/{job_id}/result?wait=1", timeout=WAIT_S)
        assert code == 200 and raw == ref, f"{point}: resumed FASTA diverged"
        code, raw = _req(port2, "GET", "/v1/metrics")
        m = json.loads(raw)
        for t in m["admission"]["tenants"].values():
            assert t["queued"] == 0 and t["bytes"] == 0
        _req(port2, "POST", "/v1/shutdown")
        assert proc2.wait(timeout=WAIT_S) == 0
    finally:
        if proc2.poll() is None:
            proc2.kill()
            proc2.wait()
    assert os.listdir(os.path.join(str(w), "jobs")) == [job_id]
    ents, _ = _journal(w)
    assert ents[job_id].state == "committed"
    commits = [e for e in _serve_events(w) if e["event"] == "serve.commit"]
    assert len(commits) == 1 and commits[0]["job"] == job_id
    if point == "mid_commit":
        man = json.load(open(os.path.join(str(w), "jobs", job_id, "manifest.json")))
        assert man.get("recovered") is True
    _lint([os.path.join(str(w), "serve.events.jsonl")])


# ---------------------------------------------------------------------------
# tooling: sentinel red flags + the top lease table
# ---------------------------------------------------------------------------

def _write_events(path, recs):
    t0 = time.time()
    with open(path, "w") as fh:
        for i, r in enumerate(recs):
            fh.write(json.dumps({"t": 0.001 * i, "ts": t0 + 0.001 * i, **r}) + "\n")


def test_sentinel_flags_replay_without_commit(tmp_path):
    from daccord_tpu.tools.sentinel import scan_events as jax_scan_events
    from daccord_tpu_torch.tools.sentinel import scan_events

    p = str(tmp_path / "serve.events.jsonl")
    _write_events(p, [
        {"event": "serve.journal", "rec": "replayed", "job": "j00001"},
        {"event": "serve.journal", "rec": "replayed", "job": "j00002"},
        {"event": "serve.journal", "rec": "committed", "job": "j00002"},
    ])
    issues = scan_events(p)
    assert any("j00001" in i and "replayed" in i for i in issues)
    assert not any("j00002" in i for i in issues)
    assert issues == jax_scan_events(p)


def test_sentinel_flags_repeated_takeover(tmp_path):
    from daccord_tpu_torch.tools.sentinel import scan_events

    p = str(tmp_path / "serve.events.jsonl")
    _write_events(p, [
        {"event": "serve.takeover", "job": "srvA.j00001", "prev_host": "srvA:1",
         "stale_s": 5.0},
        {"event": "serve.takeover", "job": "srvA.j00001", "prev_host": "srvB:2",
         "stale_s": 5.0},
        {"event": "serve.journal", "rec": "committed", "job": "srvA.j00001"},
        {"event": "serve.takeover", "job": "srvA.j00002", "prev_host": "srvA:1",
         "stale_s": 5.0},
    ])
    issues = scan_events(p)
    assert any("taken over 2 times" in i for i in issues)
    assert not any("j00002" in i and "taken over" in i for i in issues)


def test_top_renders_lease_ownership(tmp_path):
    """The port's top renders leases the port's lease module claimed."""
    from daccord_tpu_torch.tools.top import collect, render
    from daccord_tpu_torch.utils import lease

    peer = tmp_path / "peer"
    lease.claim(str(peer / "leases" / "srvA.j00001.lease"), "srvA:42", 15.0,
                extra={"job": "j00001", "service": "srvA"})
    lease.claim(str(peer / "leases" / "srvB.j00007.lease"), "srvB:43", 15.0,
                extra={"job": "j00007", "service": "srvB"})
    lease.backdate(str(peer / "leases" / "srvB.j00007.lease"), 120.0)
    snap = collect([str(peer)])
    assert len(snap["leases"]) == 2
    by_name = {le["name"]: le for le in snap["leases"]}
    assert by_name["srvA.j00001"]["holder"] == "srvA:42"
    assert by_name["srvB.j00007"]["age_s"] > 60
    text = render(snap)
    assert "LEASE" in text and "srvA.j00001" in text and "srvB:43" in text


def test_eventcheck_accepts_and_rejects_new_kinds(tmp_path):
    from daccord_tpu_torch.tools.eventcheck import validate_events

    good = str(tmp_path / "good.jsonl")
    _write_events(good, [
        {"event": "serve.journal", "rec": "admitted", "job": "j00001"},
        {"event": "serve.replay", "jobs": 3, "orphans": 1, "finished": 1, "torn": 0},
        {"event": "serve.takeover", "job": "srvA.j00001", "prev_host": "srvA:7",
         "stale_s": 4.5},
    ])
    assert validate_events(good, strict=True) == []
    bad = str(tmp_path / "bad.jsonl")
    _write_events(bad, [{"event": "serve.takeover", "job": "srvA.j00001"}])
    assert validate_events(bad, strict=True)


# ---------------------------------------------------------------------------
# chaos soak (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_chaos_soak_two_processes(dataset, tmp_path):
    """Two serve processes sharing a peer dir take eight jobs, one of them
    killed at its fourth journal append and restarted: every job commits
    exactly once, byte-identical to the solo run, with no quota left
    charged."""
    out, d = dataset
    ref = _solo_bytes(out, d)
    peer = str(tmp_path / "peer")
    extra = ("--peer-dir", peer, "--lease-ttl-s", "3", "--heartbeat-s", "0.2")
    pa, porta = _spawn_serve(tmp_path / "A", tmp_path, "A", fault="serve_crash:4",
                             extra=extra)
    pb, portb = _spawn_serve(tmp_path / "B", tmp_path, "B", extra=extra)
    procs = [pa, pb]
    try:
        keys = {}
        for i in range(8):
            port = porta if i % 2 == 0 else portb
            try:
                _, raw = _req(port, "POST", "/v1/jobs",
                              {"db": out["db"], "las": out["las"],
                               "idempotency_key": f"soak-{i}"}, timeout=60)
                keys[i] = (port, json.loads(raw)["job"])
            except (urllib.error.URLError, ConnectionError, OSError):
                keys[i] = (port, None)
        assert pa.wait(timeout=WAIT_S) == 137
        pa2, porta2 = _spawn_serve(tmp_path / "A", tmp_path, "A2", extra=extra)
        procs.append(pa2)
        for i, (port, job) in keys.items():
            port = porta2 if port == porta else portb
            _, raw = _req(port, "POST", "/v1/jobs",
                          {"db": out["db"], "las": out["las"],
                           "idempotency_key": f"soak-{i}"}, timeout=60)
            job = json.loads(raw)["job"]
            code, fasta = _req(port, "GET", f"/v1/jobs/{job}/result?wait=1",
                               timeout=WAIT_S)
            assert code == 200 and fasta == ref, (i, job)
        for port in (porta2, portb):
            _, raw = _req(port, "GET", "/v1/metrics")
            for t in json.loads(raw)["admission"]["tenants"].values():
                assert t["queued"] == 0 and t["bytes"] == 0
            _req(port, "POST", "/v1/shutdown")
    finally:
        for p in procs:
            if p.poll() is None:
                p.wait(timeout=WAIT_S)
