"""The telemetry plane of the port's main path (``runtime/pipeline.py`` with
``utils/obs.py``) against the JAX package's, both on the CPU, on one small
simulated set of the 20 kb set's shape (20x, 2 kb reads, cut to a 2.5 kb
genome).

The same run goes through each package's pipeline with ``events_path`` set,
once on the native engine and once on the ladder (the JAX package's host
CPU ladder; the port's ladder on the CPU behind its dispatcher thread, the
main path's structure). On each pair: the same event kinds and span names
(the port adds its own ``ladder.call`` span under each ``dispatch`` of its
dispatcher), the same numbers of ``pile`` and ``batch`` spans, the same
``shard_done`` counts, the same metric names in the rollup, and logs that
pass ``eventcheck --strict`` and ``prof --check``. Telemetry never changes a
byte, under the fault matrix too, and ``feeder_stall`` moves the verdict to
the injected stall with the same bytes.
"""

import json
import os

import pytest
import torch

from daccord_tpu.runtime import supervisor as jax_supervisor
from daccord_tpu.runtime.pipeline import PipelineConfig as JaxPipelineConfig
from daccord_tpu.runtime.pipeline import correct_to_fasta as jax_correct_to_fasta
from daccord_tpu.tools import prof as jax_prof
from daccord_tpu.tools.eventcheck import validate_events as jax_validate_events
from daccord_tpu_torch.runtime import supervisor
from daccord_tpu_torch.runtime.pipeline import PipelineConfig, correct_to_fasta
from daccord_tpu_torch.sim import SimConfig, make_dataset
from daccord_tpu_torch.tools import cli, prof, trace
from daccord_tpu_torch.tools.eventcheck import validate_events

ENGINES = ("native", "ladder")
DONE_COUNTS = ("reads", "windows", "solved", "skipped_shallow", "topm_overflow",
               "bases_out", "quarantined", "ingest_issues", "paged")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _events(path: str) -> list[dict]:
    return [json.loads(x) for x in open(path) if x.strip()]


def _spans(recs: list[dict]) -> list[dict]:
    return [r for r in recs if r["event"] == "span_open"]


def _run(pkg: str, engine: str, tmp, tag: str, telemetry: bool = True, **kw):
    """One run of ``pkg``'s pipeline on ``engine``: (FASTA bytes, stats,
    events path)."""
    ev = os.path.join(tmp, f"{pkg}_{engine}_{tag}.events.jsonl") if telemetry else None
    out = os.path.join(tmp, f"{pkg}_{engine}_{tag}.fasta")
    if pkg == "jax":
        cfg = JaxPipelineConfig(batch_size=64, events_path=ev,
                                native_solver=engine == "native", **kw)
        st = jax_correct_to_fasta(DATA["db"], DATA["las"], out, cfg)
    else:
        cfg = PipelineConfig(batch_size=64, events_path=ev, device="cpu",
                             native_solver=engine == "native", **kw)
        st = correct_to_fasta(DATA["db"], DATA["las"], out, cfg)
    return open(out).read(), st, ev


DATA: dict = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs on both engines, with events; the port's ladder
    run also writes a ledger, snapshots every 50 ms and captures a profiler
    trace of its first ladder call."""
    root = str(tmp_path_factory.mktemp("telemetry"))
    DATA.update(make_dataset(os.path.join(root, "d"), SimConfig(
        genome_len=2500, coverage=20, read_len_mean=2000, min_overlap=400, seed=42)))
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        # every shape cold in both packages, so both log their cold-shape
        # classification alike
        mp.setenv("DACCORD_NO_COMPCACHE", "1")
        mp.delenv("DACCORD_FAULT", raising=False)
        for engine in ENGINES:
            got[("jax", engine)] = _run("jax", engine, root, "run")
            kw = {}
            if engine == "ladder":
                mp.setenv("DACCORD_PROFILE_DIR", os.path.join(root, "capture"))
                mp.setenv("DACCORD_PROFILE_DISPATCH", "1")
                kw = dict(metrics_snapshot_s=0.05,
                          ledger_path=os.path.join(root, "port_ladder.ledger.jsonl"))
            got[("port", engine)] = _run("port", engine, root, "run", **kw)
            mp.delenv("DACCORD_PROFILE_DIR", raising=False)
    got["root"] = root
    return got


@pytest.mark.parametrize("engine", ENGINES)
def test_event_kinds_and_span_names_equal_the_jax_packages(runs, engine):
    port, jax = (_events(runs[(p, engine)][2]) for p in ("port", "jax"))
    kinds = {r["event"] for r in port}
    if engine == "ladder":
        kinds -= {"profile.capture"}      # the port run's capture
    assert kinds == {r["event"] for r in jax}
    want = {r["name"] for r in _spans(jax)}
    if engine == "ladder":
        want |= {"ladder.call"}
    assert {r["name"] for r in _spans(port)} == want
    assert {"run", "scan", "profile", "pile", "feeder", "batch", "dispatch",
            "device.fetch"} <= want
    for kind in ("shard_done", "stage.profile", "metrics", "ingest.scan"):
        assert kind in kinds


@pytest.mark.parametrize("engine", ENGINES)
def test_pile_and_batch_spans_and_shard_done_counts_equal(runs, engine):
    port, jax = (_events(runs[(p, engine)][2]) for p in ("port", "jax"))
    for name in ("pile", "batch", "feeder", "dispatch"):
        assert (sum(r["name"] == name for r in _spans(port))
                == sum(r["name"] == name for r in _spans(jax)) > 0), name
    pd, jd = ([r for r in recs if r["event"] == "shard_done"][-1] for recs in (port, jax))
    assert {k: pd[k] for k in DONE_COUNTS} == {k: jd[k] for k in DONE_COUNTS}
    assert pd["mesh"] == 0 and set(pd) >= set(jd) - {"pack_s", "stage_s", "launch_s",
                                                      "restaged"}
    assert runs[("port", engine)][0] == runs[("jax", engine)][0]


@pytest.mark.parametrize("engine", ENGINES)
def test_rollups_have_the_jax_packages_metric_names(runs, engine):
    pm, jm = runs[("port", engine)][1].metrics, runs[("jax", engine)][1].metrics
    for key in ("counters", "gauges", "hists"):
        assert sorted(pm[key]) == sorted(jm[key]), key
    assert pm["verdict"] == runs[("port", engine)][1].verdict
    assert pm["gauges"]["n_windows"] == runs[("port", engine)][1].n_windows


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("engine", ENGINES)
def test_logs_pass_eventcheck_strict_and_prof_check(runs, pkg, engine):
    ev = runs[(pkg, engine)][2]
    assert validate_events(ev, strict=True) == []
    assert jax_validate_events(ev, strict=True) == []
    assert prof.prof_main(["--check", ev]) == 0
    assert jax_prof.prof_main(["--check", ev]) == 0
    if pkg == "port":
        assert trace.trace_main([ev, "--check", "--no-timeline"]) == 0


def test_the_port_ladder_runs_telemetry(runs):
    """The main path's structure: each ladder call is a child of its
    dispatch, periodic snapshots land and end with the final one, the
    profiler capture brackets the first call and writes its trace, and the
    ledger holds one row per window."""
    _, st, ev = runs[("port", "ladder")]
    recs = _events(ev)
    spans = {r["span"]: r for r in _spans(recs)}
    calls = [r for r in spans.values() if r["name"] == "ladder.call"]
    assert calls and all(spans[c["parent"]]["name"] == "dispatch" for c in calls)
    snaps = [r for r in recs if r["event"] == "metrics"]
    assert len(snaps) >= 2 and snaps[-1].get("final") is True
    assert sum(r["event"] == "stage.profile" for r in recs) >= 2
    caps = [r for r in recs if r["event"] == "profile.capture"]
    assert [c["state"] for c in caps] == ["start", "stop"]
    cap_dir = os.path.join(runs["root"], "capture")
    assert any(f.endswith(".trace.json") for f in os.listdir(cap_dir))
    rows = [r for r in _events(os.path.join(runs["root"], "port_ladder.ledger.jsonl"))
            if r["event"] == "window"]
    assert len(rows) == st.n_windows
    d = trace.decompose(recs, "port")
    assert d is not None and trace.reconcile(d) == []
    assert st.host_s == pytest.approx(st.wall_s - st.device_s, abs=0.05)


def test_the_fasta_is_the_same_with_telemetry_on_and_off(runs, tmp_path):
    off, _, _ = _run("port", "ladder", str(tmp_path), "off", telemetry=False)
    assert off == runs[("port", "ladder")][0]


@pytest.mark.parametrize("fault", [None, "device_lost:2", "device_oom:2"])
def test_telemetry_changes_no_byte_under_the_fault_matrix(runs, fault, tmp_path, monkeypatch):
    """The port's counterpart of the JAX package's
    ``test_telemetry_byte_parity_under_fault_matrix``, on the native engine
    as there: on and off write the same bytes, and the faulted runs' spans
    still pair."""
    if fault is None:
        monkeypatch.delenv("DACCORD_FAULT", raising=False)
    else:
        monkeypatch.setenv("DACCORD_FAULT", fault)
    # a registry each, so the second run meets the injected fault at the
    # same width as the first (no ratchet carried over)
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc_off"))
    off, _, _ = _run("port", "native", str(tmp_path), "off", telemetry=False)
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc_on"))
    on, _, ev = _run("port", "native", str(tmp_path), "on", metrics_snapshot_s=0.01)
    assert on == off == runs[("port", "native")][0]
    assert trace.trace_main([ev, "--check", "--no-timeline"]) == 0
    assert validate_events(ev, strict=True) == []
    if fault == "device_oom:2":
        assert any(r["event"] == "governor.classify" for r in _events(ev))


def test_feeder_stall_moves_the_verdict_to_the_stall_with_the_same_bytes(runs, tmp_path,
                                                                         monkeypatch):
    """``DACCORD_FAULT=feeder_stall:MS`` sleeps MS a pile block: the run's
    wall is then mostly the stall, so the verdict is ``host_feeder`` with
    ``stall`` its named stage and the device idle share rises; the bytes do
    not move. MS is sized from the base run's own walls (at least 250): the
    stall's total is eight times the base run's dispatch wall and feeder
    wall together, so it dominates the run whatever load the host is under
    (on a loaded host a fixed stall could fall below the engine's share of
    the wall, which the native engine books as blocked). No wall is
    compared."""
    base = runs[("port", "native")]
    blocks = sum(r["name"] == "feeder" for r in _spans(_events(base[2]))) - 1
    ms = max(250, int(8e3 * (base[1].dispatch_s + base[1].feeder_s) / max(blocks, 1)) + 1)
    monkeypatch.setenv("DACCORD_FAULT", f"feeder_stall:{ms}")
    fasta, st, ev = _run("port", "native", str(tmp_path), "stall")
    assert fasta == base[0]
    assert base[1].bottleneck["stage"] != "stall"
    assert st.verdict == "host_feeder" and st.bottleneck["stage"] == "stall"
    assert st.bottleneck["device_idle_frac"] > base[1].bottleneck["device_idle_frac"]
    recs = _events(ev)
    assert any(r["event"] == "sup_fault" and r["kind"] == "feeder_stall"
               and r["op"] == "feeder" and r["n"] == ms for r in recs)
    assert st.stage_profile["stages"]["stall"]["calls"] == sum(
        r["name"] == "feeder" for r in _spans(recs)) - 1 == blocks
    assert prof.prof_main(["--check", ev]) == 0


def test_cli_profile_writes_a_trace_and_metrics_snapshot_flag(runs, tmp_path):
    pdir = str(tmp_path / "prof")
    ev = str(tmp_path / "cli.events.jsonl")
    out = str(tmp_path / "cli.fasta")
    assert cli.main(["daccord", DATA["db"], DATA["las"], "-o", out, "--backend", "native",
                     "--no-hp-rescue", "-b", "64", "--profile", pdir, "--events", ev,
                     "--metrics-snapshot-s", "0"]) == 0
    assert open(out).read() == runs[("port", "native")][0]
    assert any(f.endswith(".trace.json") for f in os.listdir(pdir))
    # 0 = no periodic snapshot: the final one alone
    assert [r.get("final") for r in _events(ev) if r["event"] == "metrics"] == [True]
    with pytest.raises(SystemExit):
        cli.main(["daccord", DATA["db"], DATA["las"], "-o", out, "--backend", "native",
                  "--metrics-snapshot-s", "-1"])


@pytest.mark.parametrize("rtt", [None, 0.0, 0.01, 0.5, 2.0])
def test_rtt_scaled_deadline_equals_the_jax_supervisors(rtt):
    kw = dict(log=None, probe_fn=lambda: True, inline=True)
    port = supervisor.DeviceSupervisor(lambda b: b, lambda h: h, rtt_s=rtt, **kw)
    jax = jax_supervisor.DeviceSupervisor(lambda b: b, lambda h: h, None, rtt_s=rtt, **kw)
    assert port.op_deadline_s == jax.op_deadline_s
    assert (port.cfg.rtt_mult, port.cfg.min_op_deadline_s) == (
        jax.cfg.rtt_mult, jax.cfg.min_op_deadline_s)


def test_the_audit_workers_wait_keeps_the_flat_deadline_under_rtt_scaling():
    """The RTT scaling is the card's: the wait for an audit worker, a CPU
    process, keeps ``SupervisorConfig.op_deadline_s``."""
    from types import SimpleNamespace

    from daccord_tpu_torch.audit.worker import AuditWorkerError

    waits = []

    class Worker:
        def result(self, ticket, timeout):
            waits.append(timeout)
            raise AuditWorkerError("no verdict")

    sup = supervisor.DeviceSupervisor(lambda b: b, lambda h: h, log=None,
                                      probe_fn=lambda: True, inline=True, rtt_s=0.01,
                                      audit_ref_factory=lambda: None,
                                      audit_worker=Worker(), audit_rate=1.0 / 64)
    assert sup.op_deadline_s == sup.cfg.min_op_deadline_s < sup.cfg.op_deadline_s
    out = {"seq": "kept"}
    assert sup._audit_remote(SimpleNamespace(audit=([0], 7), batch=None), out) is out
    assert waits == [sup.cfg.op_deadline_s] and sup.audit_disabled == "no verdict"
