"""The port's fault plan, capacity governor and supervisor units against the
JAX package's.

Every case runs the same scripted scenario through both packages' modules
(``runtime/faults.py``, ``runtime/governor.py``, ``runtime/supervisor.py``)
with the same stub engine, and holds the port to the JAX package's engine
widths, merged results, events and counters; then checks the expectations of
``tests/test_governor.py`` and ``tests/test_supervisor.py`` on the port's
side. No ladder runs here: ``tests/test_torch_supervisor.py`` runs the fault
matrix through the port's ``daccord``.
"""

import json
import os

import numpy as np
import pytest

import daccord_tpu.kernels.tensorize as jax_tensorize
import daccord_tpu.runtime.faults as jax_faults
import daccord_tpu.runtime.governor as jax_governor
import daccord_tpu.runtime.supervisor as jax_supervisor
import daccord_tpu.utils.obs as jax_obs
import daccord_tpu_torch.kernels.tensorize as port_tensorize
import daccord_tpu_torch.runtime.faults as port_faults
import daccord_tpu_torch.runtime.governor as port_governor
import daccord_tpu_torch.runtime.supervisor as port_supervisor
import daccord_tpu_torch.utils.obs as port_obs
from daccord_tpu.tools.eventcheck import validate_events as jax_validate
from daccord_tpu_torch.kernels.nvcc import KernelError
from daccord_tpu_torch.tools.eventcheck import validate_events

PACKAGES = {"jax": (jax_tensorize, jax_faults, jax_governor, jax_supervisor, jax_obs),
            "port": (port_tensorize, port_faults, port_governor, port_supervisor,
                     port_obs)}

SPECS = ["fetch_hang", "fetch_hang:3", "dispatch_error:5", "device_lost:7",
         "compile_stall", "device_lost:2,crash:9", "device_lost:2@3",
         "las_bitflip:4", "las_truncate:30", "db_garbage:2", "worker_crash:2",
         "worker_hang:3", "lease_stall", "worker_oom:2", "device_oom:3",
         "host_rss:2", "monster_pile:4", "feeder_stall:50", "serve_crash:3",
         "serve_hang:1", "io_enospc:3", "io_eio:2", "io_fsync_fail:1",
         "io_short_write:2", "io_slow:50", "io_enospc:3@journal",
         "net_refused:3", "net_reset:2", "net_hang:1", "net_torn:512",
         "net_slow:80", "net_reset:3@submit", "sdc:3", "sdc:1@2", "sdc:*@3",
         "device_oom:1,device_oom:2,host_rss:1,monster_pile:2,sdc:2"]
BAD_SPECS = ["nope", "fetch_hang:x", "fetch_hang:0", "sdc:1@banana",
             "io_eio:1@nowhere", "net_reset:1@nowhere", "fetch_hang:1@2"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parse_matches_jax(spec):
    """Every kind of the ``DACCORD_FAULT`` grammar parses to the same specs
    in both packages, so a composed spec means the same in both."""
    j = jax_faults.FaultPlan.parse(spec)
    p = port_faults.FaultPlan.parse(spec)
    assert [vars(s) for s in p.specs] == [vars(s) for s in j.specs]


def test_fault_plan_rejects_what_jax_rejects():
    assert port_faults._KINDS == jax_faults._KINDS
    for spec in BAD_SPECS:
        with pytest.raises(ValueError) as je:
            jax_faults.FaultPlan.parse(spec)
        with pytest.raises(ValueError) as pe:
            port_faults.FaultPlan.parse(spec)
        assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("helper,args", [
    ("corrupt_las_bitflip", (4,)), ("corrupt_las_bitflip", (2, "tlen", 30)),
    ("corrupt_las_truncate", (7,)), ("corrupt_db_garbage", (2,))])
def test_data_fault_helpers_match_jax(tmp_path, helper, args):
    """The data-corruption helpers write the JAX package's bytes."""
    from daccord_tpu_torch.sim import SimConfig, make_dataset

    outs = {}
    for name, (_, faults, _, _, _) in PACKAGES.items():
        d = make_dataset(str(tmp_path / name), SimConfig(genome_len=1500, coverage=8,
                                                         read_len_mean=400, seed=2))
        target = d["db"] if helper == "corrupt_db_garbage" else d["las"]
        info = getattr(faults, helper)(target, *args)
        idx = os.path.join(os.path.dirname(d["db"]), ".sim.idx")
        with open(idx if helper == "corrupt_db_garbage" else d["las"], "rb") as fh:
            outs[name] = (fh.read(), {k: v for k, v in info.items() if k != "path"})
    assert outs["port"] == outs["jax"]


def test_fault_plan_capacity_kinds():
    plan = port_faults.FaultPlan.parse("device_oom:2")
    plan.op("dispatch", width=64)
    with pytest.raises(port_faults.FaultDeviceOOM, match="RESOURCE_EXHAUSTED"):
        plan.op("fetch", width=64)
    assert plan.oom_max_width == 32
    with pytest.raises(port_faults.FaultDeviceOOM):
        plan.op("dispatch", width=33)
    plan.op("dispatch", width=32)
    plan = port_faults.FaultPlan.parse("host_rss:2,monster_pile:3")
    assert [plan.host_rss_check() for _ in range(3)] == [False, True, False]
    assert [plan.monster_check() for _ in range(4)] == [False, False, True, False]
    assert port_faults.non_fleet_spec("worker_oom:2,device_oom:3") == "device_oom:3"


def test_is_capacity_error_classification():
    import torch

    is_cap = port_governor.is_capacity_error
    assert is_cap(port_faults.FaultDeviceOOM("RESOURCE_EXHAUSTED: injected"))
    assert is_cap(MemoryError())
    assert is_cap(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                              "allocate 2.00 GiB"))
    assert is_cap(RuntimeError("Failed to allocate request"))
    assert not is_cap(RuntimeError("socket closed"))
    assert not is_cap(TimeoutError("deadline"))
    lost = port_supervisor.is_device_lost_error
    assert lost(RuntimeError("CUDA error: unspecified launch failure"))
    assert lost(RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert lost(RuntimeError("CUDA error: device-side assert triggered"))
    assert lost(RuntimeError("CUDA error: uncorrectable ECC error encountered"))
    assert not lost(RuntimeError("socket closed"))
    assert not lost(torch.cuda.OutOfMemoryError("CUDA out of memory"))


def test_merge_results_and_slice_batch():
    b = _mini_batch(port_tensorize, b=6)
    s = port_tensorize.slice_batch(b, 2, 5)
    assert s.size == 3 and list(s.read_ids) == [2, 3, 4]
    p = port_tensorize.pad_batch(port_tensorize.slice_batch(b, 4, 6), 4)
    assert p.size == 4 and list(p.read_ids[:2]) == [4, 5]
    parts = [(3, {"val": np.arange(4), "esc_overflow": np.int32(1), "name": "x"}),
             (2, {"val": np.arange(4) + 10, "esc_overflow": np.int32(2), "name": "x"})]
    for gov in (port_governor, jax_governor):
        m = gov.merge_results(parts)
        np.testing.assert_array_equal(m["val"], [0, 1, 2, 10, 11])
        assert m["esc_overflow"] == 3 and m["name"] == "x"
    one = {"val": np.arange(3)}
    assert port_governor.merge_results([(3, one)]) is one


# ------------------------------------------------------------- scenarios

def _mini_batch(tensorize, b=8, d=2, l=8):
    return tensorize.WindowBatch(seqs=np.zeros((b, d, l), np.int8),
                                 lens=np.zeros((b, d), np.int32),
                                 nsegs=np.zeros(b, np.int32),
                                 shape=tensorize.BatchShape(depth=d, seg_len=l, wlen=l),
                                 read_ids=np.arange(b, dtype=np.int64),
                                 wstarts=np.zeros(b, np.int64))


class WidthLogEngine:
    """Sync stub whose fetch returns each row's read_id (a bisected, merged
    result is checkable row for row) and which logs every dispatch width."""

    def __init__(self, fail_fetches=0):
        self.widths: list[int] = []
        self.fail_fetches = fail_fetches

    def dispatch(self, batch):
        self.widths.append(batch.size)
        return batch

    def fetch(self, batch):
        if self.fail_fetches:
            self.fail_fetches -= 1
            raise RuntimeError("transient socket wobble")
        return {"val": batch.read_ids.copy(), "esc_overflow": np.int32(0)}


def _events(ev):
    """The events of a file without their clocks and walls."""
    drop = {"t", "ts", "wall_s", "delay_s", "span", "parent", "waited_s",
            "rtt_s", "inline", "audit_rate", "op_deadline_s", "expected_wall_s"}
    return [{k: v for k, v in json.loads(x).items() if k not in drop}
            for x in open(ev)]


def _run(pkg, tmp_path, name, spec, steps, gov_kw=None, cfg_kw=None, engine_kw=None):
    """Run ``steps`` batches of 8 rows through one package's supervisor (a
    stub engine, no fallback clamp) under ``spec``; (results, engine widths,
    events, counters)."""
    tensorize, faults, governor, supervisor, obs = PACKAGES[pkg]
    eng = WidthLogEngine(**(engine_kw or {}))
    ev = os.path.join(str(tmp_path), f"{pkg}_{name}.events.jsonl")
    args = (eng.dispatch, eng.fetch) if pkg == "port" else (eng.dispatch, eng.fetch, None)
    sup = supervisor.DeviceSupervisor(
        *args,
        fallback_factory=lambda: (lambda b: {"val": b.read_ids.copy(),
                                             "esc_overflow": np.int32(0),
                                             "engine": "fallback"}),
        log=obs.JsonlLogger(ev),
        cfg=supervisor.SupervisorConfig(backoff_base_s=0.01, **(cfg_kw or {})),
        faults=faults.FaultPlan.parse(spec) if spec else None,
        probe_fn=lambda: True, describe="stub",
        governor_cfg=governor.GovernorConfig(**(gov_kw or {})))
    outs = []
    for step in steps:
        if step == "lift":
            sup.faults.oom_max_width = None
            continue
        outs.append(sup.fetch(sup.dispatch(_mini_batch(tensorize, b=step))))
    return outs, eng.widths, _events(ev), dict(sup.counters), sup


SCENARIOS = {
    # a classified OOM bisects, merges, ratchets; later batches go straight
    # to the known-good width
    "bisect": ("device_oom:1", [8, 8], dict(min_width=2), {}),
    # composed specs walk two rungs
    "deep": ("device_oom:1,device_oom:2", [8], dict(min_width=1), {}),
    # probation: a failed restore probe, then a successful one
    "probation": ("device_oom:1", [8, 8, 8, 8, "lift", 8, 8, 8],
                  dict(min_width=2, probation=2), {}),
    # no rung below the floor and no clamp: failover takes the batch
    "exhaust": ("device_oom:1", [8, 8], dict(min_width=8), {}),
    "fetch_hang": ("fetch_hang:1", [8, 8], {}, {}),
    "dispatch_error": ("dispatch_error:2", [8, 8, 8], {}, {}),
    "device_lost": ("device_lost:3", [8, 8, 8], {}, {}),
    "compile_stall": ("compile_stall", [8, 8], {}, {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervisor_scenario_matches_jax(tmp_path, monkeypatch, name):
    """The same results, engine widths, events (clocks aside) and counters
    in both packages."""
    spec, steps, gov_kw, cfg_kw = SCENARIOS[name]
    got = {}
    for pkg in PACKAGES:
        monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / f"cc_{pkg}"))
        got[pkg] = _run(pkg, tmp_path, name, spec, steps, gov_kw, cfg_kw)
    (p_outs, p_w, p_ev, p_c, p_sup), (j_outs, j_w, j_ev, j_c, _) = got["port"], got["jax"]
    for po, jo in zip(p_outs, j_outs):
        np.testing.assert_array_equal(po["val"], jo["val"])
        assert po.get("engine") == jo.get("engine")
    assert p_w == j_w
    # the port's sup_init carries the same fields; the JAX ones it lacks
    # (mesh and trust registry) are absent from both runs' events
    assert p_ev == j_ev
    assert p_c == j_c
    ev = os.path.join(str(tmp_path), f"port_{name}.events.jsonl")
    assert validate_events(ev, strict=True) == []
    assert jax_validate(ev, strict=True) == []
    for o in p_outs:
        np.testing.assert_array_equal(o["val"], np.arange(8))
    if name == "bisect":
        assert p_w == [4, 4, 4, 4]
        assert p_sup.governor.active_state() == {"B8xD2xL8": 4}
        assert not any(e["event"] == "sup_retry" for e in p_ev)
    elif name == "exhaust":
        assert p_outs[0]["engine"] == "fallback" and p_sup.failed_over
        assert "capacity ladder exhausted" in p_sup.fail_reason
    elif name == "device_lost":
        assert p_sup.state == port_supervisor.DEGRADED
        assert p_c["degraded_solves"] == 2


def test_ratchet_persistence_across_supervisors(tmp_path, monkeypatch):
    """The working rung is recorded beside the cold-shape registry: a new
    supervisor dispatches the shape at the known-good width directly."""
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc"))
    _run("port", tmp_path, "persist1", "device_oom:1", [8], dict(min_width=2))
    assert port_governor.load_ratchets() == {"B8xD2xL8": 4}
    outs, widths, ev, _, _ = _run("port", tmp_path, "persist2", None, [8])
    np.testing.assert_array_equal(outs[0]["val"], np.arange(8))
    assert widths == [4, 4]
    assert not any(e["event"] == "governor.classify" for e in ev)
    # the registry lives under DACCORD_COMPCACHE, not in the package
    assert os.path.exists(tmp_path / "cc" / "daccord_capacity.json")


def test_per_class_retry_budget(tmp_path, monkeypatch):
    """A timeout retry does not consume the transient budget: one injected
    hang and one transient error on the same op both recover under
    max_retries=1."""
    got = {}
    for pkg in PACKAGES:
        monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / f"cc_{pkg}"))
        got[pkg] = _run(pkg, tmp_path, "cls", "fetch_hang:1", [4],
                        cfg_kw=dict(max_retries=1), engine_kw=dict(fail_fetches=1))
    outs, _, ev, _, _ = got["port"]
    np.testing.assert_array_equal(outs[0]["val"], np.arange(4))
    assert [e["cls"] for e in ev if e["event"] == "sup_retry"] == ["timeout", "transient"]
    assert ev == got["jax"][2]


def test_watchdog_deadline_and_recovery():
    wd = port_supervisor._Watchdog()
    import time

    with pytest.raises(port_supervisor.WatchdogTimeout):
        wd.run(lambda: time.sleep(1.0), (), 0.05)
    assert wd.run(lambda: 7, (), 1.0) == 7       # a fresh worker took over
    beats = []
    assert wd.run(lambda: time.sleep(0.12) or 3, (), 5.0, slice_s=0.05,
                  on_wait=beats.append) == 3
    assert beats


def test_poisoned_context_is_device_loss(tmp_path, monkeypatch):
    """A CUDA error that poisons the process (a trapped kernel) fails over
    at once: no probe, no retry (a fresh process's probe would find the
    card alive, and every call of this one would fail again)."""
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc"))
    probes = []
    ev = os.path.join(str(tmp_path), "trap.events.jsonl")

    def bad_fetch(batch):
        raise RuntimeError("dp_backtrack launch failed (B=8, M=64, P=41): "
                           "unspecified launch failure (719)")

    sup = port_supervisor.DeviceSupervisor(
        lambda b: b, bad_fetch,
        fallback_factory=lambda: (lambda b: {"val": b.read_ids.copy(),
                                             "engine": "fallback"}),
        log=port_obs.JsonlLogger(ev), cfg=port_supervisor.SupervisorConfig(),
        faults=None, probe_fn=lambda: probes.append(1) or True)
    out = sup.fetch(sup.dispatch(_mini_batch(port_tensorize)))
    assert out["engine"] == "fallback" and sup.failed_over and not probes
    chain = [(e["state_from"], e["state_to"]) for e in _events(ev)
             if e["event"] == "sup_state"]
    assert chain[-3:] == [("HEALTHY", "SUSPECT"), ("SUSPECT", "LOST"),
                          ("LOST", "DEGRADED")]
    assert validate_events(ev, strict=True) == []


@pytest.mark.parametrize("where", ["dispatch", "fetch"])
@pytest.mark.parametrize("exc", [
    KernelError("rescore launch failed (B=8, D=32, L=64, C=3, CL=48): too many "
                "resources requested for launch (701)"),
    KernelError("nvcc failed to build daccord_tpu_torch/csrc/rescore.cu:\nerror"),
    ValueError("rescore: CL=600 outside 1..512"),
    TypeError("rescore: seqs is torch.int32, expected torch.int8")],
    ids=["launch", "build", "arguments", "dtype"])
def test_kernel_errors_raise_without_retry_or_failover(tmp_path, monkeypatch, where, exc):
    """A kernel that fails to build, refuses its arguments or fails to launch
    without poisoning the context fails the same way again: the supervisor
    raises it as it is, with no probe, no retry and no failover, so no run
    finishes with its work moved off the card."""
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc"))
    probes, built = [], []
    ev = os.path.join(str(tmp_path), "kernel.events.jsonl")

    def bad(batch):
        raise exc

    ok = lambda b: b   # noqa: E731
    sup = port_supervisor.DeviceSupervisor(
        bad if where == "dispatch" else ok, bad if where == "fetch" else ok,
        fallback_factory=lambda: built.append(1) or (lambda b: {"engine": "fallback"}),
        log=port_obs.JsonlLogger(ev), cfg=port_supervisor.SupervisorConfig(),
        faults=None, probe_fn=lambda: probes.append(1) or True)
    with pytest.raises(type(exc)) as ei:
        sup.fetch(sup.dispatch(_mini_batch(port_tensorize)))
    assert ei.value is exc
    assert not sup.failed_over and not built and not probes
    assert sup.counters["retries"] == 0
    assert not any(e["event"] in ("sup_failover", "sup_retry") for e in _events(ev))
    assert not port_supervisor.is_device_lost_error(exc)


def test_sticky_error_at_a_launch_is_device_loss():
    """A launch that reports an error of an earlier kernel which poisoned the
    context is device loss, whatever raised it."""
    lost = port_supervisor.is_device_lost_error
    assert lost(KernelError("rescore launch failed (B=8, D=32, L=64, C=3, CL=48): "
                            "unspecified launch failure (719)"))
    assert lost(KernelError("gather_pages launch failed (B=8, PPW=4, PL=16): an "
                            "illegal memory access was encountered (700)"))
    assert not lost(KernelError("position_weights launch failed (B=8, M=64, P=41, "
                                "O=56): invalid argument (1)"))


def test_eventcheck_matches_jax(tmp_path):
    """The port's eventcheck has the JAX schema: the same verdicts on good
    and bad files."""
    good = tmp_path / "good.jsonl"
    bad = tmp_path / "bad.jsonl"
    rec = lambda t, **f: json.dumps({"t": t, "ts": 1e9 + t, **f})  # noqa: E731
    good.write_text("\n".join([
        rec(0.0, event="sup_init", primary="x", op_deadline_s=1.0,
            compile_deadline_s=2.0),
        rec(0.1, event="sup_state", state_from="HEALTHY", state_to="SUSPECT", reason=""),
        rec(0.2, event="sup_state", state_from="SUSPECT", state_to="LOST", reason=""),
        rec(0.3, event="sup_state", state_from="LOST", state_to="DEGRADED", reason="")]) + "\n")
    bad.write_text("\n".join([
        rec(0.5, event="sup_state", state_from="HEALTHY", state_to="DEGRADED", reason=""),
        rec(0.1, event="sup_fault", kind="x", op="fetch"),
        "not json"]) + "\n")
    for path in (good, bad):
        assert validate_events(str(path), strict=True) == jax_validate(str(path), strict=True)
    assert validate_events(str(good), strict=True) == []
    assert len(validate_events(str(bad), strict=True)) == 4
