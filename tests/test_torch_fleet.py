"""The port's shard fleet (``parallel/fleet.py``, the ``fleet`` tool) on the
CPU, against the JAX package's ``run_fleet``.

The fleet-level cases of ``tests/test_fleet.py``, with real worker processes
(``python -m daccord_tpu_torch.tools.cli shard``) on the native engine: the
fault matrix ``worker_crash:1,worker_hang:2,lease_stall:1`` merges byte for
byte the JAX fleet's FASTA under the same faults, with the same ``fleet.*``
event kinds and the same counts of spawns, faults, retries, takeovers and
completions (heartbeats depend on timing and are not compared); a rerun
spawns nothing; a second orchestrator takes a stale lease over; a poison
shard is quarantined while the rest finish; the watchdog is not muted by a
stale manifest; a lost lease demotes the shard; an OOM-killed worker is
requeued once at half its batch. One ``--backend cpu`` fleet is held
against the port's in-turn ``run_shard`` runs. ``--backend auto`` without a
card raises, in the resolver and in the tool.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from daccord_tpu.parallel.fleet import FleetConfig as JaxFleetConfig
from daccord_tpu.parallel.fleet import flag_stragglers as jax_flag_stragglers
from daccord_tpu.parallel.fleet import run_fleet as jax_run_fleet
from daccord_tpu.parallel.launch import merge_shards as jax_merge_shards
from daccord_tpu.runtime.faults import FaultPlan as JaxFaultPlan
from daccord_tpu.sim import SimConfig, make_dataset
from daccord_tpu_torch.parallel import fleet as fleet_mod
from daccord_tpu_torch.parallel.fleet import FleetConfig, flag_stragglers, run_fleet
from daccord_tpu_torch.parallel.launch import (MergeGateError, merge_shards,
                                               run_shard, shard_paths)
from daccord_tpu_torch.runtime.faults import FaultPlan
from daccord_tpu_torch.runtime.pipeline import PipelineConfig

MATRIX = "worker_crash:1,worker_hang:2,lease_stall:1"
COUNTED = ("fleet.spawn", "fleet.fault", "fleet.retry", "fleet.takeover",
           "fleet.done")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """A cold-shape registry of the test's own, no inherited fault plan, and
    two torch threads."""
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc"))
    monkeypatch.delenv("DACCORD_FAULT", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fleetdata"))
    return make_dataset(d, SimConfig(genome_len=1200, coverage=10,
                                     read_len_mean=400, min_overlap=150,
                                     seed=7), name="fl")


def _cfg(outdir, cls=FleetConfig, nshards=4, **kw):
    kw.setdefault("workers", 2)
    kw.setdefault("backend", "native")
    kw.setdefault("checkpoint_every", 2)
    kw.setdefault("backoff_base_s", 0.05)
    kw.setdefault("backoff_cap_s", 0.5)
    kw.setdefault("speculate_min_runtime_s", 300.0)  # never in these tests
    return cls(nshards=nshards,
               events_path=os.path.join(str(outdir), "fleet.events.jsonl"), **kw)


def _events(cfg):
    with open(cfg.events_path) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


def _lint(path):
    from daccord_tpu_torch.tools.eventcheck import validate_events

    assert validate_events(path, strict=True) == []


def _counts(evs):
    return {k: sum(e["event"] == k for e in evs) for k in COUNTED}


@pytest.fixture(scope="module")
def jax_matrix(dataset, tmp_path_factory):
    """The JAX fleet under the fault matrix: its outdir, merged bytes, event
    kinds and counts."""
    root = tmp_path_factory.mktemp("jaxfleet")
    d = str(root / "faulted")
    cfg = _cfg(d, JaxFleetConfig, stall_timeout_s=10.0, max_attempts=6)
    m = jax_run_fleet(dataset["db"], dataset["las"], d, cfg,
                      faults=JaxFaultPlan.parse(MATRIX))
    assert m["done"] == [0, 1, 2, 3] and not m["poison"], m
    out = str(root / "merged.fasta")
    jax_merge_shards(d, 4, out)
    evs = _events(cfg)
    return {"dir": d, "fasta": open(out, "rb").read(),
            "kinds": {e["event"] for e in evs if e["event"].startswith("fleet.")
                      and e["event"] != "fleet.heartbeat"},
            "faults": sorted(e["kind"] for e in evs if e["event"] == "fleet.fault"),
            "counts": _counts(evs)}


@pytest.fixture(scope="module")
def jax_two(dataset, tmp_path_factory):
    """The JAX package's two shards on its native engine with its shard
    tool's defaults (in this process): the merged bytes a two-shard fleet
    writes."""
    from daccord_tpu.parallel.launch import run_shard as jax_run_shard
    from daccord_tpu.runtime import PipelineConfig as JaxPipelineConfig

    root = tmp_path_factory.mktemp("jaxtwo")
    d = str(root / "shards")
    for s in (0, 1):
        jax_run_shard(dataset["db"], dataset["las"], d, s, 2,
                      JaxPipelineConfig(native_solver=True, batch_size=4096))
    out = str(root / "merged.fasta")
    jax_merge_shards(d, 2, out)
    return open(out, "rb").read()


def _merged(d, n, tmp_path, name="merged.fasta", **kw):
    out = str(tmp_path / name)
    merge_shards(d, n, out, **kw)
    return open(out, "rb").read()


def test_fleet_fault_matrix_equals_the_jax_fleet(dataset, jax_matrix, tmp_path):
    """Crash, hang and lease stall in one unattended run: every shard done,
    the merged FASTA the JAX fleet's byte for byte, the same event kinds and
    counts, and a clean strict lint."""
    d = str(tmp_path / "faulted")
    cfg = _cfg(d, stall_timeout_s=10.0, max_attempts=6)
    m = run_fleet(dataset["db"], dataset["las"], d, cfg, faults=FaultPlan.parse(MATRIX))
    assert m["done"] == [0, 1, 2, 3] and not m["poison"], m
    assert _merged(d, 4, tmp_path) == jax_matrix["fasta"]
    _lint(cfg.events_path)
    evs = _events(cfg)
    kinds = {e["event"] for e in evs if e["event"].startswith("fleet.")
             and e["event"] != "fleet.heartbeat"}
    assert kinds == jax_matrix["kinds"]
    assert sorted(e["kind"] for e in evs if e["event"] == "fleet.fault") == \
        jax_matrix["faults"] == sorted(MATRIX.replace(":1", "").replace(":2", "")
                                       .split(","))
    assert _counts(evs) == jax_matrix["counts"]
    assert {e["reason"] for e in evs if e["event"] == "fleet.retry"} >= {"hang"}
    assert any(e["event"] == "fleet.heartbeat" for e in evs)
    # every worker was given the engine, its device and its batch
    spawned = [e for e in evs if e["event"] == "fleet.spawn"]
    assert spawned and json.load(open(os.path.join(d, "fleet.json")))["done"] == m["done"]


def test_fleet_idempotent_rerun(dataset, jax_two, tmp_path):
    """A rerun of a finished fleet spawns no worker; the merged FASTA of two
    shards is the JAX fleet's."""
    d = str(tmp_path / "once")
    m = run_fleet(dataset["db"], dataset["las"], d, _cfg(d, nshards=2), faults=None)
    assert m["done"] == [0, 1]
    cfg2 = _cfg(d, nshards=2)
    cfg2.events_path = os.path.join(d, "rerun.events.jsonl")
    m2 = run_fleet(dataset["db"], dataset["las"], d, cfg2, faults=None)
    assert m2["done"] == [0, 1] and all(a == 0 for a in m2["attempts"].values())
    assert not any(e["event"] == "fleet.spawn" for e in _events(cfg2))
    assert _merged(d, 2, tmp_path) == jax_two


def test_lease_takeover_by_second_orchestrator(dataset, jax_two, tmp_path):
    """Orchestrator A (a second OS process) claims shard 0 and dies without
    heartbeating; orchestrator B takes the stale lease over and finishes."""
    d = str(tmp_path / "shards")
    os.makedirs(d)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    wedged = f"""
import sys
sys.path.insert(0, {root!r})
from daccord_tpu_torch.parallel import fleet
ok, _ = fleet.claim_lease({d!r}, 0, "orchA", ttl_s=60.0)
assert ok
fleet.backdate_lease({d!r}, 0, age_s=120.0)
"""
    subprocess.run([sys.executable, "-c", wedged], check=True)
    assert os.path.exists(fleet_mod.lease_path(d, 0))
    cfg = _cfg(d, nshards=2, host="orchB", lease_ttl_s=60.0)
    m = run_fleet(dataset["db"], dataset["las"], d, cfg, faults=None)
    assert m["done"] == [0, 1]
    takeovers = [e for e in _events(cfg) if e["event"] == "fleet.takeover"]
    assert takeovers and takeovers[0]["prev_host"] == "orchA"
    assert takeovers[0]["shard"] == 0
    _lint(cfg.events_path)
    assert _merged(d, 2, tmp_path) == jax_two


def test_poison_shard_quarantined_fleet_continues(dataset, jax_matrix, tmp_path):
    """A shard whose input kills every worker (a corrupt LAS under strict
    ingest) is poison after two failures, with the ingest report in its
    stderr tail; the other shards write the JAX fleet's shard bytes, and the
    merge gate refuses the hole unless degraded is allowed."""
    from daccord_tpu.formats.las import shard_ranges
    from daccord_tpu.runtime.faults import (_las_record_offsets, _read_all,
                                            corrupt_las_bitflip)

    las = str(tmp_path / "poison.las")
    shutil.copy(dataset["las"], las)
    offs = _las_record_offsets(_read_all(las))
    start, end = shard_ranges(las, 4)[2]
    rec = next(i for i, o in enumerate(offs, start=1) if start <= o < end)
    corrupt_las_bitflip(las, rec)

    d = str(tmp_path / "shards")
    cfg = _cfg(d, poison_after=2, ingest_policy="strict")
    m = run_fleet(dataset["db"], las, d, cfg, faults=None)
    assert m["done"] == [0, 1, 3]
    assert [p["shard"] for p in m["poison"]] == [2]
    p = m["poison"][0]
    assert p["attempts"] == 2 and "consecutive" in p["reason"]
    assert "bad_coords" in p["stderr_tail"]
    assert [q["shard"] for q in json.load(open(os.path.join(d, "fleet.json")))["poison"]] == [2]
    _lint(cfg.events_path)
    assert any(e["event"] == "fleet.poison" for e in _events(cfg))
    for s in (0, 1, 3):
        assert open(shard_paths(d, s)["fasta"], "rb").read() == \
            open(shard_paths(jax_matrix["dir"], s)["fasta"], "rb").read()
    out = str(tmp_path / "merged.fasta")
    with pytest.raises(MergeGateError, match="missing shard output"):
        merge_shards(d, 4, out)
    assert not os.path.exists(out)
    merge_shards(d, 4, out, allow_degraded=True)
    assert open(out).read() == "".join(open(shard_paths(d, s)["fasta"]).read()
                                       for s in (0, 1, 3))


def test_oom_killed_worker_requeued_once_at_half_its_batch(dataset, jax_two, tmp_path):
    """``worker_oom:1``: the first worker exits 137 with no watchdog kill of
    the fleet's own; its shard is requeued once at half the native engine's
    auto batch (``fleet.capacity``, a ``capacity`` retry with no poison
    credit), the merged FASTA unchanged."""
    from daccord_tpu_torch.utils.obs import auto_batch_size

    d = str(tmp_path / "oom")
    cfg = _cfg(d, nshards=2)
    m = run_fleet(dataset["db"], dataset["las"], d, cfg,
                  faults=FaultPlan.parse("worker_oom:1"))
    assert m["done"] == [0, 1] and m["capacity_requeued"] == [0]
    evs = _events(cfg)
    cap = [e for e in evs if e["event"] == "fleet.capacity"]
    assert cap == [{**cap[0], "shard": 0, "batch": auto_batch_size("native") // 2}]
    assert [e["reason"] for e in evs if e["event"] == "fleet.retry"] == ["capacity"]
    _lint(cfg.events_path)
    assert _merged(d, 2, tmp_path) == jax_two


def test_cpu_backend_fleet_equals_in_turn_shards(tmp_path, monkeypatch):
    """A ``--backend cpu`` fleet (the port's CPU ladder in every worker,
    ``--device cpu`` by request) merges the bytes of the same shards run in
    turn in this process with ``run_shard``."""
    small = make_dataset(str(tmp_path / "data"), SimConfig(
        genome_len=700, coverage=8, read_len_mean=350, min_overlap=150, seed=7),
        name="cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")      # the workers' torch pools
    d = str(tmp_path / "fleet")
    cfg = _cfg(d, nshards=2, backend="cpu", batch=64)
    m = run_fleet(small["db"], small["las"], d, cfg, faults=None)
    assert m["done"] == [0, 1]
    ref = str(tmp_path / "turns")
    pcfg = PipelineConfig(device="cpu", batch_size=64)
    for s in (0, 1):
        run_shard(small["db"], small["las"], ref, s, 2, pcfg)
    assert _merged(d, 2, tmp_path, "fleet.fasta") == _merged(ref, 2, tmp_path, "turns.fasta")


# ---------------------------------------------------------------------------
# supervision-loop units (stub workers, no subprocesses)
# ---------------------------------------------------------------------------

class _StubProc:
    def __init__(self):
        self.killed = False

    def poll(self):
        return -9 if self.killed else None

    def kill(self):
        self.killed = True


def _stub_fleet(dataset, outdir, **kw):
    cfg = _cfg(outdir, nshards=1, **kw)
    cfg.events_path = None
    return fleet_mod.Fleet(dataset["db"], dataset["las"], str(outdir), cfg)


def test_watchdog_not_muted_by_stale_manifest(dataset, tmp_path):
    """A manifest predating the attempt (the stale artefact it exists to
    recompute) does not mute hang detection; one committed during the
    attempt does."""
    f = _stub_fleet(dataset, tmp_path, stall_timeout_s=5.0)
    st = f.shards[0]
    st.status, st.proc, st.spawn_t = "running", _StubProc(), time.time() - 60
    mpath = shard_paths(str(tmp_path), 0)["manifest"]
    json.dump({"shard": 0}, open(mpath, "wt"))
    old = st.spawn_t - 100
    os.utime(mpath, (old, old))
    f._watchdog(time.time())
    assert st.proc.killed and st.kill_reason == "hang"
    proc2 = _StubProc()
    st.proc, st.kill_reason, st.spawn_t = proc2, None, time.time() - 60
    os.utime(mpath, None)
    f._watchdog(time.time())
    assert not proc2.killed


def test_heartbeat_detects_ownership_loss(dataset, tmp_path):
    """A shard another orchestrator took over: the heartbeat kills our
    worker and demotes the shard to foreign instead of renewing the taker's
    lease, which survives our exit paths."""
    f = _stub_fleet(dataset, tmp_path)
    st = f.shards[0]
    st.status, st.proc, st.last_beat = "running", _StubProc(), 0.0
    ok, _ = fleet_mod.claim_lease(str(tmp_path), 0, "taker-host", ttl_s=60.0)
    assert ok
    f._heartbeat(time.time())
    assert st.proc.killed and st.kill_reason == "ownership_lost"
    f._reap()
    assert st.status == "foreign"
    fleet_mod.release_lease(str(tmp_path), 0, host=f.host)
    assert fleet_mod.read_lease(str(tmp_path), 0)["host"] == "taker-host"


@pytest.mark.parametrize("case", [
    ({}, 4.0), ({0: 1.0}, 4.0), ({0: 1.0, 1: 0.9, 2: 0.1}, 4.0),
    ({0: 1.0, 1: 0.9, 2: 0.5}, 4.0), ({0: 0.0, 1: 0.0}, 4.0),
    ({0: 1.0, 1: 0.0}, 0.0), ({0: 3.0, 1: 2.0, 2: 0.4, 3: 0.2}, 4.0),
    ({0: 1.0, 1: 1.0, 2: 1.0, 3: 0.249}, 4.0)])
def test_flag_stragglers_equals_the_jax_policy(case):
    thr, factor = case
    assert flag_stragglers(thr, factor) == jax_flag_stragglers(thr, factor)


def test_auto_backend_raises_without_a_card_and_never_falls_back(dataset, tmp_path, monkeypatch):
    """``--backend auto``: the card when the probe sees one; with no card
    and no ``--device cpu`` an error, in the resolver, the fleet and the
    tool (the JAX resolver falls back quietly to its host engines); with
    ``--device cpu`` the JAX rule, the native engine."""
    from daccord_tpu_torch.tools import cli
    from daccord_tpu_torch.utils import obs

    if torch.cuda.is_available():
        pytest.skip("a card is present: auto runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        obs.resolve_auto_backend()
    assert obs.probe_backend_status() == (0, "no_devices")
    # the fleet resolves once, from the same probe (not run again here)
    monkeypatch.setattr(obs, "probe_backend_status", lambda timeout_s=None: (0, "no_devices"))
    d = str(tmp_path / "auto")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet_mod.Fleet(dataset["db"], dataset["las"], d, _cfg(d, backend="auto"))
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(["fleet", dataset["db"], dataset["las"], d, "-n", "2"])
    assert not os.path.exists(d)     # refused before any lease or worker
    f = fleet_mod.Fleet(dataset["db"], dataset["las"], d,
                        _cfg(d, backend="auto", device="cpu"))
    assert (f.backend, f.device) == ("native", "cpu")
    argv = f._worker_argv(0)
    assert argv[argv.index("--backend") + 1] == "native"
    assert argv[argv.index("--device") + 1] == "cpu"
    assert argv[argv.index("-b") + 1] == "4096"
    monkeypatch.setattr(obs, "probe_backend_status", lambda timeout_s=None: (1, "ok"))
    f = fleet_mod.Fleet(dataset["db"], dataset["las"], d, _cfg(d, backend="auto"))
    assert (f.backend, f.device, f._worker_batch()) == ("cuda", "cuda", 2048)
    with pytest.raises(SystemExit, match="Queue 1 item 5"):
        cli.main(["fleet", dataset["db"], dataset["las"], d, "-n", "2",
                  "--backend", "native", "--mesh", "2"])
    with pytest.raises(SystemExit, match="contradicts"):
        cli.main(["fleet", dataset["db"], dataset["las"], d, "-n", "2",
                  "--backend", "native", "--device", "cuda"])
