"""The port's device mesh (``parallel/mesh.py``) and its wiring, in units on
the CPU, against the JAX package where both have the piece.

The units of ``tests/test_mesh.py`` (the escalation cap, shrink and restore,
the ``:m<N>`` shape keys, the governor's mesh quantum, the auto batch, the
fleet's argv, the solve fingerprint, the staged dispatch), the fake-mesh
units of ``tests/test_sdc.py`` (the member-aware audit sample, the trust
ratchet and its registry), the ledger's mesh column
(``tests/test_observability.py``), and the mesh cases of
``tests/test_parallel.py``: a sharded batch equals the single-device ladder
and the JAX package's, an injected mesh solver writes the single run's
FASTA, and ``init_distributed`` forms a gloo group over two processes whose
shards merge into the single process's FASTA. The CLI's ``--mesh`` rules,
the serve group's mesh build and a crashed mesh shard's resume close it.
The corpus runs at mesh 8 are in ``test_torch_mesh_parity.py`` and
``test_torch_mesh_faults.py``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch
from daccord_tpu_torch.kernels.window_kernel import KernelParams
from daccord_tpu_torch.parallel import mesh as meshmod
from daccord_tpu_torch.parallel.mesh import ShardedLadderSolver, make_mesh
from daccord_tpu_torch.runtime.faults import FaultPlan
from daccord_tpu_torch.runtime.supervisor import DeviceSupervisor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """Registries of the test's own, no inherited fault plan, two torch
    threads."""
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc"))
    monkeypatch.delenv("DACCORD_FAULT", raising=False)
    monkeypatch.delenv("DACCORD_TRUST_PROBATION", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _stub_ladder():
    p = KernelParams(k=8, min_count=2, edge_min_count=2, wlen=40)
    return SimpleNamespace(params=[p], tables={p.k: None}, wide_p0=None)


def _cpu_mesh(n=8):
    return make_mesh(n, platform="cpu")


def _unit_batch(n):
    return WindowBatch(seqs=np.zeros((n, 4, 8), np.int8), lens=np.ones((n, 4), np.int32),
                       nsegs=np.ones(n, np.int32), shape=BatchShape(4, 8, 40),
                       read_ids=np.arange(n, dtype=np.int64), wstarts=np.zeros(n, np.int64))


# ---------------------------------------------------------------------------
# the solver's units (tests/test_mesh.py)
# ---------------------------------------------------------------------------


def test_esc_cap_fixed_at_construction():
    """The auto cap resolves once from the configured batch, as the JAX
    solver's: narrower batches keep it, a wider one never overflows, an
    explicit cap wins."""
    from daccord_tpu.parallel.mesh import ShardedLadderSolver as JaxSolver
    from daccord_tpu.parallel.mesh import make_mesh as jax_make_mesh

    s = ShardedLadderSolver(_stub_ladder(), _cpu_mesh(8), batch=512)
    j = JaxSolver(_stub_ladder(), jax_make_mesh(8), batch=512)
    for w in (512, 256, 64, 1024):
        assert s._esc_cap_for(w) == j._esc_cap_for(w)
    assert [s._esc_cap_for(w) for w in (512, 256, 64, 1024)] == [64, 64, 64, 128]
    s2 = ShardedLadderSolver(_stub_ladder(), _cpu_mesh(8), esc_cap=32, batch=512)
    assert s2._esc_cap_for(512) == 32


def test_shrink_restore_and_cap_follow():
    s = ShardedLadderSolver(_stub_ladder(), _cpu_mesh(8), batch=512)
    assert s._esc_cap_for(512) == 64
    assert s.shrink() and s.nd == 4 and s.member_ids() == [0, 1, 2, 3]
    assert s._esc_cap_for(512) == 128
    assert s.shrink() and s.nd == 2
    assert s.shrink() and s.nd == 1
    assert not s.shrink()
    assert [r["state"] for r in s.device_stats.values()] == ["ok"] + ["dropped"] * 7
    s.restore()
    assert s.nd == 8 and s._esc_cap_for(512) == 64 and s.host_local
    assert all(r["state"] == "ok" for r in s.device_stats.values())
    # an attributed culprit in the first half keeps the second
    assert s.shrink(culprit=2) and s.member_ids() == [4, 5, 6, 7]
    assert s.device_stats[2]["state"] == "lost" and s.device_stats[0]["state"] == "dropped"
    assert s.describe() == "mesh4-cpu-ladder"


def test_shape_key_mesh_suffix():
    solver = ShardedLadderSolver(_stub_ladder(), _cpu_mesh(8), batch=64)
    sup = DeviceSupervisor(lambda b: b, lambda h: h, inline=True,
                           fingerprint_prefix="cpu:", mesh=solver)
    b = _unit_batch(64)
    assert sup._shape_key(b) == "cpu:B64xD4xL8:m8"
    assert sup._shape_key(dataclasses.replace(b, stream="tier0")) == "cpu:B64xD4xL8:t0:m8"
    solver.shrink()
    assert sup._shape_key(b) == "cpu:B64xD4xL8:m4"
    sup1 = DeviceSupervisor(lambda b: b, lambda h: h, inline=True, fingerprint_prefix="cpu:")
    assert sup1._shape_key(b) == "cpu:B64xD4xL8"


def test_governor_quantum_widths():
    """The supervisor's governor bisects a mesh batch in mesh multiples."""
    from daccord_tpu_torch.runtime.governor import CapacityError, GovernorConfig

    widths = []

    def solve(b):
        widths.append(b.size)
        if b.size > 16:
            raise CapacityError("out of memory: too wide", width=b.size)
        return {"cons": np.zeros((b.size, 4), np.int8), "cons_len": np.zeros(b.size, np.int32),
                "err": np.zeros(b.size, np.float32), "solved": np.ones(b.size, bool),
                "tier": np.zeros(b.size, np.int32), "m_ovf": np.zeros(b.size, bool),
                "esc_overflow": 0}

    from daccord_tpu_torch.runtime.governor import CapacityGovernor

    gov = CapacityGovernor(solve, cfg=GovernorConfig(min_width=1, persist=False),
                           quantum_fn=lambda: 8)
    out = gov.solve(_unit_batch(128), "cpu:B128xD4xL8:m8", reason="injected")
    assert len(out["solved"]) == 128
    assert widths and all(w % 8 == 0 for w in widths), widths
    assert gov.ratchet["cpu:B128xD4xL8:m8"] == 16
    # a mesh supervisor's governor takes the mesh's current width
    solver = ShardedLadderSolver(_stub_ladder(), _cpu_mesh(8), batch=128)
    sup = DeviceSupervisor(lambda b: b, lambda h: h, inline=True, mesh=solver)
    assert sup.governor._quantum_fn() == 8
    solver.shrink()
    assert sup.governor._quantum_fn() == 4


def test_auto_batch_scales_by_mesh():
    from daccord_tpu_torch.utils.obs import auto_batch_size

    assert auto_batch_size("cuda") == 2048
    assert auto_batch_size("cuda", mesh=8) == 16384
    assert auto_batch_size("cpu", mesh=4) == 2048
    assert auto_batch_size("native", mesh=8) == 4096


def test_fleet_worker_argv_forwards_mesh(tmp_path):
    from daccord_tpu_torch.parallel.fleet import Fleet, FleetConfig

    f = Fleet("db", "las", str(tmp_path), FleetConfig(nshards=2, backend="cpu", mesh=8))
    argv = f._worker_argv(0)
    assert argv[argv.index("--mesh") + 1] == "8"
    assert f._worker_batch() == 512 * 8
    assert "-b" in argv and argv[argv.index("-b") + 1] == str(512 * 8)
    f1 = Fleet("db", "las", str(tmp_path), FleetConfig(nshards=2, backend="cpu"))
    assert "--mesh" not in f1._worker_argv(0)
    # auto on the CPU: a mesh's members run the ladder, never the native engine
    fa = Fleet("db", "las", str(tmp_path),
               FleetConfig(nshards=2, backend="auto", device="cpu", mesh=2))
    assert fa.backend == "cpu"
    with pytest.raises(ValueError, match="--mesh"):
        Fleet("db", "las", str(tmp_path), FleetConfig(nshards=2, backend="native", mesh=2))


def test_solve_fingerprint_includes_mesh():
    from daccord_tpu_torch.oracle.profile import ErrorProfile
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig
    from daccord_tpu_torch.serve.jobs import solve_fingerprint

    prof, cfg = ErrorProfile(0.05, 0.05, 0.02), PipelineConfig()
    base = solve_fingerprint(prof, cfg, "cpu")
    assert solve_fingerprint(prof, cfg, "cpu", mesh=0) == base
    assert solve_fingerprint(prof, cfg, "cpu", mesh=8) != base
    assert solve_fingerprint(prof, cfg, "cpu", mesh=8) != solve_fingerprint(prof, cfg, "cpu",
                                                                            mesh=4)


def test_stage_launch_split_units(request):
    """``stage`` pads to a mesh multiple and keeps the host batch; a batch
    staged before a shrink is staged again at launch (``restaged``);
    staging under a call in flight books as overlapped."""
    s = ShardedLadderSolver(_stub_ladder(), _cpu_mesh(8), batch=64)
    request.addfinalizer(s.close)    # its dispatcher thread ends with the test
    b = _unit_batch(60)
    st = s.stage(b)
    assert isinstance(st, meshmod.StagedBatch)
    assert st.size == 60 and st.target == 64 and st.stream == "full" and st.nd == 8
    assert st.replay_batch is b and s.stage(st) is st
    assert [p[0].size for p in st.parts] == [8] * 8
    dw = s.dispatch_walls()
    assert set(dw) == {"pack_s", "stage_s", "launch_s", "dispatch_s", "restaged"}
    assert dw["restaged"] == 0
    assert dw["dispatch_s"] == dw["pack_s"] + dw["stage_s"] + dw["launch_s"]
    calls = []
    s._submit = lambda m, sub, ins, ev, tier0: calls.append((m, sub.size)) or m
    assert s.shrink() and s.nd == 4
    h = s.launch(st)
    assert h.B0 == 60 and s.dispatch_walls()["restaged"] == 1
    assert calls == [(0, 15), (1, 15), (2, 15), (3, 15)]      # 60 rows divide by 4
    s.stage(_unit_batch(64))        # one call outstanding: overlapped
    hm = s.health_map()
    assert all(0.0 < r["overlap_frac"] <= 1.0 for r in hm["devices"].values())
    assert hm["nd"] == 4 and hm["nd0"] == 8


def test_supervisor_retains_host_batch_for_staged():
    solver = ShardedLadderSolver(_stub_ladder(), _cpu_mesh(8), batch=64)
    seen = []
    sup = DeviceSupervisor(lambda b: seen.append(type(b).__name__) or b, lambda h: h,
                           inline=True, fingerprint_prefix="cpu:", mesh=solver)
    b = _unit_batch(64)
    h = sup.dispatch(solver.stage(b))
    assert seen == ["StagedBatch"] and h.batch is b and h.key == "cpu:B64xD4xL8:m8"


def test_check_mesh_devices_names_the_visible_cards(monkeypatch):
    monkeypatch.setattr(meshmod, "visible_devices", lambda: [torch.device("cuda", 0)])
    with pytest.raises(SystemExit, match=r"mesh 2: only 1 cuda device visible \(cuda:0"):
        meshmod.check_mesh_devices(2)
    meshmod.check_mesh_devices(1)
    meshmod.check_mesh_devices(8, "cpu")        # a CPU mesh: no count
    # two members on one card, as a one-card host lists them
    monkeypatch.setattr(meshmod, "visible_devices", lambda: [torch.device("cuda", 0)] * 2)
    meshmod.check_mesh_devices(2)
    assert make_mesh(2) == (torch.device("cuda", 0),) * 2


# ---------------------------------------------------------------------------
# the fake-mesh units of tests/test_sdc.py
# ---------------------------------------------------------------------------


class _CapLog:
    def __init__(self):
        self.records = []
        self._fh = None

    def log(self, event, **kw):
        self.records.append({"event": event, **kw})

    def of(self, kind):
        return [r for r in self.records if r["event"] == kind]

    def close(self):
        pass


class _FakeMesh:
    def __init__(self, nd=8):
        self.nd = nd
        self._members = list(range(nd))
        self.device_stats = {}
        self.shrunk = []

    def member_ids(self):
        return list(self._members)

    def shrink(self, culprit=-1):
        if self.nd <= 1:
            return False
        self.shrunk.append(culprit)
        self._members = [m for m in self._members if m != culprit]
        self.nd = len(self._members)
        return True


def _sup(log=None, mesh=None, rate=1.0 / 64.0):
    return DeviceSupervisor(lambda b: b, lambda h: h, inline=True, log=log or _CapLog(),
                            faults=FaultPlan.parse(""), mesh=mesh,
                            audit_ref_factory=lambda: None, audit_rate=rate)


def test_sdc_corrupts_only_the_pinned_members_rows():
    sup = _sup(mesh=_FakeMesh(4))
    out = {"cons": np.zeros((8, 3), np.int8), "cons_len": np.full(8, 3, np.int32),
           "solved": np.ones(8, bool)}
    sup._sdc_corrupt(out, 2)
    assert [bool(out["cons"][i].any()) for i in range(8)] == [False] * 4 + [True] * 2 + [False] * 2
    sup._mesh._members = [0, 1, 3]            # member 2 shrunk out: nothing
    before = out["cons"].copy()
    sup._sdc_corrupt(out, 2)
    np.testing.assert_array_equal(out["cons"], before)


def test_audit_sample_covers_every_member_when_budget_allows():
    sup = _sup(mesh=_FakeMesh(8), rate=1.0 / 64.0)
    rows = sup._audit_sample(512)
    assert len(rows) == 8 and {r // 64 for r in rows} == set(range(8))
    assert rows == sup._audit_sample(512)


def test_audit_sample_rotates_member_slices_under_budget():
    sup = _sup(mesh=_FakeMesh(8), rate=1.0 / 64.0)
    hit = set()
    for _ in range(8):
        rows = sup._audit_sample(64)
        assert len(rows) == 1
        hit.add(rows[0] // 8)
        sup._n_audit += 1
    assert hit == set(range(8))


def test_trust_ratchet_strikes_to_quarantine_and_persists(monkeypatch):
    from daccord_tpu_torch.utils.obs import trust_registry

    monkeypatch.setenv("DACCORD_TRUST_STRIKES", "2")
    log = _CapLog()
    sup = _sup(log=log)
    for _ in range(3):
        sup._trust_strike(3, "unit")
    assert [(r["state_from"], r["state_to"]) for r in log.of("trust.state")] == [
        ("TRUSTED", "SUSPECT"), ("SUSPECT", "QUARANTINED"), ("QUARANTINED", "QUARANTINED")]
    reg = trust_registry()
    assert reg["m3"]["state"] == "QUARANTINED" and reg["m3"]["strikes"] == 3


def test_trust_registry_load_shrinks_quarantined_member():
    from daccord_tpu_torch.utils.obs import TRUST_QUARANTINED, record_trust

    record_trust("m5", TRUST_QUARANTINED, 2)
    log, mesh = _CapLog(), _FakeMesh(8)
    _sup(log=log, mesh=mesh)
    assert 5 not in mesh.member_ids() and mesh.shrunk == [5]
    assert log.of("trust.load")[0] == {"event": "trust.load", "device": 5,
                                       "state": "QUARANTINED", "strikes": 2}
    shr = log.of("mesh.shrink")
    assert shr and shr[0]["culprit"] == 5 and shr[0]["reason"] == "trust quarantined (registry)"


def test_trust_probation_demotes_to_suspect(monkeypatch):
    from daccord_tpu_torch.utils.obs import TRUST_QUARANTINED, record_trust, trust_registry

    record_trust("m5", TRUST_QUARANTINED, 2)
    monkeypatch.setenv("DACCORD_TRUST_PROBATION", "1")
    log, mesh = _CapLog(), _FakeMesh(8)
    _sup(log=log, mesh=mesh)
    assert 5 in mesh.member_ids() and mesh.shrunk == []
    d = log.of("trust.state")
    assert d and d[0]["state_from"] == "QUARANTINED" and d[0]["state_to"] == "SUSPECT" \
        and d[0]["strikes"] == 1
    assert trust_registry()["m5"]["state"] == "SUSPECT"


def test_ledger_mesh_column_and_byte_stability(tmp_path):
    from daccord_tpu_torch.utils.obs import WindowLedger

    p0, p1 = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    led = WindowLedger(p0)
    led.record(1, 2, 40, 10, 0, 8, True, "full", rescued=False, wall_s=0.5)
    led.close()
    row = json.loads(open(p0).read())
    assert "mesh" not in row and "job" not in row
    led = WindowLedger(p1)
    led.record(1, 2, 40, 10, 0, 8, True, "full", rescued=False, wall_s=0.5, job="jobA", mesh=8)
    led.close()
    row = json.loads(open(p1).read())
    assert row["mesh"] == 8 and row["job"] == "jobA"


# ---------------------------------------------------------------------------
# tests/test_parallel.py's mesh cases, on a small set
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A small dataset, its profile, a port ladder and the JAX ladder built
    from the same tables, one real batch of windows, and the single-device
    run's FASTA (two torch threads, as every run of the file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        return _small(str(tmp_path_factory.mktemp("meshsmall")))
    finally:
        torch.set_num_threads(n)


def _small(root):
    from daccord_tpu.kernels.tiers import TierLadder as JaxLadder
    from daccord_tpu.oracle.consensus import ConsensusConfig as JaxCC
    from daccord_tpu.oracle.profile import ErrorProfile as JaxProfile
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.kernels.tiers import TierLadder
    from daccord_tpu_torch.runtime.pipeline import (PipelineConfig,
                                                    estimate_profile_for_shard,
                                                    iter_pile_blocks)
    from daccord_tpu_torch.sim import SimConfig, make_dataset

    d = make_dataset(root, SimConfig(genome_len=600, coverage=12, read_len_mean=400,
                                     min_overlap=150, seed=31), name="s")
    db, las = read_db(d["db"]), LasFile(d["las"])
    cfg = PipelineConfig(device="cpu", batch_size=32)
    prof = estimate_profile_for_shard(db, las, cfg)
    prof.save(os.path.join(root, "eprof.json"))
    jl = JaxLadder.from_config(JaxProfile.load(os.path.join(root, "eprof.json")), JaxCC())
    ladder = TierLadder.from_numpy({k: np.asarray(t) for k, t in jl.tables.items()},
                                   [dataclasses.asdict(p) for p in jl.params], device="cpu")
    blocks = [(s[n >= 3], ln[n >= 3], n[n >= 3]) for _, _, s, ln, n in
              iter_pile_blocks(db, las, cfg)]
    seqs, lens, nsegs = (np.concatenate([b[i] for b in blocks])[:77] for i in range(3))
    batch = WindowBatch(seqs=seqs, lens=lens, nsegs=nsegs,
                        shape=BatchShape(depth=seqs.shape[1], seg_len=seqs.shape[2], wlen=40),
                        read_ids=np.arange(len(nsegs), dtype=np.int64),
                        wstarts=np.zeros(len(nsegs), np.int64))
    # the single-device run's FASTA, the reference of the runs below (the
    # batching never changes a byte)
    from daccord_tpu_torch.runtime.pipeline import correct_to_fasta

    single = os.path.join(root, "single.fasta")
    correct_to_fasta(d["db"], d["las"], single, cfg, profile=prof)
    return dict(d=d, db=db, las=las, cfg=cfg, prof=prof, jl=jl, ladder=ladder, batch=batch,
                single=open(single).read())


def test_sharded_matches_single_device_and_jax(small):
    """A real batch sharded over 8 CPU members: the single-device ladder's
    rows, and the JAX mesh solver's on the same tables."""
    from daccord_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from daccord_tpu.parallel.mesh import make_sharded_solver as jax_make_sharded
    from daccord_tpu_torch.kernels.tiers import solve_ladder
    from daccord_tpu_torch.parallel.mesh import make_sharded_solver

    ladder, batch = small["ladder"], small["batch"]
    solver = make_sharded_solver(ladder, _cpu_mesh(8))
    try:
        out = solver(batch)
    finally:
        solver.close()
    ref = solve_ladder(batch, ladder)
    jax_out = jax_make_sharded(small["jl"], jax_make_mesh(8))(batch)
    assert out["solved"].shape == (batch.size,)      # 77 rows: not a mesh multiple
    for other in (ref, jax_out):
        np.testing.assert_array_equal(out["solved"], np.asarray(other["solved"]))
        np.testing.assert_array_equal(out["cons_len"], np.asarray(other["cons_len"]))
        for i in np.nonzero(out["solved"])[0]:
            n = out["cons_len"][i]
            np.testing.assert_array_equal(out["cons"][i, :n], np.asarray(other["cons"])[i, :n])
    assert out["esc_overflow"] == 0 and out["solved"].any()


def test_explicit_esc_cap_keeps_the_overflow_count(small):
    """An explicit per-member cap escalates that many failures a member and
    sums the rest into ``esc_overflow``, as the JAX program's psum does
    (the solver built from the profile, ``build_sharded_solver``)."""
    from daccord_tpu_torch.kernels.tiers import solve_ladder
    from daccord_tpu_torch.parallel.mesh import build_sharded_solver

    batch = small["batch"]
    solver = build_sharded_solver(4, small["prof"], small["cfg"].consensus, esc_cap=1,
                                  device="cpu")
    ladder = solver.ladder
    try:
        out = solver(batch)
    finally:
        solver.close()
    per = -(-batch.size // 4)
    deep = batch.nsegs >= ladder.params[0].min_depth
    from daccord_tpu_torch.kernels.tiers import tier0_core

    t0 = tier0_core(*(torch.as_tensor(a) for a in (batch.seqs, batch.lens, batch.nsegs)),
                    ladder.tables[ladder.params[0].k], ladder.params[0])
    need = (~t0["solved"].numpy()) & deep
    want = sum(max(int(need[j * per:(j + 1) * per].sum()) - 1, 0) for j in range(4))
    assert want > 0 and out["esc_overflow"] == want
    # the windows escalated within the cap solve as the single ladder does
    ref = solve_ladder(batch, ladder)
    both = out["solved"] & ref["solved"]
    assert both.any()
    np.testing.assert_array_equal(out["cons_len"][both], ref["cons_len"][both])


def test_full_pipeline_through_an_injected_mesh_solver(small, tmp_path):
    """``correct_shard(solver=mesh solver)`` writes the single-device run's
    FASTA (the injected solver takes the custom-solver path), its ledger
    rows carrying the mesh's width."""
    from daccord_tpu_torch.formats.fasta import FastaRecord, write_fasta
    from daccord_tpu_torch.parallel.mesh import make_sharded_solver
    from daccord_tpu_torch.runtime.pipeline import correct_shard
    from daccord_tpu_torch.utils.bases import ints_to_seq

    solver = make_sharded_solver(small["ladder"], _cpu_mesh(4))
    ledger = str(tmp_path / "ledger.jsonl")
    try:
        recs = [FastaRecord(f"read{rid}/{i}", ints_to_seq(f)) for rid, frags, _ in
                correct_shard(small["db"], small["las"],
                              dataclasses.replace(small["cfg"], ledger_path=ledger),
                              profile=small["prof"], solver=solver)
                for i, f in enumerate(frags)]
    finally:
        solver.close()
    write_fasta(str(tmp_path / "m.fasta"), recs)
    assert open(tmp_path / "m.fasta").read() == small["single"]
    assert {json.loads(x).get("mesh") for x in open(ledger)} == {4}


def test_init_distributed_is_a_no_op_without_a_coordinator(monkeypatch):
    from daccord_tpu_torch.parallel.launch import init_distributed

    monkeypatch.delenv("DACCORD_COORDINATOR", raising=False)
    assert init_distributed() == (0, 1)
    with pytest.raises(ValueError, match="num_processes"):
        init_distributed("127.0.0.1:1")


WORKER = """
import sys
import torch
import torch.distributed as dist
from daccord_tpu_torch.parallel.launch import init_distributed, run_shard
from daccord_tpu_torch.runtime.pipeline import PipelineConfig

torch.set_num_threads(1)
rank, world = init_distributed(sys.argv[1], num_processes=2, process_id=int(sys.argv[2]),
                               device="cpu")
assert world == 2, world
t = torch.tensor([rank + 1])
dist.all_reduce(t)
assert int(t) == 3, int(t)
m = run_shard(sys.argv[3], sys.argv[4], sys.argv[5], rank, 2,
              PipelineConfig(device="cpu", batch_size=32, depth_buckets=(), mesh=2))
dist.barrier()
dist.destroy_process_group()
print("proc", rank, "reads", m["reads"])
"""


def test_two_processes_form_a_gloo_group_and_merge_byte_identical(small, tmp_path):
    """``init_distributed`` over gloo on the loopback: two processes (each a
    two-member CPU mesh) correct their own byte range; the merge equals a
    single process's run of the same two shards."""
    from daccord_tpu_torch.parallel.launch import merge_shards, run_shard
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    d = small["d"]
    dist_dir, ref_dir = str(tmp_path / "dist"), str(tmp_path / "ref")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, f"127.0.0.1:{port}", str(i),
                               d["db"], d["las"], dist_dir], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(2)]
    try:
        for p in procs:
            so, se = p.communicate(timeout=300)
            assert p.returncode == 0, (so.decode()[-2000:], se.decode()[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i in range(2):
        run_shard(d["db"], d["las"], ref_dir, i, 2,
                  PipelineConfig(device="cpu", batch_size=32, depth_buckets=()))
    merge_shards(dist_dir, 2, str(tmp_path / "dist.fasta"))
    merge_shards(ref_dir, 2, str(tmp_path / "ref.fasta"))
    assert open(tmp_path / "dist.fasta").read() == open(tmp_path / "ref.fasta").read()


def test_mesh_crash_resume_restages_byte_identical(small, tmp_path, monkeypatch):
    """A crash while batches are staged (``crash:10``) loses nothing: the
    resumed two-member mesh shard equals the uninterrupted single-device
    shard (the slow JAX arm's wiring, on the small set)."""
    from daccord_tpu_torch.parallel import launch
    from daccord_tpu_torch.runtime.faults import InjectedCrash
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig

    d = small["d"]
    mesh_dir = str(tmp_path / "mesh")
    # one bucket and a shallow deque: reads complete, and checkpoint, early
    mcfg = PipelineConfig(device="cpu", batch_size=32, mesh=2, max_inflight=2,
                          depth_buckets=())
    monkeypatch.setenv("DACCORD_FAULT", "crash:10")
    with pytest.raises(InjectedCrash):
        launch.run_shard(d["db"], d["las"], mesh_dir, 0, 1, mcfg, checkpoint_every=2)
    monkeypatch.delenv("DACCORD_FAULT")
    m = launch.run_shard(d["db"], d["las"], mesh_dir, 0, 1, mcfg, checkpoint_every=2)
    assert m.get("resumed_at_read", 0) > 0
    assert open(launch.shard_paths(mesh_dir, 0)["fasta"]).read() == small["single"]


def test_serve_mesh_group_builds_and_merges_jobs(small):
    """A mesh-backed serve group: its solve path is the sharded solver
    (``mesh.init``), two jobs' rows merge into one mesh batch, and each
    job's rows equal the single-device ladder's."""
    from daccord_tpu_torch.kernels.tensorize import slice_batch
    from daccord_tpu_torch.kernels.tiers import solve_ladder
    from daccord_tpu_torch.serve.batcher import GroupConfig, SolveGroup

    batch = small["batch"]
    n = (batch.size // 2) * 2
    half = n // 2
    log = _CapLog()
    group = SolveGroup("k", small["prof"], small["cfg"],
                       GroupConfig(backend="cpu", batch=n, mesh=8, audit_rate=0),
                       log=log, name="g0")
    try:
        assert group.mesh_solver is not None and group.mesh_solver.nd == 8
        assert log.of("mesh.init")[0]["nd"] == 8
        sa, sb = group.job_solver("A"), group.job_solver("B")
        assert sa.mesh == 8
        ha = sa.dispatch(slice_batch(batch, 0, half))
        hb = sb.dispatch(slice_batch(batch, half, n))
        out_a, out_b = sa.fetch(ha), sb.fetch(hb)
        assert group.counters["mixed_batches"] >= 1
        ref = solve_ladder(slice_batch(batch, 0, n), group.ladder)
    finally:
        group.close()
    np.testing.assert_array_equal(np.asarray(out_a["solved"]), ref["solved"][:half])
    np.testing.assert_array_equal(np.asarray(out_b["solved"]), ref["solved"][half:n])
    for i in range(half):
        np.testing.assert_array_equal(out_a["cons"][i], ref["cons"][i])
        np.testing.assert_array_equal(out_b["cons"][i], ref["cons"][half + i])


# ---------------------------------------------------------------------------
# the CLI's --mesh rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tool", ["daccord", "shard", "serve", "fleet"])
def test_every_tool_refuses_a_cuda_mesh_without_its_cards(small, tmp_path, tool, monkeypatch,
                                                          capsys):
    """On cuda with fewer visible cards than members each tool exits
    non-zero before any run, naming what it sees; none refuses the mesh
    itself (``--help`` documents it)."""
    from daccord_tpu_torch.tools import cli

    monkeypatch.setattr(meshmod, "visible_devices", lambda: [])
    d = small["d"]
    argv = {"daccord": ["daccord", d["db"], d["las"], "-o", str(tmp_path / "o.fasta")],
            "shard": ["shard", d["db"], d["las"], str(tmp_path / "sh"), "-J", "0,1"],
            "serve": ["serve", "--workdir", str(tmp_path / "w")],
            "fleet": ["fleet", d["db"], d["las"], str(tmp_path / "fl"), "-n", "1",
                      "--backend", "cuda"]}[tool]
    with pytest.raises(SystemExit, match="mesh 2: only 0 cuda devices visible"):
        cli.main(argv + ["--mesh", "2"])
    assert not os.listdir(tmp_path)
    with pytest.raises(SystemExit) as ex:
        cli.main(argv[:1] + ["--help"])
    assert ex.value.code == 0
    help_ = capsys.readouterr().out
    assert "--mesh" in help_ and "not ported" not in help_


def test_cli_mesh_with_native_is_refused_and_cpu_mesh_runs(small, tmp_path):
    from daccord_tpu_torch.tools.cli import daccord_run

    d = small["d"]
    with pytest.raises(SystemExit, match="cannot be combined with --mesh"):
        daccord_run([d["db"], d["las"], "-o", str(tmp_path / "n.fasta"),
                     "--backend", "native", "--mesh", "2"])
    out = str(tmp_path / "m.fasta")
    stats, _ = daccord_run([d["db"], d["las"], "-o", out, "--device", "cpu", "-b", "32",
                            "--mesh", "2"])
    assert open(out).read() == small["single"]
    assert stats.dispatch_walls["restaged"] == 0 and stats.mesh_health["nd"] == 2
