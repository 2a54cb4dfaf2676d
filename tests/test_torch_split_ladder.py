"""The port's two-stream ladder (``--ladder split``) against the JAX package's,
the counterparts of ``tests/test_split_ladder.py`` on the same data.

The pool rule (``rescue_candidates``), the rescue density, the
``ladder.flush`` event's schema, the ``--ladder`` flag, ``pad_batch``
keeping the stream tag and the supervisor's replay of both streams against
stub engines, each beside the JAX package's; then split against fused at
the kernel level (one batch) and through ``correct_to_fasta`` on the CPU:
byte-identical to the port's fused run and to the JAX package's split run,
fewer rescue slots, dense Stream B batches, the flush-lag bound, the fault
matrix, the shadow audit's Stream A rule (in process and in the workers).
Last, the audit workers start once for two runs of one process.

Left out: checkpoint/resume with a pending pool (needs
``parallel/launch.py``, not ported) and ``kernelbench``'s stage row (the
tool is not ported).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch, pad_batch
from daccord_tpu_torch.kernels.tiers import TierLadder, rescue_candidates
from daccord_tpu_torch.kernels.window_kernel import KernelParams
from daccord_tpu_torch.tools.eventcheck import validate_events

from _torch_faults_common import make_base, run


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return make_base(str(tmp_path_factory.mktemp("torch_split")))


def _fake_ladders(n_tiers=2, wide=False, min_depth=3):
    """The same tier parameters as a port and a JAX ladder (no tables)."""
    from daccord_tpu.kernels import KernelParams as JaxKernelParams
    from daccord_tpu.kernels import TierLadder as JaxTierLadder

    fields = [dict(k=8, min_count=2 - (i > 0), wlen=40, min_depth=min_depth)
              for i in range(n_tiers)]
    out = []
    for P, L in ((KernelParams, TierLadder), (JaxKernelParams, JaxTierLadder)):
        params = [P(**f) for f in fields]
        wide_p0 = dataclasses.replace(params[0], max_kmers=256) if wide else None
        out.append(L(params=params, tables={}, wide_p0=wide_p0))
    return out


def test_rescue_candidates_match_jax():
    from daccord_tpu.kernels.tiers import rescue_candidates as jax_rescue_candidates

    out = dict(solved=np.asarray([True, False, False, True]),
               m_ovf=np.asarray([True, False, True, False]))
    nsegs = np.asarray([8, 8, 2, 8])
    for kw, want in ((dict(n_tiers=2), [False, True, False, False]),
                     (dict(n_tiers=2, wide=True), [True, True, False, False]),
                     (dict(n_tiers=1), [False] * 4)):
        port, jl = _fake_ladders(**kw)
        got = rescue_candidates(out, nsegs, port)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_rescue_candidates(out, nsegs, jl))


def test_rescue_density_matches_jax():
    from daccord_tpu.runtime.pipeline import PipelineStats as JaxPipelineStats
    from daccord_tpu_torch.runtime.pipeline import PipelineStats

    for st in (PipelineStats(), JaxPipelineStats()):
        assert st.rescue_density == 0.0
        st.n_rescue_windows, st.rescue_slots_executed = 120, 150
        assert st.rescue_density == pytest.approx(0.8)


def test_eventcheck_ladder_flush_and_graph_capture_schemas(tmp_path):
    from daccord_tpu.tools.eventcheck import validate_events as jax_validate

    good = tmp_path / "flush.jsonl"
    good.write_text(json.dumps({"t": 0.1, "ts": 1.0, "event": "ladder.flush", "rows": 100,
                                "slots": 128, "reason": "lag", "bucket": 0}) + "\n")
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"t": 0.1, "event": "ladder.flush", "rows": "many"}) + "\n")
    assert validate_events(str(good), strict=True) == jax_validate(str(good), strict=True) == []
    errs = validate_events(str(bad))
    assert errs and any("slots" in e for e in errs) and jax_validate(str(bad))
    cap = tmp_path / "capture.jsonl"
    cap.write_text(json.dumps({"t": 0.1, "ts": 1.0, "event": "graph.capture",
                               "stage": "tier0", "key": "cuda:0:B2048x32x64:fused",
                               "wall_s": 0.01}) + "\n"
                   + json.dumps({"t": 0.2, "ts": 1.1, "event": "graph.capture",
                                 "stage": "tier0"}) + "\n")
    errs = validate_events(str(cap))
    assert [e.split(": ", 1)[1] for e in errs] == [
        "graph.capture missing field 'key'", "graph.capture missing field 'wall_s'"]


def test_cli_ladder_flag_validation(tmp_path):
    """Both packages refuse a ladder mode they do not know before any work;
    the port's pipeline refuses it in its config check too."""
    from daccord_tpu.tools.cli import daccord_main as jax_daccord_main
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig, _check_config
    from daccord_tpu_torch.tools.cli import _parser, daccord_run

    for main in (jax_daccord_main, lambda a: daccord_run([*a, "-o", str(tmp_path / "x")])):
        with pytest.raises(SystemExit):
            main(["db", "las", "--ladder", "bogus"])
    args = _parser().parse_args(["db", "las", "-o", "x", "--ladder", "split"])
    assert args.ladder == "split" and _parser().parse_args(["db", "las", "-o", "x"]).ladder \
        == "fused"
    with pytest.raises(ValueError, match="ladder_mode"):
        _check_config(PipelineConfig(ladder_mode="bogus"))
    with pytest.raises(ValueError, match="rescue_flush_reads"):
        _check_config(PipelineConfig(ladder_mode="split", rescue_flush_reads=0))


def _mini_batch(stream="full", b=4, d=2, l=8, cls=WindowBatch, shape=BatchShape):
    return cls(seqs=np.zeros((b, d, l), np.int8), lens=np.zeros((b, d), np.int32),
               nsegs=np.zeros(b, np.int32), shape=shape(depth=d, seg_len=l, wlen=l),
               read_ids=np.zeros(b, np.int64), wstarts=np.zeros(b, np.int64),
               stream=stream)


def test_pad_batch_preserves_stream():
    from daccord_tpu.kernels.tensorize import BatchShape as JaxBatchShape
    from daccord_tpu.kernels.tensorize import WindowBatch as JaxWindowBatch
    from daccord_tpu.kernels.tensorize import pad_batch as jax_pad_batch
    from daccord_tpu_torch.kernels import paging
    from daccord_tpu_torch.kernels.tensorize import slice_rows

    b = pad_batch(_mini_batch(stream="rescue"), 9)
    jb = jax_pad_batch(_mini_batch("rescue", cls=JaxWindowBatch, shape=JaxBatchShape), 9)
    assert b.stream == jb.stream == "rescue" and b.size == jb.size == 9
    fam = paging.ShapeFamily(depth=2, pages=2, page_len=4)
    pb = paging.pack_paged(_mini_batch(stream="tier0"), fam, target_rows=6)
    assert pb.stream == "tier0" and pad_batch(pb, 8).stream == "tier0"
    assert pb.to_dense().stream == "tier0"
    assert slice_rows(pb, np.asarray([1, 3])).stream == "tier0"
    assert slice_rows(b, np.asarray([0, 2])).size == 2


def _two_stream_replay(pkg: str, tmp_path, monkeypatch) -> list:
    """Failover with both streams in flight, against stub engines: the
    package's supervisor replays every handle, tier-0 and rescue, on the
    fallback; returns the ``sup_compile`` keys."""
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / f"cc_{pkg}"))
    if pkg == "port":
        from daccord_tpu_torch.runtime.faults import FaultPlan
        from daccord_tpu_torch.runtime.supervisor import (DEGRADED, DeviceSupervisor,
                                                          SupervisorConfig)
        from daccord_tpu_torch.utils.obs import JsonlLogger
        batch_cls, shape_cls = WindowBatch, BatchShape
    else:
        from daccord_tpu.kernels.tensorize import BatchShape as shape_cls
        from daccord_tpu.kernels.tensorize import WindowBatch as batch_cls
        from daccord_tpu.runtime.faults import FaultPlan
        from daccord_tpu.runtime.supervisor import (DEGRADED, DeviceSupervisor,
                                                    SupervisorConfig)
        from daccord_tpu.utils.obs import JsonlLogger
    ev = str(tmp_path / f"{pkg}.events.jsonl")
    kw = dict(fallback_factory=lambda: (lambda b: {"engine": "fallback",
                                                   "stream": b.stream}),
              log=JsonlLogger(ev), cfg=SupervisorConfig(backoff_base_s=0.01),
              faults=FaultPlan.parse("device_lost:3"), describe="stub")
    dispatch = lambda b: ("h", b.stream)                      # noqa: E731
    fetch = lambda h: {"engine": "primary", "stream": h[1]}   # noqa: E731
    sup = (DeviceSupervisor(dispatch, fetch, **kw) if pkg == "port"
           else DeviceSupervisor(dispatch, fetch, None, **kw))
    mk = lambda s: _mini_batch(s, cls=batch_cls, shape=shape_cls)   # noqa: E731
    h_a = sup.dispatch(mk("tier0"))       # op 1 ok (Stream A)
    h_b = sup.dispatch(mk("rescue"))      # op 2 ok (Stream B)
    h_c = sup.dispatch(mk("tier0"))       # op 3: device lost
    assert sup.failed_over and sup.state == DEGRADED
    assert sup.fetch(h_a) == {"engine": "fallback", "stream": "tier0"}
    assert sup.fetch(h_b) == {"engine": "fallback", "stream": "rescue"}
    assert sup.fetch(h_c) == {"engine": "fallback", "stream": "tier0"}
    sup.close() if pkg == "port" else None
    recs = [json.loads(x) for x in open(ev)]
    return sorted(r["key"] for r in recs if r["event"] == "sup_compile"), ev


def test_supervisor_two_stream_replay(tmp_path, monkeypatch):
    """Stream A's program has a key of its own (``:t0``), Stream B's rescue
    batch shares the fused key: two cold shapes, as in the JAX package."""
    keys, ev = _two_stream_replay("port", tmp_path, monkeypatch)
    jax_keys, _ = _two_stream_replay("jax", tmp_path, monkeypatch)
    assert keys == jax_keys == ["B4xD2xL8", "B4xD2xL8:t0"]
    assert validate_events(ev, strict=True) == []


def _sim_batch():
    from daccord_tpu_torch.kernels.tensorize import tensorize_windows
    from daccord_tpu_torch.oracle import cut_windows, refine_overlap
    from daccord_tpu_torch.sim import SimConfig, simulate

    cfg = SimConfig(genome_len=2500, coverage=16, read_len_mean=700, seed=21)
    res = simulate(cfg)
    items = []
    for aread in sorted(range(len(res.reads)), key=lambda i: -len(res.reads[i].seq))[:2]:
        a = res.reads[aread].seq
        refined = [refine_overlap(o, a, res.reads[o.bread].seq, cfg.tspace)
                   for o in res.overlaps if o.aread == aread]
        items += [(aread, ws) for ws in cut_windows(a, refined, w=40, adv=10)]
    return tensorize_windows(items[:96], BatchShape(depth=32, seg_len=64, wlen=40))


@pytest.mark.parametrize("lad_kw", [{}, dict(max_kmers=24, overflow_rescue=True)])
def test_split_ladder_kernel_parity(lad_kw):
    """``solve_ladder_split`` == ``solve_ladder`` bit for bit (Stream B in
    chunks of 32 rows), the wide rescue included; the pool rule picks the
    same rows as the JAX package's on the port's Stream A result."""
    from daccord_tpu.kernels.tiers import rescue_candidates as jax_rescue_candidates
    from daccord_tpu_torch.kernels.tiers import fetch, solve_ladder, solve_ladder_split
    from daccord_tpu_torch.kernels.tiers import solve_tier0_async
    from daccord_tpu_torch.oracle import ConsensusConfig, ErrorProfile

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        batch = _sim_batch()
        ladder = TierLadder.from_config(ErrorProfile(0.08, 0.04, 0.015), ConsensusConfig(),
                                        device="cpu", **lad_kw)
        ref = solve_ladder(batch, ladder)
        got = solve_ladder_split(batch, ladder, rescue_batch=32)
        for key in ("solved", "cons_len", "cons", "tier", "m_ovf", "err"):
            np.testing.assert_array_equal(ref[key], got[key], key)
        out0 = fetch(solve_tier0_async(batch, ladder))
        need = rescue_candidates(out0, batch.nsegs, ladder)
        _, jl = _fake_ladders(n_tiers=len(ladder.params), wide=ladder.wide_p0 is not None)
        np.testing.assert_array_equal(need, jax_rescue_candidates(out0, batch.nsegs, jl))
        # the small tier-0 cap of the wide case binds on every window
        assert need.any() and (lad_kw or not need.all())
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def split_runs(base):
    """The port's split run and the JAX package's, audit off."""
    return (run(base, "port", "split", None, audit_rate=0, ladder_mode="split"),
            run(base, "jax", "split", None, audit_rate=0, ladder_mode="split"))


def test_split_vs_fused_pipeline_byte_parity_and_slots(base, split_runs):
    port, jax_split = split_runs
    fused = base["clean"]
    assert port["text"] == fused["text"] == jax_split["text"]
    sf, ss = fused["stats"], port["stats"]
    assert ss.n_rescue_windows == sf.n_rescue_windows > 0
    assert sf.rescue_slots_executed > ss.rescue_slots_executed > 0
    assert ss.rescue_density > sf.rescue_density
    assert ss.n_dispatch_tier0 > 0 and ss.n_dispatch_rescue > 0
    assert ss.n_dispatch_tier0 == jax_split["stats"].n_dispatch_tier0
    for di in ss.rescue_dispatches:
        assert di["reason"] == "final" or di["rows"] / di["slots"] >= 0.8, di
    assert validate_events(port["ev"], strict=True) == []
    flushes = [r for r in port["recs"] if r["event"] == "ladder.flush"]
    assert len(flushes) == ss.n_dispatch_rescue
    assert ss.tier_histogram == sf.tier_histogram
    assert ss.n_topm_overflow == sf.n_topm_overflow


def test_split_flush_lag_bound(base):
    """A tight ``rescue_flush_reads`` forces 'lag' flushes; a loose one
    leaves only full and final ones; the bytes never change. One call in
    flight, so Stream A rows pool while reads still come (this set is a
    few dozen reads)."""
    tight = run(base, "port", "lag_tight", None, audit_rate=0, ladder_mode="split",
                rescue_flush_reads=2, max_inflight=1)
    assert "lag" in {di["reason"] for di in tight["stats"].rescue_dispatches}
    loose = run(base, "port", "lag_loose", None, audit_rate=0, ladder_mode="split",
                rescue_flush_reads=10 ** 6, max_inflight=1)
    assert {di["reason"] for di in loose["stats"].rescue_dispatches} <= {"full", "final"}
    assert tight["text"] == loose["text"] == base["clean"]["text"]


@pytest.mark.parametrize("fault,degraded", [("dispatch_error:2", False),
                                            ("fetch_hang:2", False),
                                            ("device_lost:3", True)])
def test_split_fault_matrix_byte_parity(base, fault, degraded):
    """Retries, and a failover mid-run that replays both streams on the CPU
    ladder: the FASTA is the unfaulted fused run's."""
    port = run(base, "port", f"split_{fault.split(':')[0]}", fault, audit_rate=0,
               ladder_mode="split")
    assert port["stats"].degraded == degraded
    assert port["text"] == base["clean"]["text"]
    assert validate_events(port["ev"], strict=True) == []


@pytest.mark.parametrize("worker", [False, True])
def test_split_audit_compares_final_stream_a_rows_only(base, worker):
    """An audit of every window (in process, or in the workers with their
    Stream A reference) finds nothing on a clean split run; an ``sdc``
    fault is caught and the FASTA does not change."""
    clean = run(base, "port", f"split_audit1_{worker}", None, audit_rate=1.0,
                ladder_mode="split", audit_worker=worker)
    assert not any(r["event"] in ("sup_sdc", "audit.disabled") for r in clean["recs"])
    assert clean["stats"].sup_counters["audits"] == clean["stats"].n_batches
    sdc = run(base, "port", f"split_sdc_{worker}", "sdc:2", audit_rate=0.25,
              ladder_mode="split", audit_worker=worker)
    assert sdc["stats"].sup_counters["sdc_detected"] == 1
    assert clean["text"] == sdc["text"] == base["clean"]["text"]


def test_audit_workers_start_once_across_two_runs(base):
    """The first run that audits in workers starts them; the second reuses
    the same processes."""
    from daccord_tpu_torch.audit import worker as audit_worker

    audit_worker.close_shared()
    first = run(base, "port", "workers_first", None, audit_rate=0.25, audit_worker=True)
    pool = audit_worker.shared()
    pids = [p.pid for p in pool._procs]
    second = run(base, "port", "workers_second", None, audit_rate=0.25, audit_worker=True)
    again = audit_worker.shared()
    assert again is pool and [p.pid for p in again._procs] == pids and again.alive()
    assert len(pids) == audit_worker.PROCESSES
    assert first["stats"].audit_worker_start == second["stats"].audit_worker_start != {}
    assert first["stats"].audit_worker_s > 0 and second["stats"].audit_worker_s > 0
    assert first["text"] == second["text"] == base["clean"]["text"]
