"""The shadow audit's worker process (``audit/worker.py``) on the CPU, driven
through the supervisor's constructor (``PipelineConfig.audit_worker``; the
CPU default is the in-process audit), against the JAX package's run under
the same ``DACCORD_FAULT`` spec.

A run audited in the worker writes the FASTA of audit rate 0 and of the
in-process audit, with the JAX run's ``sup_state`` transitions and
``sup_done`` counters; ``--audit-rate 1`` on a clean run logs no
``sup_sdc``; an ``sdc`` fault is caught with the FASTA unchanged; a worker
that is killed, or that fails on its ladder, logs ``audit.disabled`` and
the run completes; samples of one shape solved in one ladder call equal
their separate solves and the torch reference's.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from daccord_tpu_torch.audit import ladder as np_ladder
from daccord_tpu_torch.audit import worker as audit_worker
from daccord_tpu_torch.kernels.tiers import TierLadder, audit_reference
from daccord_tpu_torch.oracle.consensus import ConsensusConfig
from daccord_tpu_torch.oracle.profile import ErrorProfile
from daccord_tpu_torch.runtime.supervisor import DeviceSupervisor
from daccord_tpu_torch.tools.eventcheck import validate_events

from _torch_faults_common import make_base, run


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return make_base(str(tmp_path_factory.mktemp("torch_audit_worker")))


@pytest.fixture(scope="module")
def jax_clean(base):
    """The JAX package's clean run (compiles its ladder for the module)."""
    return run(base, "jax", "clean", None, audit_rate=0)


def _same_as_jax(port: dict, ref: dict) -> None:
    assert port["chain"] == ref["chain"] and port["chain"]
    assert port["done"] == ref["done"]


def test_worker_audit_writes_the_unaudited_in_process_and_jax_runs(base, jax_clean):
    inproc = run(base, "port", "inproc", None, audit_rate=0.25)
    worker = run(base, "port", "worker", None, audit_rate=0.25, audit_worker=True)
    ref = run(base, "jax", "audit", None, audit_rate=0.25)
    assert worker["text"] == base["clean"]["text"] == inproc["text"]
    _same_as_jax(worker, ref)
    st = worker["stats"]
    assert st.sup_counters["audits"] == inproc["stats"].sup_counters["audits"] == st.n_batches
    assert st.audit_local == 0 and inproc["stats"].audit_local == st.n_batches
    assert st.sup_counters["sdc_detected"] == 0 and st.audit_disabled is None
    assert st.audit_worker_s > 0 and inproc["stats"].audit_worker_s == 0
    assert set(st.audit_worker_start) == {"boot_s", "import_s"}
    assert validate_events(worker["ev"], strict=True) == []
    assert not any(r["event"] in ("sup_sdc", "audit.disabled") for r in worker["recs"])


def test_worker_audit_of_every_window_finds_nothing(base, jax_clean):
    port = run(base, "port", "worker_audit1", None, audit_rate=1.0, audit_worker=True)
    ref = run(base, "jax", "audit1", None, audit_rate=1.0)
    assert port["text"] == base["clean"]["text"]
    _same_as_jax(port, ref)
    assert not any(r["event"] == "sup_sdc" for r in port["recs"])
    assert port["done"][0]["audits"] == port["stats"].n_batches
    assert port["done"][0]["sdc_detected"] == 0


def test_worker_catches_sdc_and_the_fasta_does_not_change(base, jax_clean):
    port = run(base, "port", "worker_sdc", "sdc:2", audit_rate=0.25, audit_worker=True)
    ref = run(base, "jax", "sdc", "sdc:2", audit_rate=0.25)
    assert port["text"] == base["clean"]["text"]
    assert validate_events(port["ev"], strict=True) == []
    sdc = [r for r in port["recs"] if r["event"] == "sup_sdc"]
    assert len(sdc) == 1 and port["done"][0]["sdc_detected"] == 1
    _same_as_jax(port, ref)
    assert [(r["state_from"], r["state_to"]) for r in port["recs"]
            if r["event"] == "trust.state"] == [("TRUSTED", "SUSPECT")]


def test_calls_whose_rows_are_not_back_stay_in_flight(base, monkeypatch):
    """While the worker's rows for the oldest call are not back, the deque
    holds more than ``max_inflight`` calls (up to ``AUDIT_LAG`` times) instead
    of waiting on the worker; the FASTA is the clean run's."""
    from daccord_tpu_torch.runtime import pipeline

    monkeypatch.setattr(audit_worker.AuditWorker, "done", lambda self, ticket: False)
    port = run(base, "port", "worker_lag", None, audit_rate=0.25, audit_worker=True)
    st = port["stats"]
    assert port["text"] == base["clean"]["text"]
    assert st.sup_counters["audits"] == st.n_batches and st.audit_disabled is None
    assert 8 < st.peak_inflight <= pipeline.AUDIT_LAG * 8
    assert st.peak_inflight == min(st.n_batches, pipeline.AUDIT_LAG * 8)


def test_final_drain_lands_calls_in_the_order_their_rows_come_back(base, monkeypatch):
    """The audit's tail: at the end of the run the deque is emptied in the
    order the worker's rows come back, so the host scatters and stitches
    the calls already checked while the worker solves the rest. Here the
    oldest call's rows are held back until every other call has landed:
    it is fetched last, the run waits only for it, and the FASTA is the
    clean run's."""
    first, fetched, landed = [], [], set()
    real_fetch = DeviceSupervisor.fetch

    def audit_pending(self, h):
        if not first:
            first.append(h)
        return h is first[0] and len(landed) < self.counters["dispatch"] - 1

    def fetch(self, h):
        fetched.append(h)
        out = real_fetch(self, h)
        landed.add(id(h))
        return out

    monkeypatch.setattr(DeviceSupervisor, "audit_pending", audit_pending)
    monkeypatch.setattr(DeviceSupervisor, "fetch", fetch)
    port = run(base, "port", "worker_order", None, audit_rate=0.25, audit_worker=True)
    st = port["stats"]
    assert port["text"] == base["clean"]["text"]
    assert len(fetched) == st.n_batches > 8 and fetched[-1] is first[0]
    assert st.sup_counters["audits"] == st.n_batches and st.audit_disabled is None
    assert 0 <= st.audit_drain_s <= st.audit_s


@pytest.mark.parametrize("rate", [1.0 / 64, 1.0], ids=["1/64", "1"])
def test_fasta_is_the_same_at_every_audit_rate(base, rate):
    """Rates 0 (the clean run), 1/64 and 1 write one FASTA; the tail's
    anatomy is recorded: each worker's backlog when the final flush began,
    and every part sent since came back."""
    port = run(base, "port", f"worker_rate{rate:.4f}", None, audit_rate=rate,
               audit_worker=True)
    st = port["stats"]
    assert port["text"] == base["clean"]["text"]
    assert not any(r["event"] in ("sup_sdc", "audit.disabled") for r in port["recs"])
    tail = st.audit_tail
    assert len(tail["queued_windows"]) == len(tail["running"]) == audit_worker.PROCESSES
    assert tail["tail_parts"] and all(p["back_s"] is not None and p["back_s"] >= 0
                                      for p in tail["tail_parts"])


def test_killed_worker_disables_the_audit_and_the_run_completes(base, monkeypatch):
    real = audit_worker.AuditWorker.submit
    calls = []

    def submit(self, sample, *args, **kw):
        calls.append(1)
        if len(calls) == 3:
            self._procs[0].kill()
            self._procs[0].wait()
        return real(self, sample, *args, **kw)

    monkeypatch.setattr(audit_worker.AuditWorker, "submit", submit)
    port = run(base, "port", "worker_killed", None, audit_rate=0.25, audit_worker=True)
    assert port["text"] == base["clean"]["text"]
    off = [r for r in port["recs"] if r["event"] == "audit.disabled"]
    assert len(off) == 1 and ("exited" in off[0]["error"] or "reading" in off[0]["error"])
    assert port["stats"].audit_disabled and validate_events(port["ev"], strict=True) == []
    assert port["done"][0]["audits"] < port["stats"].n_batches


def test_worker_that_fails_on_its_ladder_disables_the_audit(base, monkeypatch):
    """A ladder the worker cannot solve with (a tier without its table):
    its error reaches ``audit.disabled``, and the run completes."""
    real = audit_worker.AuditWorker.build

    def build(self, spec):
        tables, params, wide = spec
        real(self, ({}, params, wide))

    monkeypatch.setattr(audit_worker.AuditWorker, "build", build)
    port = run(base, "port", "worker_bad", None, audit_rate=0.25, audit_worker=True)
    assert port["text"] == base["clean"]["text"]
    off = [r for r in port["recs"] if r["event"] == "audit.disabled"]
    assert len(off) == 1 and "KeyError" in off[0]["error"]
    assert port["stats"].audit_disabled and port["done"][0]["audits"] == 0


#: a worker that writes its error and exits at once, before any request
_FAKE_WORKER = """
import os, sys
from multiprocessing.connection import Connection
Connection(int(sys.argv[2]), readable=False).send(("error", "KeyError: 'no table'"))
os._exit(1)
"""


@pytest.mark.parametrize("also_lost_pipe", [False, True])
def test_an_error_written_just_before_exit_is_the_one_reported(monkeypatch,
                                                               also_lost_pipe):
    """The worker's message is in its pipe and the worker has exited, but
    the parent's first wait found nothing ready (the message came between
    that wait and the exit check): the parent reads the pipe to its end and
    reports the worker's own error, not its exit code or the broken pipe
    its sender met."""
    real_popen = subprocess.Popen

    def popen(argv, **kw):
        return real_popen([sys.executable, "-c", _FAKE_WORKER, *argv[3:]], **kw)

    monkeypatch.setattr(audit_worker.subprocess, "Popen", popen)
    w = audit_worker.AuditWorker(processes=1)
    try:
        assert w._procs[0].wait(60) == 1
        if also_lost_pipe:
            w._lost = "an audit worker stopped reading: [Errno 32] Broken pipe"
        real_wait, waits = audit_worker.wait, []

        def wait(conns, timeout):
            waits.append(timeout)
            return [] if len(waits) == 1 else real_wait(conns, timeout)

        monkeypatch.setattr(audit_worker, "wait", wait)
        assert not w.alive()
        assert waits and w.error == "KeyError: 'no table'"
        with pytest.raises(audit_worker.AuditWorkerError, match="KeyError"):
            w._wait(lambda: False, 5.0)
    finally:
        w.close()


def _ladder(prof: ErrorProfile) -> TierLadder:
    return TierLadder.from_config(prof, ConsensusConfig(), device="cpu")


def _samples(base, n: int):
    """``n`` row samples of real windows of the dataset (two of them of a
    second, shallower tile), as the supervisor takes them."""
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig, iter_pile_blocks

    d = base["d"]
    cfg = PipelineConfig(device="cpu")
    got = [(s, ln, ns) for _, _, s, ln, ns in
           iter_pile_blocks(read_db(d["db"]), LasFile(d["las"]), cfg)]
    seqs, lens, nsegs = (np.concatenate([g[i] for g in got]) for i in range(3))
    keep = nsegs >= 3
    seqs, lens, nsegs = seqs[keep], lens[keep], nsegs[keep]
    batch = WindowBatch(seqs=seqs, lens=lens, nsegs=nsegs,
                        shape=BatchShape(depth=seqs.shape[1], seg_len=seqs.shape[2]),
                        read_ids=np.arange(len(nsegs)), wstarts=np.zeros(len(nsegs), np.int64))
    rng = np.random.default_rng(11)
    out = []
    for i in range(n):
        rows = sorted(rng.choice(len(nsegs), 5, replace=False))
        s = DeviceSupervisor._take_rows(batch, rows)
        if i >= n - 2:
            s = dataclasses.replace(s, seqs=s.seqs[:, :16], lens=s.lens[:, :16],
                                    nsegs=(s.lens[:, :16] > 0).sum(1).astype(np.int32),
                                    shape=BatchShape(depth=16, seg_len=s.seqs.shape[2]))
        out.append(s)
    return out


def _same(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(
        np.array_equal(np.asarray(got[k]), np.asarray(want[k])) for k in want)


@pytest.mark.parametrize("call_windows,calls", [(64, [15, 10]), (10, [10, 5, 10]),
                                                (1, [5, 5, 5, 5, 5])])
def test_samples_of_one_shape_in_one_call_equal_their_separate_solves(base, call_windows,
                                                                      calls):
    """Three samples of one shape and two of another (5 windows each): one
    call per shape, oldest first, up to ``call_windows`` windows (a sample
    alone when it is larger); each sample's rows equal its own solve."""
    prof = ErrorProfile.load(base["eprof"])
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        tl = _ladder(prof)
        ref = audit_reference(tl)
        spec = tl.spec()
        samples = _samples(base, 5)
        sizes = []

        def solve(s, ln, ns):
            sizes.append(len(ns))
            return np_ladder.solve_ladder(spec, s, ln, ns)

        done = [d for out, _ in audit_worker.solve_grouped(
            solve, [(t, (s.seqs, s.lens, s.nsegs)) for t, s in enumerate(samples)],
            call_windows) for d in out]
        assert sizes == calls and [t for t, _ in done] == [0, 1, 2, 3, 4]
        for t, got in done:
            assert _same(got, ref(samples[t])), t
    finally:
        torch.set_num_threads(n)


def test_worker_process_solves_pending_samples_together(base):
    """The process: samples queued with its ladder are solved (one call per
    shape when they are pending together), each ticket gets its own rows,
    and the worker imported nothing of jax, ``daccord_tpu`` or torch."""
    prof = ErrorProfile.load(base["eprof"])
    tl = _ladder(prof)
    samples = _samples(base, 5)
    w = audit_worker.AuditWorker()
    try:
        w.build(tl.spec())
        tickets = [w.submit(s) for s in samples]
        w.discard(tickets[0])
        got = {t: w.result(t, 300.0) for t in tickets[1:]}
        assert w.ready and w.leaked == [] and w.worker_s > 0
        assert 3 <= w.calls <= 5 and len(w._procs) == audit_worker.PROCESSES
    finally:
        w.close()
    assert all(p.poll() is not None for p in w._procs)
    ref = audit_reference(tl)
    for t, s in zip(tickets[1:], samples[1:]):
        assert _same(got[t], ref(s))


def test_a_paged_sample_is_its_pages_and_unpacks_to_the_dense_rows():
    """A paged batch's audit sample is its rows' table and the pool pages
    they name (``sample_pages``); the worker's unpack of it gives those
    rows of the dense batch that was packed, byte for byte."""
    from daccord_tpu_torch.kernels import paging
    from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch
    from daccord_tpu_torch.utils.bases import PAD

    rng = np.random.default_rng(3)
    B, D, L = 40, 8, 64
    lens = rng.integers(0, L + 1, size=(B, D)).astype(np.int32)
    nsegs = rng.integers(1, D + 1, size=B).astype(np.int32)
    for i in range(B):
        lens[i, nsegs[i]:] = 0
    seqs = np.where(np.arange(L)[None, None, :] < lens[:, :, None],
                    rng.integers(0, 4, size=(B, D, L)), PAD).astype(np.int8)
    batch = WindowBatch(seqs=seqs, lens=lens, nsegs=nsegs,
                        shape=BatchShape(depth=D, seg_len=L, wlen=40),
                        read_ids=np.arange(B, dtype=np.int64),
                        wstarts=np.arange(B, dtype=np.int64) * 10)
    pb = paging.pack_paged(batch, paging.ShapeFamily(depth=D, pages=D * L // 16,
                                                     page_len=16))
    rows = [0, 3, 7, 21, 39]
    sample = audit_worker.sample_pages(pb, rows)
    assert sample.pool.shape[0] < pb.pool.shape[0] and sample.size == len(rows)
    got = audit_worker._dense((sample.pool, sample.table, sample.lens, sample.nsegs,
                               (D, L, 16)))
    for g, w in zip(got, (seqs[rows], lens[rows], nsegs[rows])):
        assert np.array_equal(g, w)
    assert np.array_equal(sample.to_dense().seqs, seqs[rows])


@pytest.mark.parametrize("in_worker", [True, False], ids=["worker", "in-process"])
def test_paged_batches_audited_from_their_pages_write_the_clean_fasta(base, in_worker):
    """Every window of a paged run audited from the pages each sample names,
    in the workers or on the pipeline's thread: no divergence, and the
    clean (dense) run's FASTA."""
    port = run(base, "port", f"paged_audit_{in_worker}", None, audit_rate=1.0,
               audit_worker=in_worker, paged="on")
    st = port["stats"]
    assert st.paged and port["text"] == base["clean"]["text"]
    assert not any(r["event"] in ("sup_sdc", "audit.disabled") for r in port["recs"])
    assert st.sup_counters["audits"] == st.n_batches
    assert st.audit_local == (0 if in_worker else st.n_batches)
    assert (st.audit_take_s > 0) == in_worker
