"""The port's failover engines, outcome ledger and supervisor flags on the
CPU, through its ``daccord``.

``device_lost`` with the native failover engine (the host library's ladder)
stays within ROADMAP's drift bound of the clean run; the ledger writes one
row per window; ``--no-supervise`` writes the clean FASTA; the CLI flags
reach the pipeline with the JAX package's defaults; a data-corruption
spec corrupts the inputs before the run (as the JAX entry point does); and
the port's ``solve_windows`` gives the JAX package's ``NativeLadder.solve``
bytes on the same batches.
"""

import json
import os

import numpy as np
import pytest

from daccord_tpu_torch.tools import cli
from daccord_tpu_torch.tools.eventcheck import validate_events

from _torch_faults_common import make_base, run


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return make_base(str(tmp_path_factory.mktemp("torch_failover")))


def test_native_failover_within_drift(base):
    """``--failover-backend native``: the host library's ladder finishes the
    run; its DP sums in its own order, so its bytes agree within ROADMAP's
    drift bound, not byte for byte."""
    port = run(base, "port", "native_lost", "device_lost:3", audit_rate=0,
               failover_backend="native")
    assert port["stats"].degraded
    assert any(r["event"] == "sup_failover" and r["fallback"] == "native-ladder"
               for r in port["recs"])
    got, ref = _records(port["text"]), _records(base["clean"]["text"])
    same = sum(got.get(n) == s for n, s in ref.items())
    bg, br = sum(map(len, got.values())), sum(map(len, ref.values()))
    assert same >= 0.95 * len(ref) and abs(bg - br) <= 0.005 * br


def test_ledger_and_no_supervise(base):
    """The ledger writes one row per window; ``supervise=False`` runs no
    supervisor and writes the same FASTA."""
    ledger = os.path.join(base["root"], "ledger.jsonl")
    port = run(base, "port", "ledger", None, audit_rate=0, ledger_path=ledger)
    rows = [json.loads(x) for x in open(ledger)]
    assert len(rows) == port["stats"].n_windows
    assert sum(r["solved"] for r in rows) >= port["stats"].n_solved
    assert {r["stream"] for r in rows} <= {"full", "skip"}
    off = run(base, "port", "unsupervised", None, supervise=False)
    assert off["text"] == base["clean"]["text"] and not off["chain"] and not off["done"]


def test_cli_flags_reach_the_pipeline(base, tmp_path, monkeypatch):
    """The supervisor flags of the JAX package's ``daccord``, with its
    defaults."""
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc"))
    out = str(tmp_path / "cli.fasta")
    ev = str(tmp_path / "cli.events.jsonl")
    monkeypatch.setenv("DACCORD_FAULT", "device_lost:2")
    stats, args = cli.daccord_run([base["d"]["db"], base["d"]["las"], "-o", out,
                                   "-E", base["eprof"], "-b", "64", "--device", "cpu",
                                   "--failover-backend", "cpu", "--audit-rate", "0",
                                   "--events", ev, "--native-threads", "2"])
    assert stats.degraded and open(out).read() == base["clean"]["text"]
    assert validate_events(ev, strict=True) == []
    defaults = cli._parser().parse_args(["db", "las"])
    assert (defaults.failover_backend, defaults.audit_rate, defaults.failback,
            defaults.no_supervise, defaults.native_threads) == ("auto", None, False,
                                                                 False, 0)
    monkeypatch.setenv("DACCORD_FAULT", "no_such_kind:1")
    with pytest.raises(SystemExit, match="unknown kind"):
        cli.daccord_run([base["d"]["db"], base["d"]["las"], "-o", out, "--device", "cpu"])


def test_solve_windows_equals_jax(base):
    """The port's copy of the host library's consensus engine gives the JAX
    package's ``NativeLadder.solve`` bytes on the same batches, at the full
    graph and at the device ladder's top-M caps."""
    from daccord_tpu.native.api import NativeLadder as JaxNativeLadder
    from daccord_tpu.oracle.consensus import ConsensusConfig as JaxConsensusConfig
    from daccord_tpu.oracle.consensus import make_offset_likely as jax_make_ol
    from daccord_tpu.oracle.profile import ErrorProfile as JaxErrorProfile
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch
    from daccord_tpu_torch.native.api import NativeLadder, solve_windows_native
    from daccord_tpu_torch.oracle.consensus import ConsensusConfig, make_offset_likely
    from daccord_tpu_torch.oracle.profile import ErrorProfile
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig, iter_pile_blocks

    cfg = PipelineConfig(device="cpu")
    blocks = list(iter_pile_blocks(read_db(base["d"]["db"]), LasFile(base["d"]["las"]), cfg))
    seqs, lens, nsegs = (np.concatenate([b[i] for b in blocks])[:300] for i in (2, 3, 4))
    batch = WindowBatch(seqs=seqs, lens=lens, nsegs=nsegs, shape=BatchShape(),
                        read_ids=np.zeros(len(nsegs), np.int64),
                        wstarts=np.zeros(len(nsegs), np.int64))
    prof = ErrorProfile.load(base["eprof"])
    jprof = JaxErrorProfile.load(base["eprof"])
    for M in (0, 64):
        got = NativeLadder(make_offset_likely(prof, ConsensusConfig()), ConsensusConfig(),
                           max_kmers=M).solve(batch, n_threads=2)
        ref = JaxNativeLadder(jax_make_ol(jprof, JaxConsensusConfig()),
                              JaxConsensusConfig(), max_kmers=M).solve(batch, n_threads=2)
        for k in ("cons", "cons_len", "err", "solved", "tier", "m_ovf"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{k} M={M}")
        assert got["solved"].any()
    one = solve_windows_native(batch, make_offset_likely(prof, ConsensusConfig()),
                               ConsensusConfig(), max_kmers=64)
    assert all(np.array_equal(one[k], got[k]) for k in got)


def test_data_fault_corrupts_the_input_first(base, tmp_path, monkeypatch):
    """``DACCORD_FAULT=las_bitflip:N`` corrupts record N of the LAS before
    the run opens it: the strict policy then exits naming it, and the
    quarantine policy contains exactly that pile."""
    import shutil

    d = dict(base["d"])
    for key in ("db", "las"):
        for f in os.listdir(os.path.dirname(d[key])):
            src = os.path.join(os.path.dirname(d[key]), f)
            if os.path.isfile(src) and not os.path.exists(tmp_path / f):
                shutil.copy(src, tmp_path / f)
        d[key] = str(tmp_path / os.path.basename(d[key]))
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc"))
    monkeypatch.setenv("DACCORD_FAULT", "las_bitflip:5")
    out = str(tmp_path / "q.fasta")
    ev = str(tmp_path / "q.events.jsonl")
    stats, _ = cli.daccord_run([d["db"], d["las"], "-o", out, "-E", base["eprof"],
                                "-b", "64", "--device", "cpu", "--audit-rate", "0",
                                "--ingest-policy", "quarantine", "--events", ev])
    monkeypatch.delenv("DACCORD_FAULT")
    assert stats.n_quarantined == 1 and stats.n_ingest_issues == 1
    assert [json.loads(x)["event"] for x in open(ev)][0] == "ingest.fault"
    rows = [json.loads(x) for x in open(out + ".quarantine.jsonl")]
    assert len(rows) == 1
    with pytest.raises(SystemExit, match="ingest integrity failure"):
        cli.daccord_run([d["db"], d["las"], "-o", out, "-E", base["eprof"], "-b", "64",
                         "--device", "cpu"])


def _records(text: str) -> dict:
    recs, name = {}, None
    for line in text.splitlines():
        if line.startswith(">"):
            name = line[1:]
            recs[name] = ""
        else:
            recs[name] += line
    return recs
