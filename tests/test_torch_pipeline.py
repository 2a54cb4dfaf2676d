"""The port's default ``daccord`` run on the CPU: the in-flight deque, the
dense depth buckets, quarantine, the monster-pile guard and byte-range
shards, held against the JAX package's run on the same data and profile.

Bounds: runs of the port that differ only in how batches are grouped or
queued (``max_inflight``, ``-J`` shards) write byte-identical FASTA; the
port against the JAX package is held to ROADMAP's drift bound (at most 0.5%
of windows differ, corrected bases within 0.5%, at least 95% of records
byte-identical), since the f32 ``W = occ @ OL.T`` reduction order differs
between XLA and torch. Bucket routing and the monster guard's choice of
piles are exact.
"""

import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from daccord_tpu.formats.dazzdb import read_db as jax_read_db
from daccord_tpu.formats.las import LasFile as JaxLasFile
from daccord_tpu.kernels import tiers as jax_tiers
from daccord_tpu.oracle.profile import ErrorProfile as JaxErrorProfile
from daccord_tpu.runtime import faults
from daccord_tpu.runtime import pipeline as jax_pipeline
from daccord_tpu_torch.formats.dazzdb import read_db
from daccord_tpu_torch.formats.fasta import read_fasta
from daccord_tpu_torch.formats.las import LasFile
from daccord_tpu_torch.kernels import tiers
from daccord_tpu_torch.oracle.profile import ErrorProfile
from daccord_tpu_torch.runtime import pipeline
from daccord_tpu_torch.runtime.pipeline import PipelineConfig, correct_to_fasta
from daccord_tpu_torch.sim import SimConfig, make_dataset
from daccord_tpu_torch.tools import cli

B = 64      # small batches, so one run queues many ladder calls


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """A torch thread pool the size of the machine in each test worker
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _record(sink: dict, batch, out: dict) -> None:
    """(read, window start) -> (bucket depth, consensus bytes or None)."""
    for i in range(batch.size):
        if batch.read_ids[i] < 0 or batch.nsegs[i] == 0:
            continue
        seq = (bytes(np.asarray(out["cons"][i][: out["cons_len"][i]]))
               if out["solved"][i] else None)
        sink[(int(batch.read_ids[i]), int(batch.wstarts[i]))] = (
            int(batch.shape.depth), seq)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The dataset (depth up to 32, so all three dense buckets fill), one
    profile for every run, and the port's run at max_inflight=1 with every
    window it solved."""
    root = str(tmp_path_factory.mktemp("torch_pipeline"))
    d = make_dataset(root, SimConfig(genome_len=1000, coverage=20, read_len_mean=500,
                                     min_overlap=200, seed=7), name="t")
    cfg = PipelineConfig(device="cpu", batch_size=B, max_inflight=1)
    eprof = os.path.join(root, "eprof.json")
    pipeline.estimate_profile_for_shard(read_db(d["db"]), LasFile(d["las"]), cfg).save(eprof)
    windows: dict = {}
    real, real_one = pipeline.fetch_many, pipeline.fetch

    def capture(handles):
        outs = real(handles)
        for h, out in zip(handles, outs):
            _record(windows, h.batch, out)
        return outs

    def capture_one(h):
        # the supervisor fetches a drain of one call alone
        return capture([h])[0]

    out = os.path.join(root, "inflight1.fasta")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "fetch_many", capture)
        mp.setattr(pipeline, "fetch", capture_one)
        stats = correct_to_fasta(d["db"], d["las"], out, cfg,
                                 profile=ErrorProfile.load(eprof))
    return dict(d=d, root=root, eprof=eprof, cfg=cfg, out=out, stats=stats,
                windows=windows)


def _text(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def _records(path: str) -> dict:
    return {r.name: r.seq for r in read_fasta(path)}


def test_defaults_equal_jax():
    port, ref = PipelineConfig(), jax_pipeline.PipelineConfig()
    for f in ("max_inflight", "depth_buckets", "seg_len_buckets", "ingest_policy",
              "max_pile_overlaps", "bucket_flush_reads", "depth", "seg_len",
              "max_kmers", "rescue_max_kmers", "overflow_rescue",
              "profile_sample_piles", "end_trim", "paged", "page_len", "qv_track"):
        assert getattr(port, f) == getattr(ref, f), f


@pytest.mark.parametrize("max_inflight", [2, 8])
def test_max_inflight_gives_identical_fasta(max_inflight, base):
    """The deque on the dispatcher thread: the same batches, the same bytes
    as solving each batch on the pipeline's thread."""
    out = os.path.join(base["root"], f"inflight{max_inflight}.fasta")
    cfg = PipelineConfig(device="cpu", batch_size=B, max_inflight=max_inflight)
    st = correct_to_fasta(base["d"]["db"], base["d"]["las"], out, cfg,
                          profile=ErrorProfile.load(base["eprof"]))
    ref = base["stats"]
    assert _text(out) == _text(base["out"]) and ref.n_solved > 0
    assert st.n_batches == ref.n_batches > 2 * max_inflight
    assert st.batches_by_bucket == ref.batches_by_bucket
    assert st.peak_inflight == max_inflight and ref.peak_inflight == 1
    assert set(st.stage_profile["stages"]) >= {"decode", "rank", "realign"}
    assert not [t for t in threading.enumerate() if t.name == "ladder-dispatcher"]


def test_dispatcher_error_reraises_from_fetch(base, monkeypatch):
    """A failing ladder call re-raises at ``fetch``, and out of the run: no
    retry, no other solver."""
    class Boom(RuntimeError):
        pass

    def boom(batch, ladder, *args):
        raise Boom("ladder call failed")

    monkeypatch.setattr(tiers, "_ladder_packed", boom)
    lad = tiers.TierLadder.from_config(ErrorProfile.load(base["eprof"]),
                                       PipelineConfig().consensus, device="cpu")
    with tiers.LadderDispatcher("cpu") as disp:
        h = tiers.solve_ladder_async(None, lad, disp)
        with pytest.raises(Boom):
            tiers.fetch(h)
    # unsupervised: the supervisor would retry the call and then fail over
    # (tests/test_torch_supervisor.py)
    with pytest.raises(Boom):
        correct_to_fasta(base["d"]["db"], base["d"]["las"],
                         os.path.join(base["root"], "boom.fasta"),
                         PipelineConfig(device="cpu", batch_size=B, supervise=False),
                         profile=ErrorProfile.load(base["eprof"]))
    assert not [t for t in threading.enumerate() if t.name == "ladder-dispatcher"]


@pytest.fixture(scope="module")
def jax_run(base, tmp_path_factory):
    """The JAX package's default run (depth buckets (8, 16)) on the same
    data and profile, with every window it solved."""
    windows: dict = {}
    real = jax_tiers.solve_tiered

    def capture(batch, ladder, *a, **kw):
        out = real(batch, ladder, *a, **kw)
        _record(windows, batch, out)
        return out

    out = str(tmp_path_factory.mktemp("jax_pipeline") / "jax.fasta")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tiers, "solve_tiered", capture)
        stats = jax_pipeline.correct_to_fasta(
            base["d"]["db"], base["d"]["las"], out,
            jax_pipeline.PipelineConfig(audit_rate=0, batch_size=B),
            profile=JaxErrorProfile.load(base["eprof"]))
    return dict(out=out, stats=stats, windows=windows)


def test_bucket_routing_equals_jax(base, jax_run):
    port = {k: v[0] for k, v in base["windows"].items()}
    ref = {k: v[0] for k, v in jax_run["windows"].items()}
    assert port == ref
    assert set(port.values()) == {8, 16, 32}
    assert set(base["stats"].batches_by_bucket) == {"D8xL64", "D16xL64", "D32xL64"}


def test_bucketed_run_within_drift_of_jax(base, jax_run):
    ps, js = base["stats"], jax_run["stats"]
    pw, jw = base["windows"], jax_run["windows"]
    assert ps.n_windows == js.n_windows and ps.n_skipped_shallow == js.n_skipped_shallow
    n_diff = sum(pw[k][1] != jw[k][1] for k in jw)
    jrec, prec = _records(jax_run["out"]), _records(base["out"])
    same = sum(prec.get(n) == s for n, s in jrec.items())
    print(f"bucketed port vs bucketed JAX: windows differing {n_diff}/{len(jw)}, "
          f"bases {ps.bases_out} / {js.bases_out}, identical records "
          f"{same}/{len(jrec)}")
    assert set(pw) == set(jw)
    assert n_diff <= 0.005 * len(jw)
    assert abs(ps.bases_out - js.bases_out) <= 0.005 * js.bases_out
    assert same >= 0.95 * len(jrec) and abs(len(prec) - len(jrec)) <= 0.05 * len(jrec)


def _corrupt_copy(base, tmp_path) -> tuple[str, dict, dict]:
    """A copy of the LAS with one record's coordinates bit-flipped and
    another record's tlen made absurd."""
    p = str(tmp_path / "corrupt.las")
    shutil.copy(base["d"]["las"], p)
    novl = JaxLasFile(p).novl
    a = faults.corrupt_las_bitflip(p, 5)
    b = faults.corrupt_las_bitflip(p, novl - 40, field="tlen", bit=30)
    return p, a, b


def _sidecar(path: str) -> list[tuple]:
    with open(path) as fh:
        return [(r["aread"], r["offset"], r["kind"], r["detail"])
                for r in map(json.loads, fh)]


def test_quarantine_run_matches_jax(base, tmp_path):
    p, _, _ = _corrupt_copy(base, tmp_path)
    outs, stats = {}, {}
    for name, run, cfg, prof in (
            ("port", correct_to_fasta,
             PipelineConfig(device="cpu", batch_size=B, ingest_policy="quarantine"),
             ErrorProfile.load(base["eprof"])),
            ("jax", jax_pipeline.correct_to_fasta,
             jax_pipeline.PipelineConfig(audit_rate=0, batch_size=B,
                                         ingest_policy="quarantine"),
             JaxErrorProfile.load(base["eprof"]))):
        outs[name] = str(tmp_path / f"{name}.fasta")
        stats[name] = run(base["d"]["db"], p, outs[name], cfg, profile=prof)
    ps, js = stats["port"], stats["jax"]
    assert ps.n_quarantined == js.n_quarantined == 2
    assert ps.n_ingest_issues == js.n_ingest_issues == 2
    rows = _sidecar(outs["port"] + ".quarantine.jsonl")
    assert rows == _sidecar(outs["jax"] + ".quarantine.jsonl")
    assert [r[2] for r in rows] == ["bad_coords", "truncation"]   # tlen past EOF
    db = read_db(base["d"]["db"])
    got, ref, clean = _records(outs["port"]), _records(outs["jax"]), _records(base["out"])
    quarantined = {r[0] for r in rows}
    for rid in quarantined:     # emitted uncorrected, in one piece
        raw = "".join("ACGT"[b] for b in db.read_bases(rid))
        assert got[f"read{rid}/0"] == ref[f"read{rid}/0"] == raw
        assert f"read{rid}/1" not in got
    others = {n: s for n, s in clean.items()
              if int(n[4:].split("/")[0]) not in quarantined}
    same_clean = sum(got.get(n) == s for n, s in others.items())
    same_jax = sum(got.get(n) == s for n, s in ref.items())
    print(f"quarantine run: {same_clean}/{len(others)} other records equal to the "
          f"clean run's, {same_jax}/{len(ref)} equal to JAX's quarantine run")
    assert same_clean >= 0.95 * len(others)
    assert same_jax >= 0.95 * len(ref)


@pytest.mark.parametrize("feeder", ["native", "threaded", "numpy"])
def test_monster_guard_contains_same_piles_as_jax(feeder, base):
    """The guard asked before windowing, with the budget one below the
    deepest pile: the same piles become markers in both packages' feeders."""
    db, las = read_db(base["d"]["db"]), LasFile(base["d"]["las"])
    jdb, jlas = jax_read_db(base["d"]["db"]), JaxLasFile(base["d"]["las"])
    sizes = np.bincount(np.fromiter((o.aread for o in las), np.int64))
    budget = int(sizes.max()) - 1
    guard = lambda aread, n: n > budget
    cfg = PipelineConfig(device="cpu", use_native=feeder != "numpy")
    jcfg = jax_pipeline.PipelineConfig()
    if feeder == "threaded":
        port = pipeline.iter_pile_blocks_threaded(db, las, cfg, 3, monster=guard)
        ref = jax_pipeline._iter_pile_blocks_threaded(jdb, jlas, jcfg, None, None, 3,
                                                       monster=guard)
    else:
        port = pipeline.iter_pile_blocks(db, las, cfg, monster=guard)
        ref = jax_pipeline._iter_pile_blocks(jdb, jlas, jcfg, None, None,
                                             feeder == "native", monster=guard)
    got, want = [], []
    for p, r in zip(port, ref):
        assert (p[0] == "quarantine") == (r[0] == "quarantine")
        if p[0] == "quarantine":
            got.append(p)
            want.append(r)
        else:
            assert p[0] == r[0] and np.array_equal(p[4], r[4])
    assert got == want and [g[1] for g in got] == list(np.nonzero(sizes > budget)[0])


def test_monster_guard_run(base, tmp_path):
    """A run with the budget one below the deepest pile contains the deepest
    piles only: each read is emitted uncorrected with one sidecar row, every
    other read is the unguarded run's."""
    sizes = np.bincount(np.fromiter((o.aread for o in LasFile(base["d"]["las"])),
                                    np.int64))
    deepest = [int(a) for a in np.nonzero(sizes == sizes.max())[0]]
    out = str(tmp_path / "monster.fasta")
    side = str(tmp_path / "monster.jsonl")
    st = correct_to_fasta(base["d"]["db"], base["d"]["las"], out,
                          PipelineConfig(device="cpu", batch_size=B,
                                         max_pile_overlaps=int(sizes.max()) - 1,
                                         quarantine_path=side),
                          profile=ErrorProfile.load(base["eprof"]))
    assert st.n_monster_piles == st.n_quarantined == len(deepest)
    rows = _sidecar(side)
    assert [r[0] for r in rows] == deepest
    assert {r[2] for r in rows} == {"monster_pile"}
    got, ref = _records(out), _records(base["out"])
    db = read_db(base["d"]["db"])
    for rid in deepest:
        assert got[f"read{rid}/0"] == "".join("ACGT"[b] for b in db.read_bases(rid))
    keep = lambda recs: {n: s for n, s in recs.items()
                         if int(n[4:].split("/")[0]) not in deepest}
    assert keep(got) == keep(ref) and len(keep(got)) > 0


def test_sharded_runs_concatenate_to_the_whole(base, tmp_path):
    """``-J 0,3``, ``-J 1,3``, ``-J 2,3`` with the run's ``-E`` profile:
    their FASTA, concatenated, is the unsharded run's, byte for byte."""
    parts = []
    for i in range(3):
        out = str(tmp_path / f"shard{i}.fasta")
        assert cli.main(["daccord", base["d"]["db"], base["d"]["las"], "-o", out,
                         "-E", base["eprof"], "-b", str(B), "--device", "cpu",
                         "-J", f"{i},3"]) == 0
        parts.append(_text(out))
    assert all(parts) and "".join(parts) == _text(base["out"])


def test_strict_cli_exits_with_the_structured_report(base, tmp_path):
    p, a, b = _corrupt_copy(base, tmp_path)
    off_a = a["offset"] - faults.LAS_FIELD_OFF["abpos"]
    off_b = b["offset"] - faults.LAS_FIELD_OFF["tlen"]
    for extra in ([], ["-E", str(tmp_path / "new_eprof.json")]):
        with pytest.raises(SystemExit) as ei:
            cli.main(["daccord", base["d"]["db"], p, "-o", str(tmp_path / "s.fasta"),
                      "-b", str(B), "--device", "cpu", *extra])
        msg = str(ei.value.code)
        assert msg.startswith("daccord: ingest integrity failure (2 issues)")
        assert f"offset={off_a}" in msg and f"offset={off_b}" in msg
        assert "[bad_coords]" in msg and "[truncation]" in msg
        assert msg.count("pile aread=") == 2 and "--ingest-policy quarantine" in msg
    assert not os.path.exists(tmp_path / "s.fasta")
    for bad, why in ((["-k", "3"], "supported range"), (["-J", "0,2", "--block", "1"],
                                                         "mutually exclusive"),
                     (["-M", "0"], "positive top-M"), (["-J", "3,3"], "bad -J"),
                     (["--block", "2"], "blocks"), (["--max-inflight", "0"], "at least 1")):
        with pytest.raises(SystemExit, match=why):
            cli.main(["daccord", base["d"]["db"], base["d"]["las"], "--device", "cpu",
                      *bad])


def test_stage_profile_equals_jax():
    """The port's copy of ``StageProfile`` books and summarises as JAX's."""
    from daccord_tpu.utils.obs import StageProfile as JaxStageProfile
    from daccord_tpu_torch.utils.obs import StageProfile

    profs = [StageProfile(threads=3), JaxStageProfile(threads=3)]
    for p in profs:
        for stage, wall in (("decode", 0.25), ("realign", 1.5), ("decode", 0.125)):
            p.add(stage, wall)
        p.add("rank", 0.5, calls=4)
        with p.timed("kmer"):
            pass
    port, ref = profs
    assert port.summary()["threads"] == ref.summary()["threads"] == 3
    for name in ("decode", "realign", "rank"):
        assert port.summary()["stages"][name] == ref.summary()["stages"][name]
        assert port.wall(name) == ref.wall(name)
    assert port.summary()["stages"]["kmer"]["calls"] == 1
    assert port.dominant() == ref.dominant() == ("realign", 1.5)
    assert port.total() >= 2.375 and StageProfile().dominant() == (None, 0.0)
