"""The port's checkpointed shard launcher, its merge gate and the integrity
audit (``parallel/launch.py``, ``tools/audit.py``; the ``shard``, ``merge``
and ``audit`` tools) on the CPU, against the JAX package's.

A shard on the native engine writes the JAX package's FASTA byte for byte,
and so do the merged shards. On the port's CPU ladder: a crash between
checkpoints resumes byte-identical to an uninterrupted run (the JAX
package's ``tests/test_parallel.py::test_checkpoint_resume_mid_shard``), as
does an injected crash of a split-ladder run with rescue rows pending
(``tests/test_split_ladder.py::test_split_checkpoint_resume_with_pending_pool``);
a torn manifest or progress file recomputes (``tests/test_ingest.py``). The
merge gate refuses a missing, short, tampered or foreign shard, and the
audit passes a clean directory, re-solves a sample and flags a tampered
FASTA.
"""

import json
import os

import pytest
import torch

from daccord_tpu.parallel import launch as jax_launch
from daccord_tpu.runtime import PipelineConfig as JaxPipelineConfig
from daccord_tpu_torch.parallel import launch
from daccord_tpu_torch.runtime.faults import InjectedCrash
from daccord_tpu_torch.runtime.pipeline import PipelineConfig
from daccord_tpu_torch.sim import SimConfig, make_dataset
from daccord_tpu_torch.tools import audit, cli


@pytest.fixture(autouse=True)
def _two_threads(monkeypatch, tmp_path):
    """Two torch threads (the heavy port test files' cap) and a cold-shape
    registry of the test's own."""
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc"))
    monkeypatch.delenv("DACCORD_FAULT", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The JAX package's checkpoint test set (1.5 kb / 12x, 500-base reads)."""
    d = str(tmp_path_factory.mktemp("torch_launch"))
    return make_dataset(d, SimConfig(genome_len=1500, coverage=12, read_len_mean=500,
                                     min_overlap=250, seed=11), name="ck")


def _cpu(**kw) -> PipelineConfig:
    kw.setdefault("batch_size", 64)
    return PipelineConfig(device="cpu", audit_rate=0, **kw)


def _fasta(outdir: str, shard: int = 0) -> str:
    return open(launch.shard_paths(outdir, shard)["fasta"]).read()


@pytest.fixture(scope="module")
def native_shards(dataset, tmp_path_factory):
    """Both packages' two native-engine shards and their merges."""
    root = str(tmp_path_factory.mktemp("native_shards"))
    got = {}
    for name, mod, cfg in (("port", launch, PipelineConfig(batch_size=64, native_solver=True)),
                           ("jax", jax_launch,
                            JaxPipelineConfig(batch_size=64, native_solver=True))):
        outdir = os.path.join(root, name)
        ms = [mod.run_shard(dataset["db"], dataset["las"], outdir, s, 2, cfg,
                            checkpoint_every=ce) for s, ce in ((0, 0), (1, 3))]
        merged = os.path.join(root, f"{name}.fasta")
        n = mod.merge_shards(outdir, 2, merged)
        got[name] = dict(outdir=outdir, manifests=ms, merged=merged, n=n)
    return got


_COUNTERS = ("shard", "nshards", "byte_range", "reads", "windows", "solved",
             "bases_out", "fragments", "quarantined", "degraded", "fasta_bytes",
             "fasta_sha256")


@pytest.mark.parametrize("shard", [0, 1])
def test_native_shard_writes_the_jax_packages_bytes(native_shards, shard):
    port, jax = native_shards["port"], native_shards["jax"]
    assert _fasta(port["outdir"], shard) == _fasta(jax["outdir"], shard)
    pm, jm = port["manifests"][shard], jax["manifests"][shard]
    assert {k: pm.get(k) for k in _COUNTERS} == {k: jm.get(k) for k in _COUNTERS}
    assert pm["reads"] > 0 and not os.path.exists(
        launch.shard_paths(port["outdir"], shard)["progress"])


def test_merged_shards_equal_the_jax_packages_merge(native_shards):
    port, jax = native_shards["port"], native_shards["jax"]
    assert port["n"] == jax["n"] > 0
    assert open(port["merged"]).read() == open(jax["merged"]).read()
    paths = launch.shard_paths(port["outdir"], 0)
    rollup = json.load(open(paths["metrics"]))
    assert rollup["gauges"]["n_windows"] == port["manifests"][0]["windows"]
    prom = open(paths["metrics"][: -len(".json")] + ".prom").read()
    assert 'daccord_n_windows{shard="0"}' in prom


@pytest.mark.parametrize("shard", [0, 1])
def test_shard_metrics_carry_the_jax_registrys_names(native_shards, shard):
    """Each shard's ``*.metrics.json`` holds the JAX package's registry
    rollup: the same counter, gauge and histogram names, the verdict and the
    wall anchors; its ``.prom`` twin lints clean under both packages'
    ``parse_prom`` and names the same series."""
    from daccord_tpu.utils.obs import parse_prom as jax_parse_prom
    from daccord_tpu_torch.utils.obs import parse_prom

    rolls, proms = {}, {}
    for name in ("port", "jax"):
        path = launch.shard_paths(native_shards[name]["outdir"], shard)["metrics"]
        rolls[name] = json.load(open(path))
        proms[name] = open(path[: -len(".json")] + ".prom").read()
    port, jax = rolls["port"], rolls["jax"]
    for key in ("counters", "gauges", "hists"):
        assert sorted(port[key]) == sorted(jax[key]), key
    assert set(port) == set(jax)
    assert port["verdict"] in ("host_feeder", "device", "io", "balanced")
    assert port["host_s"] is not None and port["device_s"] is not None
    for parse in (parse_prom, jax_parse_prom):
        samples, errs = parse(proms["port"])
        assert errs == []
        assert sorted(samples) == sorted(parse(proms["jax"])[0])


def test_rerun_returns_the_manifest_without_recomputing(native_shards, dataset, monkeypatch):
    port = native_shards["port"]

    def boom(*a, **kw):
        raise AssertionError("recomputed")

    monkeypatch.setattr(launch, "correct_to_fasta", boom)
    m = launch.run_shard(dataset["db"], dataset["las"], port["outdir"], 0, 2)
    assert m == port["manifests"][0]


def test_crash_between_checkpoints_resumes_byte_identical(dataset, tmp_path, monkeypatch):
    ref_dir = str(tmp_path / "ref")
    m_ref = launch.run_shard(dataset["db"], dataset["las"], ref_dir, 0, 1, _cpu(),
                             checkpoint_every=3)
    assert m_ref["reads"] >= 8, m_ref
    crash_dir = str(tmp_path / "crash")
    real = launch.correct_shard

    def crashing(db, las, c, start=None, end=None, **kw):
        for i, item in enumerate(real(db, las, c, start, end, **kw)):
            if i == 5:
                raise RuntimeError("injected crash")
            yield item

    monkeypatch.setattr(launch, "correct_shard", crashing)
    with pytest.raises(RuntimeError, match="injected crash"):
        launch.run_shard(dataset["db"], dataset["las"], crash_dir, 0, 1, _cpu(),
                         checkpoint_every=2)
    prog_path = launch.shard_paths(crash_dir, 0)["progress"]
    prog = json.load(open(prog_path))
    assert prog["emitted"] == 4 and len(prog["profile"]) == 6
    monkeypatch.setattr(launch, "correct_shard", real)
    m = launch.run_shard(dataset["db"], dataset["las"], crash_dir, 0, 1, _cpu(),
                         checkpoint_every=2)
    assert m["resumed_at_read"] == 4 and m["reads"] == m_ref["reads"]
    assert _fasta(crash_dir) == _fasta(ref_dir)
    assert not os.path.exists(prog_path)


def test_hp_resume_writes_the_uninterrupted_runs_bytes(tmp_path, monkeypatch):
    """A crash and resume of a shard with the homopolymer rescue (the
    posterior vote and the likelihood accept, which read the profile's hp
    model) on an hp set writes the uninterrupted run's bytes: the progress
    file keeps all six ``ErrorProfile`` fields. Not held against the JAX
    package: its progress file keeps three (``p_ins``, ``p_del``, ``p_sub``;
    JAX ``launch.py``), so a JAX shard resumed with the rescue falls back to
    ``hp_slope`` 0 and writes other bytes than its uninterrupted run."""
    from daccord_tpu_torch.oracle.consensus import ConsensusConfig

    out = make_dataset(str(tmp_path / "d"), SimConfig(genome_len=2000, coverage=14,
                                                      read_len_mean=600, min_overlap=250,
                                                      hp_indel_slope=1.0, seed=31),
                       name="hp")

    def cfg():
        return PipelineConfig(batch_size=64, native_solver=True, consensus=ConsensusConfig(
            hp_rescue=True, hp_vote="posterior", hp_accept="likelihood"))

    ref_dir = str(tmp_path / "ref")
    m_ref = launch.run_shard(out["db"], out["las"], ref_dir, 0, 1, cfg(), checkpoint_every=3)
    crash_dir = str(tmp_path / "crash")
    real = launch.correct_shard

    def crashing(db, las, c, start=None, end=None, **kw):
        for i, item in enumerate(real(db, las, c, start, end, **kw)):
            if i == 7:
                raise RuntimeError("injected crash")
            yield item

    monkeypatch.setattr(launch, "correct_shard", crashing)
    with pytest.raises(RuntimeError, match="injected crash"):
        launch.run_shard(out["db"], out["las"], crash_dir, 0, 1, cfg(), checkpoint_every=3)
    prog = json.load(open(launch.shard_paths(crash_dir, 0)["progress"]))
    assert prog["emitted"] == 6 and len(prog["profile"]) == 6
    assert prog["profile"][3] >= 0.1      # the hp slope: the posterior engages
    monkeypatch.setattr(launch, "correct_shard", real)
    m = launch.run_shard(out["db"], out["las"], crash_dir, 0, 1, cfg(), checkpoint_every=3)
    assert m["resumed_at_read"] == 6 and m["reads"] == m_ref["reads"]
    assert _fasta(crash_dir) == _fasta(ref_dir)


def test_split_crash_with_a_pending_rescue_pool_resumes_byte_identical(tmp_path,
                                                                        monkeypatch):
    """An injected crash (``crash:N``, the port's ``InjectedCrash``) lands
    while the split ladder's rescue pool holds rows (read from the crashed
    run's own ``batch`` events); the resumed shard writes the uninterrupted
    run's bytes."""
    out = make_dataset(str(tmp_path / "d"), SimConfig(genome_len=2500, coverage=20,
                                                      read_len_mean=700, min_overlap=300,
                                                      seed=23), name="c2")

    def cfg(log=None):
        return _cpu(ladder_mode="split", rescue_flush_reads=24, bucket_flush_reads=4,
                    depth_buckets=(), log_path=log)

    ref_dir = str(tmp_path / "ref")
    m_ref = launch.run_shard(out["db"], out["las"], ref_dir, 0, 1, cfg(), checkpoint_every=2)
    assert not m_ref.get("degraded")
    crash_dir = str(tmp_path / "crash")
    log = str(tmp_path / "crash.log.jsonl")
    monkeypatch.setenv("DACCORD_FAULT", "crash:61")
    with pytest.raises(InjectedCrash):
        launch.run_shard(out["db"], out["las"], crash_dir, 0, 1, cfg(log),
                         checkpoint_every=2)
    paths = launch.shard_paths(crash_dir, 0)
    assert os.path.exists(paths["progress"]) and not os.path.exists(paths["manifest"])
    batches = [json.loads(x) for x in open(log) if '"event": "batch"' in x]
    assert batches and batches[-1]["pool"] > 0
    monkeypatch.delenv("DACCORD_FAULT")
    m = launch.run_shard(out["db"], out["las"], crash_dir, 0, 1, cfg(), checkpoint_every=2)
    assert m["resumed_at_read"] > 0
    assert _fasta(crash_dir) == _fasta(ref_dir)


@pytest.mark.parametrize("torn", ["manifest", "progress"])
def test_a_torn_manifest_recomputes(dataset, tmp_path, torn):
    cfg = PipelineConfig(batch_size=64, native_solver=True)
    ref_dir = str(tmp_path / "ref")
    m0 = launch.run_shard(dataset["db"], dataset["las"], ref_dir, 0, 1, cfg,
                          checkpoint_every=3)
    sdir = str(tmp_path / "s")
    os.makedirs(sdir)
    paths = launch.shard_paths(sdir, 0)
    if torn == "manifest":
        open(paths["manifest"], "wt").write('{"shard": 0, "rea')
        open(paths["fasta"], "wt").write(">read9999/0\nACGT\n")
    else:
        open(paths["fasta"], "wt").write(">read9999/0\nACGT\n")   # untrusted tail
        open(paths["progress"], "wt").write('{"emitted": 3, "fasta_by')
    m1 = launch.run_shard(dataset["db"], dataset["las"], sdir, 0, 1, cfg, checkpoint_every=3)
    assert "resumed_at_read" not in m1 and m1["reads"] == m0["reads"]
    assert json.load(open(paths["manifest"]))["reads"] == m0["reads"]
    assert _fasta(sdir) == _fasta(ref_dir)


def _damage(outdir: str, how: str) -> None:
    paths = launch.shard_paths(outdir, 1)
    if how == "missing":
        os.remove(paths["manifest"])
    elif how == "short":
        data = open(paths["fasta"]).read()
        open(paths["fasta"], "wt").write(data[: len(data) // 2])
    elif how == "tampered":
        data = open(paths["fasta"]).read()
        i = data.index("\n") + 1
        flip = {"A": "C", "C": "G", "G": "T", "T": "A"}[data[i]]
        open(paths["fasta"], "wt").write(data[:i] + flip + data[i + 1:])
    else:  # a manifest written for another split
        m = json.load(open(paths["manifest"]))
        m["nshards"] = 3
        json.dump(m, open(paths["manifest"], "wt"))


@pytest.mark.parametrize("how", ["missing", "short", "tampered", "foreign"])
def test_merge_and_audit_refuse_a_damaged_shard(native_shards, tmp_path, how):
    import shutil

    outdir = str(tmp_path / "shards")
    shutil.copytree(native_shards["port"]["outdir"], outdir)
    report, n = audit.audit_outdir(outdir, nshards=2, quiet=True)
    assert n == 2 and all(r["ok"] for r in report)
    _damage(outdir, how)
    with pytest.raises(launch.MergeGateError):
        launch.merge_shards(outdir, 2, str(tmp_path / "m.fasta"))
    assert not os.path.exists(tmp_path / "m.fasta")
    with pytest.raises(SystemExit, match="refusing to merge"):
        cli.main(["merge", outdir, "2", str(tmp_path / "m.fasta")])
    if how != "foreign":
        report, _ = audit.audit_outdir(outdir, nshards=2, quiet=True)
        assert [r["check"] for r in report if not r["ok"]] == ["shard 1"]
        assert cli.main(["audit", outdir, "--nshards", "2"]) == 1


def test_cli_shard_merge_audit_on_the_cpu(dataset, tmp_path, capsys):
    """The three tools from the command line on the port's CPU ladder; the
    audit re-solves the first piles of shard 0 and finds the committed
    bytes."""
    outdir = str(tmp_path / "out")
    for j in ("0,2", "1,2"):
        assert cli.main(["shard", dataset["db"], dataset["las"], outdir, "-J", j,
                         "--device", "cpu", "-b", "64", "--audit-rate", "0",
                         "--checkpoint-every", "4"]) == 0
    m = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert m["shard"] == 1 and m["fasta_sha256"]
    assert os.path.exists(launch.shard_paths(outdir, 0)["ledger"])
    merged = str(tmp_path / "all.fasta")
    assert cli.main(["merge", outdir, "2", merged]) == 0
    assert f"merged {m['fragments'] + json.load(open(launch.shard_paths(outdir, 0)['manifest']))['fragments']} fragments" \
        in capsys.readouterr().err
    assert cli.main(["audit", outdir, "--db", dataset["db"], "--las", dataset["las"],
                     "--resolve", "3", "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["failed"] == 0 and rep["audited"] == 2
    assert any(c["check"] == "resolve shard 0" for c in rep["checks"])
    assert cli.main(["audit", str(tmp_path / "nothing")]) == 2
    with pytest.raises(SystemExit):
        cli.main(["shard", dataset["db"], dataset["las"], outdir, "-J", "2,2",
                  "--device", "cpu"])


@pytest.fixture
def io_plan():
    from daccord_tpu_torch.utils import aio

    yield aio
    aio.install_faults(None)


@pytest.mark.parametrize("case", ["short_write", "transient_eio", "fsync_fail",
                                  "exclusive_create", "fsync_dir"])
def test_durable_primitives_under_injected_storage_faults(io_plan, tmp_path, case):
    """The JAX package's ``tests/test_diskfaults.py`` cases on the port's
    ``utils/aio.py``: a torn or failed commit publishes nothing and leaves
    no tmp, a transient EIO is retried, a claim's wreckage is unlinked, a
    directory fsync absorbs its fault."""
    import errno

    from daccord_tpu_torch.runtime.faults import FaultPlan

    aio, dst = io_plan, str(tmp_path / "m.json")
    if case == "short_write":
        aio.install_faults(FaultPlan.parse("io_short_write:1@manifest"))
        with pytest.raises(OSError) as ei:
            aio.durable_write(dst, lambda fh: fh.write(b"y" * 128), domain="manifest")
        assert ei.value.errno == errno.ENOSPC and not os.listdir(tmp_path)
    elif case == "transient_eio":
        aio.install_faults(FaultPlan.parse("io_eio:1@manifest"))
        aio.durable_write(dst, lambda fh: fh.write(b"ok"), domain="manifest")
        assert open(dst, "rb").read() == b"ok" and os.listdir(tmp_path) == ["m.json"]
    elif case == "fsync_fail":
        aio.install_faults(FaultPlan.parse("io_fsync_fail:1@manifest"))
        with pytest.raises(OSError) as ei:
            aio.durable_write(dst, lambda fh: fh.write(b"z"), domain="manifest")
        assert getattr(ei.value, "fault_kind", None) == "io_fsync_fail"
        assert not os.path.exists(dst)
    elif case == "exclusive_create":
        p = str(tmp_path / "j.lease")
        aio.install_faults(FaultPlan.parse("io_enospc:1@lease"))
        with pytest.raises(OSError):
            aio.exclusive_create(p, b'{"host": "me"}', domain="lease")
        assert not os.path.exists(p)
        assert aio.exclusive_create(p, b'{"host": "me"}', domain="lease")
        assert not aio.exclusive_create(p, b"{}", domain="lease")
        aio.install_faults(FaultPlan.parse("io_eio:1@lease"))
        assert aio.exclusive_create(str(tmp_path / "k.lease"), b"{}", domain="lease")
    else:
        aio.install_faults(FaultPlan.parse("io_eio:1@manifest"))
        aio.fsync_dir(dst, domain="manifest")           # absorbed, as a real one is
        assert aio.exists(str(tmp_path)) and not aio.exists(dst)


def test_a_refused_manifest_commit_leaves_no_manifest(dataset, tmp_path, io_plan):
    """``io_enospc`` on the manifest commit fails the shard with nothing
    published; the rerun, on a healthy disk, commits."""
    from daccord_tpu_torch.runtime.faults import FaultPlan

    cfg = PipelineConfig(batch_size=64, native_solver=True)
    sdir = str(tmp_path / "s")
    io_plan.install_faults(FaultPlan.parse("io_enospc:1@manifest"))
    with pytest.raises(OSError):
        launch.run_shard(dataset["db"], dataset["las"], sdir, 0, 1, cfg)
    paths = launch.shard_paths(sdir, 0)
    assert not os.path.exists(paths["manifest"])
    assert not [f for f in os.listdir(sdir) if ".tmp." in f]
    io_plan.install_faults(None)
    m = launch.run_shard(dataset["db"], dataset["las"], sdir, 0, 1, cfg)
    assert launch.load_shard_manifest(sdir, 0) == (m, None)
