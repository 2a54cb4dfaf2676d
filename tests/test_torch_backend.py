"""``--backend native`` (the host library's tier ladder as the primary
engine, with the homopolymer rescue inside the engine) and ``--mode patch``
against the JAX package, and the CLI's backend rules, on the CPU; on a card,
the hp rescue's FASTA against the CPU ladder's.

The native engine is a copy of the JAX package's, so its FASTA is
byte-identical to the JAX package's ``--backend native``, with the hp rescue
(the default there), without it and at ``-M 0`` (the full graph); so is
``--mode patch`` on it. On the port's CPU ladder ``--mode patch`` is held to
ROADMAP's drift bound of the JAX package's CPU ladder (on this set it is
byte-identical too). The JAX package is imported inside the tests, so the
file collects where JAX is not installed:

    python -m pytest tests/test_torch_backend.py -m cuda -q --noconftest
"""

import functools
import os

import pytest
import torch

from daccord_tpu_torch.formats.fasta import read_fasta
from daccord_tpu_torch.runtime.pipeline import PipelineStats
from daccord_tpu_torch.sim import SimConfig, make_dataset
from daccord_tpu_torch.tools import cli


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The tier-1 run puts several test files side by side on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _hp_set(root: str) -> dict:
    """The JAX package's hp end-to-end set (an hp indel slope of 1.0)."""
    return make_dataset(root, SimConfig(genome_len=4000, coverage=18, read_len_mean=900,
                                        min_overlap=300, hp_indel_slope=1.0, seed=31),
                        name="hp")


@pytest.fixture(scope="module")
def hp_set(tmp_path_factory):
    return _hp_set(str(tmp_path_factory.mktemp("backend")))


def _port(d: dict, out: str, *extra):
    stats, _ = cli.daccord_run([d["db"], d["las"], "-o", out, "-b", "256", *extra])
    return stats


def _jax(d: dict, out: str, profile=None, device_ladder: bool = False, max_kmers: int = 64,
         **consensus):
    """The JAX package's run with the configuration its ``daccord`` builds
    for ``--backend native`` (or, with ``device_ladder``, ``--backend cpu``)."""
    from daccord_tpu.oracle.consensus import ConsensusConfig as JaxConsensusConfig
    from daccord_tpu.runtime.pipeline import PipelineConfig as JaxPipelineConfig
    from daccord_tpu.runtime.pipeline import correct_to_fasta as jax_correct_to_fasta

    cfg = JaxPipelineConfig(batch_size=256, native_solver=not device_ladder,
                            max_kmers=max_kmers, audit_rate=0,
                            consensus=JaxConsensusConfig(**consensus))
    return jax_correct_to_fasta(d["db"], d["las"], out, cfg, profile=profile)


def _bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("extra,jax_kw", [
    ((), dict(hp_rescue=True)),
    (("--no-hp-rescue",), dict(hp_rescue=False)),
    (("-M", "0"), dict(hp_rescue=True, max_kmers=0)),
], ids=["default-hp", "no-hp", "full-graph"])
def test_native_primary_equals_jax(hp_set, tmp_path, extra, jax_kw):
    ours, theirs = str(tmp_path / "port.fasta"), str(tmp_path / "jax.fasta")
    ps = _port(hp_set, ours, "--backend", "native", *extra)
    js = _jax(hp_set, theirs, **jax_kw)
    assert _bytes(ours) == _bytes(theirs) and len(_bytes(ours)) > 0
    assert ps.n_hp_rescued == js.n_hp_rescued
    assert (ps.n_hp_rescued > 0) == jax_kw["hp_rescue"]
    assert ps.n_solved == js.n_solved and ps.tier_histogram == js.tier_histogram
    assert ps.hp_wall_s == 0.0 and not ps.degraded


def test_native_primary_python_hp_loop_writes_the_same_bytes(hp_set, tmp_path):
    """Under ``--no-native`` the piles window in numpy and the hp rescue runs
    in the python loop after each solve: the same FASTA."""
    a, b = str(tmp_path / "engine.fasta"), str(tmp_path / "loop.fasta")
    sa = _port(hp_set, a, "--backend", "native")
    sb = _port(hp_set, b, "--backend", "native", "--no-native")
    assert _bytes(a) == _bytes(b)
    assert sa.n_hp_rescued == sb.n_hp_rescued > 0 and sb.hp_wall_s > 0


def test_patch_mode_native_equals_jax(hp_set, tmp_path):
    ours, theirs = str(tmp_path / "port.fasta"), str(tmp_path / "jax.fasta")
    split = str(tmp_path / "split.fasta")
    ps = _port(hp_set, ours, "--backend", "native", "--mode", "patch")
    _jax(hp_set, theirs, hp_rescue=True, mode="patch")
    assert _bytes(ours) == _bytes(theirs)
    _port(hp_set, split, "--backend", "native")
    # patch keeps the read's bases where a window is unsolved, so fewer
    # records (a read splits only where a stitch fails), no end-trim, and
    # every read of the split run is there
    patch, whole = list(read_fasta(ours)), list(read_fasta(split))
    assert len(patch) < len(whole) and ps.n_end_trimmed == 0
    assert {r.name.split("/")[0] for r in whole} <= {r.name.split("/")[0] for r in patch}


def test_patch_mode_cpu_ladder_within_drift_of_jax(tmp_path):
    """``--mode patch`` on the port's CPU ladder against the JAX package's
    CPU ladder (W sums in another order there, so the bound is drift): the
    records agree, and an unsolved window keeps the read's own bases."""
    from daccord_tpu.oracle.profile import ErrorProfile as JaxErrorProfile

    d = make_dataset(str(tmp_path), SimConfig(genome_len=1500, coverage=8,
                                              read_len_mean=700, seed=9))
    eprof = str(tmp_path / "eprof.json")
    ours, theirs = str(tmp_path / "port.fasta"), str(tmp_path / "jax.fasta")
    ps = _port(d, ours, "--device", "cpu", "--mode", "patch", "-E", eprof,
               "--audit-rate", "0")
    js = _jax(d, theirs, profile=JaxErrorProfile.load(eprof), device_ladder=True,
              mode="patch")
    assert ps.n_windows > ps.n_solved + ps.n_skipped_shallow > 0, "no unsolved window"
    prec = {r.name: r.seq for r in read_fasta(ours)}
    jrec = {r.name: r.seq for r in read_fasta(theirs)}
    same = sum(prec.get(n) == s for n, s in jrec.items())
    print(f"patch: records identical {same}/{len(jrec)}, bases port {ps.bases_out} / "
          f"jax {js.bases_out}")
    assert same >= 0.95 * len(jrec) and abs(len(prec) - len(jrec)) <= 0.05 * len(jrec)
    assert abs(ps.bases_out - js.bases_out) <= 0.005 * js.bases_out


@pytest.mark.parametrize("bad,jax_bad", [
    (("--backend", "native", "--ladder", "split"),) * 2,
    (("--backend", "native", "--paged", "on"),) * 2,
    (("--backend", "cpu", "-M", "0"),) * 2,
    (("-M", "0", "--device", "cpu"), ("-M", "0", "--backend", "cpu")),
], ids=["native-split", "native-paged", "M0-cpu", "M0-device-cpu"])
def test_cli_refuses_what_jax_refuses(bad, jax_bad):
    from daccord_tpu.tools import cli as jax_cli

    with pytest.raises(SystemExit) as ours:
        cli.main(["daccord", "no.db", "no.las", *bad])
    with pytest.raises(SystemExit) as theirs:
        jax_cli.daccord_main(["no.db", "no.las", *jax_bad])
    assert str(ours.value.code) == str(theirs.value.code) and ours.value.code


def _resolved(monkeypatch, *argv):
    """The PipelineConfig the CLI builds for ``argv`` (no run)."""
    seen = {}

    def fake(db, las, out, cfg, start=None, end=None, profile=None):
        seen["cfg"] = cfg
        return PipelineStats()

    monkeypatch.setattr(cli, "correct_to_fasta", fake)
    stats, args = cli.daccord_run(["no.db", "no.las", *argv])
    return seen["cfg"], args, cli.stats_record(stats, args)


def test_backend_rules_and_hp_defaults(monkeypatch):
    """The JAX package's hp default (on for an explicit cpu or native
    backend, off on the card and under auto), ``--device`` as before, a
    contradiction refused, and no fallback from the card."""
    for argv, hp, native, device in [
            ((), False, False, "cuda"), (("--device", "cpu"), False, False, "cpu"),
            (("--backend", "cuda"), False, False, "cuda"),
            (("--backend", "cpu"), True, False, "cpu"),
            (("--backend", "native"), True, True, "cpu"),
            (("--backend", "native", "--device", "cpu"), True, True, "cpu"),
            (("--backend", "native", "--no-hp-rescue"), False, True, "cpu"),
            (("--device", "cpu", "--hp-rescue"), True, False, "cpu")]:
        cfg, args, rec = _resolved(monkeypatch, *argv)
        assert (cfg.consensus.hp_rescue, cfg.native_solver, cfg.device) == (
            hp, native, device), argv
        assert rec["backend"] == args.backend and rec["device"] == device
        assert {"n_hp_rescued", "hp_wall_s", "backend"} <= set(rec)
    cfg, _, _ = _resolved(monkeypatch, "--device", "cpu", "--mode", "patch", "--hp-rescue",
                          "--hp-vote", "posterior", "--hp-accept", "likelihood",
                          "--no-native")
    assert (cfg.consensus.mode, cfg.consensus.hp_vote, cfg.consensus.hp_accept,
            cfg.hp_native, cfg.use_native) == ("patch", "posterior", "likelihood",
                                               False, False)
    for bad in (("--backend", "native", "--device", "cuda"),
                ("--backend", "cpu", "--device", "cuda"),
                ("--backend", "cuda", "--device", "cpu")):
        with pytest.raises(SystemExit, match="contradicts"):
            cli.main(["daccord", "no.db", "no.las", *bad])


def test_auto_backend_never_falls_back(hp_set, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: auto runs on it")
    for extra in ((), ("--backend", "auto"), ("--backend", "cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _port(hp_set, str(tmp_path / "x.fasta"), *extra)
    assert not os.path.exists(tmp_path / "x.fasta")


@pytest.mark.cuda
def test_card_hp_rescue_equals_cpu_ladder(hp_set, tmp_path):
    """On the card, ``--hp-rescue`` writes the CPU ladder's FASTA byte for
    byte (the ladder is bit-equal there, and the hp pass runs on the host
    over the same rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card, host = str(tmp_path / "card.fasta"), str(tmp_path / "cpu.fasta")
    sc = _port(hp_set, card, "--hp-rescue", "--audit-rate", "0")
    sh = _port(hp_set, host, "--hp-rescue", "--device", "cpu", "--audit-rate", "0")
    assert sc.n_hp_rescued == sh.n_hp_rescued > 0
    assert _bytes(card) == _bytes(host)
