"""The port's decision tools (``profilevar``, ``topmbench``,
``mismatchbench``, ``hptune``, ``hpdrainbench``, ``hperrors``) and the two
``PipelineConfig`` fields they need (``profile_sample_offset``,
``skip_shallow``) against the JAX package's, on one micro dataset with
homopolymer-dependent indels, both caches under the test's directory; the
port runs on the CPU wherever the JAX function takes no device.

Counts (windows, solved, ``hp_rescued``, ``topm_overflow``) are equal, the
FASTA files stay within ROADMAP's drift bound and Q within 0.1 (equal where
the files are byte-identical); the profile sampled at each offset equals
the JAX package's; ``skip_shallow`` off writes the same FASTA as on, and as
the JAX run; hperrors prints the JAX tool's JSON byte for byte.
"""

import json
import os
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_bench_common import MICRO, fasta_drift, records, same_q
from _torch_bench_common import _few_torch_threads  # noqa: F401
from daccord_tpu.tools import hpdrainbench as jax_hd
from daccord_tpu.tools import hperrors as jax_he
from daccord_tpu.tools import hptune as jax_ht
from daccord_tpu.tools import ladderbench as jax_lb
from daccord_tpu.tools import mismatchbench as jax_mm
from daccord_tpu.tools import profilevar as jax_pv
from daccord_tpu.tools import topmbench as jax_tm
from daccord_tpu_torch.tools import hpdrainbench as torch_hd
from daccord_tpu_torch.tools import hperrors as torch_he
from daccord_tpu_torch.tools import hptune as torch_ht
from daccord_tpu_torch.tools import ladderbench as torch_lb
from daccord_tpu_torch.tools import mismatchbench as torch_mm
from daccord_tpu_torch.tools import profilevar as torch_pv
from daccord_tpu_torch.tools import topmbench as torch_tm

#: the micro set under the hp stress knob (mismatchbench's ``hp`` regime's)
HP_MICRO = dict(MICRO, hp_indel_slope=1.0)


@pytest.fixture(scope="module")
def mm(tmp_path_factory):
    """mismatchbench's ``hp`` regime on the micro set through both packages
    (the std arm and the hp-rescue arm), both caches in one module
    directory: the rows ``j``/``t``, the dataset directories ``jd``/``td``
    and the caches ``jc``/``tc``."""
    root = tmp_path_factory.mktemp("decision")
    jc, tc = str(root / "jax_cache"), str(root / "torch_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_lb, "CACHE", jc)
        mp.setattr(torch_lb, "CACHE", tc)
        j = jax_mm.run_regime("hp", HP_MICRO, hp_arm=True)
        t = torch_mm.run_regime("hp", HP_MICRO, hp_arm=True, device="cpu")
    return SimpleNamespace(j=j, t=t, jc=jc, tc=tc, jd=os.path.join(jc, "ladder_mm_hp"),
                           td=os.path.join(tc, "ladder_mm_hp"))


@pytest.fixture
def caches(mm, monkeypatch):
    """The module's two caches, for a tool that reuses its dataset."""
    monkeypatch.setattr(jax_lb, "CACHE", mm.jc)
    monkeypatch.setattr(torch_lb, "CACHE", mm.tc)
    for mod in (jax_mm, torch_mm):
        monkeypatch.setitem(mod.REGIMES, "hp", HP_MICRO)
    return mm


def _paths(d: str) -> dict:
    return {k: os.path.join(d, f"mm_hp.{ext}")
            for k, ext in (("db", "db"), ("las", "las"), ("truth", "truth.npz"))}


def test_regimes_cells_and_rungs_equal_jax():
    assert torch_mm.REGIMES == jax_mm.REGIMES
    assert torch_tm.REGIMES == jax_tm.REGIMES
    assert torch_tm.CELLS == jax_tm.CELLS
    assert torch_lb.RUNGS == jax_lb.RUNGS
    assert torch_pv._SHAPE == jax_pv._SHAPE
    assert torch_hd.REGIMES == {
        "clean_cfg2": dict(genome_len=20_000, coverage=100, read_len_mean=8_000, seed=12),
        "hp_cfg2": dict(genome_len=20_000, coverage=100, read_len_mean=8_000,
                        hp_indel_slope=1.0, seed=12)}


def test_mismatchbench_hp_regime_equals_jax(mm):
    j, t, jd, td = mm.j, mm.t, mm.jd, mm.td
    assert set(j) == set(t)
    for k in ("regime", "p_ins", "p_del", "p_sub", "windows", "solve_std", "solve_hp",
              "hp_rescued", "q_raw"):
        assert t[k] == j[k], k
    assert t["hp_rescued"] > 0
    for arm in ("std", "hp"):
        same = fasta_drift(os.path.join(jd, f"corr_{arm}.fasta"),
                           os.path.join(td, f"corr_{arm}.fasta"))
        same_q(j[f"q_{arm}"], t[f"q_{arm}"], same)


def test_skip_shallow_off_writes_the_same_fasta(mm):
    """With ``skip_shallow=False`` the shallow windows go to the ladder,
    which marks them unsolved: the FASTA of the default run (the std arm,
    which skips them on the host), itself the JAX package's."""
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.runtime.pipeline import (PipelineConfig, correct_to_fasta,
                                                    estimate_profile_for_shard)

    p = _paths(mm.td)
    cfg = PipelineConfig(batch_size=512, device="cpu")
    prof = estimate_profile_for_shard(read_db(p["db"]), LasFile(p["las"]), cfg)
    out = os.path.join(mm.td, "skip_off.fasta")
    off = correct_to_fasta(p["db"], p["las"], out, replace(cfg, skip_shallow=False),
                           profile=prof)
    assert off.n_skipped_shallow == 0 and off.n_windows == mm.t["windows"]
    assert round(off.n_solved / off.n_windows, 4) == mm.t["solve_std"]
    on = os.path.join(mm.td, "corr_std.fasta")
    with open(on, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
    assert fasta_drift(os.path.join(mm.jd, "corr_std.fasta"), out)


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_profile_sample_offset_equals_jax(caches, offset):
    """``estimate_profile_for_shard`` at offsets 0, 1 and 3, through the LAS
    index and through explicit pile ranges, equals the JAX package's; the
    offsets draw different samples."""
    from daccord_tpu.formats.dazzdb import read_db as jax_read_db
    from daccord_tpu.formats.las import LasFile as JaxLasFile
    from daccord_tpu.runtime import pipeline as jax_pipeline
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile, index_las
    from daccord_tpu_torch.runtime import pipeline

    p = _paths(caches.td)
    idx = index_las(p["las"])
    ends = list(idx[1:, 1]) + [os.path.getsize(p["las"])]
    ranges = [(int(s), int(e)) for s, e in zip(idx[:, 1], ends)]
    got = {}
    for pr in (None, ranges):
        j = jax_pipeline.estimate_profile_for_shard(
            jax_read_db(p["db"]), JaxLasFile(p["las"]),
            jax_pipeline.PipelineConfig(profile_sample_offset=offset), pile_ranges=pr)
        t = pipeline.estimate_profile_for_shard(
            read_db(p["db"]), LasFile(p["las"]),
            pipeline.PipelineConfig(device="cpu", profile_sample_offset=offset),
            pile_ranges=pr)
        for k in ("p_ins", "p_del", "p_sub"):
            assert getattr(t, k) == pytest.approx(getattr(j, k), rel=1e-12, abs=1e-15), k
        got[pr is None] = t
    base = pipeline.estimate_profile_for_shard(
        read_db(p["db"]), LasFile(p["las"]), pipeline.PipelineConfig(device="cpu"))
    assert (got[True].p_ins == base.p_ins) == (offset == 0)


def test_profilevar_cell_equals_jax(caches):
    j = jax_pv.run_cell(_paths(caches.jd), 2, 1)
    t = torch_pv.run_cell(_paths(caches.td), 2, 1, device="cpu")
    assert set(j) == set(t)
    for k in ("piles", "offset", "p_ins", "p_del", "p_sub", "solve"):
        assert t[k] == j[k], k
    same = fasta_drift(os.path.join(caches.jd, "pv_2_1.fasta"),
                       os.path.join(caches.td, "pv_2_1.fasta"))
    same_q(j["q"], t["q"], same)


@pytest.mark.parametrize("label,mk,rescue", [("M48", 48, False), ("M64+rescue", 64, True)])
def test_topmbench_cell_equals_jax(caches, label, mk, rescue):
    j = jax_tm.run_cell(_paths(caches.jd), label, mk, rescue)
    t = torch_tm.run_cell(_paths(caches.td), label, mk, rescue, device="cpu")
    assert set(j) == set(t)
    for k in ("cell", "max_kmers", "rescue", "solve", "topm_overflow", "windows"):
        assert t[k] == j[k], k
    name = f"tm_{label.replace('+', '_')}.fasta"
    same = fasta_drift(os.path.join(caches.jd, name), os.path.join(caches.td, name))
    same_q(j["q"], t["q"], same)


def test_hptune_arm_equals_jax(caches, capsys):
    argv = ["--arms", "0.18:3"]
    assert jax_ht.main(argv) == 0
    j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert torch_ht.main([*argv, "--device", "cpu"]) == 0
    t = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(j) == set(t)
    for k in ("hp_err", "hp_min_run", "vote", "solve", "rescued"):
        assert t[k] == j[k], k
    name = "corr_hp_0.18_3_median_rescore.fasta"
    same = fasta_drift(os.path.join(caches.jd, name), os.path.join(caches.td, name))
    same_q(j["q"], t["q"], same)


def test_hpdrainbench_regime_equals_jax(tmp_path):
    """The drain bench's counts equal the JAX tool's; its keys are the JAX
    tool's without the TPU's rate: the non-overlap bound comes from this
    run's own ladder rate."""
    j = jax_hd.run_regime("hp_micro", HP_MICRO, 512, str(tmp_path / "j"))
    t = torch_hd.run_regime("hp_micro", HP_MICRO, None, str(tmp_path / "t"), device="cpu")
    for k in ("regime", "batch", "windows", "hp_rescued"):
        assert t[k] == j[k], k
    assert set(t) == {"regime", "batch", "device", "windows", "hp_rescued", "hp_wall_s",
                      "pipe_wall_s", "total_wall_s", "hp_fraction",
                      "hp_wall_per_window_us", "solve_s", "device_windows_per_s",
                      "worst_case_nonoverlap_fraction"}
    assert t["device"] == "cpu" and t["device_windows_per_s"] > 0
    assert 0 < t["worst_case_nonoverlap_fraction"] < 1
    h = t["hp_wall_s"] / t["windows"]
    want = h / (1 / (t["windows"] / t["solve_s"]) + h)
    assert t["worst_case_nonoverlap_fraction"] == pytest.approx(want, abs=1e-4)
    assert fasta_drift(tmp_path / "j" / "hp_micro" / "on.fasta",
                       tmp_path / "t" / "hp_micro" / "on.fasta")


def test_no_port_source_carries_a_tpu_rate():
    import daccord_tpu_torch

    root = os.path.dirname(daccord_tpu_torch.__file__)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                assert "14_800" not in text and "14800" not in text, f


def test_hperrors_prints_the_jax_json(mm, capsys):
    p = _paths(mm.jd)
    fa = os.path.join(mm.jd, "corr_hp.fasta")
    assert records(fa)
    outs = []
    for main in (jax_he.main, torch_he.main):
        assert main([fa, p["truth"], "--max-frags", "40"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    row = json.loads(outs[1])
    assert row["fragments"] > 0 and row["errors"] > 0
    assert np.isclose(sum(v for k, v in row.items() if k.startswith(("ins_", "del_", "sub_"))),
                      row["errors"])
