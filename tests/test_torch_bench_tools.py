"""The port's bench tools (``ladderbench``, ``kernelbench``,
``consensusbench``, ``feederbench``, ``scalebench``) against the JAX
package's on the same micro datasets, both caches under the test's
directory; the port runs on the CPU (``device="cpu"``) wherever the JAX
function takes no device.

Counts (reads, windows, fragments, solved) are equal, the FASTA files stay
within ROADMAP's drift bound and Q within 0.1 (equal where the files are
byte-identical). The port's ``build_windows`` equals bench.py's recipe run
through the JAX package; every kernelbench stage runs on the CPU and its
ladder routes give one result; cfg3 lays its members round-robin over the
cards; the feeder sidecar reads back through the port's sentinel and prof;
scalebench runs the JAX tool's stages end to end.
"""

import json
import os
import subprocess

import numpy as np
import pytest

from _torch_bench_common import MICRO, caches, fasta_drift, same_q  # noqa: F401
from _torch_bench_common import _few_torch_threads  # noqa: F401
from daccord_tpu.tools import consensusbench as jax_cb
from daccord_tpu.tools import feederbench as jax_fb
from daccord_tpu.tools import kernelbench as jax_kb
from daccord_tpu.tools import ladderbench as jax_lb
from daccord_tpu.tools import scalebench as jax_sb
from daccord_tpu_torch.tools import consensusbench as torch_cb
from daccord_tpu_torch.tools import feederbench as torch_fb
from daccord_tpu_torch.tools import kernelbench as torch_kb
from daccord_tpu_torch.tools import ladderbench as torch_lb
from daccord_tpu_torch.tools import scalebench as torch_sb


def _corrected(cache, name):
    return os.path.join(str(cache), f"ladder_{name}", "corrected.fasta")


def test_ladderbench_rungs_smoke(caches):
    """The plain rung and the shard-workflow rung (checkpoints + merge),
    each through both packages on one micro set."""
    jc, tc = caches
    j = jax_lb.run_rung("smoke", MICRO)
    t = torch_lb.run_rung("smoke", MICRO, device="cpu")
    assert t["reads"] > 0 and t["delta_q"] is not None
    assert set(j) <= set(t) and t["cards"] == 0 and t["backend"] == "cpu"
    for k in ("reads", "windows", "solve_rate", "bases_in", "devices"):
        assert t[k] == j[k], k
    same = fasta_drift(_corrected(jc, "smoke"), _corrected(tc, "smoke"))
    assert abs(t["bases_out"] - j["bases_out"]) <= 0.005 * j["bases_out"]
    same_q(j["q_corrected"], t["q_corrected"], same)
    assert t["q_raw"] == j["q_raw"]

    j = jax_lb.run_rung_shards("smoke2", MICRO, shards=2)
    t = torch_lb.run_rung_shards("smoke2", MICRO, shards=2, device="cpu")
    assert t["shards"] == 2 and t["fragments"] > 0
    assert t["q_corrected"] > t["q_raw"]
    assert set(j) == set(t)
    for k in ("reads", "fragments", "q_raw"):
        assert t[k] == j[k], k
    same = fasta_drift(_corrected(jc, "smoke2"), _corrected(tc, "smoke2"))
    same_q(j["q_corrected"], t["q_corrected"], same)


class _InProcess:
    """Stands in for the JAX rung's ``subprocess`` module: its CLI stages
    run in this process (a fresh interpreter would pay JAX's import and
    compiles for each of the seven stages)."""

    def run(self, argv, cwd=None, capture_output=False, text=False):
        from daccord_tpu.tools.cli import main

        assert argv[1:3] == ["-m", "daccord_tpu.tools.cli"]
        rc = main(list(argv[3:]))
        return subprocess.CompletedProcess(argv, rc or 0, "", "")


def test_ladderbench_tracks_rung_smoke(caches, monkeypatch):
    """The two-arm track-pipeline rung (cfg6 shape): the port's CLI stages
    in subprocesses on the CPU ladder against the JAX rung's stages."""
    kw = dict(MICRO, repeat_fraction=0.3, repeat_divergence=0.08)
    monkeypatch.setattr(jax_lb, "subprocess", _InProcess())
    j = jax_lb.run_rung_tracks("tsmoke", kw)
    t = torch_lb.run_rung_tracks("tsmoke", kw, device="cpu")
    assert "error" not in t
    assert set(j) == set(t) and t["backend"] == "cpu"
    assert t["q_plain"] > t["q_raw"]
    assert t["q_tracks"] is not None and t["errors_tracks"] is not None
    assert t["q_raw"] == j["q_raw"]
    jd, td = (os.path.join(str(c), "ladder_tsmoke") for c in caches)
    for arm in ("plain", "tracks"):
        same = fasta_drift(os.path.join(jd, f"{arm}.fasta"), os.path.join(td, f"{arm}.fasta"))
        same_q(j[f"q_{arm}"], t[f"q_{arm}"], same)
    # the track files the JAX tools wrote equal the port's
    for f in (".tsmoke.inqual.anno", ".tsmoke.inqual.data", "filt.las", "sym.las"):
        with open(os.path.join(jd, f), "rb") as a, open(os.path.join(td, f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("cards,want", [
    (1, [0] * 8), (2, [0, 1] * 4), (4, [0, 1, 2, 3] * 2)])
def test_cfg3_members_round_robin_over_the_cards(cards, want):
    import torch

    fake = [torch.device("cuda", i) for i in range(cards)]
    members = torch_lb.mesh_members(8, torch.device("cuda"), cards=fake)
    assert [m.index for m in members] == want
    assert all(m.type == "cuda" for m in members)
    cpu = torch_lb.mesh_members(8, torch.device("cpu"))
    assert len(cpu) == 8 and {m.type for m in cpu} == {"cpu"}


def test_ladderbench_rungs_equal_jax():
    assert torch_lb.RUNGS == jax_lb.RUNGS


def test_ladder_tools_default_to_the_card_and_raise_without_one():
    """Every ladder-running tool's entry point defaults to cuda, which this
    box has not: each raises instead of falling back to the CPU."""
    from daccord_tpu_torch.tools import (hpdrainbench, hptune, mismatchbench,
                                         profilevar, topmbench)

    for mod, argv in ((torch_lb, ["--configs", "cfg1"]), (torch_kb, []),
                      (topmbench, []), (profilevar, []), (mismatchbench, []),
                      (hptune, []), (hpdrainbench, [])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(argv)


def test_kernelbench_rejects_unknown_stage():
    for main in (jax_kb.main, torch_kb.main):
        with pytest.raises(SystemExit, match="unknown stage"):
            main(["--stages", "ladder_full,nope"])


def test_kernelbench_every_stage_on_the_cpu(tmp_path, monkeypatch):
    """Every stage at ``--device cpu --batch 64 --reps 1`` on a 256-window
    bench set; the fused, scan, paged, mesh and split ladders give one
    result."""
    monkeypatch.setattr(torch_lb, "CACHE", str(tmp_path))
    monkeypatch.setattr(torch_kb, "N_BENCH_WINDOWS", 256)
    lines = []
    res = torch_kb.bench(64, 1, torch_kb.STAGES, "cpu", emit=lines.append)
    stages = [json.loads(ln)["stage"] for ln in lines]
    assert stages == ["ladder_full", "ladder_scan", "ladder_paged", "decision:paged",
                      "ladder_mesh", "decision:mesh", "ladder_split",
                      "decision:ladder_split", "tier0", "prefix:counts+topk",
                      "prefix:+eq/occ/einsum"]
    rows = {r["stage"]: r for r in res["rows"]}
    assert rows["ladder_mesh"]["mesh"] == 8 and rows["ladder_full"]["device"] == "cpu"
    outs = res["outs"]
    full = outs["ladder_full"]
    assert full["solved"].sum() > 0
    for stage in ("ladder_scan", "ladder_paged", "ladder_mesh", "ladder_split"):
        for key in ("cons", "cons_len", "err", "solved", "tier", "m_ovf"):
            np.testing.assert_array_equal(np.asarray(outs[stage][key]), full[key],
                                          err_msg=f"{stage} {key}")
    # kernelbench's main parses the stages and runs them
    assert torch_kb.main(["--device", "cpu", "--batch", "8", "--reps", "1",
                          "--stages", "tier0"]) == 0


def test_build_windows_is_bench_recipe(tmp_path):
    """The port's copy of bench.py's ``build_windows`` equals bench.py's
    recipe run through the JAX package (written out here: bench.py is not
    imported)."""
    from daccord_tpu.kernels import BatchShape, tensorize_windows
    from daccord_tpu.oracle import (ConsensusConfig, cut_windows,
                                    estimate_profile_two_pass, refine_overlap)
    from daccord_tpu.sim import SimConfig, simulate

    n = 256
    got = torch_kb.build_windows(n=n, cache=str(tmp_path))
    cfg = SimConfig(genome_len=20_000, coverage=20, read_len_mean=2_000, seed=42)
    res = simulate(cfg)
    ccfg = ConsensusConfig()
    items, prof, piles = [], None, {}
    for o in res.overlaps:
        piles.setdefault(o.aread, []).append(o)
    for aread, pile in piles.items():
        a = res.reads[aread].seq
        refined = [refine_overlap(o, a, res.reads[o.bread].seq, cfg.tspace) for o in pile]
        windows = cut_windows(a, refined, w=ccfg.w, adv=ccfg.adv)
        if prof is None:
            prof = estimate_profile_two_pass(refined, windows, ccfg, sample=24)
        items.extend((aread, ws) for ws in windows)
        if len(items) >= n:
            break
    batch = tensorize_windows(items[:n], BatchShape(depth=32, seg_len=64, wlen=40))
    for k in ("seqs", "lens", "nsegs"):
        np.testing.assert_array_equal(got[k], getattr(batch, k), err_msg=k)
    for k in ("p_ins", "p_del", "p_sub"):
        assert float(got[k]) == getattr(prof, k), k
    again = torch_kb.build_windows(n=n, cache=str(tmp_path))   # the cached npz
    np.testing.assert_array_equal(again["seqs"], got["seqs"])


def test_consensusbench_equals_jax(caches, monkeypatch, capsys):
    """Host only: the port's host-library engine and oracle on the micro
    set count the same windows and solve the same share as the JAX
    package's."""
    for mod in (jax_cb, torch_cb):
        monkeypatch.setattr(mod, "_SHAPE", MICRO)
    argv = ["--windows", "256", "--oracle-sample", "8"]
    rows = []
    for main in (jax_cb.main, torch_cb.main):
        assert main(argv) == 0
        rows.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    j, t = rows
    assert set(j) == set(t)
    for k in ("windows", "adv", "depth_cap", "native_solve_rate"):
        assert t[k] == j[k], k
    assert t["native_wps_t1"] > 0 and t["oracle_wps"] > 0


def test_feederbench_commits_sidecar(tmp_path, capsys):
    """The port's ``FEEDER_r*.json`` reads back through the port's sentinel
    and prof; its windows and the paged pack's equal the JAX tool's."""
    from daccord_tpu_torch.tools.prof import load_profiles
    from daccord_tpu_torch.tools.sentinel import load_bench

    argv = ["--threads", "0", "--genome", "1500", "--coverage", "6", "--paged"]
    assert jax_fb.main([*argv, "--sidecar-dir", ""]) == 0
    j = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert torch_fb.main([*argv, "--sidecar-dir", str(tmp_path)]) == 0
    t = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    for k in ("threads", "reads", "windows", "paged_windows", "families",
              "paged_pad_waste", "dense_pad_waste"):
        assert t[k] == j[k], k
    side = tmp_path / "FEEDER_r01.json"
    payload = json.load(open(side))
    assert payload["n"] == 1 and "parsed" in payload
    parsed = payload["parsed"]
    assert parsed["metric"] == "feeder_windows_per_sec"
    assert parsed["stages"] and "realign" in parsed["stages"]
    assert "last_real_tpu_ts" in parsed
    assert load_bench(str(side))["metric"] == "feeder_windows_per_sec"
    profs, _ = load_profiles([str(side)])
    assert profs and profs[0]["stages"]
    # a second run appends r02, never overwrites; threaded feeder too
    assert torch_fb.main(["--threads", "2", "--genome", "1500", "--coverage", "6",
                          "--sidecar-dir", str(tmp_path)]) == 0
    t2 = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert t2["windows"] == t["windows"]
    assert (tmp_path / "FEEDER_r02.json").exists()


def test_scalebench_runs_the_jax_stages(tmp_path, monkeypatch, capsys):
    """``--genome-mb 0.02 --shards 2`` end to end, every stage a port CLI
    subprocess and the shards on the JAX tool's engine (``--backend
    native``), with the JAX tool's stage list (its stages recorded, not
    run)."""
    small = ["--genome-mb", "0.02", "--shards", "2", "--coverage", "8",
             "--read-len", "1000"]

    def recorded(name, argv, outputs=(), env=None):
        row = {"stage": name, "wall_s": 0.0, "peak_rss_mb": 0.0, "out_bytes": 0}
        print(json.dumps(row))
        return row

    monkeypatch.setattr(jax_sb, "timed_stage", recorded)
    assert jax_sb.main([*small, "--dir", str(tmp_path / "j")]) == 0
    jax_stages = [json.loads(ln)["stage"] for ln in capsys.readouterr().out.splitlines()]
    out = tmp_path / "rows.jsonl"
    assert torch_sb.main([*small, "--dir", str(tmp_path / "t"), "--backend", "native",
                          "--out", str(out)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["stage"] for r in lines] == jax_stages
    assert jax_stages[0] == "sim" and jax_stages[-1] == "TOTAL"
    assert all(r["peak_rss_mb"] for r in lines[1:-1])
    assert lines[-1]["disk_bytes"] > 0
    assert not (tmp_path / "t").exists()     # removed without --keep
    assert len(out.read_text().splitlines()) == len(lines)
