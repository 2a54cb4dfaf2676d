"""The benchmark's files: BENCHMARK.json against the contract's shape, every
file it names present and parsed, and a new cell, traffic mix and metric
found by name without an edit."""

import json
import os
import re
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_benchmark_json_has_the_contract_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert {"consensus_bases_per_s", "block_p95_ms", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"] + b["workloads"] + b["configs"]:
        assert NAME.match(m["name"]), m["name"]
        assert "unit" not in m or UNIT.match(m["unit"])
        assert set(m.get("workloads", [])) <= cells
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    assert len(json.dumps(b)) < 64 * 1024


def test_every_metric_reader_loads():
    """Every reader under ``metrics/`` loads and is named in
    ``BENCHMARK.json``; a roofline reads nothing from a run that has no
    trace."""
    names = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "portbench", "metrics"))
                   if f.endswith(".py"))
    b = bench()
    assert names == sorted(m["name"] for m in b["end_to_end"] + b["per_layer"])
    for n in names:
        assert callable(harness.reader(n))
    assert harness.reader("dp_backtrack_m64_roofline")({"trace": None}) is None


def test_batch_fill_counts_the_rows_flushed_in_the_window():
    read = harness.reader("batch_fill")
    ctx = dict(group0={"rows": 100, "batches": 1}, group1={"rows": 4196, "batches": 3},
               pooled0=50, pooled1=50 + 4096 - 4000, width=2048)
    assert read(ctx) == 100.0 * 4000 / (2 * 2048)


def test_every_file_the_benchmark_names_exists_and_parses():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        path = os.path.join(ROOT, c["file"])
        cfg = json.load(open(path))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("portbench/configs/")
    for w in b["workloads"]:
        assert w["config"] in configs
        t = json.load(open(os.path.join(ROOT, "portbench", "traffic", f"{w['traffic']}.json")))
        assert os.path.exists(os.path.join(ROOT, "portbench", "kinds", f"{t['kind']}.py"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_a_new_cell_traffic_mix_and_metric_are_found_without_edits(tmp_path):
    """A later change adds files and entries only: a copy of the benchmark
    with a new traffic file, a new workload entry and a new metric reader
    finds all three by name."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".out"))
    b = bench()
    (tmp_path / "portbench" / "traffic" / "jobs2.json").write_text(json.dumps(
        {"kind": "closed_jobs", "jobs": 2, "rows_min": 4, "rows_max": 32, "outstanding": 2,
         "flush_lag_s": 0.05, "warmup_rows": 64}))
    cfg = json.load(open(os.path.join(ROOT, "portbench", "configs", "ecoli_clr_100x.json")))
    (tmp_path / "portbench" / "configs" / "ecoli_clr_25x.json").write_text(json.dumps(
        dict(cfg, name="ecoli_clr_25x", coverage=25)))
    (tmp_path / "portbench" / "metrics" / "blocks_in_window.py").write_text(
        "def read(ctx):\n    return len(ctx['window_blocks'])\n")
    b["workloads"].append({"name": "clr25x.jobs2", "config": "ecoli_clr_25x",
                           "traffic": "jobs2", "chips": 1, "why": "a test"})
    b["configs"].append({"name": "ecoli_clr_25x", "source": "a test",
                         "file": "portbench/configs/ecoli_clr_25x.json", "reduced": ["genome_len"],
                         "why": "a test"})
    b["per_layer"].append({"name": "blocks_in_window", "unit": "blocks", "better": "higher",
                           "source": "host_clock", "layer": "cross-job batcher",
                           "moves": "block_p95_ms", "workloads": ["clr25x.jobs2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    sys.path.insert(0, str(tmp_path))
    saved = {k: v for k, v in sys.modules.items() if k == "portbench" or k.startswith("portbench.")}
    for k in saved:
        del sys.modules[k]
    try:
        import portbench.harness as h2
        assert h2.HERE == str(tmp_path / "portbench")
        bb = h2.load_json(str(tmp_path), "BENCHMARK.json")
        cell = h2.cell_of(bb, "clr25x.jobs2")
        traffic = h2.load_json(h2.HERE, "traffic", f"{cell['traffic']}.json")
        assert traffic["jobs"] == 2
        assert h2.load_json(h2.HERE, "configs", f"{cell['config']}.json")["coverage"] == 25
        names = [m["name"] for m in h2.metrics_of(bb, "clr25x.jobs2", True)]
        assert "blocks_in_window" in names
        assert "blocks_in_window" not in [m["name"] for m in h2.metrics_of(bb, "clr100x.jobs8", True)]
        assert h2.reader("blocks_in_window")({"window_blocks": [1, 2, 3]}) == 3
    finally:
        sys.path.remove(str(tmp_path))
        for k in [k for k in sys.modules if k == "portbench" or k.startswith("portbench.")]:
            del sys.modules[k]
        sys.modules.update(saved)


@pytest.mark.parametrize("name", ["ecoli_clr_100x"])
def test_configs_state_the_programs_defaults(name):
    """Each configuration states the port's own defaults for a dense card
    service, so the program runs as the configuration states."""
    from daccord_tpu_torch.oracle.consensus import ConsensusConfig
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig

    cfg = json.load(open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")))
    p, c = PipelineConfig(), ConsensusConfig()
    assert (cfg["depth"], cfg["seg_len"], cfg["max_kmers"], cfg["rescue_max_kmers"],
            tuple(cfg["depth_buckets"]), cfg["max_inflight"], cfg["dp_route"],
            cfg["overflow_rescue"]) == (p.depth, p.seg_len, p.max_kmers, p.rescue_max_kmers,
                                        tuple(p.depth_buckets), p.max_inflight, p.dp_route,
                                        p.overflow_rescue)
    assert (cfg["w"], cfg["adv"], tuple(map(tuple, cfg["tiers"]))) == (c.w, c.adv, c.tiers)
    for k, v in cfg["dbg"].items():
        assert getattr(c.dbg, k) == v
    assert cfg["audit_rate"] == 1.0 / 64
