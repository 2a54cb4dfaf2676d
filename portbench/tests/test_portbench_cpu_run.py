"""A tiny run of the harness through ``SolveGroup(backend="cpu")``, the
port's CPU ladder, against the frozen reference: sound, it is correct; with
the solve path broken underneath, it is not; and the control (the
reference in bfloat16) differs from the reference."""

import json
import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import control, harness  # noqa: E402
from portbench.reference import check  # noqa: E402

TINY = dict(traffic_over=dict(jobs=3, rows_min=4, rows_max=40, outstanding=4, warmup_rows=64),
            width=64, pool_windows=256, ref_processes=1, backend="cpu", log=lambda m: None)


def tiny_run(cell="clr100x.jobs8", seed=2**31 + 11, fault=None):
    return harness.run(ROOT, cell, seed, 4.0, False, time.perf_counter(), fault=fault, **TINY)


class Broken:
    """A solve path whose fetched rows are damaged by ``damage(out)``."""

    def __init__(self, path, damage):
        self._path, self._damage = path, damage

    def __getattr__(self, name):
        return getattr(self._path, name)

    def fetch_many(self, handles):
        outs = []
        for out in self._path.fetch_many(handles):
            out = {k: (np.array(v) if isinstance(v, np.ndarray) else v) for k, v in out.items()}
            self._damage(out)
            outs.append(out)
        return outs


def unsolved(out, rows=slice(None)):
    out["cons"][rows] = 4
    out["cons_len"][rows] = 0
    out["err"][rows] = np.inf
    out["solved"][rows] = False
    out["tier"][rows] = -1


def half_left_out(out):
    unsolved(out, slice(len(out["tier"]) // 2, None))


def altered(out):
    out["cons"][0, 0] = (out["cons"][0, 0] + 1) % 4


def test_a_sound_run_is_correct_and_loads_no_jax():
    res = tiny_run()
    assert res["correct"], res["checks"]
    assert res["checks"]["windows_differing"]["value"] == 0
    assert res["checks"]["err_rel_gap"]["value"] == 0
    assert res["checks"]["rows_compared"]["value"] > 0
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"consensus_bases_per_s", "block_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert harness.leaked() == []


@pytest.mark.parametrize("damage", [unsolved, half_left_out, altered],
                         ids=["state_unchanged", "half_the_batch_left_out", "answer_altered"])
def test_a_broken_solve_path_is_not_correct(damage):
    res = tiny_run(fault=lambda path: Broken(path, damage))
    assert not res["correct"]
    assert res["checks"]["windows_differing"]["value"] > check.WINDOWS_LIMIT


def test_the_control_fails_the_check():
    with open(os.path.join(ROOT, "portbench", "configs", "ecoli_clr_100x.json")) as fh:
        cfg = dict(json.load(fh), pool_windows=1024)
    r = control.readings(cfg, 2**31 + 5, 1)
    assert r["rows_compared"] == 1024
    assert r["err_rel_gap"] > check.ERR_LIMIT or r["windows_differing"] > check.WINDOWS_LIMIT


def rows3():
    return dict(cons=np.zeros((3, 4), np.int8), cons_len=np.array([4, 4, 0], np.int32),
                solved=np.array([True, True, False]), tier=np.array([0, 1, -1], np.int32),
                err=np.array([0.1, 0.2, np.inf], np.float32))


def test_differing_compares_every_consensus_field():
    want = rows3()
    assert not check.differing({k: v.copy() for k, v in want.items()}, want).any()
    for k, i in (("cons", (1, 2)), ("cons_len", 0), ("tier", 1), ("solved", 2)):
        got = {kk: v.copy() for kk, v in want.items()}
        got[k][i] = got[k][i] + 1 if k != "solved" else True
        assert check.differing(got, want).tolist() == [r == (i[0] if isinstance(i, tuple) else i)
                                                      for r in range(3)]


def test_the_comparison_counts_windows_once_and_reads_err_where_the_consensus_agrees():
    want = rows3()
    ref = {8: want}
    got = {k: v.copy() for k, v in want.items()}
    got["err"][0] = np.nextafter(np.float32(0.1), np.float32(1))
    c = check.compare([(8, 0, 3, got)], ref)
    assert c.windows == 0 and c.rows == 3
    assert 0 < c.err_gap < 1e-6
    bad = {k: v.copy() for k, v in want.items()}
    bad["cons"][1, 0] = 2
    bad["err"][1] = 5.0
    c = check.compare([(8, 0, 3, bad), (8, 1, 2, {k: v[1:2] for k, v in bad.items()})], ref)
    assert c.windows == 1 and c.rows == 4 and c.err_gap == 0
    inf = {k: v.copy() for k, v in want.items()}
    inf["err"][0] = np.inf
    assert check.compare([(8, 0, 3, inf)], ref).err_gap == np.inf
