"""On the card: each cell's set-up and a few seconds of its traffic, as the
benchmark's command runs them, print the contract's last line with
``correct`` true. Run on a machine with a card:
``python3 -m pytest portbench/tests/test_portbench_card.py -m cuda -q``."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cells() -> list[str]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return [w["name"] for w in json.load(fh)["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_a_short_run_of_each_cell_is_correct(card, cell):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                        "--seed", str(2**31 + 101), "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    print(json.dumps(line))
    assert line["correct"] is True, p.stderr[-3000:]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"
