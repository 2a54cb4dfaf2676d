"""The port's telemetry readers ``trace``, ``prof``, ``top`` and ``sentinel``
(``daccord_tpu_torch/tools/``) against the JAX package's over the committed
fixture sidecars (``tests/data/obs/{run,srv,bench}``): in each mode the JAX
package's tests use, both print the same bytes and return the same exit
code. The clock is pinned for both (``top`` stamps its screen with it,
``sentinel`` and ``trace`` age records against it)."""

import glob
import os
import time

import pytest

from daccord_tpu.tools import prof as jax_prof
from daccord_tpu.tools import sentinel as jax_sentinel
from daccord_tpu.tools import top as jax_top
from daccord_tpu.tools import trace as jax_trace
from daccord_tpu_torch.tools import cli, prof, sentinel, top, trace

FIX = os.path.join(os.path.dirname(__file__), "data", "obs")
RUN, SRV = os.path.join(FIX, "run"), os.path.join(FIX, "srv")
BENCH = sorted(glob.glob(os.path.join(FIX, "bench", "*.json")))
EV = os.path.join(RUN, "shard0000.events.jsonl")
ROLLUP = os.path.join(RUN, "shard0000.metrics.json")
SRV_EV = os.path.join(SRV, "serve.events.jsonl")

MAINS = {"trace": (trace.trace_main, jax_trace.trace_main),
         "prof": (prof.prof_main, jax_prof.prof_main),
         "top": (top.top_main, jax_top.top_main),
         "sentinel": (sentinel.sentinel_main, jax_sentinel.sentinel_main)}

CASES = [
    ("top", [RUN, SRV, "--once"]),
    ("top", [RUN, SRV, "--once", "--json"]),
    ("top", [RUN, "--once"]),
    ("top", [SRV, "--once"]),
    ("top", ["{empty}", "--once"]),
    ("sentinel", BENCH),
    ("sentinel", ["--strict", *BENCH]),
    ("sentinel", ["--noise", "0.3", *BENCH]),
    ("sentinel", ["--tpu-stale-h", "1", *BENCH]),
    ("sentinel", [RUN, SRV]),
    ("sentinel", ["--strict", RUN, SRV]),
    ("sentinel", ["--baseline", ROLLUP, ROLLUP]),
    ("sentinel", ["--strict", "{good.prom}"]),
    ("sentinel", ["--strict", "{bad.prom}"]),
    ("prof", [RUN]),
    ("prof", ["--check", RUN]),
    ("prof", ["--check", EV]),
    ("prof", ["--json", RUN]),
    ("prof", [ROLLUP]),
    ("prof", BENCH),
    ("prof", ["--diff", EV, ROLLUP]),
    ("prof", ["--check", "{empty.events.jsonl}"]),
    ("prof", ["--check", "{empty}"]),
    ("trace", [EV, "--check", "--no-timeline"]),
    ("trace", [RUN, "--check"]),
    ("trace", [RUN, SRV]),
    ("trace", [SRV_EV, "--no-timeline"]),
    ("trace", ["--json", RUN, SRV]),
    ("trace", ["--probe-history", "{tunnel.jsonl}"]),
]


@pytest.fixture
def scratch(tmp_path):
    """Files of the cases that need one (the JAX tests write the same)."""
    (tmp_path / "empty").mkdir()
    (tmp_path / "good.prom").write_text("# TYPE daccord_x gauge\ndaccord_x 1.5\n")
    (tmp_path / "bad.prom").write_text("daccord_x one-point-five\n")
    (tmp_path / "empty.events.jsonl").write_text(
        '{"t": 0.0, "ts": 1.0, "event": "fleet.init", "nshards": 1, "workers": 1, '
        '"host": "h"}\n')
    (tmp_path / "tunnel.jsonl").write_text(
        '{"ts": "2026-07-30T10:00:00Z", "alive": true, "devices": 1}\n'
        '{"ts": "2026-08-01T08:00:00Z", "alive": false, "devices": 0}\n')
    return tmp_path


def _call(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("tool,argv", CASES,
                         ids=[f"{t}-{i}" for i, (t, _) in enumerate(CASES)])
def test_tool_prints_what_the_jax_tool_prints(tool, argv, scratch, capsys, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_791_000_000.0)
    argv = [str(scratch / a[1:-1]) if a.startswith("{") else a for a in argv]
    port_main, jax_main = MAINS[tool]
    got = _call(port_main, argv, capsys)
    want = _call(jax_main, argv, capsys)
    assert got == want
    assert got[1] or got[2]          # the case printed something


def test_the_cli_dispatches_the_readers(capsys, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_791_000_000.0)
    assert cli.main(["top", RUN, SRV, "--once"]) == 0
    screen = capsys.readouterr().out
    assert "daccord-top" in screen and "MESH 4/8" in screen
    assert cli.main(["sentinel", "--strict", *BENCH]) == 1
    assert "below the series median" in capsys.readouterr().err
    assert cli.main(["prof", "--check", RUN]) == 0
    # the fixture's spans do not reconcile with its anchors: --check fails
    assert cli.main(["trace", EV, "--check", "--no-timeline"]) == 1
    assert cli.main(["trace", EV, "--no-timeline"]) == 0
