"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference loads neither torch nor the port."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HARNESS = """
import json, sys
from portbench import harness, run, control, trace, gen, roofline
from portbench.kinds import closed_jobs
b = harness.load_json('.', 'BENCHMARK.json')
for m in b['end_to_end'] + b['per_layer']:
    harness.reader(m['name'])
from daccord_tpu_torch.serve.batcher import SolveGroup, GroupConfig
from daccord_tpu_torch.runtime.pipeline import PipelineConfig, build_solve_path
from daccord_tpu_torch.kernels import graphs, dp_backtrack, rescore, position_weights
from daccord_tpu_torch.audit.worker import AuditWorker
print(json.dumps(harness.leaked()))
"""

REFERENCE = """
import json, sys
from portbench import gen, control
from portbench.reference import check, tables, ladder
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & {'torch', 'daccord_tpu_torch', 'jax', 'daccord_tpu'})))
"""


def run(code: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.strip().splitlines()[-1]


def test_the_harness_and_the_port_load_no_jax():
    assert run(HARNESS) == "[]"


def test_the_reference_loads_neither_torch_nor_the_port():
    assert run(REFERENCE) == "[]"


def test_leaked_compares_whole_top_level_names():
    sys.path.insert(0, ROOT)
    from portbench import harness

    saved = {k: sys.modules.get(k) for k in ("daccord_tpu", "jaxtools")}
    try:
        sys.modules.pop("daccord_tpu", None)
        sys.modules["jaxtools"] = sys  # a name that only begins with "jax"
        assert harness.leaked() == []
        sys.modules["daccord_tpu"] = sys
        assert harness.leaked() == ["daccord_tpu"]
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
