"""Run one cell of ``BENCHMARK.json`` on this machine's card.

``python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1``
from the root of a checkout. Prints the cell's numbers as one JSON line,
last on standard output, and the numbers that decided ``correct`` beside
their limits, last on standard error. Exits non-zero, printing no result,
without a CUDA card (or fewer than the cell asks for), without the port's
package, or when the process holds JAX or the JAX package once the window
has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    root = os.getcwd()
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == a.workload), None)
    if chips is None:
        print(f"no workload {a.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from portbench import harness

    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    res = harness.run(root, a.workload, a.seed, a.seconds, bool(a.trace), T_START, log=log)
    bad = harness.leaked()
    if bad:
        print(f"this process holds {bad}: the benchmark may load neither JAX nor the "
              "JAX package", file=sys.stderr)
        return 4
    card = power_limit()
    log(f"card (name, power limit): {card}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(res["peak"]), "power_limit": card}
    if a.trace:
        device.update(busy_s=res.get("busy_s", 0.0), window_s=res.get("window_s", 0.0))
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        log(f"check {name}: {c['value']} ({c['rule']} {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
