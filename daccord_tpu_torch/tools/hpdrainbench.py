"""Measure the hp-rescue drain-pass cost on the device-ladder path.

The port of ``daccord_tpu/tools/hpdrainbench.py``. The hp drain pass is
host-side work (the host library via ``NativeLadder.hp_rescue``, after each
fetch, ``runtime/pipeline.py _hp_pass``) whose wall does not depend on which
device produced the batch. Each regime runs the pipeline with the hp rescue
on, on the tool's device, and reports the pass's wall per window ``h``
beside the run's own ladder rate ``r = windows / solve_s``
(``device_windows_per_s``, the ladder calls' own wall). The worst-case
NON-overlapped fraction of the pass is ``h / (1/r + h)``: worst case because
the in-flight deque can hide the drain behind the card's work.

Two regimes: the clean control (routing cost only: a max-run scan plus a
handful of routed windows) and the hp stress regime (hp_indel_slope=1.0,
the most windows routed). One JSON line per regime.

Run: ``python -m daccord_tpu_torch.tools.hpdrainbench [--batch N] [--out F]
[--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REGIMES = {
    # cfg2's error model / pile depth at 2/5 genome scale (per-window drain
    # cost is size-independent; only the routing MIX matters)
    "clean_cfg2": dict(genome_len=20_000, coverage=100, read_len_mean=8_000, seed=12),
    # same shape under the hp stress knob: worst-case routing volume
    "hp_cfg2": dict(genome_len=20_000, coverage=100, read_len_mean=8_000,
                    hp_indel_slope=1.0, seed=12),
}


def run_regime(name: str, sim_kw: dict, batch: int | None, tmp: str,
               device: str = "cuda") -> dict:
    from ..oracle.consensus import ConsensusConfig
    from ..runtime.pipeline import PipelineConfig, correct_to_fasta
    from ..sim import SimConfig, make_dataset
    from ..utils.device import resolve_device
    from ..utils.obs import auto_batch_size
    from .ladderbench import device_tag

    dev = resolve_device(device)
    batch = batch or auto_batch_size(dev.type)
    d = os.path.join(tmp, name)
    out = make_dataset(d, SimConfig(**sim_kw), name=name)
    # ON arm only: the decision quantity is the per-window drain cost h; an
    # off arm would only re-measure the ladder
    pcfg = PipelineConfig(batch_size=batch, device=dev.type, hp_native=True,
                          consensus=ConsensusConfig(hp_rescue=True))
    t0 = time.time()
    st = correct_to_fasta(out["db"], out["las"], os.path.join(d, "on.fasta"), pcfg)
    wall = time.time() - t0
    h = st.hp_wall_s / max(st.n_windows, 1)
    rate = st.n_windows / st.solve_s if st.solve_s > 0 else 0.0
    bound = h / (1.0 / rate + h) if rate > 0 and h > 0 else 0.0
    line = {
        "regime": name, "batch": batch, "device": device_tag(dev),
        "windows": st.n_windows, "hp_rescued": st.n_hp_rescued,
        "hp_wall_s": round(st.hp_wall_s, 3),
        "pipe_wall_s": round(st.wall_s, 2),
        "total_wall_s": round(wall, 2),
        "hp_fraction": round(st.hp_wall_s / st.wall_s, 4) if st.wall_s else 0.0,
        "hp_wall_per_window_us": round(1e6 * h, 2),
        "solve_s": round(st.solve_s, 3),
        "device_windows_per_s": round(rate, 1),
        "worst_case_nonoverlap_fraction": round(bound, 4),
    }
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=None,
                   help="ladder batch (default the device's: 2048 on the "
                        "card, 512 on the CPU; hp cost scales with windows, "
                        "not batch shape)")
    p.add_argument("--out", default=None, help="also append JSON lines here")
    p.add_argument("--keep", action="store_true",
                   help="keep the datasets in $TMPDIR/hpdrain")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the ladder runs (default cuda; no fallback)")
    args = p.parse_args(argv)
    from ..utils.device import resolve_device

    dev = resolve_device(args.device).type
    tmp = (os.path.join(tempfile.gettempdir(), "hpdrain") if args.keep
           else tempfile.mkdtemp(prefix="hpdrain_"))
    lines = [run_regime(name, kw, args.batch, tmp, device=dev)
             for name, kw in REGIMES.items()]
    if args.out:
        with open(args.out, "a") as fh:
            for ln in lines:
                fh.write(json.dumps(ln) + "\n")
    if not args.keep:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
