"""Measurement-ladder bench: end-to-end runs shaped like BASELINE.md's configs.

The port of ``daccord_tpu/tools/ladderbench.py``. Each rung is a synthetic
dataset with the shape (coverage, read length regime, error profile) of one
of BASELINE.md's configurations, run through the production path
(``correct_to_fasta``, the shard launcher or the command line) on the
tool's device and scored with qv-eval; one JSON line per rung.

Rungs:
  cfg1  25x PacBio-like, oracle-vs-kernel parity regime (small)
  cfg2  100x PacBio-like on one card (the "first bases/sec/card" rung)
  cfg3  80x multi-contig over an 8-member mesh: the members laid
        round-robin over the visible cards (8 CPU members under
        ``--device cpu``); exercises the sharded solver end to end
  cfg4  60x streamed as 4 sequential LAS byte-range shards with mid-shard
        checkpoints + manifest merge (the streaming-shards rung)
  cfg5  ONT R10-like regime corrected by two concurrent OS processes, each
        owning one LAS shard, outputs merged (the multi-host scale-out
        model: zero cross-process communication, shared FS); both processes
        share the tool's device
  cfg6  8%-diverged two-copy repeat, TWO ARMS: plain daccord vs the full
        track pipeline (inqual -> repeats -> filter -> filtersym ->
        QV-ranked daccord); reports both arms' Q in one row

Usage: ``python -m daccord_tpu_torch.tools.ladderbench [--configs cfg1,...,cfg6]
[--device cuda|cpu]``. The ladder runs on the card unless ``--device cpu``;
without a card the tool raises. Datasets are cached in ``.bench_cache_torch/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE = os.path.join(REPO, ".bench_cache_torch")


def _dataset(name: str, **kw) -> dict:
    """Build (or reuse) a cached synthetic dataset; returns its file paths.

    The cache is keyed on the sim parameters (config.json comparison), so
    editing a rung's sim_kw invalidates the old dataset instead of silently
    reusing it."""
    from dataclasses import asdict

    from ..sim import SimConfig, make_dataset

    cfg = SimConfig(**kw)
    d = os.path.join(CACHE, f"ladder_{name}")
    paths = {k: os.path.join(d, f"{name}.{ext}")
             for k, ext in (("db", "db"), ("las", "las"), ("truth", "truth.npz"))}
    cfg_json = os.path.join(d, f"{name}.config.json")
    if all(os.path.exists(p) for p in paths.values()) and os.path.exists(cfg_json):
        with open(cfg_json) as fh:
            if json.load(fh) == asdict(cfg):
                return paths
        import shutil

        shutil.rmtree(d)
    out = make_dataset(d, cfg, name=name)
    return {k: out[k] for k in ("db", "las", "truth")}


def _qveval(fasta: str, truth: str, raw_db: str | None) -> dict:
    from .cli import qveval_main

    with tempfile.NamedTemporaryFile("rt", suffix=".json", delete=False) as fh:
        path = fh.name
    try:
        args = [fasta, truth, "--json", path]
        if raw_db is not None:   # raw-read scoring is a full DP pass; skip
            args += ["--raw-db", raw_db]   # it when the caller discards it
        if qveval_main(args) != 0:
            raise RuntimeError(f"qveval failed on {fasta}")
        with open(path) as fh2:
            return json.load(fh2)
    finally:
        os.unlink(path)


def device_tag(dev) -> str:
    """The device a row ran on, without spaces as the JAX rows print it:
    ``cuda:<card name>`` on the card, ``cpu`` on the CPU."""
    import torch

    if dev.type == "cuda":
        return f"{dev}:{torch.cuda.get_device_name(dev)}".replace(" ", "")
    return "cpu"


def mesh_members(n: int, dev, cards=None) -> tuple:
    """cfg3's ``n`` mesh members: laid round-robin over ``cards`` (default
    ``parallel.mesh.visible_devices()``) on cuda, so one card holds several
    members when there are fewer cards than members; ``n`` CPU members on
    the CPU."""
    from ..parallel.mesh import make_mesh, visible_devices

    if dev.type == "cpu":
        return make_mesh(n, platform="cpu")
    cards = visible_devices() if cards is None else list(cards)
    if not cards:
        raise RuntimeError("cfg3: no cuda device visible; pass --device cpu")
    return make_mesh(n, devices=[cards[i % len(cards)] for i in range(n)])


def _cli_device_args(dev) -> list[str]:
    """A CLI stage's engine: the tool's device, with the hp rescue on as the
    JAX rung's explicit ``--backend cpu`` had it."""
    return ["--device", dev.type, "--backend", dev.type, "--hp-rescue"]


def run_rung(name: str, sim_kw: dict, feeder_threads: int = 0,
             mesh: int = 0, native: bool = False, device: str = "cuda") -> dict:
    """One ladder rung through the production pipeline; returns the JSON row."""
    from ..formats.dazzdb import read_db
    from ..formats.las import LasFile
    from ..runtime.pipeline import (PipelineConfig, correct_to_fasta,
                                    estimate_profile_for_shard)
    from ..utils.device import resolve_device
    from ..utils.obs import auto_batch_size

    dev = resolve_device(device)
    paths = _dataset(name, **sim_kw)
    native = native and mesh <= 1
    cfg = PipelineConfig(batch_size=auto_batch_size("native" if native else dev.type),
                         device=dev.type, feeder_threads=feeder_threads,
                         native_solver=native,
                         # pin engine threads to the bench's thread setting so
                         # --threads 1 stays a per-core anchor
                         native_threads=max(feeder_threads, 1))
    out_fa = os.path.join(CACHE, f"ladder_{name}", "corrected.fasta")

    # profile estimation runs OUTSIDE the timed window for every rung, so
    # bases_out_per_s measures the correction pipeline symmetrically
    prof = estimate_profile_for_shard(read_db(paths["db"]),
                                      LasFile(paths["las"]), cfg)
    solver = None
    members = (dev,)
    if mesh > 1:
        from ..kernels.tiers import TierLadder
        from ..parallel.mesh import make_sharded_solver

        members = mesh_members(mesh, dev)
        ladder = TierLadder.from_config(prof, cfg.consensus, device=members[0])
        solver = make_sharded_solver(ladder, members, batch=cfg.batch_size)
    try:
        t0 = time.perf_counter()
        stats = correct_to_fasta(paths["db"], paths["las"], out_fa, cfg,
                                 profile=prof, solver=solver)
        wall = time.perf_counter() - t0
    finally:
        if solver is not None:
            solver.close()

    q = _qveval(out_fa, paths["truth"], paths["db"])
    return {
        "rung": name, "devices": mesh if mesh > 1 else 1,
        "cards": len({str(m) for m in members if m.type == "cuda"}),
        "backend": dev.type, "device0": device_tag(members[0]),
        "reads": stats.n_reads, "windows": stats.n_windows,
        "solve_rate": round(stats.n_solved / max(stats.n_windows, 1), 4),
        "bases_in": stats.bases_in, "bases_out": stats.bases_out,
        "wall_s": round(wall, 2), "device_s": round(stats.device_s, 3),
        "bases_out_per_s": round(stats.bases_out / wall, 1),
        "pad_waste": round(stats.pad_waste, 4),
        "q_raw": q.get("raw_qscore"), "q_corrected": q.get("qscore"),
        "delta_q": q.get("delta_q"),
    }


RUNGS = {
    # 25x PacBio-like: the oracle-parity regime (BASELINE ladder config 1)
    "cfg1": dict(sim_kw=dict(genome_len=20_000, coverage=25, read_len_mean=4_000,
                             seed=11)),
    # 100x PacBio-like: single-card throughput rung (config 2)
    "cfg2": dict(sim_kw=dict(genome_len=50_000, coverage=100, read_len_mean=8_000,
                             seed=12)),
    # 80x over an 8-member mesh (config 3; members round-robin over the cards)
    "cfg3": dict(sim_kw=dict(genome_len=30_000, coverage=80, read_len_mean=6_000,
                             repeat_fraction=0.05, seed=13), mesh=8),
    # 60x streamed as 4 byte-range shards with checkpoints (config 4's shape)
    "cfg4": dict(sim_kw=dict(genome_len=40_000, coverage=60, read_len_mean=7_000,
                             seed=14), shards=4),
    # ONT R10-like, two concurrent shard processes (config 5's regime)
    "cfg5": dict(sim_kw=dict(genome_len=30_000, coverage=15, read_len_mean=8_000,
                             read_len_sigma=0.5, p_ins=0.008, p_del=0.018,
                             p_sub=0.01, min_overlap=2_000, seed=15), procs=2),
    # diverged two-copy repeat: the full track pipeline (inqual -> QV-gated
    # repeats -> consistency filter -> filtersym -> QV-ranked daccord) vs the
    # trackless run (BASELINE.md "Track-pipeline measurement")
    "cfg6": dict(sim_kw=dict(genome_len=6_000, coverage=24, read_len_mean=800,
                             repeat_fraction=0.35, repeat_divergence=0.08,
                             seed=43), tracks=True),
}


def _cli(*a) -> None:
    r = subprocess.run([sys.executable, "-m", "daccord_tpu_torch.tools.cli", *a],
                       cwd=REPO, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{a[0]} failed: {r.stderr[-300:]}")


def run_rung_tracks(name: str, sim_kw: dict, device: str = "cuda") -> dict:
    """Two-arm rung: plain daccord vs the full track pipeline, one JSON row.

    Every stage runs through the production CLI in a subprocess; both
    daccord arms solve on the tool's device with the same engine settings
    (the track tools are host-only)."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    paths = _dataset(name, **sim_kw)
    d = os.path.dirname(paths["db"])
    eng = _cli_device_args(dev)

    t0 = time.perf_counter()
    plain_fa = os.path.join(d, "plain.fasta")
    _cli("daccord", paths["db"], paths["las"], "-o", plain_fa, *eng, "--qv-track", "")
    filt = os.path.join(d, "filt.las")
    sym = os.path.join(d, "sym.las")
    depth = str(int(sim_kw.get("coverage", 20)))
    _cli("inqual", paths["db"], paths["las"], "-d", depth)
    _cli("repeats", paths["db"], paths["las"], "-d", depth, "--factor", "1.5")
    _cli("filter", paths["db"], paths["las"], filt)
    _cli("filtersym", filt, sym, "--db", paths["db"])
    tracks_fa = os.path.join(d, "tracks.fasta")
    _cli("daccord", paths["db"], sym, "-o", tracks_fa, *eng)
    wall = time.perf_counter() - t0

    qp = _qveval(plain_fa, paths["truth"], paths["db"])
    qt = _qveval(tracks_fa, paths["truth"], None)   # q_raw comes from qp
    return {
        "rung": name, "backend": dev.type, "wall_s": round(wall, 2),
        "q_raw": qp.get("raw_qscore"),
        "q_plain": qp.get("qscore"), "q_tracks": qt.get("qscore"),
        "errors_plain": qp.get("errors"), "errors_tracks": qt.get("errors"),
        "delta_q_tracks": round((qt.get("qscore") or 0)
                                - (qp.get("qscore") or 0), 2),
    }


def run_rung_shards(name: str, sim_kw: dict, shards: int, device: str = "cuda") -> dict:
    """Sequential byte-range shards with mid-shard checkpoints + merge."""
    from ..parallel.launch import merge_shards, run_shard
    from ..runtime.pipeline import PipelineConfig
    from ..utils.device import resolve_device
    from ..utils.obs import auto_batch_size

    dev = resolve_device(device)
    paths = _dataset(name, **sim_kw)
    outdir = os.path.join(CACHE, f"ladder_{name}", "shards")
    out_fa = os.path.join(CACHE, f"ladder_{name}", "corrected.fasta")
    cfg = PipelineConfig(batch_size=auto_batch_size(dev.type), device=dev.type)
    t0 = time.perf_counter()
    manifests = [run_shard(paths["db"], paths["las"], outdir, s, shards, cfg,
                           force=True, checkpoint_every=64)
                 for s in range(shards)]
    n_frags = merge_shards(outdir, shards, out_fa)
    wall = time.perf_counter() - t0
    q = _qveval(out_fa, paths["truth"], paths["db"])
    bases_out = sum(m.get("bases_out", 0) for m in manifests)
    # no bases_out_per_s here: the timed window covers the whole shard
    # workflow (one profile-estimation pass PER shard, by design of the
    # resumable shard machinery), so it would not compare with the other
    # rungs' correction-only throughput
    return {
        "rung": name, "shards": shards, "devices": 1,
        "backend": dev.type,
        "reads": sum(m.get("reads", 0) for m in manifests),
        "fragments": n_frags, "bases_out": bases_out,
        "wall_s": round(wall, 2),
        "q_raw": q.get("raw_qscore"), "q_corrected": q.get("qscore"),
        "delta_q": q.get("delta_q"),
    }


def run_rung_procs(name: str, sim_kw: dict, procs: int, device: str = "cuda") -> dict:
    """Concurrent shard OS processes (multi-host model: shared FS, zero
    cross-process communication), merged afterwards. Every process solves
    on the tool's device; on cuda they share the card, as the fleet's
    workers do."""
    from ..parallel.launch import merge_shards
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    paths = _dataset(name, **sim_kw)
    outdir = os.path.join(CACHE, f"ladder_{name}", "shards")
    out_fa = os.path.join(CACHE, f"ladder_{name}", "corrected.fasta")
    t0 = time.perf_counter()
    running = [subprocess.Popen(
        [sys.executable, "-m", "daccord_tpu_torch.tools.cli", "shard",
         paths["db"], paths["las"], outdir, "-J", f"{s},{procs}",
         "--force", *_cli_device_args(dev)],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for s in range(procs)]
    errs = [p.communicate()[1] for p in running]
    if any(p.returncode != 0 for p in running):
        return {"rung": name, "error": [p.returncode for p in running],
                "stderr": " | ".join(e[-200:] for e in errs)}
    n_frags = merge_shards(outdir, procs, out_fa)
    wall = time.perf_counter() - t0
    q = _qveval(out_fa, paths["truth"], paths["db"])
    return {
        "rung": name, "processes": procs, "backend": dev.type,
        "fragments": n_frags, "wall_s": round(wall, 2),
        "q_raw": q.get("raw_qscore"), "q_corrected": q.get("qscore"),
        "delta_q": q.get("delta_q"),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--configs", default="cfg1,cfg2,cfg3")
    p.add_argument("--threads", type=int, default=0, help="feeder threads")
    p.add_argument("--native", action="store_true",
                   help="solve with the host library's tier ladder (--backend "
                        "native's engine, the device ladder's top-M semantics "
                        "at the default -M 64; single-device rungs only — "
                        "mesh/tracks rungs unchanged)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the ladder runs (default cuda; no fallback)")
    args = p.parse_args(argv)

    names = args.configs.split(",")
    unknown = [n for n in names if n not in RUNGS]
    if unknown:
        p.error(f"unknown configs {unknown}; valid: {', '.join(RUNGS)}")
    from ..utils.device import resolve_device

    dev = resolve_device(args.device).type   # raises without a card

    for name in names:
        r = RUNGS[name]
        if r.get("tracks"):
            try:
                row = run_rung_tracks(name, r["sim_kw"], device=dev)
            except Exception as exc:   # a failed stage must not kill the
                row = {"rung": name, "error": str(exc)[-400:]}   # whole ladder
        elif "shards" in r:
            row = run_rung_shards(name, r["sim_kw"], r["shards"], device=dev)
        elif "procs" in r:
            row = run_rung_procs(name, r["sim_kw"], r["procs"], device=dev)
        else:
            row = run_rung(name, r["sim_kw"], feeder_threads=args.threads,
                           mesh=r.get("mesh", 0), native=args.native, device=dev)
        # the port never falls back: the key stays for the JAX rows' readers
        print(json.dumps({**row, "fallback": False}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
