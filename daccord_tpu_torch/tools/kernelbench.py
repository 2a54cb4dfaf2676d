"""Kernel-stage breakdown bench: where does a ladder batch spend its time?

The port of ``daccord_tpu/tools/kernelbench.py``.

Usage: ``python -m daccord_tpu_torch.tools.kernelbench [--batch 1024] [--reps 4]
[--stages ladder_full,ladder_scan] [--device cuda|cpu]``

Prints one JSON line per timing of one batch of the bench window set:

- ``ladder_full``: the whole ladder on the default fused route
  (``csrc/dp_backtrack.cu``), through its CUDA graphs on the card;
- ``ladder_scan``: the same ladder on the scan route (``csrc/heaviest_path.cu``
  and the torch backtrack), the JAX package's default route; the two give
  the same bytes, so their rows are the fused-against-scan comparison;
- ``ladder_paged``: the batch as a page pool and page table, the dense tile
  gathered by ``csrc/gather_pages.cu`` inside the graph, and the
  ``decision:paged`` row;
- ``ladder_mesh``: the batch sharded over the visible cards (up to 8; 8 CPU
  members under ``--device cpu``) and the ``decision:mesh`` row; with fewer
  than two cards the row is skipped and names them;
- ``ladder_split``: the two-stream ladder (tier 0, then the whole ladder over
  the rescue candidates) and the ``decision:ladder_split`` row;
- ``tier0``: tier 0 alone, as the ladder runs it;
- ``prefixes``: cumulative stage prefixes of tier 0's graph construction
  (``kernels/window_kernel.py``): ``prefix:counts+topk`` (``count_topm``)
  and ``prefix:+eq/occ/einsum`` (the whole ``prep_batch``, the edge support
  and ``csrc/position_weights.cu`` in it).

Each rep is bracketed by ``torch.cuda.synchronize``. ``DACCORD_BENCH_EVENTS``
names a jsonl file for the split stage's ``kernel.tier0``/``kernel.rescue``
spans. The window set is :func:`build_windows`: bench.py's 20 kb / 20x /
seed 42 simulation, cached in ``.bench_cache_torch/``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from . import ladderbench

#: stages in run order; --stages picks a comma-separated subset
STAGES = ("ladder_full", "ladder_scan", "ladder_paged", "ladder_mesh",
          "ladder_split", "tier0", "prefixes")
N_BENCH_WINDOWS = 32768
DEPTH, SEG_LEN, WLEN = 32, 64, 40
#: the most mesh members the ladder_mesh stage uses
MESH_MAX = 8


def build_windows(n: int | None = None, cache: str | None = None) -> dict:
    """The bench window set, as bench.py builds it: the 20 kb / 20x / 2 kb
    reads / seed 42 simulation, each pile's refined overlaps cut into
    windows until ``n`` (default ``N_BENCH_WINDOWS``) are collected,
    tensorized at D=32, L=64, w=40, and the two-pass error profile of the
    first pile. Cached as an npz in ``cache`` (default the tools' cache
    directory)."""
    from ..kernels.tensorize import BatchShape, tensorize_windows
    from ..oracle import (ConsensusConfig, cut_windows, estimate_profile_two_pass,
                          refine_overlap)
    from ..sim import SimConfig, simulate

    n = n or N_BENCH_WINDOWS
    cache = cache or ladderbench.CACHE
    os.makedirs(cache, exist_ok=True)
    npz = os.path.join(cache, f"windows_v1_n{n}.npz")
    if os.path.exists(npz):
        d = np.load(npz)
        return {k: d[k] for k in d.files}
    cfg = SimConfig(genome_len=20_000, coverage=20, read_len_mean=2_000, seed=42)
    res = simulate(cfg)
    ccfg = ConsensusConfig()
    shape = BatchShape(depth=DEPTH, seg_len=SEG_LEN, wlen=WLEN)
    items = []
    prof = None
    piles: dict[int, list] = {}
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
    batch = tensorize_windows(items[:n], shape)
    out = dict(seqs=batch.seqs, lens=batch.lens, nsegs=batch.nsegs,
               p_ins=np.float64(prof.p_ins), p_del=np.float64(prof.p_del),
               p_sub=np.float64(prof.p_sub))
    np.savez_compressed(npz, **out)
    return out


def bench(batch: int = 1024, reps: int = 4, stages=STAGES, device: str = "cuda",
          emit=print) -> dict:
    """Run ``stages`` on the first ``batch`` windows of :func:`build_windows`
    on ``device``; each row goes to ``emit`` as it is timed. Returns the
    rows and, by stage, the result of the stage's first call (``outs``;
    the ladder stages' unpacked host results)."""
    import torch

    from ..kernels.tensorize import BatchShape, WindowBatch
    from ..kernels.tiers import (TierLadder, fetch, rescue_candidates,
                                 solve_ladder_async, solve_ladder_split,
                                 solve_tier0_async)
    from ..oracle.consensus import ConsensusConfig
    from ..oracle.profile import ErrorProfile
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    tag = ladderbench.device_tag(dev)
    data = build_windows()
    prof = ErrorProfile(float(data["p_ins"]), float(data["p_del"]), float(data["p_sub"]))
    ladder = TierLadder.from_config(prof, ConsensusConfig(), device=dev)
    B = min(batch, len(data["nsegs"]))
    p0 = ladder.params[0]
    shape = BatchShape(depth=data["seqs"].shape[1], seg_len=data["seqs"].shape[2],
                       wlen=p0.wlen)
    wb = WindowBatch(seqs=data["seqs"][:B], lens=data["lens"][:B],
                     nsegs=data["nsegs"][:B], shape=shape,
                     read_ids=np.zeros(B, np.int64), wstarts=np.zeros(B, np.int64))
    rows: list[dict] = []
    outs: dict = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def line(row: dict) -> None:
        rows.append(row)
        emit(json.dumps(row))

    def timed(label, fn, *a, extra=None):
        outs[label] = fn(*a)
        sync()
        total = 0.0
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn(*a)
            sync()
            total += time.perf_counter() - t0
        ms = total / reps * 1e3
        line({"stage": label, "ms_per_batch": round(ms, 2), "batch": B,
              "device": tag, **(extra or {})})
        return ms

    # full ladder (what the fused pipeline dispatches)
    ms_full = None
    if "ladder_full" in stages:
        ms_full = timed("ladder_full", lambda: fetch(solve_ladder_async(wb, ladder)),
                        extra={"route": "fused"})

    if "ladder_scan" in stages:
        # the scan route: the DP kernel writes the score and pointer stacks,
        # the torch backtrack finishes; the same bytes as the fused route
        scan = TierLadder.from_config(prof, ConsensusConfig(), device=dev, route="scan")
        timed("ladder_scan", lambda: fetch(solve_ladder_async(wb, scan)),
              extra={"route": "scan"})

    if "ladder_paged" in stages:
        # ragged paged wire format: the same full-ladder program fed pool +
        # page table, the dense tile gathered on the device (gather_pages)
        from ..kernels import paging

        pgs = paging.window_pages(wb.lens)
        fams = paging.derive_families(wb.nsegs, pgs, max_depth=wb.seqs.shape[1],
                                      max_pages=-(-wb.seqs.shape[1] * wb.seqs.shape[2]
                                                  // paging.PAGE_LEN),
                                      budget=1)
        t_pack = time.perf_counter()
        pwb = paging.pack_paged(wb, fams[-1], target_rows=B)
        pack_ms = (time.perf_counter() - t_pack) * 1e3
        dense_waste = round(wb.pad_waste(), 4)
        paged_waste = round(pwb.pad_waste(), 4)
        ms_paged = timed("ladder_paged", lambda: fetch(solve_ladder_async(pwb, ladder)),
                         extra={"family": fams[-1].describe(),
                                "pack_ms": round(pack_ms, 2),
                                "pad_waste_dense": dense_waste,
                                "pad_waste_paged": paged_waste})
        if ms_full is not None:
            line({"stage": "decision:paged", "batch": B,
                  "dense_ms": round(ms_full, 2), "paged_ms": round(ms_paged, 2),
                  "paged_speedup": round(ms_full / ms_paged, 3) if ms_paged else None,
                  "pad_waste_dense": dense_waste, "pad_waste_paged": paged_waste,
                  "shipped_cells_dense": int(wb.seqs.size),
                  "shipped_cells_paged": int(pwb.shipped_cells),
                  "pack_ms": round(pack_ms, 2), "device": tag})

    if "ladder_mesh" in stages:
        # the same batch sharded over the mesh's members, each running the
        # whole ladder on its row slice, against the one-device program
        from ..parallel.mesh import (OFF_CARD_RECIPE, _card_names, make_mesh,
                                     make_sharded_solver, visible_devices)

        if dev.type == "cpu":
            members = make_mesh(MESH_MAX, platform="cpu")
        else:
            cards = visible_devices()
            members = make_mesh(min(MESH_MAX, len(cards)), devices=cards) if cards else ()
        nd = len(members)
        if nd < 2:
            vis = visible_devices()
            line({"stage": "ladder_mesh", "skipped": True,
                  "reason": f"{len(vis)} card(s) visible ({_card_names(vis)})",
                  "recipe": OFF_CARD_RECIPE})
        else:
            mladder = TierLadder.from_config(prof, ConsensusConfig(), device=members[0])
            solver = make_sharded_solver(mladder, members, batch=B)
            try:
                ms_mesh = timed("ladder_mesh", lambda: solver(wb),
                                extra={"mesh": nd, "pad_to_mesh_rows": int((-B) % nd),
                                       "cards": len({str(m) for m in members
                                                     if m.type == "cuda"})})
            finally:
                solver.close()
            if ms_full is not None:
                line({"stage": "decision:mesh", "batch": B, "mesh": nd,
                      "single_ms": round(ms_full, 2), "mesh_ms": round(ms_mesh, 2),
                      "mesh_speedup": round(ms_full / ms_mesh, 3) if ms_mesh else None,
                      "per_device_rows": B // nd, "device": tag})

    if "ladder_split" in stages:
        # two-stream ladder: tier 0 over the full batch + the full rescue
        # ladder over the compacted candidates only, at one fixed rescue
        # width (the candidate count rounded up to a power of two)
        from ..utils.obs import JsonlLogger, Tracer

        ev_path = os.environ.get("DACCORD_BENCH_EVENTS")
        tr_log = JsonlLogger(ev_path) if ev_path else None
        tracer = Tracer(tr_log)
        out0 = fetch(solve_tier0_async(wb, ladder))
        n_resc = int(np.sum(rescue_candidates(out0, wb.nsegs, ladder)))
        rb = 1
        while rb < max(n_resc, 1):
            rb *= 2
        rb = min(rb, B)
        try:
            ms_split = timed("ladder_split",
                             lambda: solve_ladder_split(wb, ladder, rescue_batch=rb,
                                                        tracer=tracer),
                             extra={"rescue_rows": n_resc, "rescue_batch": rb,
                                    "rescue_fraction": round(n_resc / B, 4)})
        finally:
            if tr_log is not None:
                tr_log.close()
        if ms_full is not None:
            # split_speedup > 1: Stream A + a dense Stream B beat the fused
            # call on identical inputs (the pipeline amortizes Stream B over
            # many Stream A batches; this row is the kernel-cost bound)
            line({"stage": "decision:ladder_split", "batch": B,
                  "fused_ms": round(ms_full, 2), "split_ms": round(ms_split, 2),
                  "split_speedup": round(ms_full / ms_split, 3) if ms_split else None,
                  "rescue_rows": n_resc, "rescue_fraction": round(n_resc / B, 4),
                  "device": tag})

    if "tier0" in stages:
        timed("tier0", lambda: fetch(solve_tier0_async(wb, ladder)))

    if "prefixes" in stages:
        # cumulative prefixes of tier 0's graph construction (deltas
        # attribute time to each stage)
        from ..kernels.window_kernel import count_topm, prep_batch

        ts, tl, tn = (torch.as_tensor(a, device=dev) for a in (wb.seqs, wb.lens, wb.nsegs))
        ol = ladder.tables[p0.k]
        timed("prefix:counts+topk", count_topm, ts, tl, tn, p0)
        timed("prefix:+eq/occ/einsum", prep_batch, ts, tl, tn, ol, p0)
    return {"rows": rows, "outs": outs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the ladder runs (default cuda; no fallback)")
    p.add_argument("--backend", choices=("auto", "cpu"), default="auto",
                   help="the JAX tool's flag: cpu = --device cpu, auto follows "
                        "--device")
    p.add_argument("--stages", default=",".join(STAGES), metavar="LIST",
                   help="comma-separated subset of: " + ", ".join(STAGES))
    args = p.parse_args(argv)
    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    bad = [s for s in stages if s not in STAGES]
    if bad:
        raise SystemExit(f"kernelbench: unknown stage(s) {bad}; "
                         f"known: {', '.join(STAGES)}")
    device = "cpu" if args.backend == "cpu" else args.device
    bench(args.batch, args.reps, stages, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
