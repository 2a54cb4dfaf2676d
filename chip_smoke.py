#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``daccord_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. the card's name and power limit (``nvidia-smi``); no CUDA -> exit 1;
2. build ``daccord_tpu_torch/csrc/dp_backtrack.cu`` for sm_90a (nvcc), with
   the build seconds and ptxas' register/shared-memory report;
3. kernel phase: at B=2048 for every ladder shape (M, P), inputs made by the
   port's ``prep_batch`` from real windows of the phase-4 dataset (topped up
   from a seeded generator if a tier had fewer), the kernel held bit-equal to
   its plain torch version on the card, both timed with CUDA events, beside
   the least time the card could take (bytes or f32 operations at peak);
4. slice phase: the ``daccord`` command line in-process on cuda (batch 2048)
   on the 20 kb / 20x simulated dataset, with the kernel's launch counts set to
   0 just before and read just after; then one 2048-window batch through the
   ladder with the kernel and with the plain DP on the card (packed results
   bit-equal), the same batch on the CPU (drift from the f32 matmul order at
   most 0.5% of windows), and the corrected reads scored against the
   simulation's truth (they must beat the raw reads). Beside it, one ladder
   call's time split into tier 0's prep, DP kernel and rescore, and the
   device's busy share of the call under ``torch.profiler``.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``daccord_tpu``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B = 2048                     # windows per ladder call (the CLI default)
DEVICE = "cuda"              # a CPU rehearsal of the control flow may set "cpu"
HBM_BYTES_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
F32_FLOP_S = 67e12           # H100 SXM float32 outside the tensor cores
DATASET = dict(genome_len=20_000, coverage=20, read_len_mean=2_000, seed=42)
REPLACES = "daccord_tpu/kernels/pallas_window.py:129"
SOURCE = "daccord_tpu_torch/csrc/dp_backtrack.cu"


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, each between two
    CUDA events, after two warm-up runs."""
    for _ in range(2):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def synthetic_windows(n: int, D: int, L: int, wlen: int, seed: int):
    """``n`` windows of noisy copies of a random sequence (3 edits per copy,
    depth 3..D), to top up a tier that has fewer real windows than B."""
    rng = np.random.default_rng(seed)
    seqs = np.full((n, D, L), 4, np.int8)
    lens = np.zeros((n, D), np.int32)
    for b in range(n):
        true = rng.integers(0, 4, wlen + 8).astype(np.int8)
        for d in range(int(rng.integers(3, D + 1))):
            s = list(true)
            for _ in range(3):
                at = int(rng.integers(0, len(s)))
                op = int(rng.integers(0, 3))
                if op == 0:
                    s[at] = int(rng.integers(0, 4))
                elif op == 1:
                    s.insert(at, int(rng.integers(0, 4)))
                else:
                    del s[at]
            s = np.asarray(s[:L], np.int8)
            seqs[b, d, :len(s)] = s
            lens[b, d] = len(s)
    return seqs, lens, (lens > 0).sum(1).astype(np.int32)


def real_windows(db, las, cfg, need: int):
    """The first ``need`` windows deep enough to reach the device (the
    pipeline's skip-shallow rule), windowed by the port's host path."""
    from daccord_tpu_torch.runtime.pipeline import iter_pile_blocks

    min_depth = cfg.consensus.dbg.min_depth
    got, n = [], 0
    for _, _, seqs, lens, nsegs in iter_pile_blocks(db, las, cfg):
        keep = nsegs >= min_depth
        got.append((seqs[keep], lens[keep], nsegs[keep]))
        n += int(keep.sum())
        if n >= need:
            break
    return tuple(np.concatenate([g[i] for g in got])[:need] for i in range(3))


def bound(ins, outs, M: int, P: int, C: int, T: int) -> tuple[float, str]:
    """Least time (ms) the card could take for one launch: every input read
    once and every output written once at the HBM rate, against the DP's
    (P-1)*M*M f32 add+compare pairs and the C end-state scans over T*M
    scores at the f32 rate; whichever is larger bounds it."""
    nbytes = sum(t.numel() * t.element_size() for t in (*ins, *outs))
    Bn = ins[0].shape[0]
    ops = Bn * (2 * (P - 1) * M * M + C * T * M)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(ladder, seqs, lens, nsegs, dev) -> list[dict]:
    from daccord_tpu_torch.kernels import dp_backtrack
    from daccord_tpu_torch.kernels.window_kernel import prep_batch

    rows = []
    shapes = []
    for p in ladder.params:
        if (p.max_kmers, p.positions) not in [(s.max_kmers, s.positions) for s in shapes]:
            shapes.append(p)
    tseqs, tlens, tnsegs = (torch.as_tensor(a, device=dev) for a in (seqs, lens, nsegs))
    for p in shapes:
        M, P, C, CL = p.max_kmers, p.positions, p.n_candidates, p.cons_len
        t_lo, t_hi = p.t_range
        g = prep_batch(tseqs, tlens, tnsegs, ladder.tables[p.k], p)
        ins = (g["adjW"], g["W"].transpose(1, 2).contiguous(), g["score0"],
               g["snk_ok"], g["sel"])
        kw = dict(k=p.k, cons_len=CL, n_candidates=C, t_lo=t_lo, t_hi=t_hi)
        got = dp_backtrack.dp_backtrack_batch(*ins, **kw)
        ref = dp_backtrack.dp_backtrack_plain(*ins, **kw)
        torch.cuda.synchronize()
        err = max(float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in zip(got, ref))
        for name, a, b in zip(("cand", "clen", "ok"), got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"dp_backtrack M={M} P={P}: kernel {name} "
                                     f"differs from the plain version")
        ms = cuda_ms(lambda: dp_backtrack.dp_backtrack_batch(*ins, **kw), 20)
        plain_ms = cuda_ms(lambda: dp_backtrack.dp_backtrack_plain(*ins, **kw), 3)
        bms, by = bound(ins, got, M, P, C, t_hi - t_lo + 1)
        n_ok = int(got[2].any(dim=1).sum())
        log(f"kernel dp_backtrack M={M} P={P} k={p.k} B={ins[0].shape[0]}: "
            f"bit-equal to plain, windows with a path {n_ok}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bms:.6f} ms ({by})")
        rows.append(dict(name=f"dp_backtrack[M={M},P={P}]", route="cuda",
                         source=SOURCE, replaces=REPLACES, shape=(M, P),
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, library_ms=None))
    return rows


def ladder_breakdown(ladder, seqs, lens, nsegs) -> None:
    """Where one B-window ladder call goes: tier 0's three stages timed with
    CUDA events, the whole call, and the device's busy share of the call
    from a ``torch.profiler`` trace (kernel time over the call's wall)."""
    from daccord_tpu_torch.kernels import dp_backtrack
    from daccord_tpu_torch.kernels.tiers import ladder_core
    from daccord_tpu_torch.kernels.window_kernel import prep_batch, rescore_pick

    p = ladder.params[0]
    ol = ladder.tables[p.k]
    t_lo, t_hi = p.t_range
    kw = dict(k=p.k, cons_len=p.cons_len, n_candidates=p.n_candidates,
              t_lo=t_lo, t_hi=t_hi)
    g = prep_batch(seqs, lens, nsegs, ol, p)
    ins = (g["adjW"], g["W"].transpose(1, 2).contiguous(), g["score0"],
           g["snk_ok"], g["sel"])
    cand, clen, ok = dp_backtrack.dp_backtrack_batch(*ins, **kw)
    cand = cand.to(torch.int8)
    prep_ms = cuda_ms(lambda: prep_batch(seqs, lens, nsegs, ol, p), 5)
    dp_ms = cuda_ms(lambda: dp_backtrack.dp_backtrack_batch(*ins, **kw), 5)
    resc_ms = cuda_ms(lambda: rescore_pick(seqs, lens, nsegs, cand, clen, ok, p), 5)
    tables = tuple(ladder.tables[q.k] for q in ladder.params)
    call = lambda: ladder_core(seqs, lens, nsegs, tables, tuple(ladder.params))
    ladder_ms = cuda_ms(call, 3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    log(f"ladder breakdown, B={seqs.shape[0]}: tier-0 prep {prep_ms:.3f} ms, "
        f"dp_backtrack {dp_ms:.3f} ms, rescore {resc_ms:.3f} ms; whole ladder "
        f"call {ladder_ms:.3f} ms")
    if kernels:
        log(f"ladder call under torch.profiler: wall {wall_ms:.3f} ms, "
            f"{len(kernels)} device kernels, device busy {busy_ms:.3f} ms "
            f"({busy_ms / wall_ms:.4f} of the wall)")
    else:
        log("ladder call under torch.profiler: no device events (busy share not measured)")


def score_vs_truth(fasta: str, truth: str, db) -> tuple[float, float]:
    """(corrected, raw) error rates of the corrected fragments against the
    simulation's truth: each fragment's best infix edit distance to its
    read's true sequence, and the raw reads' edit distance to the same."""
    from daccord_tpu_torch.formats.fasta import read_fasta
    from daccord_tpu_torch.oracle.align import edit_distance, infix_distance
    from daccord_tpu_torch.utils.bases import revcomp_ints, seq_to_ints

    t = np.load(truth)
    genome, starts, ends, strands = t["genome"], t["starts"], t["ends"], t["strands"]

    def truth_of(rid: int) -> np.ndarray:
        tr = genome[starts[rid]:ends[rid]]
        return revcomp_ints(tr) if strands[rid] == 1 else tr

    e = n = 0
    rids = set()
    for rec in read_fasta(fasta):
        rid = int(rec.name.split()[0].removeprefix("read").split("/")[0])
        f = seq_to_ints(rec.seq)
        e += infix_distance(f, truth_of(rid))
        n += len(f)
        rids.add(rid)
    re = rn = 0
    for rid in sorted(rids):
        raw = db.read_bases(rid)
        re += edit_distance(raw, truth_of(rid))
        rn += len(raw)
    return e / max(n, 1), re / max(rn, 1)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.kernels import dp_backtrack
    from daccord_tpu_torch.kernels.tiers import (TierLadder, ladder_core,
                                                 pack_result, unpack_result)
    from daccord_tpu_torch.runtime.pipeline import (PipelineConfig,
                                                    estimate_profile_for_shard)
    from daccord_tpu_torch.sim import SimConfig, make_dataset
    from daccord_tpu_torch.tools.cli import daccord_run

    t_all = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    dev = torch.device(DEVICE)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build -----------------------------------------------------------
    path, secs = dp_backtrack.build()
    log(f"build: {os.path.relpath(path)} in {secs:.2f} s (nvcc sm_90a)")
    for line in dp_backtrack.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        d = make_dataset(tmp, SimConfig(**DATASET))
        log(f"dataset {DATASET}: made in {time.perf_counter() - t0:.1f} s")
        db, las = read_db(d["db"]), LasFile(d["las"])
        cfg = PipelineConfig(batch_size=B, device=dev.type)
        t0 = time.perf_counter()
        prof = estimate_profile_for_shard(db, las, cfg)
        eprof = os.path.join(tmp, "eprof.json")
        prof.save(eprof)
        log(f"profile pass: {time.perf_counter() - t0:.1f} s -> {prof}")
        ladder = TierLadder.from_config(prof, cfg.consensus, device=dev)

        # ---- 3. kernel phase ------------------------------------------------
        t0 = time.perf_counter()
        seqs, lens, nsegs = real_windows(db, las, cfg, B)
        n_real = len(nsegs)
        if n_real < B:
            extra = synthetic_windows(B - n_real, cfg.depth, cfg.seg_len,
                                      cfg.consensus.w, seed=7)
            seqs, lens, nsegs = (np.concatenate([a, x]) for a, x in
                                 zip((seqs, lens, nsegs), extra))
        log(f"kernel inputs: {n_real} real windows + {B - n_real} generated, "
            f"windowed in {time.perf_counter() - t0:.1f} s")
        rows = kernel_phase(ladder, seqs, lens, nsegs, dev)

        # ---- 4. slice phase: the main path ----------------------------------
        out = os.path.join(tmp, "out.fasta")
        torch.cuda.reset_peak_memory_stats()
        dp_backtrack.launches = 0
        dp_backtrack.launches_by_shape.clear()
        stats, _ = daccord_run([d["db"], d["las"], "-o", out, "-E", eprof,
                                "-b", str(B), "--device", dev.type])
        torch.cuda.synchronize()
        launches = dp_backtrack.launches
        by_shape = dict(dp_backtrack.launches_by_shape)
        log(f"daccord: reads {stats.n_reads}, windows {stats.n_windows}, solved "
            f"{stats.n_solved} ({stats.n_solved / max(stats.n_windows, 1):.4f}), "
            f"skipped shallow {stats.n_skipped_shallow}, batches {stats.n_batches}, "
            f"tiers {dict(sorted(stats.tier_histogram.items()))}, "
            f"fragments {stats.n_fragments}, bases out {stats.bases_out}")
        log(f"daccord: wall {stats.wall_s:.3f} s, {stats.windows_per_sec():.1f} "
            f"windows/s, {stats.bases_per_sec():.1f} bases/s; host windowing "
            f"{stats.windowing_s * 1e3:.1f} ms, device ladder {stats.ladder_s * 1e3:.1f} ms")
        per_shape = ", ".join(f"M={m} P={p}: {n}" for (m, p), n in sorted(by_shape.items()))
        log(f"dp_backtrack launches on the main path: {launches} ({per_shape}); "
            f"device ladder {stats.ladder_s * 1e3 / max(stats.n_batches, 1):.1f} ms "
            f"per batch; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if launches <= 0:
            raise AssertionError("the main path never launched the dp_backtrack kernel")
        if stats.n_solved <= 0 or stats.bases_out <= 0:
            raise AssertionError("the main path solved no window")

        tseqs, tlens, tnsegs = (torch.as_tensor(a[:B], device=dev)
                                for a in (seqs, lens, nsegs))
        tables = tuple(ladder.tables[p.k] for p in ladder.params)
        params = tuple(ladder.params)
        kern = pack_result(ladder_core(tseqs, tlens, tnsegs, tables, params))
        plain = pack_result(ladder_core(tseqs, tlens, tnsegs, tables, params,
                                        dp=dp_backtrack.dp_backtrack_plain))
        torch.cuda.synchronize()
        if not torch.equal(kern, plain):
            raise AssertionError("ladder with the kernel differs from the ladder "
                                 "with the plain DP on the card")
        res = unpack_result(kern.cpu().numpy(), params[0].cons_len)
        log(f"ladder on one batch of {B}: kernel == plain DP on the card, "
            f"bit-equal; tiers {np.unique(res['tier'], return_counts=True)}")

        ladder_breakdown(ladder, tseqs, tlens, tnsegs)

        cpu = tuple(t.cpu() for t in tables)
        ref = unpack_result(pack_result(ladder_core(
            tseqs.cpu(), tlens.cpu(), tnsegs.cpu(), cpu, params)).numpy(),
            params[0].cons_len)
        differ = int(sum(
            (res["solved"][i] != ref["solved"][i])
            or (res["solved"][i] and (res["cons_len"][i] != ref["cons_len"][i]
                                      or res["cons"][i].tobytes() != ref["cons"][i].tobytes()))
            for i in range(B)))
        log(f"same batch on the CPU: {differ}/{B} windows differ")
        if differ > 0.005 * B:
            raise AssertionError(f"card and CPU ladders differ on {differ} windows")

        err, raw = score_vs_truth(out, d["truth"], db)
        q = -10 * math.log10(max(err, 1e-9))
        log(f"accuracy vs truth: corrected error rate {err:.6f} (Q{q:.2f}), "
            f"raw {raw:.6f}")
        if not err < raw / 2:
            raise AssertionError("corrected reads are not clearly better than raw")

    for r in rows:
        r["launches"] = by_shape.get(r.pop("shape"), 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"smoke total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
