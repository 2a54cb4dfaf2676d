#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``daccord_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. the card's name and power limit (``nvidia-smi``); no CUDA -> exit 1;
2. build the five kernels ``daccord_tpu_torch/csrc/{dp_backtrack,
   heaviest_path,gather_pages,rescore,position_weights}.cu`` for sm_90a, one
   nvcc each, all started together, with the build seconds and ptxas'
   register/shared-memory report, and beside them the host library
   ``daccord_tpu_torch/native/dazz_native.cpp`` with g++ (its seconds, the
   g++ version and the host's usable CPUs);
3. feeder phase, the first 40 piles of the 20 kb / 20x simulated dataset:
   the host library's windows are byte-equal to the numpy feeder's, and
   three feeders' windows/s (the numpy feeder and the host library on one
   thread, the host library on N = min(8, usable CPUs) threads);
4. slice phase, three runs of the ``daccord`` command line in-process on
   cuda (batch 2048) with the JAX package's defaults (the in-flight deque
   at 8 ladder calls on the dispatcher thread, dense depth buckets 8/16/32,
   strict ingest validation, the monster-pile guard at 100,000 overlaps),
   each with every kernel's launch counts (and the DP kernels' windows per
   shape) set to 0 just before and read just after: on the 20 kb set with
   one ``-E`` profile, the dense fused run (``--paged off --dp fused``, must
   launch ``dp_backtrack``) and the paged scan run (``--paged on --dp scan
   -t N``, must launch ``gather_pages`` and ``heaviest_path``); then the
   dense fused run with ``-t N`` on a 100 kb / 30x set of 5 kb reads (about
   3 Mb of reads, 300k windows). Each prints its wall, windows/s, the
   ingest scan, host windowing, ladder dispatch and the wall blocked in
   fetch ("device"), the rest ("else"), the feeder stage profile, batches
   per bucket, pad waste, the mean batch the path gave each DP shape, the
   peak device memory, the CUDA graphs the run captured and their wall
   (``graph_capture_s``) and the pinned host memory in flight. The two 20 kb
   FASTA outputs are compared (the drift bound of ROADMAP's parity
   invariant), and all three are scored against the simulation's truth
   (they must beat the raw reads). Every run is supervised
   (``runtime/supervisor.py``) with the shadow audit at its default 1/64,
   its samples solved in the audit worker process (``audit/worker.py``:
   the CPU ladder in numpy, in an interpreter of its own); each prints the
   audit's wall on the pipeline's thread (``audit_s``; the workers are the
   process's, started by the first run and reused), the worker's own
   solve wall (``audit_worker_s``), its start walls and the shares of the
   run's wall, fails if the audit was disabled, and is run again at audit
   rate 0, which must write the same FASTA byte for byte (its wall on the
   line), then with the audit on the pipeline's thread only (no worker,
   the torch CPU ladder) and with the default again (warm, as the run at
   rate 0 is). Then the worker's reference on 32 and 256 real
   windows of the 100 kb set: bit-equal to the torch CPU ladder, and both
   timed (one thread);
4b. the slice's checks on the 20 kb set, each a ``daccord`` run with the
   counts set to 0 before it: ``--max-inflight 1`` and a second deque run
   at audit rate 0, each with the ladder's CUDA graphs and with its stages
   run eagerly (``graphs=False``, the ladder before the graphs), write the
   first deque run's FASTA byte for byte (their walls and their
   ``ladder.call`` spans' wall and CPU time on one line); ``--ladder
   split`` writes it too (its Stream A and B calls and rescue density);
   ``--depth-buckets ''`` (one
   bucket) stays within the drift bound of the bucketed run; on a copy of
   the LAS the script corrupts (one record's coordinates bit-flipped,
   another's ``tlen`` made absurd), ``--ingest-policy strict`` exits
   non-zero naming both offsets and piles, and ``quarantine`` emits exactly
   those two reads uncorrected with one sidecar row each and every other
   read within the drift bound of the clean run; ``--max-pile-overlaps``
   one below the deepest pile contains the deepest piles only; ``-J 0,3``,
   ``-J 1,3`` and ``-J 2,3`` concatenate to the unsharded FASTA, byte for
   byte;
4c. hp phase, each run with the counts set to 0 before it: on a 100 kb /
   30x set of 5 kb reads damaged by homopolymer indels (``hp_indel_slope``
   1.0, seed 44, ~300k windows; one profile estimated as an hp run does),
   dense fused ``-t N`` without the rescue, with ``--hp-rescue`` (median
   vote, rescore accept) and with ``--hp-rescue --hp-vote posterior
   --hp-accept likelihood``: each prints its wall, windows/s,
   ``n_hp_rescued``, ``hp_wall_s`` and its share of the wall, ``audit_s``
   and the corrected and raw error, and both rescue runs must rescue
   windows and beat the run without; on a 20 kb hp set of the same slope
   ``--paged on --dp scan -t N --hp-rescue`` must launch ``gather_pages``
   and ``heaviest_path``, and ``--backend native`` (the default hp rescue
   and an explicit ``--hp-rescue``, the same FASTA) must stay within 0.5%
   of its solved windows and corrected bases and within 2e-3 of its error;
   ``--mode patch`` on the clean 20 kb set keeps the read's bases over
   every run of unsolved windows (read off ``--ledger``; from the run's
   first start to one advance past its last, which no later patch takes
   back), writes fewer records than split mode, and is scored;
   every main-path run and warm rerun of phase 4 also prints the shadow
   audit's tail (the final drain's audit wall, each worker's backlog and
   running call when the final flush began, the last parts' send-to-
   solved seconds) and the warm 20 kb dense rerun's audit share against
   the JAX package's 2%;
5. kernel phase, on inputs made from real windows of the dataset (topped up
   from a seeded generator if there were fewer than B), each kernel held
   bit-equal to its plain torch version on the card and timed (its device
   time per launch from ``torch.profiler``'s kernel events; the plain
   version between CUDA events), beside the least time the card could take
   (bytes or f32 operations at peak) and, where one PyTorch call computes
   the same function, that call's time:
   - ``dp_backtrack`` (fused DP + backtrack) and ``heaviest_path`` (the DP
     alone) at every ladder shape (M, P), on inputs ``prep_batch`` made, at
     B=2048 and at the mean batch the phase-4 run gave that shape; and both
     at M=512 (the wide layout, B=256);
   - ``gather_pages`` once per shape family of the paged run, on a paged
     batch packed from the real windows routed to that family;
   - ``rescore`` on tier 0's candidates of the B real windows (and at the
     mean batch the run gave it), and ``position_weights`` on the kept
     k-mer index of each position ``prep_batch`` made at every ladder shape,
     beside ``torch.matmul`` of the counts and the table;
6. one 2048-window batch: the gathered paged tile is bit-equal to the dense
   tile; the scan-route ladder, the paged ladder and the ladder with the
   plain DP are bit-equal to the fused-route ladder on the card; the same
   batch through the CPU ladder is bit-equal to the card's. Beside it, one
   ladder call's time split into tier 0's prep, DP kernel and rescore, and
   the device kernels and busy share of the call under ``torch.profiler``,
   with the kernels and with the torch rescore and ``torch.matmul`` in
   their place (the design before the two kernels);
6b. graph phase, the same batch: the ladder through its CUDA graphs
   (``kernels/graphs.py``) bit-equal to the eager ladder at each escalation
   width and at the width a call picks (first call and replay), the
   captures' wall and memory, and one call's wall, host CPU, device
   kernels and host launch calls eager, through the graphs, and through
   the graphs at the whole batch's width with no count read;
7. supervisor phase, ``daccord`` runs on the first quarter of the 20 kb
   set at ``-b 512`` under ``DACCORD_FAULT``: ``device_lost`` with
   ``--failover-backend cpu``, ``fetch_hang``, ``dispatch_error``,
   ``device_oom`` and ``sdc`` (audit rate 1/4) each write the clean run's
   FASTA byte for byte; ``device_lost`` with the default (native) failover
   stays within the drift bound; a real trap of the DP kernel in a child
   process fails over to the CPU ladder and writes the clean FASTA; an
   audit of every window of a clean run (the first eighth) logs no
   ``sup_sdc``.

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
BIG_DATASET = dict(genome_len=100_000, coverage=30, read_len_mean=5_000, seed=43)
FEEDER_PILES = 40            # piles the feeder phase windows through each route
KERNELS = ("dp_backtrack", "heaviest_path", "gather_pages", "rescore", "position_weights")
# rescore and position_weights replace no Pallas kernel: the XLA steps of the
# JAX package they compute
REPLACES = {"dp_backtrack": "daccord_tpu/kernels/pallas_window.py:129",
            "heaviest_path": "daccord_tpu/kernels/pallas_dp.py:36",
            "gather_pages": "daccord_tpu/kernels/pallas_window.py:96",
            "rescore": "none (XLA): daccord_tpu/kernels/window_kernel.py:381",
            "position_weights": "none (XLA): daccord_tpu/kernels/window_kernel.py:286"}
SUP_SHARD = "0,4"            # the supervisor phase's prefix of the 20 kb set
SUP_B = 512


def log(*a) -> None:
    print(*a, flush=True)


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


def same_blocks(got: list, ref: list) -> bool:
    """Whether two feeders' pile blocks are byte-equal, dtypes included."""
    return len(got) == len(ref) and all(
        g[0] == r[0] and all(x.dtype == y.dtype and np.array_equal(x, y)
                             for x, y in zip(g[1:], r[1:]))
        for g, r in zip(got, ref))


def feeder_phase(db, las, cfg, nthreads: int) -> None:
    """The first ``FEEDER_PILES`` piles through the numpy feeder and through
    the host library on one and on ``nthreads`` threads: byte-equal or
    raise, and each feeder's windows/s (host clock, from the first pile's
    request to the last pile's block)."""
    from dataclasses import replace
    from itertools import islice

    from daccord_tpu_torch.runtime.pipeline import (iter_pile_blocks,
                                                    iter_pile_blocks_threaded)

    def run(c, threads: int):
        t0 = time.perf_counter()
        it = (iter_pile_blocks_threaded(db, las, c, threads) if threads
              else iter_pile_blocks(db, las, c))
        blocks = list(islice(it, FEEDER_PILES))
        secs = time.perf_counter() - t0
        it.close()
        return blocks, secs

    ref, ref_s = run(replace(cfg, use_native=False), 0)
    nwin = sum(len(b[4]) for b in ref)
    log(f"feeder phase: {len(ref)} piles, {nwin} windows")
    log(f"  numpy feeder (library alignments), 1 thread: {ref_s:.3f} s, "
        f"{nwin / ref_s:.1f} windows/s")
    for threads in (0, nthreads):
        got, secs = run(cfg, threads)
        tag = f"host library, {max(threads, 1)} thread{'s' if threads > 1 else ''}"
        if not same_blocks(got, ref):
            raise AssertionError(f"feeder phase: the {tag} windows differ from the "
                                 f"numpy feeder's")
        log(f"  {tag}: {secs:.3f} s, {nwin / secs:.1f} windows/s; byte-equal to the "
            f"numpy feeder")


def source(name: str) -> str:
    return f"daccord_tpu_torch/csrc/{name}.cu"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, ops: int) -> tuple[float, str]:
    """Least time (ms) the card could take: the bytes that must move at the
    HBM rate against the f32 operations at the f32 rate; whichever is
    larger bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, ops / F32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def max_err(got, ref) -> float:
    return max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
               for a, b in zip(got, ref))


def row(name: str, kernel: str, key, err: float, ms: float, plain_ms: float,
        bms: float, by: str, library_ms=None, timed_by: str = "profiler",
        path=None) -> dict:
    """One kernel's record; ``path`` is the same kernel's (B, ms, plain ms,
    bound ms) at the mean batch the path gave it."""
    pb, pms, pplain, pbound = path if path else (None,) * 4
    return dict(name=name, kernel=kernel, key=key, route="cuda",
                source=source(kernel), replaces=REPLACES[kernel], max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms, timed_by=timed_by, path_B=pb, path_ms=pms,
                path_plain_ms=pplain, path_bound_ms=pbound)


def dp_case(kernel: str, fn, plain, ins, kw: dict, ops: int, label: str) -> dict:
    """One DP kernel on ``ins``: bit-equal to its plain version or raise;
    its device time per launch, the plain version's time, and the bound
    from these inputs (``ops`` f32 operations a window)."""
    from daccord_tpu_torch.tools.timing import event_ms, kernel_ms

    got = fn(*ins, **kw)
    ref = plain(*ins, **kw)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, ref)):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: kernel output {i} differs from the "
                                 f"plain version")
    ms, how = kernel_ms(lambda: fn(*ins, **kw), f"{kernel}_kernel", 20)
    plain_ms = event_ms(lambda: plain(*ins, **kw), 3)
    bms, by = bound(nbytes(*ins, *got), ins[0].shape[0] * ops)
    log(f"kernel {label}: bit-equal to plain, kernel {ms:.4f} ms ({how}), plain "
        f"{plain_ms:.4f} ms, bound {bms:.6f} ms ({by})")
    return dict(got=got, err=max_err(got, ref), ms=ms, how=how, plain_ms=plain_ms,
                bound_ms=bms, by=by)


def dp_kernel_phase(ladder, seqs, lens, nsegs, dev, path_b: dict) -> list[dict]:
    """``dp_backtrack`` and ``heaviest_path`` at every ladder shape, at B and
    at the batch the path gave the shape (``path_b[kernel][(M, P)]``)."""
    from daccord_tpu_torch.kernels import dp_backtrack, heaviest_path
    from daccord_tpu_torch.kernels.window_kernel import prep_batch

    from dataclasses import replace

    rows = []
    shapes = []
    for p in ladder.params:
        if (p.max_kmers, p.positions) not in [(s.max_kmers, s.positions) for s in shapes]:
            shapes.append(p)
    # the wide layout (M > 256: two threads a column, the bits sharing their
    # shared memory with the score rows and pointer stack), at B=256
    wide = replace(ladder.params[0], max_kmers=512)
    shapes.append(wide)
    tseqs, tlens, tnsegs = (torch.as_tensor(a, device=dev) for a in (seqs, lens, nsegs))
    for p in shapes:
        if p is wide:
            tseqs, tlens, tnsegs = tseqs[:256], tlens[:256], tnsegs[:256]
        M, P, C, CL = p.max_kmers, p.positions, p.n_candidates, p.cons_len
        t_lo, t_hi = p.t_range
        T = t_hi - t_lo + 1
        g = prep_batch(tseqs, tlens, tnsegs, ladder.tables[p.k], p)
        ins = (g["adjW"], g["W"].transpose(1, 2).contiguous(), g["score0"],
               g["snk_ok"], g["sel"])
        Bn = ins[0].shape[0]
        kw = dict(k=p.k, cons_len=CL, n_candidates=C, t_lo=t_lo, t_hi=t_hi)
        cases = (
            # the DP's (P-1)*M*M add+compare pairs and the C end-state scans
            ("dp_backtrack", dp_backtrack.dp_backtrack_batch,
             dp_backtrack.dp_backtrack_plain, ins, kw, 2 * (P - 1) * M * M + C * T * M),
            ("heaviest_path", heaviest_path.heaviest_path_batch,
             dp_backtrack.heaviest_path_plain, ins[:3], {}, 2 * (P - 1) * M * M))
        for kernel, fn, plain, kins, kkw, ops in cases:
            pb = path_b[kernel].get((M, P))
            res = {Bx: dp_case(kernel, fn, plain, tuple(t[:Bx] for t in kins), kkw, ops,
                               f"{kernel} M={M} P={P} k={p.k} B={Bx}")
                   for Bx in dict.fromkeys((Bn, pb)) if Bx is not None}
            full = res[Bn]
            if kernel == "dp_backtrack":
                log(f"  windows with a path at B={Bn}: "
                    f"{int(full['got'][2].any(dim=1).sum())}")
            path = None if pb is None else (pb, res[pb]["ms"], res[pb]["plain_ms"],
                                            res[pb]["bound_ms"])
            rows.append(row(f"{kernel}[M={M},P={P}]", kernel, (M, P),
                            max(r["err"] for r in res.values()), full["ms"],
                            full["plain_ms"], full["bound_ms"], full["by"],
                            timed_by="/".join(sorted({r["how"] for r in res.values()})),
                            path=path))
    return rows


def rescore_kernel_phase(ladder, seqs, lens, nsegs, dev, path_b: dict) -> list[dict]:
    """``rescore`` on tier 0's candidates of the real windows (the DP
    kernel's), at B and at the mean batch the run gave it: bit-equal to the
    plain version, timed beside it and its bound (the window tiles,
    candidates and lengths read once, the rows written once, against ~17
    64-bit word operations a (candidate, segment base, word) at the f32
    rate)."""
    from daccord_tpu_torch.kernels import dp_backtrack, rescore
    from daccord_tpu_torch.kernels.window_kernel import prep_batch
    from daccord_tpu_torch.tools.timing import event_ms, kernel_ms

    p = ladder.params[0]
    t_lo, t_hi = p.t_range
    tseqs, tlens, tnsegs = (torch.as_tensor(a, device=dev) for a in (seqs, lens, nsegs))
    g = prep_batch(tseqs, tlens, tnsegs, ladder.tables[p.k], p)
    cand, clen, ok = dp_backtrack.dp_backtrack_batch(
        g["adjW"], g["W"].transpose(1, 2).contiguous(), g["score0"], g["snk_ok"], g["sel"],
        k=p.k, cons_len=p.cons_len, n_candidates=p.n_candidates, t_lo=t_lo, t_hi=t_hi)
    ins = (tseqs, tlens, tnsegs, cand.to(torch.int8), clen, ok)
    C, CL = p.n_candidates, p.cons_len
    res = {}
    for Bx in dict.fromkeys((ins[0].shape[0], path_b.get((C, CL)))):
        if Bx is None:
            continue
        xs = tuple(t[:Bx] for t in ins)
        got = rescore.rescore_pick(*xs, p)
        ref = rescore.rescore_pick_plain(*xs, p)
        torch.cuda.synchronize()
        for key in ref:
            if not torch.equal(got[key], ref[key]):
                raise AssertionError(f"rescore B={Bx}: kernel {key} differs from plain")
        ms, how = kernel_ms(lambda: rescore.rescore_pick(*xs, p), "rescore_kernel", 20)
        plain_ms = event_ms(lambda: rescore.rescore_pick_plain(*xs, p), 3)
        words = -(-CL // 64)
        ops = C * int(xs[1].clamp(min=0).sum()) * 17 * words
        bms, by = bound(nbytes(*xs, *got.values()), ops)
        log(f"kernel rescore C={C} CL={CL} B={Bx}: bit-equal to plain, kernel {ms:.4f} ms "
            f"({how}), plain {plain_ms:.4f} ms, bound {bms:.6f} ms ({by}); solved "
            f"{int(got['solved'].sum())}")
        res[Bx] = dict(ms=ms, how=how, plain_ms=plain_ms, bound_ms=bms, by=by)
    full = res[ins[0].shape[0]]
    pb = path_b.get((C, CL))
    path = None if pb is None else (pb, res[pb]["ms"], res[pb]["plain_ms"], res[pb]["bound_ms"])
    return [row(f"rescore[C={C},CL={CL}]", "rescore", (C, CL), 0.0, full["ms"],
                full["plain_ms"], full["bound_ms"], full["by"],
                timed_by="/".join(sorted({r["how"] for r in res.values()})), path=path)]


def weights_kernel_phase(ladder, seqs, lens, nsegs, dev, path_b: dict) -> list[dict]:
    """``position_weights`` at every ladder shape (M, P) on the kept k-mer
    index of each position ``prep_batch`` made from the real windows, at B
    and at the mean batch the run gave the shape (``path_b[(M, P)]``):
    bit-equal to the plain version on the card and on the CPU, timed beside
    it, its bound (kid read once at 2 bytes a position, what a kept index
    below M <= 1024 needs, though the kernel is handed searchsorted's int32;
    ol read once and W written once; against 2 f32 operations a nonzero
    count and column: the terms this data needs) and ``torch.matmul`` of the
    f32 counts and the table."""
    from daccord_tpu_torch.kernels import position_weights as pw
    from daccord_tpu_torch.kernels import window_kernel
    from daccord_tpu_torch.tools.timing import event_ms, kernel_ms

    tseqs, tlens, tnsegs = (torch.as_tensor(a, device=dev) for a in (seqs, lens, nsegs))
    seen, rows = set(), []
    for p in ladder.params:
        if (p.max_kmers, p.positions) in seen:
            continue
        seen.add((p.max_kmers, p.positions))
        grabbed = []
        real = window_kernel.position_weights
        window_kernel.position_weights = (
            lambda kid, ol, M: grabbed.append((kid, ol, M)) or real(kid, ol, M))
        try:
            window_kernel.prep_batch(tseqs, tlens, tnsegs, ladder.tables[p.k], p)
        finally:
            window_kernel.position_weights = real
        kid_all, ol, M = grabbed[0]
        Bn = kid_all.shape[0]
        P, O = ol.shape
        pb = path_b.get((M, P))
        res = {}
        for Bx in dict.fromkeys((Bn, pb)):
            if Bx is None:
                continue
            kid = kid_all[:Bx]
            got = pw.position_weights(kid, ol, M)
            ref = pw.position_weights_plain(kid, ol, M)
            torch.cuda.synchronize()
            cpu = pw.position_weights(kid.cpu(), ol.cpu(), M)
            if not (torch.equal(got, ref) and torch.equal(got.cpu(), cpu)):
                raise AssertionError(f"position_weights M={M} B={Bx}: kernel differs "
                                     f"from plain (card or CPU)")
            ms, how = kernel_ms(lambda: pw.position_weights(kid, ol, M),
                                "position_weights", 20)
            plain_ms = event_ms(lambda: pw.position_weights_plain(kid, ol, M), 3)
            occ = pw.occurrence_counts(kid, M, O)
            lib_ms, lib_how = kernel_ms(lambda: torch.matmul(occ, ol.t()), None, 20)
            diff = float((torch.matmul(occ, ol.t()) - got).abs().max())
            nnz = int((occ != 0).sum())
            bms, by = bound(2 * kid.numel() + nbytes(ol, got), 2 * nnz * P)
            log(f"kernel position_weights M={M} P={P} O={O} B={Bx}: bit-equal to plain "
                f"on the card and on the CPU, kernel {ms:.4f} ms ({how}), plain "
                f"{plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms ({lib_how}; max |diff| "
                f"{diff:.3g}), bound {bms:.6f} ms ({by}; {nnz} nonzero counts of "
                f"{occ.numel()})")
            res[Bx] = dict(ms=ms, how=how, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bms,
                           by=by)
        if (M, P) == (64, 41):
            # the fixed cost at small batches: one window a block up to 2*132
            sweep = []
            for Bx in (1, 33, 132, 133, 264):
                kid = kid_all[:Bx]
                occ = pw.occurrence_counts(kid, M, O)
                ms, _ = kernel_ms(lambda: pw.position_weights(kid, ol, M),
                                  "position_weights", 20)
                lib_ms, _ = kernel_ms(lambda: torch.matmul(occ, ol.t()), None, 20)
                sweep.append(f"B={Bx} {ms:.4f} / {lib_ms:.4f}")
            log(f"kernel position_weights M={M} P={P}, kernel / torch.matmul ms by "
                f"batch: {'; '.join(sweep)}")
        full = res[Bn]
        path = None if pb is None else (pb, res[pb]["ms"], res[pb]["plain_ms"],
                                        res[pb]["bound_ms"])
        rows.append(row(f"position_weights[M={M},P={P}]", "position_weights", (M, P), 0.0,
                        full["ms"], full["plain_ms"], full["bound_ms"], full["by"],
                        full["lib_ms"],
                        timed_by="/".join(sorted({r["how"] for r in res.values()})),
                        path=path))
    return rows


def paged_family_batch(seqs, lens, nsegs, families, fi: int, page_len: int):
    """A B-row paged batch of family ``fi`` from the real windows: those the
    router sends to it (else those that fit it), repeated in order up to B
    rows and cut where the pages would overflow one pool, as the router
    cuts. Returns (paged batch, real windows used)."""
    from daccord_tpu_torch.kernels import paging
    from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch

    fam = families[fi]
    pgs = paging.window_pages(lens, page_len)
    idx = np.nonzero(paging.assign_family(families, nsegs, pgs) == fi)[0]
    if not len(idx):
        idx = np.nonzero((nsegs <= fam.depth) & (pgs <= fam.pages))[0]
    rows = np.resize(idx, B)
    take = max(int(np.searchsorted(np.cumsum(pgs[rows]), B * fam.budget,
                                   side="right")), 1)
    rows = rows[:take]
    dense = WindowBatch(seqs=seqs[rows, :fam.depth], lens=lens[rows, :fam.depth],
                        nsegs=nsegs[rows],
                        shape=BatchShape(depth=fam.depth, seg_len=seqs.shape[2]),
                        read_ids=np.zeros(len(rows), np.int64),
                        wstarts=np.zeros(len(rows), np.int64))
    return paging.pack_paged(dense, fam, target_rows=B), len(idx)


def gather_kernel_phase(seqs, lens, nsegs, families, page_len: int, dev) -> list[dict]:
    """``gather_pages`` once per shape family."""
    from daccord_tpu_torch.kernels import gather_pages
    from daccord_tpu_torch.tools.timing import event_ms, kernel_ms

    rows = []
    for fi, fam in enumerate(families):
        pb, n_real = paged_family_batch(seqs, lens, nsegs, families, fi, page_len)
        gather_pages.check_table(pb.table, pb.pool.shape[0])
        pool = torch.as_tensor(pb.pool, device=dev)
        table = torch.as_tensor(pb.table, device=dev)
        N, PPW = pool.shape[0], table.shape[1]
        got = gather_pages.gather_pages(pool, table)
        ref = gather_pages.gather_pages_plain(pool, table)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"gather_pages {fam.describe()}: kernel differs "
                                 f"from the plain version")
        ms, how = kernel_ms(lambda: gather_pages.gather_pages(pool, table),
                            "gather_pages_kernel", 50)
        plain_ms = event_ms(lambda: gather_pages.gather_pages_plain(pool, table), 20)
        flat = table.view(-1)
        lib_ms, lib_how = kernel_ms(
            lambda: pool.index_select(0, flat).view(B, PPW, fam.page_len), None, 50)
        # the table read once, every distinct page it references read once,
        # the output written once; no arithmetic
        pages = int(torch.unique(table).numel())
        bms, by = bound(nbytes(table, got) + pages * fam.page_len, 0)
        log(f"kernel gather_pages {fam.describe()} B={B}: pool {N} x {fam.page_len}, "
            f"table {B} x {PPW}, {pb.size} rows from {n_real} real windows, "
            f"{pages} distinct pages; bit-equal to plain, kernel {ms:.4f} ms ({how}), "
            f"plain {plain_ms:.4f} ms, index_select {lib_ms:.4f} ms ({lib_how}), bound "
            f"{bms:.6f} ms ({by})")
        rows.append(row(f"gather_pages[{fam.describe()}]", "gather_pages", (N, PPW),
                        0.0, ms, plain_ms, bms, by, lib_ms, timed_by=how))
    return rows


def profile_call(call) -> tuple[float, int, float]:
    """One call under ``torch.profiler``: (wall ms, device kernels, device
    busy ms); kernels 0 when the profiler records no device events."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall_ms, len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def ladder_breakdown(ladder, seqs, lens, nsegs) -> None:
    """Where one B-window ladder call goes: tier 0's three stages timed with
    CUDA events, the whole call, and the device kernels and busy share of
    the call from a ``torch.profiler`` trace; then the same call with the
    design before the two new kernels (the torch rescore, W by
    ``torch.matmul``), timed and counted the same way, in turns."""
    from daccord_tpu_torch.kernels import dp_backtrack, rescore, window_kernel
    from daccord_tpu_torch.kernels.position_weights import occurrence_counts
    from daccord_tpu_torch.kernels.tiers import ladder_core
    from daccord_tpu_torch.kernels.window_kernel import prep_batch, rescore_pick
    from daccord_tpu_torch.tools.timing import event_ms

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
    prep_ms = event_ms(lambda: prep_batch(seqs, lens, nsegs, ol, p), 5)
    dp_ms = event_ms(lambda: dp_backtrack.dp_backtrack_batch(*ins, **kw), 5)
    resc_ms = event_ms(lambda: rescore_pick(seqs, lens, nsegs, cand, clen, ok, p), 5)
    tables = tuple(ladder.tables[q.k] for q in ladder.params)
    call = lambda: ladder_core(seqs, lens, nsegs, tables, tuple(ladder.params))  # noqa: E731
    ladder_ms = event_ms(call, 3)
    log(f"ladder breakdown, B={seqs.shape[0]}: tier-0 prep {prep_ms:.3f} ms (W by the "
        f"position_weights kernel), dp_backtrack {dp_ms:.3f} ms, rescore kernel "
        f"{resc_ms:.3f} ms; whole ladder call {ladder_ms:.3f} ms")

    def torch_design():
        # the rescore in torch and W by cuBLAS, as before the two kernels
        return (("rescore_pick", rescore.rescore_pick_plain),
                ("position_weights", lambda kid, o, M: torch.matmul(
                    occurrence_counts(kid, M, o.shape[1]), o.t())))

    def with_design(design, fn):
        saved = {name: getattr(window_kernel, name) for name, _ in design}
        for name, f in design:
            setattr(window_kernel, name, f)
        try:
            return fn()
        finally:
            for name, f in saved.items():
                setattr(window_kernel, name, f)

    old_ms = with_design(torch_design(), lambda: event_ms(call, 3))
    resc_old_ms = event_ms(lambda: rescore.rescore_pick_plain(seqs, lens, nsegs, cand, clen,
                                                              ok, p), 3)
    turns = []
    for tag in ("kernels", "torch", "torch", "kernels"):
        design = torch_design() if tag == "torch" else ()
        turns.append((tag, with_design(design, lambda: profile_call(call))))
    log(f"ladder call, torch design (torch rescore {resc_old_ms:.3f} ms, W by "
        f"torch.matmul): whole call {old_ms:.3f} ms")
    for tag, (wall_ms, n, busy_ms) in turns:
        if n:
            log(f"ladder call under torch.profiler, {tag}: wall {wall_ms:.3f} ms, {n} "
                f"device kernels, device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.4f} "
                f"of the wall)")
        else:
            log(f"ladder call under torch.profiler, {tag}: wall {wall_ms:.3f} ms, no "
                f"device events (launches not measured)")


LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch")


def profile_launches(call) -> dict:
    """One call under ``torch.profiler``: its wall, the device kernels and
    their busy time, and the host's launch calls (``cudaLaunchKernel`` and
    its kin, ``cudaGraphLaunch`` apart) and copies."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.name for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    return dict(wall_ms=wall_ms, kernels=len(kernels),
                busy_ms=sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
                launches=sum(n in LAUNCH_APIS and n != "cudaGraphLaunch" for n in names),
                graph_launches=names.count("cudaGraphLaunch"),
                copies=sum(n.startswith(("cudaMemcpy", "cudaMemset")) for n in names))


def graph_phase(prof, cfg, seqs, lens, nsegs, dev) -> None:
    """Phase 6b: one call of the ladder on B real windows through the CUDA
    graphs (``kernels/graphs.py``, a cache of its own) against the eager
    ladder on the card: bit-equal at each escalation width (``esc_cap``,
    no count read) and at the width a call picks, first call (warm-up and
    capture) and replays alike; then each form's wall (the median of 20)
    and host CPU a call (their mean), its device kernels, busy time and the host's launch
    calls under ``torch.profiler``, and the graphs' memory."""
    from daccord_tpu_torch.kernels import graphs
    from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch
    from daccord_tpu_torch.kernels.tiers import (TierLadder, _ladder_packed, ladder_core,
                                                 pack_result)

    hb = WindowBatch(seqs=seqs[:B], lens=lens[:B], nsegs=nsegs[:B],
                     shape=BatchShape(depth=seqs.shape[1], seg_len=seqs.shape[2]),
                     read_ids=np.zeros(B, np.int64), wstarts=np.zeros(B, np.int64))
    lg = TierLadder.from_config(prof, cfg.consensus, device=dev)
    le = TierLadder.from_config(prof, cfg.consensus, device=dev, graphs=False)
    ins = tuple(torch.as_tensor(a, device=dev) for a in (hb.seqs, hb.lens, hb.nsegs))
    tables = tuple(le.tables[p.k] for p in le.params)
    cache = graphs.GraphCache()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    checked = []
    for E in (*graphs.widths(B), None):
        want = (pack_result(ladder_core(*ins, tables, tuple(le.params), esc_cap=E))
                if E is not None else _ladder_packed(hb, le))
        got = [cache.run(hb, lg, esc_cap=E) for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(g, want) for g in got):
            raise AssertionError(f"graph ladder at width {E or 'picked'} differs from the "
                                 f"eager ladder")
        over = int(want[0, -1].item()) >> 6
        checked.append(f"{E or 'picked'} (overflow {over})")
    log(f"graph phase, {B} real windows: the graph replay (first call and replay) is "
        f"bit-equal to the eager ladder at widths {', '.join(checked)}; {cache.captures} "
        f"graphs captured in {cache.capture_s:.3f} s; device memory reserved "
        f"{(torch.cuda.memory_reserved() - m0) / 2**30:.3f} GiB more, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    def timed(call, n: int = 20) -> tuple[float, float]:
        # the thread's CPU clock ticks coarsely on some hosts: its total
        # over the n calls, a call's share of it
        walls = []
        c0 = time.thread_time()
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls)) * 1e3, (time.thread_time() - c0) / n * 1e3

    forms = (("eager", lambda: _ladder_packed(hb, le)),
             ("graphs, picked width", lambda: cache.run(hb, lg)),
             (f"graphs, width {B} (no count read)", lambda: cache.run(hb, lg, esc_cap=B)))
    for tag, call in forms:
        wall_ms, cpu_ms = timed(call)
        pr = profile_launches(call)
        log(f"ladder call, {tag}: {wall_ms:.3f} ms wall (median of 20), {cpu_ms:.3f} ms "
            f"host CPU (the mean); under torch.profiler {pr['kernels']} device kernels, busy "
            f"{pr['busy_ms']:.3f} ms of {pr['wall_ms']:.3f} ms; host launch calls "
            f"{pr['launches']}, graph launches {pr['graph_launches']}, copies {pr['copies']}")


def daccord(argv: list[str], counters, on_card: bool = True) -> tuple:
    """One in-process ``daccord`` run with every kernel's launch counts set
    to 0 just before and read just after: (stats, {kernel: (launches,
    launches by shape)}). With ``on_card`` a run whose supervisor failed
    over, moving work off the card, raises."""
    for mod in counters:
        mod.launches = 0
        mod.launches_by_shape.clear()
        getattr(mod, "windows_by_shape", {}).clear()
    from daccord_tpu_torch.tools.cli import daccord_run

    stats, _ = daccord_run(argv)
    torch.cuda.synchronize()
    if on_card and (stats.degraded or stats.sup_counters.get("degraded_solves")):
        raise AssertionError(f"daccord {' '.join(argv)}: the supervisor failed over "
                             f"({stats.fallback_reason})")
    if stats.audit_disabled:
        raise AssertionError(f"daccord {' '.join(argv)}: audit.disabled "
                             f"({stats.audit_disabled})")
    return stats, {mod.__name__.rsplit(".", 1)[1]: (
        mod.launches, dict(mod.launches_by_shape),
        dict(getattr(mod, "windows_by_shape", {}))) for mod in counters}


def mean_batches(launched: dict, kernel: str) -> dict:
    """The mean windows a launch of ``kernel`` took, by (M, P), rounded."""
    _, by_shape, windows = launched[kernel]
    return {key: max(1, round(windows[key] / n)) for key, n in by_shape.items() if n}


def else_s(stats) -> float:
    """The wall less the ingest scan, windowing, ladder dispatch, the wait
    in fetch and the profile/family sample: scatter, stitch and FASTA."""
    return (stats.wall_s - stats.ingest_s - stats.windowing_s - stats.ladder_s
            - stats.device_s - stats.profile_s)


def pinned_peak() -> str:
    """Peak pinned host memory of the caching host allocator, where this
    torch reports it."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return "not reported by this torch"
    peaks = {k: v for k, v in stats().items() if "bytes" in k and "peak" in k}
    return ", ".join(f"{k} {v}" for k, v in sorted(peaks.items())) or "not reported"


def log_run(tag: str, stats, launched: dict) -> None:
    n = max(stats.n_batches, 1)
    log(f"daccord {tag}: reads {stats.n_reads}, windows {stats.n_windows}, solved "
        f"{stats.n_solved} ({stats.n_solved / max(stats.n_windows, 1):.4f}), "
        f"skipped shallow {stats.n_skipped_shallow}, batches {stats.n_batches} "
        f"{dict(sorted(stats.batches_by_bucket.items()))}, "
        f"tiers {dict(sorted(stats.tier_histogram.items()))}, "
        f"fragments {stats.n_fragments}, bases out {stats.bases_out}, quarantined "
        f"{stats.n_quarantined} (ingest issues {stats.n_ingest_issues}, monster "
        f"piles {stats.n_monster_piles})")
    log(f"daccord {tag}: feeder {'host library' if stats.native_host else 'numpy'}, "
        f"QV ranking {'on' if stats.qv_ranked else 'off (no track)'}, ladder "
        f"calls in flight at most {stats.peak_inflight}")
    w = stats.wall_s
    log(f"daccord {tag}: wall {w:.3f} s, {stats.windows_per_sec():.1f} windows/s, "
        f"{stats.bases_per_sec():.1f} bases/s; ingest_s {stats.ingest_s:.3f} s, "
        f"windowing_s {stats.windowing_s:.3f} s, ladder_s {stats.ladder_s:.3f} s "
        f"({stats.ladder_s * 1e3 / n:.1f} ms per batch), device_s "
        f"{stats.device_s:.3f} s ({stats.device_s / w:.4f} of the wall; the ladder "
        f"calls' own wall solve_s {stats.solve_s:.3f} s), profile/"
        f"family sample {stats.profile_s:.3f} s, else {else_s(stats):.3f} s "
        f"({else_s(stats) / w:.4f}); pad waste {stats.pad_waste:.4f}, H2D "
        f"{stats.h2d_bytes} bytes ({stats.h2d_bytes / n:.0f} per batch)")
    log(f"daccord {tag}: CUDA graphs captured {stats.graphs} in graph_capture_s "
        f"{stats.graph_capture_s:.3f} s ({stats.graph_capture_s / w:.4f} of the wall), "
        f"replays {stats.graph_replays}; ladder.call threads' CPU solve_cpu_s "
        f"{stats.solve_cpu_s:.3f} s")
    if stats.n_dispatch_tier0:
        log(f"daccord {tag}: split ladder: {stats.n_dispatch_tier0} Stream A calls, "
            f"{stats.n_dispatch_rescue} Stream B calls "
            f"{[(r['rows'], r['reason']) for r in stats.rescue_dispatches]}, rescue "
            f"windows {stats.n_rescue_windows} in {stats.rescue_slots_executed} slots "
            f"(density {stats.rescue_density:.4f})")
    elif stats.rescue_slots_executed:
        log(f"daccord {tag}: fused ladder: rescue windows {stats.n_rescue_windows} in "
            f"{stats.rescue_slots_executed} escalation slots (density "
            f"{stats.rescue_density:.4f})")
    log(f"daccord {tag}: feeder stage profile {json.dumps(stats.stage_profile)}")
    log(f"daccord {tag}: supervisor {json.dumps(stats.sup_counters)}, degraded "
        f"{stats.degraded}; {audit_text(stats)}")
    for name, (total, by_shape, windows) in launched.items():
        shapes = ", ".join(f"{k}: {v}" for k, v in sorted(by_shape.items()))
        log(f"daccord {tag}: {name} launches {total} ({shapes})")
        if windows:
            means = ", ".join(f"{k}: {windows[k] / n:.1f}"
                              for k, n in sorted(by_shape.items()) if n)
            log(f"daccord {tag}: {name} mean windows per launch ({means})")


def daccord_with(argv: list[str], counters, **cfg):
    """:func:`daccord` with ``PipelineConfig`` fields the command line does
    not set; its stats."""
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig
    from daccord_tpu_torch.tools import cli

    real = cli.PipelineConfig
    cli.PipelineConfig = lambda **kw: PipelineConfig(**cfg, **kw)
    try:
        return daccord(argv, counters)[0]
    finally:
        cli.PipelineConfig = real


class eager_ladder:
    """Within it, every ``TierLadder.from_config`` builds a ladder that runs
    its stages eagerly (``graphs=False``): the ladder before the CUDA
    graphs, with the same sync-free stages."""

    def __enter__(self):
        from daccord_tpu_torch.kernels import tiers

        self.real = real = tiers.TierLadder.__dict__["from_config"]

        def from_config(cls, *a, **kw):
            kw.setdefault("graphs", False)
            return real.__func__(cls, *a, **kw)

        tiers.TierLadder.from_config = classmethod(from_config)
        return self

    def __exit__(self, *exc):
        from daccord_tpu_torch.kernels import tiers

        tiers.TierLadder.from_config = self.real


def audit_text(stats) -> str:
    w = stats.wall_s
    return (f"shadow audit (rate 1/64) audit_s {stats.audit_s:.4f} s, "
            f"{stats.audit_s / w:.4f} of the wall; audit_worker_s "
            f"{stats.audit_worker_s:.4f} s ({stats.audit_worker_s / w:.4f}); "
            f"{stats.audit_local} of {stats.sup_counters.get('audits', 0)} audits on the "
            f"pipeline's thread, their warm-up audit_warm_s "
            f"{stats.audit_warm_s:.4f} s ({stats.audit_warm_s / w:.4f}); the worker's start "
            f"{json.dumps({k: round(v, 3) for k, v in stats.audit_worker_start.items()})}")


def records(path: str) -> dict:
    from daccord_tpu_torch.formats.fasta import read_fasta

    return {r.name: r.seq for r in read_fasta(path)}


def read_id(name: str) -> int:
    return int(name[4:].split("/")[0])


def within_drift(got: dict, ref: dict, what: str) -> str:
    """ROADMAP's drift bound between two FASTA record sets (at least 95% of
    ``ref``'s records identical, bases within 0.5%, record counts within
    5%), or raise; returns the measured drift as text."""
    same = sum(got.get(n) == s for n, s in ref.items())
    bg, br = sum(map(len, got.values())), sum(map(len, ref.values()))
    text = (f"{same}/{len(ref)} records identical ({len(ref) - same} differ), "
            f"bases {bg} vs {br}")
    if (same < 0.95 * len(ref) or abs(bg - br) > 0.005 * br
            or abs(len(got) - len(ref)) > 0.05 * len(ref)):
        raise AssertionError(f"{what}: drifted past the parity bound: {text}")
    return text


def corrupt_copy(src: str, dst: str) -> list[tuple[int, int, str]]:
    """Copy a LAS with two records corrupted: record 5's abpos gets its top
    bit flipped (framing intact, coordinates out of bounds) and the record
    two thirds in gets bit 30 of its tlen set (framing lost). Returns
    (record offset, aread, field) of each."""
    with open(src, "rb") as fh:
        data = bytearray(fh.read())
    tspace = int.from_bytes(data[8:12], "little")
    tsize = 1 if tspace <= 125 else 2
    offs, pos = [], 16
    while pos < len(data):
        offs.append(pos)
        pos += 40 + int.from_bytes(data[pos:pos + 4], "little", signed=True) * tsize
    out = []
    for off, field, byte, bit in ((offs[4], "abpos", 8 + 3, 0x80),
                                  (offs[2 * len(offs) // 3], "tlen", 3, 0x40)):
        data[off + byte] ^= bit
        out.append((off, int.from_bytes(data[off + 28:off + 32], "little"), field))
    with open(dst, "wb") as fh:
        fh.write(bytes(data))
    return out


def slice_checks(d: dict, eprof: str, dense: tuple, counters, tmp: str) -> None:
    """Phase 4b: the deque against one call in flight, buckets against one
    bucket, the ingest policies on a corrupted LAS, the monster guard and
    ``-J`` shards, each a ``daccord`` run on the 20 kb set with the dense
    fused run's flags (``dense``: its FASTA path and stats)."""
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.native.api import ColumnarLas

    dense_out, dense_stats = dense
    base = ["-E", eprof, "-b", str(B), "--device", DEVICE, "--paged", "off",
            "--dp", "fused"]
    clean = records(dense_out)

    def run(tag: str, las: str, *extra: str):
        out = os.path.join(tmp, f"check_{tag}.fasta")
        stats, launched = daccord([d["db"], las, "-o", out, *base, *extra], counters)
        if launched["dp_backtrack"][0] <= 0:
            raise AssertionError(f"{tag}: the run never launched dp_backtrack")
        return out, stats

    # the main run above was the process's first (cold); the deque runs again
    # after the synchronous run, so the two walls on the line are both warm.
    # Audit rate 0 and traced: each ladder call's span holds its wall and
    # its thread's CPU time (the rest it waited, for the card or the
    # interpreter lock)
    walls = []
    for tag, mi in (("sync", "1"), ("deque", "8"), ("eager deque", "8"),
                    ("eager sync", "1")):
        ev = os.path.join(tmp, f"trace_{tag.replace(' ', '_')}.jsonl")
        if tag.startswith("eager"):
            # the ladder before the graphs: the same stages, run eagerly
            with eager_ladder():
                out, st = run(tag.replace(" ", "_"), d["las"], "--max-inflight", mi,
                              "--audit-rate", "0", "--events", ev)
        else:
            out, st = run(tag, d["las"], "--max-inflight", mi, "--audit-rate", "0",
                          "--events", ev)
        with open(out, "rb") as a, open(dense_out, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{tag} (max_inflight {mi}) and the first run "
                                     f"wrote different FASTA")
        with open(ev) as fh:
            calls = [r for r in map(json.loads, fh)
                     if r["event"] == "span_close" and r["name"] == "ladder.call"]
        if len(calls) != st.n_batches:
            raise AssertionError(f"{tag}: {len(calls)} ladder.call spans for "
                                 f"{st.n_batches} batches")
        walls.append(f"{tag}: max_inflight {mi} wall {st.wall_s:.3f} s (ladder_s "
                     f"{st.ladder_s:.3f}, device_s {st.device_s:.3f}, solve_s "
                     f"{st.solve_s:.3f}, windowing_s "
                     f"{st.windowing_s:.3f}, else {else_s(st):.3f}; {len(calls)} "
                     f"ladder.call spans: wall {sum(r['wall_s'] for r in calls):.3f} s, "
                     f"their thread's CPU {sum(r['cpu_s'] for r in calls):.3f} s)")
    log(f"deque vs sync at audit rate 0, 20 kb dense fused -t 0, graphs and the eager "
        f"ladder, all after the first run: {'; '.join(walls)}; FASTA byte-identical to "
        f"the first run's")

    out, st = run("split", d["las"], "--ladder", "split")
    with open(out, "rb") as a, open(dense_out, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("--ladder split wrote another FASTA than --ladder fused")
    if not (st.n_dispatch_tier0 and st.n_dispatch_rescue):
        raise AssertionError(f"--ladder split ran {st.n_dispatch_tier0} Stream A and "
                             f"{st.n_dispatch_rescue} Stream B calls")
    log(f"--ladder split, 20 kb dense -t 0: FASTA byte-identical to --ladder fused; wall "
        f"{st.wall_s:.3f} s against {dense_stats.wall_s:.3f} s (the first run), solve_s "
        f"{st.solve_s:.3f}, device_s {st.device_s:.3f}, else {else_s(st):.3f}; "
        f"{st.n_dispatch_tier0} Stream A calls, {st.n_dispatch_rescue} Stream B calls "
        f"{[(r['rows'], r['reason']) for r in st.rescue_dispatches]}, rescue density "
        f"{st.rescue_density:.4f} against the fused run's {dense_stats.rescue_density:.4f}; "
        f"graphs captured {st.graphs} ({st.graph_capture_s:.3f} s)")

    out, st = run("one_bucket", d["las"], "--depth-buckets", "")
    log(f"one bucket (D32) vs buckets 8/16/32: {within_drift(records(out), clean, 'one bucket')}; "
        f"batches {st.n_batches} vs {dense_stats.n_batches}, pad waste "
        f"{st.pad_waste:.4f} vs {dense_stats.pad_waste:.4f}, wall {st.wall_s:.3f} vs "
        f"{dense_stats.wall_s:.3f} s")

    bad = os.path.join(tmp, "corrupt.las")
    hurt = corrupt_copy(d["las"], bad)
    try:
        run("strict", bad)
    except SystemExit as e:
        msg = str(e.code)
    else:
        raise AssertionError("the strict run over a corrupt LAS did not exit")
    for off, aread, _ in hurt:
        if f"offset={off}" not in msg or f"pile aread={aread}" not in msg:
            raise AssertionError(f"the strict report does not name offset {off} / "
                                 f"pile {aread}: {msg}")
    if not msg.startswith("daccord: ingest integrity failure (2 issues)"):
        raise AssertionError(f"strict run: unexpected report {msg}")
    log(f"strict ingest over the corrupted LAS exits: {msg.splitlines()[0]} "
        f"{' | '.join(x.strip() for x in msg.splitlines()[1:3])}")

    side = os.path.join(tmp, "quarantine.jsonl")
    out, st = run("quarantine", bad, "--ingest-policy", "quarantine",
                  "--quarantine", side)
    with open(side) as fh:
        rows = [json.loads(x) for x in fh]
    named = sorted(a for _, a, _ in hurt)
    if sorted(r["aread"] for r in rows) != named or st.n_quarantined != 2:
        raise AssertionError(f"quarantine: sidecar {rows}, {st.n_quarantined} "
                             f"quarantined; expected reads {named}")
    got = records(out)
    db = read_db(d["db"])
    for r in named:
        if (got.get(f"read{r}/0") != "".join("ACGT"[b] for b in db.read_bases(r))
                or f"read{r}/1" in got):
            raise AssertionError(f"quarantine: read {r} not emitted uncorrected")
    others = {n: s for n, s in clean.items() if read_id(n) not in named}
    log(f"quarantine run: {st.n_quarantined} piles contained ({[r['kind'] for r in rows]}), "
        f"reads {named} emitted uncorrected, sidecar rows {len(rows)}; other reads "
        f"vs the clean run: "
        f"{within_drift({n: s for n, s in got.items() if read_id(n) not in named}, others, 'quarantine')}")

    sizes = np.bincount(ColumnarLas(d["las"]).aread)
    deepest = [int(a) for a in np.nonzero(sizes == sizes.max())[0]]
    side = os.path.join(tmp, "monster.jsonl")
    out, st = run("monster", d["las"], "--max-pile-overlaps", str(int(sizes.max()) - 1),
                  "--quarantine", side)
    with open(side) as fh:
        rows = [json.loads(x) for x in fh]
    if (st.n_monster_piles != len(deepest) or [r["aread"] for r in rows] != deepest
            or {r["kind"] for r in rows} != {"monster_pile"}):
        raise AssertionError(f"monster guard: {st.n_monster_piles} piles, sidecar "
                             f"{rows}; expected the deepest piles {deepest}")
    got = records(out)
    log(f"monster guard at {int(sizes.max()) - 1} overlaps: contained piles {deepest} "
        f"({int(sizes.max())} overlaps each) only; other reads vs the clean run: "
        f"""{within_drift({n: s for n, s in got.items() if read_id(n) not in deepest},
                          {n: s for n, s in clean.items() if read_id(n) not in deepest},
                          'monster guard')}""")

    parts = []
    for i in range(3):
        out, st = run(f"shard{i}", d["las"], "-J", f"{i},3")
        with open(out) as fh:
            parts.append(fh.read())
        log(f"-J {i},3: reads {st.n_reads}, windows {st.n_windows}, wall {st.wall_s:.3f} s")
    with open(dense_out) as fh:
        if "".join(parts) != fh.read() or not all(parts):
            raise AssertionError("-J 0,3 + 1,3 + 2,3 differ from the unsharded FASTA")
    log("-J 0,3 + -J 1,3 + -J 2,3 concatenated == the unsharded FASTA, byte for byte")


def audit_tail_text(stats) -> str:
    """The audit's tail: the wait at the final drain, each worker's backlog
    when the final flush began and the call it was running then, and each
    later part's send-to-solved seconds (``PipelineStats.audit_tail``)."""
    t = stats.audit_tail
    if not t:
        return "no audit workers"
    parts = t["tail_parts"]
    backs = [p["back_s"] for p in parts if p["back_s"] is not None]
    return (f"final drain audit_drain_s {stats.audit_drain_s:.4f} s "
            f"({stats.audit_drain_s / stats.wall_s:.4f} of the wall); at the final flush "
            f"each worker's queued windows {t['queued_windows']}, running calls "
            f"{t['running']}; {len(parts)} parts sent since ({sum(p['windows'] for p in parts)} "
            f"windows), send to solved {min(backs, default=0):.4f}-"
            f"{max(backs, default=0):.4f} s")


def hp_phase(d: dict, eprof: str, split_out: str, counters, tmp: str,
             nthreads: int) -> None:
    """Phase 4c: the homopolymer rescue (``oracle/hp.py``; the host library's
    ``hp_rescue_windows`` over each fetched batch), the native primary and
    patch mode, each a ``daccord`` run with the counts set to 0 before it
    (``split_out``: the 20 kb dense fused run's FASTA)."""
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.oracle.consensus import ConsensusConfig
    from daccord_tpu_torch.oracle.hp import HP_TIER
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig, estimate_profile_for_shard
    from daccord_tpu_torch.sim import SimConfig, make_dataset, score_vs_truth

    def hp_set(spec: dict, name: str):
        t0 = time.perf_counter()
        ds = make_dataset(tmp, SimConfig(**spec), name=name)
        ep = os.path.join(tmp, f"{name}_eprof.json")
        # one profile for every run of the set, estimated as an hp run does
        prof = estimate_profile_for_shard(
            read_db(ds["db"]), LasFile(ds["las"]),
            PipelineConfig(device=DEVICE, consensus=ConsensusConfig(hp_rescue=True)))
        prof.save(ep)
        log(f"hp dataset {spec}: made, profile estimated in "
            f"{time.perf_counter() - t0:.1f} s -> {prof}")
        return ds, ep

    def run(tag: str, ds: dict, ep: str, *extra: str, on_card: bool = True):
        out = os.path.join(tmp, f"hp_{tag.replace(' ', '_')}.fasta")
        stats, launched = daccord([ds["db"], ds["las"], "-o", out, "-E", ep, "-b", str(B),
                                   *extra], counters, on_card=on_card)
        err, raw = score_vs_truth(out, ds["truth"], read_db(ds["db"]))
        w = stats.wall_s
        log(f"hp {tag} ({' '.join(extra)}): windows {stats.n_windows}, solved "
            f"{stats.n_solved}; wall {w:.3f} s, {stats.windows_per_sec():.1f} windows/s; "
            f"n_hp_rescued {stats.n_hp_rescued} (tier {HP_TIER}: "
            f"{stats.tier_histogram.get(HP_TIER, 0)}), hp_wall_s {stats.hp_wall_s:.3f} s "
            f"({stats.hp_wall_s / w:.4f} of the wall); audit_s {stats.audit_s:.4f} s "
            f"({stats.audit_s / w:.4f}); corrected error {err:.6f} "
            f"(Q{-10 * math.log10(max(err, 1e-9)):.2f}), raw {raw:.6f}; launches "
            f"{ {k: v[0] for k, v in launched.items()} }")
        return out, stats, launched, err, raw

    big = dict(BIG_DATASET, seed=44, hp_indel_slope=1.0)
    ds, ep = hp_set(big, "hpbig")
    dense = ["--device", DEVICE, "--paged", "off", "--dp", "fused", "-t", str(nthreads)]
    _, off, l_off, e_off, raw = run("100 kb off", ds, ep, *dense, "--no-hp-rescue")
    if off.n_hp_rescued:
        raise AssertionError("--no-hp-rescue rescued windows")
    for tag, extra in (("100 kb median", ("--hp-rescue",)),
                       ("100 kb posterior", ("--hp-rescue", "--hp-vote", "posterior",
                                             "--hp-accept", "likelihood"))):
        _, st, launched, err, _ = run(tag, ds, ep, *dense, *extra)
        if not (st.n_hp_rescued > 0 and err < e_off):
            raise AssertionError(f"hp {tag}: rescued {st.n_hp_rescued} windows, error "
                                 f"{err:.6f} against {e_off:.6f} without the rescue")
        for name in ("dp_backtrack", "rescore", "position_weights"):
            if launched[name][0] <= 0:
                raise AssertionError(f"hp {tag} never launched {name}")

    small = dict(DATASET, hp_indel_slope=1.0)
    ds, ep = hp_set(small, "hp20")
    card_out, card, launched, e_card, _ = run(
        "20 kb paged scan", ds, ep, "--device", DEVICE, "--paged", "on", "--dp", "scan",
        "-t", str(nthreads), "--hp-rescue")
    for name in ("gather_pages", "heaviest_path"):
        if launched[name][0] <= 0:
            raise AssertionError(f"the paged scan hp run never launched {name}")
    if not (card.paged and card.n_hp_rescued > 0):
        raise AssertionError("the paged scan hp run shipped dense batches or rescued nothing")
    nat_out, nat, launched, _, _ = run("20 kb native (default hp)", ds, ep,
                                       "--backend", "native", on_card=False)
    if nat.n_hp_rescued <= 0 or any(v[0] for v in launched.values()):
        raise AssertionError("--backend native rescued nothing, or launched a kernel")
    exp_out, exp, _, e_nat, _ = run("20 kb native --hp-rescue", ds, ep, "--backend",
                                    "native", "--hp-rescue", on_card=False)
    with open(nat_out, "rb") as a, open(exp_out, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("--backend native: the default and an explicit "
                                 "--hp-rescue wrote different FASTA")
    # the native engine is not bit-equal to the card's ladder (its DP sums in
    # its own order), and one differing window changes a whole record, so
    # the bound is held on windows and bases (ROADMAP's drift bound) and on
    # the corrected error (the JAX package's cross-engine rule: within 2e-3)
    got, ref = records(exp_out), records(card_out)
    same = sum(got.get(n) == q for n, q in ref.items())
    text = (f"solved {exp.n_solved} vs {card.n_solved} of {card.n_windows} windows, "
            f"bases {exp.bases_out} vs {card.bases_out}, error {e_nat:.6f} vs "
            f"{e_card:.6f}, {same}/{len(ref)} records identical")
    if (abs(exp.n_solved - card.n_solved) > 0.005 * card.n_windows
            or abs(exp.bases_out - card.bases_out) > 0.005 * card.bases_out
            or abs(e_nat - e_card) >= 2e-3):
        raise AssertionError(f"native primary vs the card's hp run: {text}")
    log(f"native primary --hp-rescue vs the card's --hp-rescue (paged scan): {text}; "
        f"n_hp_rescued {exp.n_hp_rescued} vs {card.n_hp_rescued}")

    # patch mode on the clean 20 kb set, with the ledger of every window
    ledger = os.path.join(tmp, "patch_ledger.jsonl")
    out, st, launched, err, raw = run("20 kb clean, --mode patch", d, eprof, "--device",
                                      DEVICE, "--paged", "off", "--dp", "fused",
                                      "--mode", "patch", "--ledger", ledger)
    if st.n_end_trimmed:
        raise AssertionError("--mode patch trimmed read ends")
    got = records(out)
    by_read: dict = {}
    for name, seq in got.items():
        by_read.setdefault(read_id(name), []).append(seq)
    unsolved: dict = {}
    with open(ledger) as fh:
        for r in map(json.loads, fh):
            if r.get("event") == "window" and not r["solved"]:
                unsolved.setdefault(r["aread"], set()).add(r["widx"])
    db = read_db(d["db"])
    spans = 0
    cfg = ConsensusConfig()
    for aread, idx in unsolved.items():
        bases = "".join("ACGT"[b] for b in db.read_bases(aread))
        run_start = None
        for j in sorted(idx) + [None]:
            if run_start is not None and (j is None or j != prev + 1):
                # the run's patches join into the read's bases; the next
                # unsolved window's patch may take back up to w - adv bases
                # of its end (the JAX package's stitch), never its first
                # advance past the run's last start
                span = bases[run_start * cfg.adv:(prev + 1) * cfg.adv]
                if not any(span in rec for rec in by_read.get(aread, [])):
                    raise AssertionError(f"--mode patch: read {aread}'s unsolved windows "
                                         f"{run_start}-{prev} lost the read's bases")
                spans += 1
                run_start = None
            if j is not None and run_start is None:
                run_start = j
            prev = j
    split_recs = records(split_out)
    if not spans or len(got) >= len(split_recs) or not err < raw:
        raise AssertionError(f"--mode patch: {spans} unsolved spans, {len(got)} records "
                             f"against {len(split_recs)} split, error {err:.6f} vs raw {raw:.6f}")
    log(f"--mode patch, 20 kb: {spans} runs of unsolved windows each kept the read's own "
        f"bases (from the run's first start to one advance past its last); {len(got)} records for {st.n_reads} reads against {len(split_recs)} in "
        f"split mode (a read splits only where a stitch fails); corrected error "
        f"{err:.6f} vs raw {raw:.6f}")


def reference_cost(big: dict, eprof: str) -> None:
    """The audit worker's reference (the CPU ladder in numpy, ``audit/
    ladder.py``) on 32 and 256 real windows of the 100 kb set: bit-equal to
    the torch CPU ladder (``audit_reference``, on one torch thread), and
    each one's host seconds a call (the median of 3 after one warm-up)."""
    from daccord_tpu_torch.audit import ladder as np_ladder
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch
    from daccord_tpu_torch.kernels.tiers import TierLadder, audit_reference
    from daccord_tpu_torch.oracle.profile import ErrorProfile
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig

    def median_s(call) -> float:
        call()
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            secs.append(time.perf_counter() - t0)
        return float(np.median(secs))

    cfg = PipelineConfig(device="cpu")
    tl = TierLadder.from_config(ErrorProfile.load(eprof), cfg.consensus, device="cpu")
    ref, spec = audit_reference(tl), tl.spec()
    seqs, lens, nsegs = real_windows(read_db(big["db"]), LasFile(big["las"]), cfg, 256)
    n0 = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for n in (32, 256):
            s, ln, ns = seqs[:n], lens[:n], nsegs[:n]
            b = WindowBatch(seqs=s, lens=ln, nsegs=ns,
                            shape=BatchShape(depth=cfg.depth, seg_len=cfg.seg_len),
                            read_ids=np.zeros(n, np.int64), wstarts=np.zeros(n, np.int64))
            want, got = ref(b), np_ladder.solve_ladder(spec, s, ln, ns)
            for k in want:
                a, g = np.asarray(want[k]), np.asarray(got[k])
                if a.dtype == np.float32:
                    a, g = a.view(np.uint32), g.view(np.uint32)
                if a.dtype != g.dtype or not np.array_equal(a, g):
                    raise AssertionError(f"the numpy ladder's {k} differs from the torch "
                                         f"CPU ladder on {n} windows")
            t_np = median_s(lambda: np_ladder.solve_ladder(spec, s, ln, ns))
            t_torch = median_s(lambda: ref(b))
            tiers = {int(t): int(c) for t, c in zip(*np.unique(want["tier"],
                                                             return_counts=True))}
            log(f"audit reference on {n} windows (tiers {tiers}): the worker's "
                f"numpy ladder bit-equal to the torch CPU ladder; {t_np:.4f} s a call "
                f"({t_np / n * 1e3:.3f} ms a window) against the torch ladder's "
                f"{t_torch:.4f} s on 1 thread")
    finally:
        torch.set_num_threads(n0)


TRAP_RUN = """
import json, os, sys
from daccord_tpu_torch.kernels import window_kernel
from daccord_tpu_torch.tools.cli import daccord_run

real, calls = window_kernel.prep_batch, [0]


def prep(seqs, lens, nsegs, ol, p):
    g = real(seqs, lens, nsegs, ol, p)
    if g["adjW"].is_cuda:
        calls[0] += 1
        if calls[0] == int(os.environ["TRAP_AT"]):
            g["adjW"][0, 0, 0] = 1.0   # no bit holds it: the DP kernel traps
    return g


window_kernel.prep_batch = prep
stats, _ = daccord_run(sys.argv[1:])
print("STATS " + json.dumps(dict(degraded=stats.degraded, reason=stats.fallback_reason,
                                 counters=stats.sup_counters, n_solved=stats.n_solved)))
"""


def supervisor_phase(d: dict, eprof: str, counters, tmp: str) -> None:
    """Phase 7: ``daccord`` on the first quarter of the 20 kb set at ``-b
    512`` under each ``DACCORD_FAULT`` kind, against the clean run of the
    same shard; the native failover; a real kernel trap in a child process;
    an audit of every window."""
    base = [d["db"], d["las"], "-E", eprof, "-b", str(SUP_B), "--device", DEVICE,
            "--paged", "off", "--dp", "fused"]

    def run(tag: str, spec, *extra, shard=SUP_SHARD):
        out = os.path.join(tmp, f"sup_{tag}.fasta")
        ev = os.path.join(tmp, f"sup_{tag}.events.jsonl")
        env = {"DACCORD_COMPCACHE": os.path.join(tmp, f"cc_{tag}"),
               "DACCORD_SUP_BACKOFF_S": "0.05"}
        saved = {k: os.environ.get(k) for k in (*env, "DACCORD_FAULT")}
        os.environ.update(env)
        os.environ.pop("DACCORD_FAULT", None)
        if spec:
            os.environ["DACCORD_FAULT"] = spec
        try:
            stats, _ = daccord([*base, "-J", shard, "-o", out, "--events", ev, *extra],
                               counters, on_card=not spec)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        from daccord_tpu_torch.tools.eventcheck import validate_events

        errs = validate_events(ev, strict=True)
        if errs:
            raise AssertionError(f"supervisor {tag}: events fail eventcheck: {errs[:3]}")
        with open(ev) as fh:
            recs = [json.loads(x) for x in fh]
        chain = [f"{r['state_from']}>{r['state_to']}" for r in recs
                 if r["event"] == "sup_state"]
        return out, stats, recs, chain

    def text(path: str) -> str:
        with open(path) as fh:
            return fh.read()

    clean_out, clean_st, _, _ = run("clean", None, "--audit-rate", "0")
    ops = 2 * clean_st.n_batches
    log(f"supervisor phase, -J {SUP_SHARD} -b {SUP_B}: clean run {clean_st.n_windows} "
        f"windows, {clean_st.n_batches} batches, wall {clean_st.wall_s:.3f} s")
    cases = (("device_lost, --failover-backend cpu", f"device_lost:{ops // 2}",
              ("--failover-backend", "cpu", "--audit-rate", "0"),
              lambda st: st.degraded and "device_lost" in st.fallback_reason),
             ("fetch_hang", "fetch_hang:3", ("--audit-rate", "0"),
              lambda st: not st.degraded and st.sup_counters["timeouts"] == 1),
             ("dispatch_error", "dispatch_error:4", ("--audit-rate", "0"),
              lambda st: not st.degraded and st.sup_counters["retries"] == 1),
             ("device_oom", "device_oom:5", ("--audit-rate", "0"),
              lambda st: not st.degraded and st.n_capacity_events >= 1),
             ("sdc", "sdc:3", ("--audit-rate", "0.25"),
              lambda st: not st.degraded and st.sup_counters["sdc_detected"] == 1))
    for i, (tag, spec, extra, ok) in enumerate(cases):
        out, st, _, chain = run(f"case{i}", spec, *extra)
        if text(out) != text(clean_out):
            raise AssertionError(f"supervisor {tag} ({spec}): FASTA differs from the clean run")
        if not ok(st):
            raise AssertionError(f"supervisor {tag} ({spec}): unexpected outcome "
                                 f"{st.sup_counters}, degraded {st.degraded}")
        log(f"supervisor {tag} ({spec}): FASTA byte-identical to the clean run; wall "
            f"{st.wall_s:.3f} s; transitions {' '.join(chain)}; counters "
            f"{json.dumps(st.sup_counters)}; capacity events {st.n_capacity_events}, "
            f"ratchet {st.governor_ratchet}, audit_s {st.audit_s:.3f}")

    # auto is the native engine on cuda (a CPU rehearsal names it)
    auto = () if DEVICE == "cuda" else ("--failover-backend", "native")
    out, st, recs, chain = run("native", f"device_lost:{ops // 2}", "--audit-rate", "0", *auto)
    fb = [r["fallback"] for r in recs if r["event"] == "sup_failover"]
    if not st.degraded or fb != ["native-ladder"]:
        raise AssertionError(f"supervisor native failover: degraded {st.degraded}, {fb}")
    log(f"supervisor device_lost, default (native) failover: "
        f"{within_drift(records(out), records(clean_out), 'native failover')}; wall "
        f"{st.wall_s:.3f} s; transitions {' '.join(chain)}")

    trap_out = os.path.join(tmp, "sup_trap.fasta")
    res = subprocess.run(
        [sys.executable, "-c", TRAP_RUN, *base, "-J", SUP_SHARD, "-o", trap_out,
         "--failover-backend", "cpu", "--audit-rate", "0"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "TRAP_AT": "4", "DACCORD_COMPCACHE": os.path.join(tmp, "cc_trap")})
    if "STATS " not in res.stdout:
        raise AssertionError(f"the trapped run did not finish:\n{res.stdout[-2000:]}"
                             f"{res.stderr[-3000:]}")
    tstats = json.loads(res.stdout.split("STATS ", 1)[1].splitlines()[0])
    if not tstats["degraded"] or text(trap_out) != text(clean_out):
        raise AssertionError(f"the trapped run: {tstats}; FASTA identical "
                             f"{text(trap_out) == text(clean_out)}")
    log(f"supervisor, a real trap of dp_backtrack in a child process (exit "
        f"{res.returncode}): failed over ({tstats['reason']}), FASTA byte-identical to "
        f"the clean run; counters {json.dumps(tstats['counters'])}")

    small_out, _, _, _ = run("clean16", None, "--audit-rate", "0", shard="0,16")
    out, st, recs, _ = run("audit1", None, "--audit-rate", "1", shard="0,16")
    if any(r["event"] == "sup_sdc" for r in recs) or text(out) != text(small_out):
        raise AssertionError("an audit of every window of a clean run found a divergence")
    log(f"supervisor --audit-rate 1 on -J 0,16 ({st.n_windows} windows): no sup_sdc in "
        f"{st.sup_counters['audits']} audited batches, FASTA byte-identical; audit_s "
        f"{st.audit_s:.3f} s of a {st.wall_s:.3f} s wall")


def fasta_drift(a: str, b: str) -> tuple[int, int, int, int]:
    """(records of ``a``, records of ``b`` identical to them, bases of ``a``,
    bases of ``b``)."""
    from daccord_tpu_torch.formats.fasta import read_fasta

    ra = {r.name: r.seq for r in read_fasta(a)}
    rb = {r.name: r.seq for r in read_fasta(b)}
    same = sum(rb.get(n) == s for n, s in ra.items())
    return len(ra), same, sum(map(len, ra.values())), sum(map(len, rb.values()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from daccord_tpu_torch import native
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.kernels import (dp_backtrack, gather_pages, heaviest_path,
                                           nvcc, paging, position_weights, rescore)
    from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch
    from daccord_tpu_torch.kernels.tiers import (TierLadder, ladder_core,
                                                 ladder_core_paged, pack_result,
                                                 unpack_result)
    from daccord_tpu_torch.runtime.pipeline import (PipelineConfig,
                                                    estimate_profile_for_shard,
                                                    run_families)
    from daccord_tpu_torch.sim import SimConfig, make_dataset, score_vs_truth

    t_all = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    dev = torch.device(DEVICE)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:
        host = ex.submit(native.build)
        built = nvcc.build_many(KERNELS)
        host_path, host_s = host.result()
    native.load()
    log(f"build: {len(built)} kernels and the host library in "
        f"{time.perf_counter() - t0:.2f} s (nvcc sm_90a and g++, one process each, "
        f"in parallel)")
    gxx = subprocess.run([native.CXX, "--version"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    ncpu = len(os.sched_getaffinity(0))
    nthreads = min(8, ncpu)
    log(f"  host library: {os.path.relpath(host_path)} in {host_s:.2f} s ({gxx}; "
        f"{' '.join(native.CXX_FLAGS)}); usable CPUs {ncpu}, so N = {nthreads} "
        f"feeder threads")
    for name, (path, secs) in built.items():
        log(f"  {name}: {os.path.relpath(path)} in {secs:.2f} s")
        for line in nvcc.logs.get(name, "").splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")
    counters = (dp_backtrack, heaviest_path, gather_pages, rescore, position_weights)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        d = make_dataset(tmp, SimConfig(**DATASET))
        log(f"dataset {DATASET}: made in {time.perf_counter() - t0:.1f} s")
        db, las = read_db(d["db"]), LasFile(d["las"])
        cfg = PipelineConfig(batch_size=B, device=dev.type)
        t0 = time.perf_counter()
        prof, sample = estimate_profile_for_shard(db, las, cfg, return_windows=True)
        eprof = os.path.join(tmp, "eprof.json")
        prof.save(eprof)
        families = run_families(db, las, cfg, sample)
        log(f"profile pass: {time.perf_counter() - t0:.1f} s -> {prof}; "
            f"{len(sample)} sampled windows -> families "
            f"{[f.describe() for f in families]}")
        ladder = TierLadder.from_config(prof, cfg.consensus, device=dev)

        # ---- 3. feeder phase ----------------------------------------------
        feeder_phase(db, las, cfg, nthreads)

        # ---- 4. slice phase: the three main-path runs ------------------------
        t0 = time.perf_counter()
        big = make_dataset(tmp, SimConfig(**BIG_DATASET), name="big")
        big_db = read_db(big["db"])
        big_eprof = os.path.join(tmp, "big_eprof.json")
        estimate_profile_for_shard(big_db, LasFile(big["las"]), cfg).save(big_eprof)
        log(f"dataset {BIG_DATASET}: made, profile estimated in "
            f"{time.perf_counter() - t0:.1f} s; {big_db.nreads} reads, "
            f"{big_db.totlen} bases")
        runs = {}
        for tag, ds, ep, args in (
                ("dense fused", d, eprof, ["--paged", "off", "--dp", "fused"]),
                ("paged scan", d, eprof, ["--paged", "on", "--dp", "scan",
                                          "-t", str(nthreads)]),
                ("100 kb dense fused", big, big_eprof,
                 ["--paged", "off", "--dp", "fused", "-t", str(nthreads)])):
            out = os.path.join(tmp, f"out_{tag.replace(' ', '_')}.fasta")
            torch.cuda.reset_peak_memory_stats()
            stats, launched = daccord([ds["db"], ds["las"], "-o", out, "-E", ep,
                                       "-b", str(B), "--device", dev.type, *args],
                                      counters)
            log_run(f"{tag} ({' '.join(args)})", stats, launched)
            log(f"daccord {tag}: audit tail: {audit_tail_text(stats)}")
            packed = stats.peak_inflight * B * (-(-ladder.params[0].cons_len // 4) + 3) * 4
            log(f"daccord {tag}: peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB allocated (a "
                f"graph's memory counts in the run that captures it), "
                f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved; pinned host "
                f"memory {pinned_peak()}; packed results in flight at most "
                f"{stats.peak_inflight} x {B} rows (~{packed} bytes)")
            if stats.n_solved <= 0 or stats.bases_out <= 0:
                raise AssertionError(f"daccord {tag} solved no window")
            if not stats.native_host:
                raise AssertionError(f"daccord {tag} did not window through the "
                                     f"host library")
            runs[tag] = (out, stats, launched, ds)
            out0 = out + ".audit0"
            st0, _ = daccord([ds["db"], ds["las"], "-o", out0, "-E", ep, "-b", str(B),
                              "--device", dev.type, "--audit-rate", "0", *args], counters)
            with open(out, "rb") as a, open(out0, "rb") as b0:
                if a.read() != b0.read():
                    raise AssertionError(f"daccord {tag}: the audited FASTA differs from "
                                         f"the run at audit rate 0")
            log(f"daccord {tag}: FASTA byte-identical at audit rate 0 (wall {st0.wall_s:.3f} "
                f"s against {stats.wall_s:.3f} s at 1/64; solve_s {st0.solve_s:.3f}, "
                f"device_s {st0.device_s:.3f}, else {else_s(st0):.3f})")
            # the audit without its worker (every sample on the pipeline's
            # thread, on the torch CPU ladder), then the default again, warm
            # like the run at rate 0
            for label, worker in (("in-process audit only", False), ("default again", None)):
                st1 = daccord_with([ds["db"], ds["las"], "-o", out0, "-E", ep, "-b", str(B),
                                    "--device", dev.type, *args], counters,
                                   audit_worker=worker)
                with open(out, "rb") as a, open(out0, "rb") as b0:
                    if a.read() != b0.read():
                        raise AssertionError(f"daccord {tag}, {label}: FASTA differs")
                log(f"daccord {tag}, {label}: wall {st1.wall_s:.3f} s, FASTA "
                    f"byte-identical; {audit_text(st1)}; {audit_tail_text(st1)}")
                if worker is None:
                    share = st1.audit_s / st1.wall_s
                    log(f"audit share, warm {tag} rerun: {share:.4f} of the wall (the "
                        f"JAX package's contract: at most 0.02): "
                        f"{'met' if share <= 0.02 else 'missed'}")
        dense_launch = runs["dense fused"][2]
        paged_launch = runs["paged scan"][2]
        for run_launched, name in ((dense_launch, "dp_backtrack"),
                                   (dense_launch, "rescore"),
                                   (dense_launch, "position_weights"),
                                   (paged_launch, "heaviest_path"),
                                   (paged_launch, "gather_pages"),
                                   (paged_launch, "rescore"),
                                   (paged_launch, "position_weights"),
                                   (runs["100 kb dense fused"][2], "dp_backtrack"),
                                   (runs["100 kb dense fused"][2], "rescore")):
            if run_launched[name][0] <= 0:
                raise AssertionError(f"the main path never launched the {name} kernel")
        if not runs["paged scan"][1].paged:
            raise AssertionError("the paged run did not ship paged batches")
        n_rec, same, bases_a, bases_b = fasta_drift(runs["dense fused"][0],
                                                    runs["paged scan"][0])
        log(f"paged scan vs dense fused FASTA: {same}/{n_rec} records identical "
            f"({n_rec - same} differ), bases {bases_a} vs {bases_b}")
        if same < 0.95 * n_rec or abs(bases_a - bases_b) > 0.005 * bases_a:
            raise AssertionError("the paged scan run drifted past the parity bound")

        reference_cost(big, big_eprof)

        # ---- 4b. the slice's checks -----------------------------------------
        t0 = time.perf_counter()
        slice_checks(d, eprof, runs["dense fused"][:2], counters, tmp)
        log(f"slice checks: {time.perf_counter() - t0:.1f} s")

        # ---- 4c. the hp rescue, the native primary, patch mode ---------------
        t0 = time.perf_counter()
        hp_phase(d, eprof, runs["dense fused"][0], counters, tmp, nthreads)
        log(f"hp phase: {time.perf_counter() - t0:.1f} s")

        # ---- 5. kernel phase ------------------------------------------------
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
        path_b = {"dp_backtrack": mean_batches(dense_launch, "dp_backtrack"),
                  "heaviest_path": mean_batches(paged_launch, "heaviest_path")}
        rows = dp_kernel_phase(ladder, seqs, lens, nsegs, dev, path_b)
        rows += gather_kernel_phase(seqs, lens, nsegs, families, cfg.page_len, dev)
        rows += rescore_kernel_phase(ladder, seqs, lens, nsegs, dev,
                                     mean_batches(dense_launch, "rescore"))
        rows += weights_kernel_phase(ladder, seqs, lens, nsegs, dev,
                                     mean_batches(dense_launch, "position_weights"))

        # ---- 6. one batch through every route -------------------------------
        tseqs, tlens, tnsegs = (torch.as_tensor(a[:B], device=dev)
                                for a in (seqs, lens, nsegs))
        tables = tuple(ladder.tables[p.k] for p in ladder.params)
        params = tuple(ladder.params)
        kern = pack_result(ladder_core(tseqs, tlens, tnsegs, tables, params))
        plain = pack_result(ladder_core(tseqs, tlens, tnsegs, tables, params,
                                        dp=dp_backtrack.dp_backtrack_plain))
        scan = pack_result(ladder_core(tseqs, tlens, tnsegs, tables, params,
                                       route="scan"))
        full = paging.ShapeFamily(depth=cfg.depth, pages=cfg.depth * cfg.seg_len
                                  // cfg.page_len, page_len=cfg.page_len)
        pb = paging.pack_paged(WindowBatch(
            seqs=seqs[:B], lens=lens[:B], nsegs=nsegs[:B],
            shape=BatchShape(depth=cfg.depth, seg_len=cfg.seg_len),
            read_ids=np.zeros(B, np.int64), wstarts=np.zeros(B, np.int64)), full)
        gather_pages.check_table(pb.table, pb.pool.shape[0])
        ppool, ptable, plens, pnsegs = (torch.as_tensor(a, device=dev) for a in
                                        (pb.pool, pb.table, pb.lens, pb.nsegs))
        tile = paging.gather_windows(ppool, ptable, plens, page_len=cfg.page_len,
                                     seg_len=cfg.seg_len)
        paged_scan = pack_result(ladder_core_paged(
            ppool, ptable, plens, pnsegs, tables, params, page_len=cfg.page_len,
            seg_len=cfg.seg_len, route="scan"))
        torch.cuda.synchronize()
        if not torch.equal(tile, tseqs):
            raise AssertionError("the gathered paged tile differs from the dense tile")
        for what, got in (("the plain DP", plain), ("the scan route", scan),
                          ("the paged scan route", paged_scan)):
            if not torch.equal(got, kern):
                raise AssertionError(f"ladder with {what} differs from the fused "
                                     f"ladder on the card")
        res = unpack_result(kern.cpu().numpy(), params[0].cons_len)
        log(f"one batch of {B}: gathered paged tile == dense tile; ladder with the "
            f"fused kernel == plain DP == scan route == paged scan route on the "
            f"card, bit-equal; tiers {np.unique(res['tier'], return_counts=True)}")

        ladder_breakdown(ladder, tseqs, tlens, tnsegs)
        graph_phase(prof, cfg, seqs, lens, nsegs, dev)

        cpu = tuple(t.cpu() for t in tables)
        cpu_packed = pack_result(ladder_core(tseqs.cpu(), tlens.cpu(), tnsegs.cpu(), cpu,
                                             params))
        ref = unpack_result(cpu_packed.numpy(), params[0].cons_len)
        differ = int(sum(
            (res["solved"][i] != ref["solved"][i])
            or (res["solved"][i] and (res["cons_len"][i] != ref["cons_len"][i]
                                      or res["cons"][i].tobytes() != ref["cons"][i].tobytes()))
            for i in range(B)))
        same_bits = torch.equal(cpu_packed, kern.cpu())
        log(f"same batch through the CPU ladder: {differ}/{B} windows differ; packed "
            f"results (cons, cons_len, err, tier, top-M flag) bit-equal: {same_bits}")
        if differ or not same_bits:
            raise AssertionError(f"card and CPU ladders differ ({differ} windows; "
                                 f"bit-equal {same_bits})")

        # ---- 7. the supervisor ----------------------------------------------
        t0 = time.perf_counter()
        supervisor_phase(d, eprof, counters, tmp)
        log(f"supervisor phase: {time.perf_counter() - t0:.1f} s")

        for tag, (out, _, _, ds) in runs.items():
            t0 = time.perf_counter()
            err, raw = score_vs_truth(out, ds["truth"], read_db(ds["db"]))
            q = -10 * math.log10(max(err, 1e-9))
            log(f"accuracy vs truth, {tag}: corrected error rate {err:.6f} "
                f"(Q{q:.2f}), raw {raw:.6f} (scored in "
                f"{time.perf_counter() - t0:.1f} s)")
            if not err < raw / 2:
                raise AssertionError(f"{tag}: corrected reads are not clearly "
                                     f"better than raw")

    for r in rows:
        kernel = r.pop("kernel")
        run_launched = (paged_launch if kernel in ("heaviest_path", "gather_pages")
                        else dense_launch)
        r["launches"] = run_launched[kernel][1].get(r.pop("key"), 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "timed_by", "path_B",
            "path_ms", "path_plain_ms", "path_bound_ms")
    log(f"smoke total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
