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
   line), then (the 20 kb runs) with the audit on the pipeline's thread
   only (no worker, the torch CPU ladder) and with the default again
   (warm, as the run at rate 0 is), the paged run also with the numpy take of the audited rows
   (the take before the host library's); the audit's sends and the rows'
   take are printed with their wall and the pipeline thread's CPU time in
   them, and each warm rerun's wall against the run at rate 0. Then the
   worker's reference on 32 and 256 real
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
4c. hp phase, each run with the counts set to 0 before it: on the 20 kb
   set damaged by homopolymer indels (``hp_indel_slope`` 1.0; one profile
   estimated as an hp run does; a 100 kb hp set left the smoke for its
   time limit), dense fused ``-t N`` without the rescue, with ``--hp-rescue`` (median
   vote, rescore accept) and with ``--hp-rescue --hp-vote posterior
   --hp-accept likelihood``: each prints its wall, windows/s,
   ``n_hp_rescued``, ``hp_wall_s`` and its share of the wall, ``audit_s``
   and the corrected and raw error, and both rescue runs must rescue
   windows and beat the run without; on the same set
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
4d. workflow phase, the upstream daccord workflow through the port's
   command line (``daccord_tpu_torch.tools.cli``, in-process) on a 100 kb /
   30x set of 5 kb reads with a two-copy repeat (35% of the genome, 8%
   divergence) and 3% chimeras, seed 45; each step prints its wall and what
   it made: ``db2fasta`` then ``fasta2db`` rebuild the DB's files byte for
   byte; ``dbsplit`` into four blocks, ``lassplit``, ``lasmerge`` of the
   parts equal to the LAS, ``lassort`` of a seeded shuffle with about 100
   on-disk runs (a two-level merge) equal to its in-memory sort,
   ``lasindex``; ``inqual --block I`` for every block and ``catrack`` equal
   to the whole-DB ``inqual``; ``repeats -d 30 --factor 1.5``, ``filter``,
   ``filtersym --db`` in memory and partitioned (the same bytes), with the
   overlaps kept; ``shard -J 0,2`` dense fused and ``-J 1,2 --paged on --dp
   scan`` on the card over the symmetric LAS with the QV ranking on (each
   with the counts set to 0 before it: ``dp_backtrack``, ``gather_pages``,
   ``heaviest_path``, ``rescore`` and ``position_weights`` must launch), and
   shard 0 again with an ``InjectedCrash`` after its first checkpoint, then
   resumed: the same FASTA byte for byte; ``merge``, ``audit`` (the sha256
   chain, and one pile re-solved on the CPU ladder) and ``qveval``; the
   plain arm, ``daccord`` on the unfiltered LAS with ``--qv-track ''``, and
   the two mixed arms (the unfiltered LAS ranked, the filtered LAS
   unranked): every arm's error and Q beside the card's name and power
   limit, the track arm held below half the raw error;
4e. telemetry phase: the cost of ``--events`` on the 20 kb dense fused run
   (warm in this process, A B B A, B with ``--events``; fresh processes in
   turns are ``tools/wall_ab.py``'s, outside the smoke), and one warm run
   of each under cProfile: the pipeline thread's own time in the telemetry
   functions,
   the 100 kb dense fused run again with ``--events``,
   ``--metrics-snapshot-s 2`` and ``DACCORD_PROFILE_DIR`` (a torch.profiler
   capture of its second ladder call, the JAX package's bracket: from its
   dispatch to the drain that fetches it, the other calls in flight; again
   at the 5th call, the one that hung before the repair, bounded at 120 s),
   read by the
   port's own tools:
   ``eventcheck --strict``, ``trace --check --json`` (the wall's split
   into spans, with "else" split into the pile loop's own work, the
   flushes and the hp pass, and the rest), ``prof --check`` (the feeder's
   stage table, the gauges and the verdict), ``top --once`` and
   ``sentinel --strict`` over the events and the rollup's ``.prom``; the
   capture must have written its trace and ``shard_done`` must be there.
   The warm 20 kb run again under ``--profile DIR`` (one capture of the
   whole run, a faulthandler dump bounding it): a trace, the same FASTA.
   Then the supervisor phase's quarter of the 20 kb set, clean and under
   ``DACCORD_FAULT=feeder_stall:50``: the same FASTA byte for byte, and the
   stalled run's verdict ``host_feeder`` with ``stall`` its named stage;
   warm graphed runs are ``host_feeder`` already, so the flip is held on
   the eager ladder (``graphs=False``), whose host launches keep the card
   busy: the warm 20 kb dense fused run clean, then under the stall, in
   this process; the clean verdict must not be ``host_feeder`` and the
   stalled one must, same bytes;
4f. serve phase, the serving plane through its real entry point: three
   ``python -m daccord_tpu_torch.tools.cli serve --backend cuda -b 2048``
   processes on an ephemeral port, each driven over HTTP and stopped by
   SIGTERM (exit 0, ``serve.done``; ``eventcheck --strict`` on the
   service's, the groups' and the jobs' event files; ``top --once`` on the
   workdir). The dense fused service (``--workers 4``, ``--idle-evict-s
   10``) takes three 20 kb jobs from two tenants and one 100 kb job at once;
   each job's streamed FASTA (and its ``result``) must be byte-identical to
   a solo card run of ``serve.jobs.build_job_config``'s config; it prints
   each job's latency, the service's windows/s against the solo runs' sum,
   the batches holding rows of more than one job, the warm
   hits and misses (two groups, two hits), each group's ``saturation()``,
   graphs (captured at its build) and governor, and the kernels' launch
   counts in that process (``dp_backtrack``, ``rescore`` and
   ``position_weights`` must launch; the capture warm-ups are not
   counted); then both groups must evict at the TTL and the process's
   allocated device memory fall back within 64 MiB of its value before the
   first group. The paged scan service (``--paged --dp scan``) takes two
   20 kb jobs, byte-identical to a solo paged scan card run, and must
   launch ``gather_pages``, ``heaviest_path``, ``rescore`` and
   ``position_weights``. The faulted service (``DACCORD_FAULT=device_oom:1``,
   ``--workers 3 --flush-lag-ms 1000``) takes three 20 kb jobs: the OOM
   leaves a ceiling at half the width, every later merged batch (mixed ones
   among them, at least one) runs bisected, and the bytes do not move;
4g. fleet and router phase, the multi-process layer through its entry
   points (``python -m daccord_tpu_torch.tools.cli fleet|shard|serve|
   router``), each process counting its own kernel launches (the shards in
   ``shardNNNN.launches.json``, the peers in ``/v1/metrics``): the 100 kb
   set through ``fleet -n 4 --backend cuda -b 2048 --merge`` at 1, 2 and 4
   workers (``-t`` = the CPUs over the workers, at most 8), each fleet's
   wall to the merged FASTA, windows/s, its workers' walls and saturation
   gauges and the card's peak used memory (``nvidia-smi`` every 0.5 s);
   the four shards as ``shard`` processes in turn; phase 4's single-process
   run; every merged FASTA byte-identical to the in-turn shards'. The fleet
   at W=2 under ``DACCORD_FAULT=worker_crash:1,worker_oom:2,lease_stall:1``
   (same bytes, the OOM'd shard requeued once at ``-b 1024``, its event
   file clean under ``eventcheck --strict``); the paged scan route's fleet
   (``-n 2`` on the 20 kb set) against its in-turn shards. Then two
   ``serve --backend cuda -b 2048 --peer-dir P --aot-cache A`` peers, each
   run from a copy of the package with no kernel library in its build
   directory (a peer on another host: the first builds and publishes the
   five kernels, the second installs them from the cache), and a ``router
   --peer-dir P``: 4f's dense mix through the router, every job
   byte-identical to its solo card run, with its latency and the windows/s
   against the solo runs' sum and against 4f's one service; the owner of
   tenant a SIGKILLed in the middle of a proxied stream, the same
   idempotency key resubmitted through the router until it lands, exactly
   once, on the survivor, with the solo bytes; five ``aot.publish`` on the
   first peer, five ``aot.hit`` on the second; a third peer started after
   one byte of ``rescore``'s cache entry is flipped logs ``aot.reject
   reason=corrupt``, builds that kernel with nvcc, re-publishes it and
   serves the same bytes;
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
import shutil
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
# the workflow phase's set: the 100 kb / 30x shape with a two-copy repeat and
# chimeras (the JAX package's ladderbench cfg6 repeat)
WORKFLOW_DATASET = dict(BIG_DATASET, repeat_fraction=0.35, repeat_divergence=0.08,
                        p_chimera=0.03, seed=45)
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


def zero_counts(counters) -> None:
    """Set every kernel wrapper's launch counts to 0."""
    for mod in counters:
        mod.launches = 0
        mod.launches_by_shape.clear()
        getattr(mod, "windows_by_shape", {}).clear()


def daccord(argv: list[str], counters, on_card: bool = True) -> tuple:
    """One in-process ``daccord`` run with every kernel's launch counts set
    to 0 just before and read just after: (stats, {kernel: (launches,
    launches by shape)}). With ``on_card`` a run whose supervisor failed
    over, moving work off the card, raises."""
    zero_counts(counters)
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
    log(f"daccord {tag}: feeder stage profile {json.dumps(stats.stage_profile)}; "
        f"host_s {stats.host_s:.3f} s, verdict {stats.verdict} "
        f"{json.dumps(stats.bottleneck)}")
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
            f"{stats.audit_s / w:.4f} of the wall (its sends {stats.audit_send_s:.4f} s, "
            f"CPU {stats.audit_send_cpu_s:.4f} s; of which taking the sampled rows "
            f"{stats.audit_take_s:.4f} s, CPU {stats.audit_take_cpu_s:.4f} s: the "
            f"pipeline thread's CPU time, a 10 ms clock on some hosts); audit_worker_s "
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

    # the vote arms on the 20 kb hp set (the 100 kb one's three runs, ~50 s,
    # left the smoke for its time limit)
    small = dict(DATASET, hp_indel_slope=1.0)
    ds, ep = hp_set(small, "hp20")
    dense = ["--device", DEVICE, "--paged", "off", "--dp", "fused", "-t", str(nthreads)]
    _, off, l_off, e_off, raw = run("20 kb off", ds, ep, *dense, "--no-hp-rescue")
    if off.n_hp_rescued:
        raise AssertionError("--no-hp-rescue rescued windows")
    for tag, extra in (("20 kb median", ("--hp-rescue",)),
                       ("20 kb posterior", ("--hp-rescue", "--hp-vote", "posterior",
                                            "--hp-accept", "likelihood"))):
        _, st, launched, err, _ = run(tag, ds, ep, *dense, *extra)
        if not (st.n_hp_rescued > 0 and err < e_off):
            raise AssertionError(f"hp {tag}: rescued {st.n_hp_rescued} windows, error "
                                 f"{err:.6f} against {e_off:.6f} without the rescue")
        for name in ("dp_backtrack", "rescore", "position_weights"):
            if launched[name][0] <= 0:
                raise AssertionError(f"hp {tag} never launched {name}")

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


def counted(call, counters) -> dict:
    """``call()`` with every kernel's launch counts set to 0 just before and
    read just after: {kernel: launches}."""
    zero_counts(counters)
    call()
    torch.cuda.synchronize()
    return {mod.__name__.rsplit(".", 1)[1]: mod.launches for mod in counters}


def workflow_phase(counters, tmp: str, nthreads: int, smi: str) -> None:
    """Phase 4d: the upstream daccord workflow through the port's command
    line on the workflow set (:data:`WORKFLOW_DATASET`): round trips, the
    sort and merge, the block tracks, the filters, two checkpointed shards
    on the card with the QV ranking on, a crash and resume, the merge gate,
    the audit and the Q of both arms. Each step prints its wall and what it
    made, and raises on a broken contract."""
    import random
    import shutil

    from daccord_tpu_torch.formats.dazzdb import db_blocks, read_db
    from daccord_tpu_torch.formats.las import LasFile, write_las
    from daccord_tpu_torch.parallel import launch
    from daccord_tpu_torch.runtime.faults import InjectedCrash
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig, load_qv_ranker
    from daccord_tpu_torch.sim import SimConfig, make_dataset
    from daccord_tpu_torch.tools import cli

    walls: list[tuple[str, float]] = []

    def tool(step: str, *argv: str):
        t0 = time.perf_counter()
        rc = cli.main(list(argv))
        walls.append((step, time.perf_counter() - t0))
        if rc != 0:
            raise AssertionError(f"workflow: {' '.join(argv[:1])} exited {rc}")
        log(f"workflow {step}: {walls[-1][1]:.3f} s")

    def same(a: str, b: str) -> bool:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            return fa.read() == fb.read()

    t0 = time.perf_counter()
    w = os.path.join(tmp, "wf")
    ds = make_dataset(w, SimConfig(**WORKFLOW_DATASET), name="wf")
    db_path, las_path = ds["db"], ds["las"]
    las = LasFile(las_path)
    nreads = read_db(db_path, load_bases=False).nreads
    log(f"workflow dataset {WORKFLOW_DATASET}: made in {time.perf_counter() - t0:.1f} s; "
        f"{nreads} reads, {las.novl} overlaps")

    # 1. db2fasta, then fasta2db: the rebuilt DB's files equal the original's
    fa = os.path.join(w, "reads.fasta")
    tool("db2fasta", "db2fasta", db_path, "-o", fa)
    os.makedirs(os.path.join(w, "re"))
    re_db = os.path.join(w, "re", "wf.db")
    tool("fasta2db", "fasta2db", fa, re_db)
    for f in ("wf.db", ".wf.idx", ".wf.bps", ".wf.names"):
        if not same(os.path.join(w, f), os.path.join(w, "re", f)):
            raise AssertionError(f"workflow: fasta2db of db2fasta changed {f}")
    log(f"workflow: db2fasta -> fasta2db rebuilt the DB's .db, .idx, .bps and "
        f".names byte for byte ({os.path.getsize(fa)} bytes of FASTA)")

    # 2. four DB blocks, lassplit, a sort with on-disk runs and a multi-level
    # merge of a seeded shuffle, lasmerge of the parts, lasindex
    total = os.path.getsize(os.path.join(w, ".wf.bps")) * 4
    tool("dbsplit", "dbsplit", db_path, "-s", f"{total / 4 / 1e6 * 1.02:.6f}")
    nb = len(db_blocks(db_path))
    if nb < 2:
        raise AssertionError(f"workflow: dbsplit made {nb} block")
    tool("lassplit", "lassplit", las_path, db_path, os.path.join(w, "part.#.las"))
    parts = [os.path.join(w, f"part.{i}.las") for i in range(1, nb + 1)]
    ovls = list(las)
    random.Random(45).shuffle(ovls)
    shuf, ref = os.path.join(w, "shuf.las"), os.path.join(w, "ref.las")
    write_las(shuf, las.tspace, ovls)
    # the simulator orders a pile's records by its own rule, so the sort's
    # reference is the in-memory stable sort of the shuffle
    write_las(ref, las.tspace, sorted(ovls, key=lambda o: (o.aread, o.bread, o.abpos)))
    del ovls
    mem = max(1, las.novl // 100)       # ~100 runs: on-disk runs, two merge levels
    tool("lassort", "lassort", shuf, os.path.join(w, "sorted.las"), "--mem-records", str(mem))
    tool("lasmerge", "lasmerge", os.path.join(w, "merged.las"), *parts)
    if not same(os.path.join(w, "sorted.las"), ref):
        raise AssertionError("workflow: lassort differs from the in-memory sort")
    if not same(os.path.join(w, "merged.las"), las_path):
        raise AssertionError("workflow: lasmerge of the parts differs from the original")
    tool("lasindex", "lasindex", las_path)
    log(f"workflow: {nb} blocks, lassplit into {[LasFile(p).novl for p in parts]} "
        f"overlaps, lasmerge of the parts == the original byte for byte; lassort of "
        f"the shuffle at --mem-records {mem} ({-(-las.novl // mem)} runs) == its "
        f"in-memory stable sort")

    # 3. the intrinsic-QV track per block, merged, equals the whole-DB track
    for i in range(1, nb + 1):
        tool(f"inqual --block {i}", "inqual", db_path, las_path, "-d", "30",
             "--block", str(i))
    tool("catrack", "catrack", db_path, "inqual", "-d")
    track = [os.path.join(w, f".wf.inqual.{x}") for x in ("anno", "data")]
    merged_track = [open(p, "rb").read() for p in track]
    tool("inqual (whole DB)", "inqual", db_path, las_path, "-d", "30")
    if [open(p, "rb").read() for p in track] != merged_track:
        raise AssertionError("workflow: the merged block tracks differ from the "
                             "whole-DB inqual track")
    log(f"workflow: inqual of {nb} blocks + catrack == the whole-DB track "
        f"({len(merged_track[1])} tile bytes)")

    # 4. repeats, filter, filtersym in memory and partitioned
    tool("repeats", "repeats", db_path, las_path, "-d", "30", "--factor", "1.5")
    filt, sym, sym_ext = (os.path.join(w, f) for f in ("filt.las", "sym.las", "sym_ext.las"))
    tool("filter", "filter", db_path, las_path, filt)
    tool("filtersym", "filtersym", filt, sym, "--db", db_path)
    n_filt = LasFile(filt).novl
    tool("filtersym (partitioned)", "filtersym", filt, sym_ext, "--db", db_path,
         "--mem-records", str(max(1, n_filt // 16)))
    if not same(sym, sym_ext):
        raise AssertionError("workflow: the partitioned filtersym differs")
    n_sym = LasFile(sym).novl
    log(f"workflow: overlaps kept: {las.novl} -> filter {n_filt} -> filtersym {n_sym} "
        f"(partitioned at --mem-records {max(1, n_filt // 16)}: the same bytes)")
    if not 0 < n_sym <= n_filt < las.novl:
        raise AssertionError("workflow: the filters kept nothing, or everything")

    # 5. two checkpointed shards on the card over the symmetric LAS, the QV
    # ranking on; shard 0 again with a crash after its first checkpoint
    qcfg = PipelineConfig(device=DEVICE)
    if load_qv_ranker(read_db(db_path), LasFile(sym), qcfg) is None:
        raise AssertionError("workflow: the inqual track does not load for the ranking")
    out = os.path.join(w, "shards")
    every = max(2, nreads // 8)         # about four checkpoints a shard
    dense = ["--device", DEVICE, "-b", str(B), "--paged", "off", "--dp", "fused",
             "-t", str(nthreads), "--checkpoint-every", str(every)]
    paged = ["--device", DEVICE, "-b", str(B), "--paged", "on", "--dp", "scan",
             "-t", str(nthreads), "--checkpoint-every", str(every)]
    launched = {}
    for j, args in (("0,2", dense), ("1,2", paged)):
        launched[j] = counted(lambda: tool(f"shard -J {j}", "shard", db_path, sym, out,
                                           "-J", j, *args), counters)
        m = json.load(open(launch.shard_paths(out, int(j[0]))["manifest"]))
        log(f"workflow shard -J {j} ({' '.join(args)}): {m['reads']} reads, "
            f"{m['windows']} windows, {m['solved']} solved, {m['fragments']} "
            f"fragments, wall {m['wall_s']:.3f} s, {m['windows'] / m['wall_s']:.1f} "
            f"windows/s, degraded {m['degraded']}; launches {launched[j]}")
        if m["degraded"] or not m["solved"]:
            raise AssertionError(f"workflow: shard {j} degraded or solved nothing")
    for j, names in (("0,2", ("dp_backtrack", "rescore", "position_weights")),
                     ("1,2", ("gather_pages", "heaviest_path", "rescore",
                              "position_weights"))):
        for name in names:
            if launched[j][name] <= 0:
                raise AssertionError(f"workflow: shard {j} never launched {name}")
    crash = os.path.join(w, "crash")
    real = launch.correct_shard

    def crashing(*a, **kw):
        for i, item in enumerate(real(*a, **kw)):
            if i == every + every // 2:
                raise InjectedCrash("injected after the first checkpoint")
            yield item

    launch.correct_shard = crashing
    t0 = time.perf_counter()
    try:
        cli.main(["shard", db_path, sym, crash, "-J", "0,2", *dense])
        raise AssertionError("workflow: the injected crash did not fire")
    except InjectedCrash:
        pass
    finally:
        launch.correct_shard = real
    t_crash = time.perf_counter() - t0
    prog = json.load(open(launch.shard_paths(crash, 0)["progress"]))
    t0 = time.perf_counter()
    cli.main(["shard", db_path, sym, crash, "-J", "0,2", *dense])
    t_resume = time.perf_counter() - t0
    m = json.load(open(launch.shard_paths(crash, 0)["manifest"]))
    if not same(launch.shard_paths(crash, 0)["fasta"], launch.shard_paths(out, 0)["fasta"]):
        raise AssertionError("workflow: the resumed shard 0 differs from the "
                             "uninterrupted one")
    log(f"workflow crash and resume, shard 0: crashed {t_crash:.3f} s in, after "
        f"{prog['emitted']} reads checkpointed; the resume ({t_resume:.3f} s, from read "
        f"{m['resumed_at_read']}) wrote the uninterrupted run's FASTA byte for byte")

    # 6. the merge gate, the audit, the Q of the track arm
    merged = os.path.join(w, "corrected.fasta")
    tool("merge", "merge", out, "2", merged)
    tool("audit", "audit", out, "--nshards", "2")
    tool("audit --resolve 1", "audit", out, "--nshards", "2", "--db", db_path,
         "--las", sym, "--resolve", "1", "--shard", "0")
    qj = os.path.join(w, "q_track.json")
    tool("qveval (track arm)", "qveval", merged, ds["truth"], "--raw-db", db_path,
         "--json", qj)
    q_track = json.load(open(qj))

    # 7. the plain arm: daccord on the unfiltered LAS, no QV track; and, to
    # tell the filters' share from the ranking's, the two mixed arms
    arms = {}
    for arm, las_in, extra in (("plain", las_path, ["--qv-track", ""]),
                               ("ranked, unfiltered", las_path, []),
                               ("filtered, unranked", sym, ["--qv-track", ""])):
        fa_out = os.path.join(w, f"arm_{len(arms)}.fasta")
        lp = counted(lambda: tool(f"daccord ({arm} arm)", "daccord", db_path, las_in,
                                  "-o", fa_out, *extra, *dense[:-2]), counters)
        qj = os.path.join(w, f"q_arm_{len(arms)}.json")
        tool(f"qveval ({arm} arm)", "qveval", fa_out, ds["truth"], "--raw-db", db_path,
             "--json", qj)
        arms[arm] = json.load(open(qj))
        log(f"workflow {arm} arm: error {arms[arm]['error_rate']} "
            f"(Q{arms[arm]['qscore']}), {arms[arm]['fragments']} fragments, "
            f"{arms[arm]['bases']} bases; launches {lp}")
    q_plain = arms["plain"]
    log(f"workflow arms, {smi}: track arm (inqual, repeats, filter, filtersym, two "
        f"shards, merge) error {q_track['error_rate']} (Q{q_track['qscore']}), "
        f"{q_track['fragments']} fragments, {q_track['bases']} bases; plain arm "
        f"(daccord on the unfiltered LAS, --qv-track '') error "
        f"{q_plain['error_rate']} (Q{q_plain['qscore']}), {q_plain['fragments']} "
        f"fragments, {q_plain['bases']} bases; raw {q_track['raw_error_rate']} "
        f"(Q{q_track['raw_qscore']})")
    if not q_track["error_rate"] < q_track["raw_error_rate"] / 2:
        raise AssertionError("workflow: the track arm is not clearly better than raw")
    log(f"workflow walls, {smi}: " + ", ".join(f"{s} {t:.3f} s" for s, t in walls))
    shutil.rmtree(w, ignore_errors=True)


def pile_own_wall(recs: list) -> tuple[float, float]:
    """(the pile spans' summed wall, the part of it in spans of their own:
    dispatch, device.fetch, flush and hp opened while a pile was open, and
    a profiler capture's start or stop there). The difference is the pile
    loop's own work: routing rows to buckets, packing, scattering,
    stitching and emitting reads."""
    inner_names = {"dispatch", "device.fetch", "flush", "hp"}
    piles = inner = 0.0
    open_pile, inside = None, set()
    for r in recs:
        ev = r["event"]
        if ev == "profile.capture" and open_pile is not None:
            inner += r.get("wall_s", 0.0)
        elif ev == "span_open":
            if r["name"] == "pile":
                open_pile = r["span"]
            elif open_pile is not None and r["name"] in inner_names:
                inside.add(r["span"])
        elif ev == "span_close":
            if r["span"] == open_pile:
                piles += r["wall_s"]
                open_pile = None
            elif r["span"] in inside:
                inner += r["wall_s"]
                inside.discard(r["span"])
    return piles, inner


def telemetry_phase(d: dict, eprof: str, big: dict, big_eprof: str, counters,
                    tmp: str, nthreads: int, smi: str) -> None:
    """Phase 4e: the cost of the telemetry plane, one captured 100 kb run read
    by the port's tools, a warm run under ``--profile``, and the feeder
    stall's verdict."""
    from daccord_tpu_torch.tools import prof, sentinel, top, trace
    from daccord_tpu_torch.tools.eventcheck import validate_events
    from daccord_tpu_torch.utils.obs import render_prom

    # the cost of --events, warm in this process, in turns (the fresh-process
    # turns of tools/wall_ab.py left the smoke for its time limit)
    base = [d["db"], d["las"], "-E", eprof, "-b", str(B), "--device", DEVICE,
            "--paged", "off", "--dp", "fused"]
    warm = {"A": [], "B": []}
    outs = {}
    for i, side in enumerate("ABBA"):
        out = os.path.join(tmp, f"tel_{i}.fasta")
        extra = ["--events", os.path.join(tmp, "warm.events.jsonl")] if side == "B" else []
        st, _ = daccord(base + ["-o", out] + extra, counters)
        warm[side].append(st.wall_s)
        outs[i] = out
    for i in (1, 2, 3):
        if records(outs[i]) != records(outs[0]):
            raise AssertionError("the warm 20 kb run's FASTA differs with --events")
    hot = sum(warm["B"]) / sum(warm["A"]) - 1.0
    log(f"telemetry cost, 20 kb dense fused -t 0 ({smi}): warm in this process "
        f"{[round(w, 3) for w in warm['A']]} / {[round(w, 3) for w in warm['B']]} s -> "
        f"{hot:+.4f} (predicted at most +0.02)")
    # the pipeline thread's own time in the telemetry plane's functions
    # (utils/obs.py and the json encoder), without and with --events, one
    # warm run each under cProfile (which sees only the thread that runs it)
    import cProfile
    import pstats

    tel_files = ("utils/obs.py", "json/encoder.py", "json/__init__.py")
    prof_rows = []
    for side in "AB":
        extra = ["--events", os.path.join(tmp, "cprof.events.jsonl")] if side == "B" else []
        pr = cProfile.Profile()
        pr.enable()
        st, _ = daccord(base + ["-o", os.path.join(tmp, f"cprof_{side}.fasta")] + extra,
                        counters)
        pr.disable()
        funcs = pstats.Stats(pr).stats
        tel = sum(v[2] for k, v in funcs.items() if k[0].endswith(tel_files))
        calls = sum(v[1] for k, v in funcs.items() if k[0].endswith(tel_files))
        prof_rows.append(f"{'with' if extra else 'without'} --events {tel:.4f} s in "
                         f"{calls} calls of a {st.wall_s:.3f} s wall ({tel / st.wall_s:.4f})")
    log(f"telemetry on the pipeline thread, warm 20 kb dense fused under cProfile: "
        f"{'; '.join(prof_rows)}")

    # one captured 100 kb run, read by the port's tools
    run_dir = os.path.join(tmp, "telemetry_run")
    cap_dir = os.path.join(tmp, "capture")
    os.makedirs(run_dir)
    ev = os.path.join(run_dir, "big.events.jsonl")
    out = os.path.join(tmp, "tel_big.fasta")
    import faulthandler

    os.environ["DACCORD_PROFILE_DIR"] = cap_dir
    # a wedged capture dumps every thread's stack and ends the smoke, rather
    # than spending the run's time limit (faulthandler's own thread: it fires
    # even when a hang holds the interpreter lock)
    faulthandler.dump_traceback_later(120, exit=True)
    try:
        st, launched = daccord([big["db"], big["las"], "-o", out, "-E", big_eprof, "-b",
                                str(B), "--device", DEVICE, "--paged", "off", "--dp",
                                "fused", "-t", str(nthreads), "--events", ev,
                                "--metrics-snapshot-s", "2"], counters)
    finally:
        faulthandler.cancel_dump_traceback_later()
        del os.environ["DACCORD_PROFILE_DIR"]
    log_run("100 kb dense fused, captured", st, launched)
    errs = validate_events(ev, strict=True)
    if errs:
        raise AssertionError(f"eventcheck --strict: {errs[:5]}")
    recs = [json.loads(x) for x in open(ev)]
    if not any(r["event"] == "shard_done" for r in recs):
        raise AssertionError("the captured run wrote no shard_done")
    caps = [r["state"] for r in recs if r["event"] == "profile.capture"]
    cap_walls = [r.get("wall_s") for r in recs if r["event"] == "profile.capture"]
    traces = [f for f in os.listdir(cap_dir)] if os.path.isdir(cap_dir) else []
    if caps != ["start", "stop"] or not any(f.endswith(".trace.json") for f in traces):
        raise AssertionError(f"the profiler capture: events {caps}, files {traces}")
    log(f"profiler capture: {caps}, its own walls (the start; the stop and the export) "
        f"{cap_walls} s, {[(f, os.path.getsize(os.path.join(cap_dir, f))) for f in traces]}")
    with open(os.path.join(run_dir, "big.metrics.json"), "wt") as fh:
        json.dump({"wall_s": st.wall_s, "device_s": st.device_s, "host_s": st.host_s,
                   **st.metrics}, fh)
    prom = os.path.join(run_dir, "big.prom")
    with open(prom, "wt") as fh:
        fh.write(render_prom(st.metrics))
    import contextlib
    import io

    for name, call in (("trace --check --json", lambda: trace.trace_main([ev, "--check", "--json"])),
                       ("prof --check", lambda: prof.prof_main(["--check", ev])),
                       ("prof", lambda: prof.prof_main([ev])),
                       ("top --once", lambda: top.top_main([run_dir, "--once"])),
                       ("sentinel --strict", lambda: sentinel.sentinel_main(
                           ["--strict", ev, prom]))):
        so, se = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = call()
        for line in (so.getvalue() + se.getvalue()).splitlines():
            log(f"  {name}: {line}")
        if rc != 0:
            raise AssertionError(f"{name} exited {rc}")
        if name.startswith("trace"):
            dec = json.loads(so.getvalue().splitlines()[-1])["decomposition"][0]
    piles, inner = pile_own_wall(recs)
    run_wall = dec["wall_s"]
    capture_s = sum(r.get("wall_s", 0.0) for r in recs if r["event"] == "profile.capture")
    e = else_s(st) - capture_s
    pile_own = piles - inner
    in_spans = pile_own + dec["stages"]["flush"] + dec["stages"]["hp"]
    log(f"else split, 100 kb dense fused ({smi}): stats wall {st.wall_s:.3f} s (the "
        f"run span {run_wall:.3f} s; outside it read_db and the FASTA write "
        f"{st.wall_s - run_wall:.3f} s), else {e:.3f} s (less the profiler capture's "
        f"own {capture_s:.3f} s); in spans: the pile loop's own "
        f"work (routing, scatter, stitch, emit) {pile_own:.3f} s, flush "
        f"{dec['stages']['flush']:.3f} s, hp {dec['stages']['hp']:.3f} s = {in_spans:.3f} s "
        f"({in_spans / max(e, 1e-9):.4f} of else; predicted at least 0.5); the trace's "
        f"other(host) {dec['other']:.3f} s; pile spans {piles:.3f} s, of it in "
        f"dispatch, fetch, flush and hp spans {inner:.3f} s; the trace's stages "
        f"{json.dumps(dec['stages'])}")
    log(f"saturation, 100 kb dense fused: verdict {st.verdict}, {json.dumps(st.bottleneck)}, "
        f"feeder_s {st.feeder_s}, dispatch_s {st.dispatch_s}, host_s {st.host_s:.3f}, "
        f"device_peak_bytes {st.metrics['gauges'].get('device_peak_bytes')}")

    # the capture's bracket (the calls in flight stay in flight) hung a warm
    # 100 kb run at its 5th call before the profiler took the graph cache's
    # lock; the same run warm again at the 5th, bounded (the 13th call's run
    # left the smoke for its time limit)
    for at in (5,):
        bdir = os.path.join(tmp, f"capture_{at}")
        bev = os.path.join(tmp, f"bracket_{at}.events.jsonl")
        os.environ["DACCORD_PROFILE_DIR"] = bdir
        os.environ["DACCORD_PROFILE_DISPATCH"] = str(at)
        faulthandler.dump_traceback_later(120, exit=True)
        try:
            bst, _ = daccord([big["db"], big["las"], "-o", os.path.join(tmp, f"bracket_{at}.fasta"),
                              "-E", big_eprof, "-b", str(B), "--device", DEVICE, "--paged",
                              "off", "--dp", "fused", "-t", str(nthreads), "--events", bev],
                             counters)
        finally:
            faulthandler.cancel_dump_traceback_later()
            del os.environ["DACCORD_PROFILE_DIR"], os.environ["DACCORD_PROFILE_DISPATCH"]
        bcaps = [(r["state"], r.get("wall_s")) for r in map(json.loads, open(bev))
                 if r["event"] == "profile.capture"]
        bfiles = os.listdir(bdir) if os.path.isdir(bdir) else []
        log(f"bracket at the {at}th call, warm 100 kb dense fused: wall {bst.wall_s:.3f} s, "
            f"capture {bcaps}, {bfiles}")
        if [c for c, _ in bcaps] != ["start", "stop"] or not bfiles \
                or records(os.path.join(tmp, f"bracket_{at}.fasta")) != records(out):
            raise AssertionError(f"the bracket at the {at}th call: {bcaps}, {bfiles}")

    # the whole-run capture (--profile DIR), warm in this process: the
    # profiler stays on while the dispatcher thread replays the graphs
    whole_dir = os.path.join(tmp, "capture_whole")
    whole_out = os.path.join(tmp, "tel_whole.fasta")
    faulthandler.dump_traceback_later(300, exit=True)
    try:
        t0 = time.perf_counter()
        st, _ = daccord(base + ["-o", whole_out, "--profile", whole_dir], counters)
        whole_s = time.perf_counter() - t0
    finally:
        faulthandler.cancel_dump_traceback_later()
    files = os.listdir(whole_dir) if os.path.isdir(whole_dir) else []
    if not any(f.endswith(".trace.json") for f in files):
        raise AssertionError(f"--profile wrote no trace: {files}")
    if records(whole_out) != records(outs[0]):
        raise AssertionError("the warm 20 kb run's FASTA differs under --profile")
    log(f"--profile, warm 20 kb dense fused in this process: wall {st.wall_s:.3f} s "
        f"(with the trace's export {whole_s:.3f} s; the warm runs without it "
        f"{[round(w, 3) for w in warm['A']]} s), "
        f"{[(f, os.path.getsize(os.path.join(whole_dir, f))) for f in files]}; same FASTA")

    # the feeder stall on the supervisor phase's quarter of the 20 kb set
    quarter = [d["db"], d["las"], "-E", eprof, "-J", SUP_SHARD, "-b", str(SUP_B),
               "--device", DEVICE]
    clean_out, stall_out = (os.path.join(tmp, f"stall_{t}.fasta") for t in ("clean", "on"))
    clean, _ = daccord(quarter + ["-o", clean_out, "--events",
                                  os.path.join(tmp, "clean.events.jsonl")], counters)
    os.environ["DACCORD_FAULT"] = "feeder_stall:50"
    try:
        stalled, _ = daccord(quarter + ["-o", stall_out, "--events",
                                        os.path.join(tmp, "stall.events.jsonl")], counters)
    finally:
        del os.environ["DACCORD_FAULT"]
    same = records(clean_out) == records(stall_out)
    log(f"feeder_stall:50 on -J {SUP_SHARD} -b {SUP_B}: clean verdict {clean.verdict} "
        f"({json.dumps(clean.bottleneck)}, wall {clean.wall_s:.3f} s), stalled verdict "
        f"{stalled.verdict} ({json.dumps(stalled.bottleneck)}, wall {stalled.wall_s:.3f} s, "
        f"stall stage {stalled.stage_profile['stages'].get('stall')}); FASTA "
        f"byte-identical: {same}")
    if not same or stalled.verdict != "host_feeder" or stalled.bottleneck["stage"] != "stall":
        raise AssertionError("feeder_stall did not move the verdict to the stall with "
                             "the same bytes")
    # warm, every graphed run here is host_feeder already (a warm 20 kb
    # run's ladder calls take about 0.1 s of the card), and a first run in
    # a fresh process sits on the verdict's line (host blocked 0.40, idle
    # 0.44). The eager ladder keeps the card busy through its host launches
    # (idle about a quarter of the wall), so the flip is held there: the
    # warm 20 kb dense fused run with the eager ladder in this process,
    # clean, then stalled
    eager = {}
    for tag, fault in (("clean", None), ("stalled", "feeder_stall:50")):
        out = os.path.join(tmp, f"eager_{tag}.fasta")
        if fault:
            os.environ["DACCORD_FAULT"] = fault
        try:
            with eager_ladder():
                eager[tag] = (out, daccord(base + ["-o", out], counters)[0])
        finally:
            os.environ.pop("DACCORD_FAULT", None)
    (clean_out, clean), (stall_out, stalled) = eager["clean"], eager["stalled"]
    same = records(stall_out) == records(clean_out)
    log(f"feeder_stall:50 on the eager ladder, warm 20 kb dense fused -t 0: clean verdict "
        f"{clean.verdict} ({json.dumps(clean.bottleneck)}, wall {clean.wall_s:.3f} s), "
        f"stalled verdict {stalled.verdict} ({json.dumps(stalled.bottleneck)}, wall "
        f"{stalled.wall_s:.3f} s); FASTA byte-identical: {same}")
    if (not same or clean.verdict == "host_feeder" or stalled.verdict != "host_feeder"
            or stalled.bottleneck["stage"] != "stall"):
        raise AssertionError("feeder_stall did not flip the eager run's verdict to "
                             "host_feeder with the same bytes")


SERVE_FAULT = "device_oom:1"    # the faulted serve arm's injected OOM: the first
                                # device op, which leaves a ceiling at half its
                                # width, so every later merged batch bisects
SERVE_EVICT_S = 10.0            # the dense serve arm's idle TTL
SERVE_MEM_SLACK = 64 << 20      # allocated bytes an evicted server may keep


def serve_start(tmp: str, tag: str, extra=(), env_extra=None, cwd=None):
    """Start ``python -m daccord_tpu_torch.tools.cli serve`` (the user's entry
    point) on an ephemeral port, from ``cwd`` (default: the checkout):
    (process, port, workdir). The port comes from its ready file; a process
    that dies first raises with its log."""
    workdir = os.path.join(tmp, f"serve_{tag}")
    ready = os.path.join(tmp, f"serve_{tag}.ready.json")
    logp = os.path.join(tmp, f"serve_{tag}.log")
    backend = "cuda" if DEVICE == "cuda" else "cpu"
    argv = [sys.executable, "-m", "daccord_tpu_torch.tools.cli", "serve",
            "--workdir", workdir, "--port", "0", "--ready-file", ready,
            "--backend", backend, "-b", str(B), *extra]
    env = dict(os.environ, **(env_extra or {}))
    with open(logp, "wb") as fh:
        proc = subprocess.Popen(argv, env=env, stdout=fh, stderr=subprocess.STDOUT,
                                cwd=cwd or os.path.dirname(os.path.abspath(__file__)))
    deadline = time.time() + 120
    while not os.path.exists(ready):
        if proc.poll() is not None or time.time() > deadline:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            raise AssertionError(f"serve {tag} did not start (rc {proc.returncode}):\n"
                                 + open(logp).read()[-4000:])
        time.sleep(0.05)
    port = json.load(open(ready))["port"]
    log(f"serve {tag}: {' '.join(argv[3:])} on port {port}, pid {proc.pid}")
    return proc, port, workdir


def http(port: int, method: str, path: str, body=None, timeout: float = 600.0):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def serve_jobs(port: int, bodies: list) -> tuple[list, float, dict]:
    """Submit every job at once from a thread each and read each one's
    streamed FASTA to its end: ([(body, status, streamed bytes, result
    bytes)], wall from the first submit to the last stream's end, each
    group's stats as last seen when one of its jobs ended, by name: a group
    may evict before the last job ends)."""
    import threading
    import urllib.request

    got: list = [None] * len(bodies)
    errs: list = []
    groups: dict = {}

    def client(i: int) -> None:
        try:
            _, raw = http(port, "POST", "/v1/jobs", bodies[i])
            job = json.loads(raw)["job"]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/jobs/{job}/stream",
                                        timeout=600) as r:
                streamed = r.read()
            _, result = http(port, "GET", f"/v1/jobs/{job}/result?wait=1")
            _, st = http(port, "GET", f"/v1/jobs/{job}")
            got[i] = (bodies[i], json.loads(st), streamed, result)
            for g in serve_metrics(port)["warm"]["groups"]:
                groups[g["name"]] = g
        except Exception as e:  # noqa: BLE001 - raised below
            errs.append(f"job {i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    if errs or any(g is None for g in got):
        raise AssertionError(f"serve jobs failed: {errs}")
    return got, wall, groups


def serve_stop(proc, port: int, workdir: str, tag: str) -> None:
    """SIGTERM: the drain must be clean (exit 0, ``serve.done``), every event
    file of the service, its groups and its jobs passes ``eventcheck
    --strict``, and ``top --once`` renders the workdir."""
    import contextlib
    import glob
    import io
    import signal

    from daccord_tpu_torch.tools import top
    from daccord_tpu_torch.tools.eventcheck import validate_events

    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"serve {tag}: SIGTERM did not end the process in 120 s")
    files = (glob.glob(os.path.join(workdir, "*.events.jsonl"))
             + glob.glob(os.path.join(workdir, "jobs", "*", "events.jsonl")))
    bad = {f: validate_events(f, strict=True) for f in files}
    bad = {os.path.relpath(f, workdir): e[:3] for f, e in bad.items() if e}
    done = [json.loads(x) for x in open(os.path.join(workdir, "serve.events.jsonl"))
            if '"serve.done"' in x]
    so = io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(so):
        top_rc = top.top_main([workdir, "--once"])
    log(f"serve {tag}: SIGTERM -> exit {rc} in {time.perf_counter() - t0:.2f} s, "
        f"{done[-1] if done else 'no serve.done'}; eventcheck --strict on {len(files)} "
        f"files: {'clean' if not bad else bad}; top --once exit {top_rc}, "
        f"{len(so.getvalue().splitlines())} lines")
    for line in so.getvalue().splitlines()[:12]:
        log(f"  top: {line}")
    if rc != 0 or not done or bad or top_rc != 0:
        raise AssertionError(f"serve {tag}: unclean stop (exit {rc}, serve.done "
                             f"{bool(done)}, eventcheck {bad}, top {top_rc})")


def serve_solo(ds: dict, tag: str, tmp: str, paged: bool = False) -> tuple[bytes, object]:
    """A solo run of ``serve.jobs.build_job_config``'s config on this card
    (the byte reference of a serve job): (FASTA bytes, stats)."""
    import dataclasses

    from daccord_tpu_torch.runtime.pipeline import correct_to_fasta
    from daccord_tpu_torch.serve.jobs import JobSpec, build_job_config

    spec = JobSpec.from_json({"db": ds["db"], "las": ds["las"]}, tmp)
    cfg = build_job_config(spec, "cuda" if DEVICE == "cuda" else "cpu", True, B, "fused",
                           tmp, "solo")
    cfg = dataclasses.replace(cfg, supervise=True, events_path=None, ledger_path=None,
                              job_tag=None, quarantine_path=None,
                              paged="on" if paged else "off",
                              dp_route="scan" if paged else "fused")
    out = os.path.join(tmp, f"serve_solo_{tag}.fasta")
    st = correct_to_fasta(ds["db"], ds["las"], out, cfg)
    with open(out, "rb") as fh:
        return fh.read(), st


def serve_metrics(port: int) -> dict:
    return json.loads(http(port, "GET", "/v1/metrics")[1])


def serve_phase(d: dict, big: dict, tmp: str, smi: str) -> dict:
    """Phase 4f: the serving plane through its real entry point. Three
    ``serve`` processes on the card at -b 2048: the dense fused service takes
    three 20 kb jobs from two tenants and one 100 kb job at once; the paged
    scan service two 20 kb jobs; the faulted service two 20 kb jobs under an
    injected device OOM. Every streamed FASTA is held byte-identical to a solo
    card run of ``build_job_config``'s config; the dense service's groups
    evict at their idle TTL and its allocated device memory falls back; each
    service stops clean on SIGTERM. Returns the solo references and the dense
    service's windows/s and its ratio to the solo runs' sum."""
    t_phase = time.perf_counter()
    on_card = DEVICE == "cuda"
    t0 = time.perf_counter()
    refs = {"20kb": serve_solo(d, "20kb", tmp), "100kb": serve_solo(big, "100kb", tmp),
            "20kb paged": serve_solo(d, "20kb_paged", tmp, paged=True)}
    log(f"serve solo references ({smi}): " + "; ".join(
        f"{k} wall {st.wall_s:.3f} s, {st.n_windows} windows, "
        f"{st.n_windows / st.wall_s:.0f} windows/s" for k, (_, st) in refs.items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    job20 = {"db": d["db"], "las": d["las"]}
    job100 = {"db": big["db"], "las": big["las"]}

    # ---- dense fused: four jobs at once, then eviction and SIGTERM ----------
    proc, port, wd = serve_start(tmp, "dense", ["--idle-evict-s", str(SERVE_EVICT_S),
                                                "--workers", "4"])
    try:
        m0 = serve_metrics(port)
        alloc0 = m0.get("device", {}).get("allocated_bytes", 0)
        got, wall, groups = serve_jobs(port, [dict(job20, tenant="a"), dict(job20, tenant="a"),
                                      dict(job20, tenant="b"), dict(job100, tenant="b")])
        m1 = serve_metrics(port)
        for body, st, streamed, result in got:
            ref = refs["100kb" if body["db"] == big["db"] else "20kb"][0]
            if st["state"] != "done" or streamed != ref or result != ref:
                raise AssertionError(f"serve dense: job {st['job']} ({body['tenant']}) "
                                     f"state {st['state']}: its FASTA differs from the "
                                     f"solo card run")
        wins = sum(st["windows"] for _, st, _, _ in got)
        solo_s = sum(refs["100kb" if b["db"] == big["db"] else "20kb"][1].wall_s
                     for b, _, _, _ in got)
        log(f"serve dense fused -b {B} ({smi}): 4 jobs byte-identical to their solo card "
            f"runs (streamed and result); latencies "
            + ", ".join(f"{st['job']} {b['tenant']} "
                        f"{'100kb' if b['db'] == big['db'] else '20kb'} "
                        f"{st['latency']['total_s']} s (queue {st['latency']['queue_s']}, "
                        f"first result {st['latency']['first_result_s']})"
                        for b, st, _, _ in got)
            + f"; service {wins} windows in {wall:.3f} s = {wins / wall:.0f} windows/s "
            f"against the solo runs' sum {wins} in {solo_s:.3f} s = {wins / solo_s:.0f} "
            f"windows/s ({solo_s / wall:.3f}x)")
        dense_wps, dense_ratio = wins / wall, solo_s / wall
        warm = m1["warm"]
        for g in sorted({**groups, **{g["name"]: g for g in warm["groups"]}}.values(),
                        key=lambda g: g["name"]):
            log(f"serve dense group {g['name']}: {g['batches']} batches, "
                f"{g['mixed_batches']} with rows of more than one job, rows {g['rows']}, "
                f"flushes demand {g['demand_flushes']} lag {g['lag_flushes']}, width "
                f"{g['width']}; saturation {json.dumps(g['saturation'])}; graphs "
                f"{json.dumps(g['graphs'])}; governor {json.dumps(g['governor'])}")
        log(f"serve dense warm state: {warm['hits']} hits, {warm['misses']} misses; "
            f"device {json.dumps(m1.get('device'))}; verdict {m1.get('verdict')}")
        if warm["hits"] < 2 or warm["misses"] != 2:
            raise AssertionError(f"serve dense: warm {warm['hits']} hits / "
                                 f"{warm['misses']} misses (want 2 groups, 2 hits)")
        # from the groups' event files: a group whose jobs ended may be gone
        import glob

        sb = [json.loads(x) for f in sorted(glob.glob(os.path.join(wd, "g*.events.jsonl")))
              for x in open(f) if '"serve.batch"' in x]
        mixed = sum(r["jobs"] > 1 for r in sb)
        # printed, not held: at the default flush lag a job's full batches
        # flush alone and only its partial blocks can meet another job's
        # rows (1-5 such batches in four chip runs); the faulted service below
        # holds mixed batches
        log(f"serve dense batches: {len(sb)}, {mixed} with rows of more than one job "
            f"(the three 20 kb jobs share a group; the 100 kb job has its own)")
        if on_card:
            la = m1["device"]["launches"]
            for k in ("dp_backtrack", "rescore", "position_weights"):
                if la.get(k, 0) <= 0:
                    raise AssertionError(f"serve dense: the {k} kernel never launched")
            log(f"serve dense kernel launches (the jobs' batches; the groups' capture "
                f"warm-ups not counted): {json.dumps(la)}")
        # eviction at the idle TTL: every group closes, and the device memory
        # the groups held comes back
        t0 = time.perf_counter()
        m2 = m1
        while time.perf_counter() - t0 < 60 and (m2["warm"]["resident"] or
                                                 m2["warm"]["evicted"] < 2):
            time.sleep(0.5)
            m2 = serve_metrics(port)
        alloc1 = m1.get("device", {}).get("allocated_bytes", 0)
        alloc2 = m2.get("device", {}).get("allocated_bytes", 0)
        log(f"serve dense eviction: {m2['warm']['evicted']} groups evicted "
            f"{time.perf_counter() - t0:.1f} s after the last job (TTL {SERVE_EVICT_S} s); "
            f"allocated device memory {alloc0} bytes before the first group, {alloc1} "
            f"with the groups warm, {alloc2} after the eviction; graph shapes held "
            f"{m2.get('device', {}).get('graphs', {}).get('shapes')}")
        if m2["warm"]["resident"] or m2["warm"]["evicted"] < 2:
            raise AssertionError("serve dense: the idle groups did not evict")
        if alloc2 > alloc0 + SERVE_MEM_SLACK:
            raise AssertionError(f"serve dense: {alloc2 - alloc0} bytes stay allocated "
                                 f"after the eviction")
    except BaseException:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        raise
    serve_stop(proc, port, wd, "dense")

    # ---- paged scan: gather_pages and heaviest_path on the serve path -------
    proc, port, wd = serve_start(tmp, "paged", ["--paged", "--dp", "scan"])
    try:
        got, wall, groups = serve_jobs(port, [dict(job20, tenant="a"), dict(job20, tenant="b")])
        m = serve_metrics(port)
        ref = refs["20kb paged"][0]
        for _, st, streamed, result in got:
            if st["state"] != "done" or streamed != ref or result != ref:
                raise AssertionError(f"serve paged: job {st['job']}'s FASTA differs from "
                                     f"the solo paged card run")
        if ref != refs["20kb"][0]:
            log("serve paged: note, the solo paged scan run's FASTA differs from the "
                "dense fused one (both packages' routes agree within the drift bound)")
        g = m["warm"]["groups"][0]
        log(f"serve paged scan ({smi}): 2 jobs byte-identical to the solo paged scan card "
            f"run in {wall:.3f} s; latencies "
            + ", ".join(f"{st['job']} {st['latency']['total_s']} s" for _, st, _, _ in got)
            + f"; {g['batches']} batches, {g['mixed_batches']} mixed; saturation "
            f"{json.dumps(g['saturation'])}; device {json.dumps(m.get('device'))}")
        if on_card:
            la = m["device"]["launches"]
            for k in ("gather_pages", "heaviest_path", "rescore", "position_weights"):
                if la.get(k, 0) <= 0:
                    raise AssertionError(f"serve paged: the {k} kernel never launched")
    except BaseException:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        raise
    serve_stop(proc, port, wd, "paged")

    # ---- an injected device OOM on a mixed batch: bisected, same bytes ------
    # a job hands the group full batches, which flush alone; its partial
    # blocks (stale buckets, its tail) merge with the others' rows while they
    # wait, so here they wait up to a second (the flush lag) and three jobs
    # run: mixed batches come often enough that one runs under the ceiling
    proc, port, wd = serve_start(tmp, "fault", ["--workers", "3", "--flush-lag-ms", "1000"],
                                 env_extra={"DACCORD_FAULT": SERVE_FAULT,
                                            "DACCORD_COMPCACHE": os.path.join(tmp, "cc_serve")})
    try:
        got, wall, groups = serve_jobs(port, [dict(job20, tenant="a"), dict(job20, tenant="b"),
                                              dict(job20, tenant="a")])
        m = serve_metrics(port)
        ref = refs["20kb"][0]
        for _, st, streamed, result in got:
            if st["state"] != "done" or streamed != ref or result != ref:
                raise AssertionError(f"serve fault: job {st['job']}'s FASTA differs")
        g = m["warm"]["groups"][0]
        gev = [json.loads(x) for x in open(os.path.join(wd, "g0.events.jsonl"))]
        cls = next((i for i, r in enumerate(gev) if r["event"] == "governor.classify"),
                   len(gev))
        # the OOM leaves a ceiling at half the width: every merged batch
        # dispatched after its classification runs bisected (a shrink, or
        # the ratchet's chunks), the mixed ones among them
        after = [r for r in gev[cls:] if r["event"] == "serve.batch"]
        mixed = [r for r in after if r["jobs"] > 1]
        log(f"serve {SERVE_FAULT}: 3 jobs byte-identical in {wall:.3f} s; governor "
            f"{json.dumps(g['governor'])}, degraded {g['degraded']}; {len(after)} batches "
            f"dispatched after the OOM's classification under its ceiling, {len(mixed)} "
            f"of them mixed (first: {mixed[0] if mixed else None})")
        if not (g["governor"]["classify"] >= 1 and g["governor"]["shrink"] >= 1) \
                or g["degraded"]:
            raise AssertionError("serve fault: the OOM was not bisected on the card")
        if not mixed or g["governor"]["chunks"] <= 0:
            raise AssertionError("serve fault: no mixed batch ran under the OOM's ceiling")
    except BaseException:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        raise
    serve_stop(proc, port, wd, "fault")
    log(f"serve phase: {time.perf_counter() - t_phase:.1f} s (predicted at most 120 s)")
    return {"refs": refs, "wps": dense_wps, "ratio": dense_ratio}


FLEET_FAULT = "worker_crash:1,worker_oom:2,lease_stall:1"   # phase 4g's faulted fleet
FLEET_SHARDS = 4             # the 100 kb fleet's -n
FLEET_WIDTHS = (1, 2, 4)     # its --workers


class MemSampler:
    """The whole card's used memory (``nvidia-smi``, MiB), sampled every
    half second on a thread while a multi-process run goes on."""

    def __init__(self):
        import threading

        self.peak = 0
        self.samples = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                                      "--format=csv,noheader,nounits"], capture_output=True,
                                     text=True, timeout=10).stdout.split()
                self.peak = max(self.peak, int(out[0]))
                self.samples += 1
            except (OSError, ValueError, IndexError, subprocess.SubprocessError):
                pass
            self._stop.wait(0.5)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(15)
        return False


def shard_flags(threads: int, extra=()) -> list[str]:
    """The flags every fleet worker gets besides its shard and sidecars, so
    that a shard run in turn by hand is the same run."""
    backend = "cuda" if DEVICE == "cuda" else "cpu"
    return ["--backend", backend, "--device", backend, "--checkpoint-every", "16",
            "--ingest-policy", "strict", "-t", str(threads), "--no-hp-rescue",
            "-b", str(B), *extra]


def shard_outputs(outdir: str, n: int) -> dict:
    """What a fleet's (or the in-turn runs') shards left: their manifests,
    the metrics rollups' saturation gauges and the kernel launches summed
    over every shard's attempts."""
    launches: dict = {}
    mans, gauges = [], []
    for s in range(n):
        with open(os.path.join(outdir, f"shard{s:04d}.json")) as fh:
            mans.append(json.load(fh))
        try:
            with open(os.path.join(outdir, f"shard{s:04d}.metrics.json")) as fh:
                gauges.append(json.load(fh).get("gauges", {}))
        except (OSError, ValueError):
            gauges.append({})
        try:
            with open(os.path.join(outdir, f"shard{s:04d}.launches.json")) as fh:
                for k, v in json.load(fh).items():
                    launches[k] = launches.get(k, 0) + v
        except (OSError, ValueError):
            pass
    return {"manifests": mans, "gauges": gauges, "launches": launches,
            "windows": sum(int(m["windows"]) for m in mans)}


def fleet_run(ds: dict, outdir: str, n: int, workers: int, threads: int, extra=(),
              env_extra=None) -> dict:
    """One ``fleet`` through its command line (the user's entry point) with
    ``--merge``: its wall from start to the merged FASTA, the card's peak
    used memory meanwhile, and its shards' outputs."""
    merged = outdir + ".fasta"
    backend = "cuda" if DEVICE == "cuda" else "cpu"
    argv = [sys.executable, "-m", "daccord_tpu_torch.tools.cli", "fleet", ds["db"],
            ds["las"], outdir, "-n", str(n), "--workers", str(workers), "--backend",
            backend, "--device", backend, "-b", str(B), "-t", str(threads),
            "--merge", merged, *extra]
    env = dict(os.environ, **(env_extra or {}))
    with MemSampler() as mem:
        t0 = time.perf_counter()
        r = subprocess.run(argv, env=env, capture_output=True, text=True,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"fleet {' '.join(argv[3:])}: exit {r.returncode}\n"
                             f"{r.stderr[-4000:]}")
    with open(os.path.join(outdir, "fleet.json")) as fh:
        fj = json.load(fh)
    with open(merged, "rb") as fh:
        data = fh.read()
    return {"wall": wall, "mem_mib": mem.peak, "mem_samples": mem.samples,
            "fleet": fj, "bytes": data, **shard_outputs(outdir, n)}


def in_turn(ds: dict, outdir: str, n: int, threads: int, extra=()) -> dict:
    """The same shards in turn in this process (the ``shard`` tool's
    ``shard_main`` with the fleet's worker flags, warm: no process start),
    and merged."""
    from daccord_tpu_torch.parallel.launch import merge_shards
    from daccord_tpu_torch.tools.cli import shard_main

    t0 = time.perf_counter()
    for s in range(n):
        if shard_main([ds["db"], ds["las"], outdir, "-J", f"{s},{n}",
                       *shard_flags(threads, extra)]) != 0:
            raise AssertionError(f"shard {s},{n} failed")
    merged = outdir + ".fasta"
    merge_shards(outdir, n, merged)
    wall = time.perf_counter() - t0
    with open(merged, "rb") as fh:
        return {"wall": wall, "bytes": fh.read(), **shard_outputs(outdir, n)}


def fleet_text(tag: str, f: dict, threads: int) -> str:
    walls = [round(float(m["wall_s"]), 3) for m in f["manifests"]]
    gauges = [{k: g.get(k) for k in ("device_idle_frac", "host_blocked_frac",
                                     "overlap_frac") if k in g} for g in f["gauges"]]
    return (f"{tag}: wall {f['wall']:.3f} s from start to the merged FASTA, "
            f"{f['windows']} windows, {f['windows'] / f['wall']:.0f} windows/s; -t "
            f"{threads} a worker; workers' walls {walls} s; their saturation gauges "
            f"{json.dumps(gauges)}; kernel launches {json.dumps(f['launches'])}; card "
            f"memory used at most {f.get('mem_mib', 0)} MiB ({f.get('mem_samples', 0)} "
            f"nvidia-smi samples); attempts {json.dumps(f['fleet'].get('attempts'))}")


def need_launches(tag: str, launches: dict, kernels) -> None:
    if DEVICE != "cuda":
        return
    for k in kernels:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"{tag}: the {k} kernel never launched")


def router_jobs(rport: int, bodies: list) -> tuple[list, float]:
    """Every job at once through the router, each from a thread: submit,
    read the proxied stream to its end, the result and the status."""
    import threading
    import urllib.request

    got: list = [None] * len(bodies)
    errs: list = []

    def client(i: int) -> None:
        try:
            _, raw = http(rport, "POST", "/v1/jobs", bodies[i])
            job = json.loads(raw)["job"]
            with urllib.request.urlopen(f"http://127.0.0.1:{rport}/v1/jobs/{job}/stream",
                                        timeout=600) as r:
                streamed = r.read()
            _, result = http(rport, "GET", f"/v1/jobs/{job}/result?wait=1")
            _, st = http(rport, "GET", f"/v1/jobs/{job}")
            got[i] = (bodies[i], json.loads(st), streamed, result)
        except Exception as e:  # noqa: BLE001 - raised below
            errs.append(f"job {i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    if errs or any(g is None for g in got):
        raise AssertionError(f"router jobs failed: {errs}")
    return got, wall


def aot_events(workdir: str) -> list:
    import glob

    out = []
    for f in sorted(glob.glob(os.path.join(workdir, "*.events.jsonl"))):
        out += [json.loads(x) for x in open(f) if '"aot.' in x]
    return out


def fleet_router_phase(d: dict, big: dict, big_stats, served: dict, tmp: str, smi: str,
                       ncpu: int) -> None:
    """Phase 4g: the multi-process layer on the card. The 100 kb set through
    ``fleet -n 4`` at W = 1, 2 and 4 workers, in turn by hand and in this
    process's phase 4; the fleet under a crash, an OOM and a lease stall;
    the paged scan route's fleet; then two ``serve`` peers behind a
    ``router`` sharing one kernel cache, the dense mix of 4f through it, a
    peer SIGKILLed mid-proxy, and a peer started on a flipped cache entry."""
    import signal
    import urllib.error

    t_phase = time.perf_counter()
    on_card = DEVICE == "cuda"
    dense_k = ("dp_backtrack", "rescore", "position_weights")
    paged_k = ("gather_pages", "heaviest_path", "rescore", "position_weights")

    # ---- fleet shape: W = 1, 2, 4, the in-turn shards, phase 4's run ---------
    runs = {}
    for w in FLEET_WIDTHS:
        t_w = max(1, min(8, ncpu // w))
        f = fleet_run(big, os.path.join(tmp, f"fleet_w{w}"), FLEET_SHARDS, w, t_w)
        log(fleet_text(f"fleet -n {FLEET_SHARDS} --workers {w} ({smi})", f, t_w))
        need_launches(f"fleet W={w}", f["launches"], dense_k)
        runs[w] = f
    t_1 = max(1, min(8, ncpu))
    turns = in_turn(big, os.path.join(tmp, "fleet_turns"), FLEET_SHARDS, t_1)
    log(f"in turn, the {FLEET_SHARDS} shards one after another in this process (warm; "
        f"the W=1 fleet is one shard process after another), -t {t_1} "
        f"({smi}): wall {turns['wall']:.3f} s, {turns['windows']} windows, "
        f"{turns['windows'] / turns['wall']:.0f} windows/s; shards' walls "
        f"{[round(float(m['wall_s']), 3) for m in turns['manifests']]} s")
    log(f"phase 4's single-process daccord run of the set (in this process, -t "
        f"{min(8, ncpu)}): wall {big_stats.wall_s:.3f} s, {big_stats.n_windows} windows, "
        f"{big_stats.n_windows / big_stats.wall_s:.0f} windows/s")
    for w, f in runs.items():
        if f["bytes"] != turns["bytes"]:
            raise AssertionError(f"fleet W={w}: the merged FASTA differs from the "
                                 f"in-turn shards'")
    log(f"fleet W={'/'.join(map(str, FLEET_WIDTHS))}: merged FASTA byte-identical at "
        f"every W and to the in-turn shards ({len(turns['bytes'])} bytes)")

    # ---- the fleet under faults; the paged scan route ------------------------
    fdir = os.path.join(tmp, "fleet_fault")
    f = fleet_run(big, fdir, FLEET_SHARDS, 2, max(1, min(8, ncpu // 2)),
                  env_extra={"DACCORD_FAULT": FLEET_FAULT})
    from daccord_tpu_torch.tools.eventcheck import validate_events

    evpath = os.path.join(fdir, "fleet.events.jsonl")
    evs = [json.loads(x) for x in open(evpath)]
    bad = validate_events(evpath, strict=True)
    cap = [e for e in evs if e["event"] == "fleet.capacity"]
    kinds = sorted(e["kind"] for e in evs if e["event"] == "fleet.fault")
    log(fleet_text(f"fleet W=2 under DACCORD_FAULT={FLEET_FAULT}", f,
                   max(1, min(8, ncpu // 2)))
        + f"; faults {kinds}; retries "
        f"{[e['reason'] for e in evs if e['event'] == 'fleet.retry']}; takeovers "
        f"{sum(e['event'] == 'fleet.takeover' for e in evs)}; capacity {cap}; "
        f"eventcheck --strict: {'clean' if not bad else bad[:3]}")
    if f["bytes"] != turns["bytes"]:
        raise AssertionError("the faulted fleet's merged FASTA differs from the clean one")
    if len(cap) != 1 or cap[0]["batch"] != B // 2 or f["fleet"]["capacity_requeued"] \
            != [cap[0]["shard"]]:
        raise AssertionError(f"the OOM'd shard was not requeued once at -b {B // 2}: {cap}")
    if bad or kinds != ["lease_stall", "worker_crash", "worker_oom"]:
        raise AssertionError(f"faulted fleet: faults {kinds}, eventcheck {bad[:3]}")
    t_2 = max(1, min(8, ncpu // 2))
    paged = ("--paged", "on", "--dp", "scan")
    fp = fleet_run(d, os.path.join(tmp, "fleet_paged"), 2, 2, t_2, extra=paged)
    tp = in_turn(d, os.path.join(tmp, "fleet_paged_turns"), 2, t_2, extra=paged)
    log(fleet_text(f"fleet -n 2 --workers 2 --paged on --dp scan, 20 kb ({smi})", fp, t_2)
        + f"; in turn {tp['wall']:.3f} s")
    if fp["bytes"] != tp["bytes"]:
        raise AssertionError("the paged scan fleet's FASTA differs from its in-turn shards'")
    need_launches("fleet paged scan", fp["launches"], paged_k)
    log(f"fleet phase: {time.perf_counter() - t_phase:.1f} s")

    # ---- router shape: two peers, one kernel cache ---------------------------
    t_r = time.perf_counter()
    peer_dir = os.path.join(tmp, "peers")
    aot = os.path.join(tmp, "aotcache")
    refs = served["refs"]
    procs = {}

    def peer(tag: str, extra=()):
        """A serve peer run from a copy of the package whose build directory
        holds no kernel library (a peer on another host), with the fleet's
        cache and lease dir."""
        host = os.path.join(tmp, f"host_{tag}")
        pkg = os.path.dirname(os.path.abspath(__file__))
        shutil.copytree(os.path.join(pkg, "daccord_tpu_torch"),
                        os.path.join(host, "daccord_tpu_torch"),
                        ignore=lambda d, names: [n for n in names if n.endswith(".so")
                                                 and not n.startswith("dazz_native")])
        t0 = time.perf_counter()
        proc, port, wd = serve_start(
            tmp, f"peer_{tag}", ["--workers", "4", "--lease-ttl-s", "600",
                                 "--aot-cache", aot, *extra], cwd=host)
        log(f"peer {tag}: ready in {time.perf_counter() - t0:.2f} s (kernels from the "
            f"cache or built, the service up)")
        procs[tag] = (proc, port, wd)
        return proc, port, wd

    def stop_all():
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    rproc = None
    try:
        peer("a", ["--peer-dir", peer_dir])
        peer("b", ["--peer-dir", peer_dir])
        rdir = os.path.join(tmp, "router")
        rready = os.path.join(tmp, "router.ready.json")
        rlog = open(os.path.join(tmp, "router.log"), "wb")
        rproc = subprocess.Popen([sys.executable, "-m", "daccord_tpu_torch.tools.cli",
                                  "router", "--workdir", rdir, "--peer-dir", peer_dir,
                                  "--port", "0", "--ready-file", rready, "--poll-s", "0.5"],
                                 stdout=rlog, stderr=subprocess.STDOUT,
                                 cwd=os.path.dirname(os.path.abspath(__file__)))
        deadline = time.time() + 60
        while not os.path.exists(rready) and time.time() < deadline:
            time.sleep(0.05)
        rport = json.load(open(rready))["port"]
        while time.time() < deadline:
            rs = json.loads(http(rport, "GET", "/v1/router")[1])
            if sum(p["alive"] and p["ready"] for p in rs["peers"]) == 2:
                break
            time.sleep(0.2)
        else:
            raise AssertionError(f"router: the peers never turned ready: {rs}")
        names = {os.path.basename(procs[t][2]): t for t in ("a", "b")}
        from daccord_tpu_torch.serve.router import Router

        owner = {t: names[max(names, key=lambda n: Router._score(t, n))] for t in "ab"}
        log(f"router on port {rport}: peers {sorted(names)}; rendezvous owners: tenant a "
            f"-> peer {owner['a']}, tenant b -> peer {owner['b']}")
        job20 = {"db": d["db"], "las": d["las"]}
        job100 = {"db": big["db"], "las": big["las"]}
        with MemSampler() as mem:
            got, wall = router_jobs(rport, [dict(job20, tenant="a"), dict(job20, tenant="a"),
                                            dict(job20, tenant="b"),
                                            dict(job100, tenant="b")])
        rs = json.loads(http(rport, "GET", "/v1/router")[1])
        for body, st, streamed, result in got:
            ref = refs["100kb" if body["db"] == big["db"] else "20kb"][0]
            if st["state"] != "done" or streamed != ref or result != ref:
                raise AssertionError(f"router: job {st['job']} ({body['tenant']}) differs "
                                     f"from its solo card run: state {st['state']}, "
                                     f"streamed {len(streamed)} / result {len(result)} / "
                                     f"solo {len(ref)} bytes, streamed == result "
                                     f"{streamed == result}")
        wins = sum(st["windows"] for _, st, _, _ in got)
        solo_s = sum(refs["100kb" if b["db"] == big["db"] else "20kb"][1].wall_s
                     for b, _, _, _ in got)
        log(f"router, two peers, 4f's dense mix ({smi}): 4 jobs byte-identical to their "
            f"solo card runs (proxied stream and result); on peers "
            f"{[rs['jobs'].get(st['job']) for _, st, _, _ in got]}; latencies "
            + ", ".join(f"{st['job']} {b['tenant']} "
                        f"{'100kb' if b['db'] == big['db'] else '20kb'} "
                        f"{st['latency']['total_s']} s" for b, st, _, _ in got)
            + f"; {wins} windows in {wall:.3f} s = {wins / wall:.0f} windows/s against the "
            f"solo runs' sum {wins / solo_s:.0f} windows/s ({solo_s / wall:.3f}x; 4f's one "
            f"service {served['wps']:.0f} windows/s, {served['ratio']:.3f}x); card memory "
            f"used at most {mem.peak} MiB; router counters "
            f"{ {k: rs[k] for k in ('routes', 'spills', 'proxied', 'proxy_errors')} }")
        used = {names[rs["jobs"][st["job"]]] for _, st, _, _ in got}
        for t in ("a", "b"):
            m = serve_metrics(procs[t][1])
            log(f"peer {t} device (its jobs' batches; the groups' capture warm-ups not "
                f"counted): {json.dumps(m.get('device'))}")
            if t in used:
                need_launches(f"router peer {t}", m.get("device", {}).get("launches", {}),
                              dense_k)

        # ---- SIGKILL the owner of tenant a in the middle of a proxied job ------
        import threading
        import urllib.request

        victim, survivor = owner["a"], "b" if owner["a"] == "a" else "a"
        body = dict(job100, tenant="a", idempotency_key="kill-once")
        st, raw = http(rport, "POST", "/v1/jobs", body)
        jid1 = json.loads(raw)["job"]
        streamed = {"bytes": 0, "error": None}

        def reader():
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{rport}/v1/jobs/{jid1}/stream", timeout=600) as r:
                    while True:
                        c = r.read(4096)
                        if not c:
                            break
                        streamed["bytes"] += len(c)
            except Exception as e:  # noqa: BLE001 - the torn proxy is the point
                streamed["error"] = f"{type(e).__name__}: {e}"

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        deadline = time.time() + 120
        while streamed["bytes"] == 0 and time.time() < deadline and th.is_alive():
            time.sleep(0.02)
        vproc = procs[victim][0]
        vproc.send_signal(signal.SIGKILL)
        vproc.wait(30)
        th.join(60)
        t_kill = time.perf_counter()
        jid2 = None
        tries = 0
        while time.perf_counter() - t_kill < 120:
            tries += 1
            try:
                st, raw = http(rport, "POST", "/v1/jobs", body, timeout=60)
                if st in (200, 201):
                    jid2 = json.loads(raw)["job"]
                    break
            except urllib.error.HTTPError as e:
                if e.code not in (502, 503) or not json.loads(e.read()).get("retryable"):
                    raise
            except (urllib.error.URLError, OSError):
                pass
            time.sleep(0.3)
        landed_s = time.perf_counter() - t_kill
        if jid2 is None:
            raise AssertionError("router: the retried submit never landed")
        _, got2 = http(rport, "GET", f"/v1/jobs/{jid2}/result?wait=1")
        st, raw = http(rport, "POST", "/v1/jobs", body)
        again = json.loads(raw)["job"]
        rs = json.loads(http(rport, "GET", "/v1/router")[1])
        from daccord_tpu_torch.serve.journal import replay

        ents = {t: replay(os.path.join(procs[t][2], "journal.jsonl"))[0] for t in "ab"}
        committed = [e for t in "ab" for e in ents[t].values()
                     if e.idem == "kill-once" and e.state == "committed"]
        on_survivor = [e for e in ents[survivor].values() if e.idem == "kill-once"]
        log(f"router kill: peer {victim} (owner of tenant a) SIGKILLed after "
            f"{streamed['bytes']} proxied stream bytes of {jid1} (the reader: "
            f"{streamed['error']}); the retried submit landed on peer "
            f"{names.get(rs['jobs'].get(jid2))} as {jid2} after {tries} tries in "
            f"{landed_s:.2f} s; its bytes == the solo 100 kb run: "
            f"{got2 == refs['100kb'][0]}; a further replay -> {again}; journals: "
            f"{len(on_survivor)} entry of the key on the survivor, {len(committed)} "
            f"committed fleet-wide")
        if got2 != refs["100kb"][0] or again != jid2 or len(committed) != 1 \
                or len(on_survivor) != 1 or names.get(rs["jobs"].get(jid2)) != survivor:
            raise AssertionError("router kill: the retry did not land exactly once on "
                                 "the survivor with the same bytes")
        rproc.send_signal(signal.SIGTERM)
        rc = rproc.wait(60)
        rbad = validate_events(os.path.join(rdir, "router.events.jsonl"), strict=True)
        log(f"router: SIGTERM -> exit {rc}; router.events.jsonl eventcheck --strict: "
            f"{'clean' if not rbad else rbad[:3]}")
        if rc != 0 or rbad:
            raise AssertionError(f"router: unclean stop (exit {rc}, {rbad[:3]})")
        sp, sport, swd = procs[survivor]
        serve_stop(sp, sport, swd, f"peer {survivor}")

        # ---- the kernel cache: five publishes, five hits, one corrupt reject ---
        ev = {t: aot_events(procs[t][2]) for t in "ab"}
        count = {t: {k: sum(e["event"] == k for e in ev[t])
                     for k in ("aot.publish", "aot.hit", "aot.miss", "aot.reject")}
                 for t in "ab"}
        log(f"kernel cache: peer a {count['a']}, peer b {count['b']}")
        if on_card and (count["a"]["aot.publish"] != 5 or count["b"]["aot.hit"] != 5
                        or count["b"]["aot.publish"]):
            raise AssertionError(f"kernel cache: want five publishes then five hits, got "
                                 f"{count}")
        if on_card:
            from daccord_tpu_torch.kernels import nvcc
            from daccord_tpu_torch.serve.aotcache import AotCache

            path = AotCache(aot)._path("rescore", nvcc.source_key(nvcc.source("rescore")))
            blob = bytearray(open(path, "rb").read())
            blob[len(blob) // 2] ^= 0xFF
            with open(path, "wb") as fh:
                fh.write(bytes(blob))
        proc, port, wd = peer("c")
        got3, wall3 = router_jobs(port, [dict(job20, tenant="c")])
        if got3[0][2] != refs["20kb"][0] or got3[0][3] != refs["20kb"][0]:
            raise AssertionError("peer c (the flipped cache entry): its FASTA differs")
        serve_stop(proc, port, wd, "peer c")
        ev3 = aot_events(wd)
        rej = [(e["key"], e["reason"]) for e in ev3 if e["event"] == "aot.reject"]
        pubs = [e["key"] for e in ev3 if e["event"] == "aot.publish"]
        hits = sum(e["event"] == "aot.hit" for e in ev3)
        log(f"kernel cache, peer c after one flipped byte in rescore's entry: rejects "
            f"{rej}, rebuilt and published {pubs}, hits {hits}; its 20 kb job "
            f"byte-identical to the solo card run in {wall3:.3f} s")
        if on_card and (rej != [("rescore", "corrupt")] or pubs != ["rescore"] or hits != 4):
            raise AssertionError("kernel cache: the flipped entry was not rejected and "
                                 "rebuilt")
    except BaseException:
        # what the router and the peers saw, before they go
        rdir = os.path.join(tmp, "router")
        log(f"router phase failed: router process "
            f"{'running' if rproc is not None and rproc.poll() is None else rproc and rproc.returncode}; "
            f"peers {[(t, p.poll()) for t, (p, _, _) in procs.items()]}")
        for f in (os.path.join(tmp, "router.log"), os.path.join(rdir, "router.events.jsonl")):
            if os.path.exists(f):
                for line in open(f, errors="replace").read().splitlines()[-25:]:
                    if "router.route" not in line:
                        log(f"  {os.path.basename(f)}: {line[:400]}")
        for t, (_, _, wd) in procs.items():
            f = os.path.join(wd, "serve.events.jsonl")
            if os.path.exists(f):
                for line in open(f, errors="replace"):
                    if any(k in line for k in ("abort", "disconnect", "error", "fail")):
                        log(f"  peer {t} serve.events: {line.strip()[:400]}")
            f = os.path.join(tmp, f"serve_peer_{t}.log")
            if os.path.exists(f):
                for line in open(f, errors="replace").read().splitlines()[-8:]:
                    log(f"  peer {t} log: {line[:400]}")
        if rproc is not None and rproc.poll() is None:
            rproc.kill()
            rproc.wait()
        stop_all()
        raise
    stop_all()
    log(f"router phase: {time.perf_counter() - t_r:.1f} s; fleet and router phase "
        f"{time.perf_counter() - t_phase:.1f} s (predicted at most 150 s)")


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
            # thread, on the torch CPU ladder; the 20 kb runs only: the 100
            # kb one left the smoke for its time limit), then the default
            # again, warm like the run at rate 0; the paged run also with the
            # rows taken by the numpy take (the take before the host
            # library's)
            variants = [("default again", None, False)]
            if ds is not big:
                variants.insert(0, ("in-process audit only", False, False))
            if tag == "paged scan":
                variants.append(("default, numpy take", None, True))
            for label, worker, plain_take in variants:
                if plain_take:
                    from daccord_tpu_torch.audit.worker import take_rows_plain
                    from daccord_tpu_torch.runtime.supervisor import DeviceSupervisor

                    own = DeviceSupervisor.__dict__["_take_rows"]
                    DeviceSupervisor._take_rows = staticmethod(take_rows_plain)
                try:
                    st1 = daccord_with([ds["db"], ds["las"], "-o", out0, "-E", ep, "-b",
                                        str(B), "--device", dev.type, *args], counters,
                                       audit_worker=worker)
                finally:
                    if plain_take:
                        DeviceSupervisor._take_rows = own
                with open(out, "rb") as a, open(out0, "rb") as b0:
                    if a.read() != b0.read():
                        raise AssertionError(f"daccord {tag}, {label}: FASTA differs")
                log(f"daccord {tag}, {label}: wall {st1.wall_s:.3f} s, FASTA "
                    f"byte-identical; {audit_text(st1)}; {audit_tail_text(st1)}")
                if worker is None:
                    share = st1.audit_s / st1.wall_s
                    log(f"audit share, warm {tag} rerun ({label}): {share:.4f} of the "
                        f"wall (the JAX package's contract: at most 0.02): "
                        f"{'met' if share <= 0.02 else 'missed'}; the warm wall against "
                        f"the run at rate 0: {(st1.wall_s - st0.wall_s) / st1.wall_s:+.4f}")
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

        # ---- 4d. the upstream workflow through the port's tools --------------
        t0 = time.perf_counter()
        workflow_phase(counters, tmp, nthreads, smi)
        log(f"workflow phase: {time.perf_counter() - t0:.1f} s")

        # ---- 4e. the telemetry plane ------------------------------------------
        t0 = time.perf_counter()
        telemetry_phase(d, eprof, big, big_eprof, counters, tmp, nthreads, smi)
        log(f"telemetry phase: {time.perf_counter() - t0:.1f} s (predicted at most 60 s)")

        # ---- 4f. the serving plane ---------------------------------------------
        served = serve_phase(d, big, tmp, smi)

        # ---- 4g. the multi-process layer: fleet, router, kernel cache ----------
        fleet_router_phase(d, big, runs["100 kb dense fused"][1], served, tmp, smi, ncpu)

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
