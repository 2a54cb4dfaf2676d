"""A/B timing of two sources of one DP kernel on one card.

    python -m daccord_tpu_torch.tools.dp_ab OLD.cu NEW.cu \\
        [--kernel dp_backtrack|heaviest_path] [-B 2048,128] [--reps 20]

Both sources must export the C interface of ``csrc/<kernel>.cu``
(``dp_backtrack_launch`` or ``heaviest_path_launch``). Each is built with the
port's nvcc flags (a header beside a source is part of its build key) into
``daccord_tpu_torch/_build/``. At every ladder shape (M, P) and every batch
size of ``-B``, both run on the same seeded inputs, must agree bit for bit,
and are timed in turns A, B, B, A: the median device time of ``--reps``
launches a turn, from ``torch.profiler``'s kernel events (CUDA event pairs if
the profiler records none), so that the two are compared on one card within
one process. Prints the card's name and power limit, then one line per
shape and batch size.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from ..kernels import nvcc
from ..kernels.window_kernel import KernelParams
from .timing import kernel_ms

SHAPES = ((8, 64), (10, 64), (12, 64), (8, 256))   # (k, M) of the default ladder
N_PTR = {"dp_backtrack": 8, "heaviest_path": 5}     # pointer arguments
N_INT = {"dp_backtrack": 8, "heaviest_path": 3}     # int arguments


def build(src: str, kernel: str):
    """Build one source with the port's flags; the ctypes launch function."""
    out = os.path.join(nvcc.BUILD_DIR, f"ab-{kernel}-{nvcc.source_key(src)}.so")
    if not os.path.exists(out):
        os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
        res = subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-o", out, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    fn = getattr(ctypes.CDLL(out), f"{kernel}_launch")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * N_PTR[kernel] + [ci] * N_INT[kernel] + [vp]
    fn.restype = ci
    return fn


def inputs(seed: int, B: int, M: int, P: int, dev):
    """Random DP inputs: a 20%-dense adjacency, integer-valued weights."""
    rng = np.random.default_rng(seed)
    adjW = np.where(rng.random((B, M, M)) < 0.2, 0, -1e30).astype(np.float32)
    wt = np.rint(rng.random((B, P, M)) * 3).astype(np.float32)
    s0 = np.where(rng.random((B, M)) < 0.4, np.rint(rng.random((B, M)) * 2),
                  -1e30).astype(np.float32)
    snk = rng.random((B, M)) < 0.5
    sel = np.sort(rng.integers(0, 4**6, (B, M)), axis=1).astype(np.int32)
    return [torch.as_tensor(a, device=dev) for a in (adjW, wt, s0, snk, sel)]


def launcher(fn, kernel: str, p: KernelParams, ins, dev):
    """A function that launches ``fn`` once on ``ins`` and returns its outputs."""
    B, M, P = ins[0].shape[0], p.max_kmers, p.positions
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "dp_backtrack":
        C, CL = p.n_candidates, p.cons_len
        t_lo, t_hi = p.t_range

        def run():
            outs = (torch.empty((B, C, CL), dtype=torch.int32, device=dev),
                    torch.empty((B, C), dtype=torch.int32, device=dev),
                    torch.empty((B, C), dtype=torch.bool, device=dev))
            rc = fn(*(t.data_ptr() for t in ins + list(outs)), B, M, P, C, CL,
                    p.k, t_lo, t_hi, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed ({rc})")
            return outs
    else:
        def run():
            outs = (torch.empty((B, P, M), dtype=torch.float32, device=dev),
                    torch.empty((B, P, M), dtype=torch.int32, device=dev))
            rc = fn(*(t.data_ptr() for t in ins[:3] + list(outs)), B, M, P, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed ({rc})")
            return outs
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dp_ab", description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--kernel", choices=tuple(N_PTR), default="dp_backtrack")
    ap.add_argument("-B", default="2048",
                    help="batch sizes, comma-separated (default 2048)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sizes = [int(x) for x in args.B.split(",")]
    if not torch.cuda.is_available():
        print("dp_ab: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    fns = {"A": build(args.a, args.kernel), "B": build(args.b, args.kernel)}
    name = f"{args.kernel}_kernel"
    for k, M in SHAPES:
        p = KernelParams(k=k, max_kmers=M)
        for B in sizes:
            ins = inputs(k * M, B, M, p.positions, dev)
            run = {tag: launcher(fns[tag], args.kernel, p, ins, dev) for tag in "AB"}
            outs = {tag: run[tag]() for tag in "AB"}
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(outs["A"], outs["B"])):
                raise AssertionError(f"A and B disagree at M={M} P={p.positions} B={B}")
            times = {"A": [], "B": []}
            how = set()
            for tag in "ABBA":
                ms, by = kernel_ms(run[tag], name, args.reps)
                times[tag].append(ms)
                how.add(by)
            print(f"{args.kernel} M={M} P={p.positions} k={k} B={B}: "
                  f"A {times['A']} ms, B {times['B']} ms (median of {args.reps} "
                  f"launches per turn, turns A B B A, timed by {'/'.join(sorted(how))}), "
                  f"A/B {np.mean(times['A']) / np.mean(times['B']):.2f}x, bit-equal",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
