"""A/B timing of two sources of the ``dp_backtrack`` kernel on one card.

    python -m daccord_tpu_torch.tools.dp_ab OLD.cu NEW.cu [-B 2048] [--reps 20]

Both sources must export the C interface of ``csrc/dp_backtrack.cu``
(``dp_backtrack_launch``). Each is built with the port's nvcc flags into
``daccord_tpu_torch/_build/``; both run on the same seeded inputs at every
ladder shape (M, P), must agree bit for bit, and are timed in turns A, B, B,
A (median of ``--reps`` launches between CUDA events each), so that the two
are compared on one card within one process. Prints one line per shape and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

from ..kernels import nvcc
from ..kernels.window_kernel import KernelParams

SHAPES = ((8, 64), (10, 64), (12, 64), (8, 256))   # (k, M) of the default ladder


def build(src: str):
    """Build one source with the port's flags; the ctypes launch function."""
    with open(src, "rb") as fh:
        key = hashlib.sha256(fh.read() + " ".join(nvcc.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(nvcc.BUILD_DIR, f"ab-{key}.so")
    if not os.path.exists(out):
        os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
        res = subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-o", out, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(out).dp_backtrack_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 8 + [ci] * 8 + [vp]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dp_ab", description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("-B", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dp_ab: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    fns = {"A": build(args.a), "B": build(args.b)}
    for k, M in SHAPES:
        p = KernelParams(k=k, max_kmers=M)
        P, C, CL = p.positions, p.n_candidates, p.cons_len
        t_lo, t_hi = p.t_range
        ins = inputs(k * M, args.B, M, P, dev)
        outs = {}

        def launch(tag):
            cand = torch.empty((args.B, C, CL), dtype=torch.int32, device=dev)
            clen = torch.empty((args.B, C), dtype=torch.int32, device=dev)
            ok = torch.empty((args.B, C), dtype=torch.bool, device=dev)
            rc = fns[tag](*(t.data_ptr() for t in ins), cand.data_ptr(),
                          clen.data_ptr(), ok.data_ptr(), args.B, M, P, C, CL, k,
                          t_lo, t_hi, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch {tag} failed ({rc})")
            return cand, clen, ok

        for tag in "AB":
            outs[tag] = launch(tag)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(outs["A"], outs["B"])):
            raise AssertionError(f"A and B disagree at M={M} P={P}")
        times = {"A": [], "B": []}
        for tag in "ABBA":
            for _ in range(2):
                launch(tag)
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(args.reps)]
            for s, e in ev:
                s.record()
                launch(tag)
                e.record()
            torch.cuda.synchronize()
            times[tag].append(float(np.median([s.elapsed_time(e) for s, e in ev])))
        print(f"M={M} P={P} k={k} B={args.B}: A {times['A']} ms, B {times['B']} ms "
              f"(median of {args.reps} launches per turn, turns A B B A), "
              f"bit-equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
