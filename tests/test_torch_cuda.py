"""Tests of the port that need a CUDA card: the hand-written kernels
(``dp_backtrack``, ``heaviest_path``, ``gather_pages``, ``rescore``,
``position_weights``) have no CPU form. Each test skips without a card.

This file imports neither jax nor ``daccord_tpu``, so it also runs on a
machine without JAX; there the JAX-configuring ``tests/conftest.py`` is left
out:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from daccord_tpu_torch.kernels import (dp_backtrack, gather_pages, heaviest_path, paging,
                                       position_weights, rescore)
from daccord_tpu_torch.kernels.window_kernel import KernelParams


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU form")
    return torch.device("cuda")


def make_inputs(seed: int, B: int, M: int, P: int, device):
    """Random DP inputs with integer-valued weights (equal path sums tie
    exactly), one window with no sink-admissible end state and one with no
    start state."""
    rng = np.random.default_rng(seed)
    adjW = np.where(rng.random((B, M, M)) < 0.2, 0, -1e30).astype(np.float32)
    wt = np.rint(rng.random((B, P, M)) * 3).astype(np.float32)
    s0 = np.where(rng.random((B, M)) < 0.4, np.rint(rng.random((B, M)) * 2),
                  -1e30).astype(np.float32)
    snk = rng.random((B, M)) < 0.5
    snk[0] = False
    s0[1:2] = -1e30
    sel = np.sort(rng.integers(0, 4**6, (B, M)), axis=1).astype(np.int32)
    return [torch.as_tensor(a, device=device) for a in (adjW, wt, s0, snk, sel)]


LADDER_SHAPES = [(8, 64), (10, 64), (12, 64), (8, 256)]      # (k, M)
# one window, a partial block of windows, fewer blocks than SMs, and the
# escalation tiers' batch with a partial block
BATCHES = [1, 7, 128, 133]


@pytest.mark.cuda
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("k,M", LADDER_SHAPES)
def test_kernel_matches_plain_at_ladder_shapes(cuda, k, M, B):
    p = KernelParams(k=k, max_kmers=M)
    t_lo, t_hi = p.t_range
    args = make_inputs(seed=k * M + B, B=B, M=M, P=p.positions, device=cuda)
    kw = dict(k=k, cons_len=p.cons_len, n_candidates=p.n_candidates,
              t_lo=t_lo, t_hi=t_hi)
    before = dp_backtrack.launches
    got = dp_backtrack.dp_backtrack_batch(*args, **kw)
    assert dp_backtrack.launches == before + 1
    ref = dp_backtrack.dp_backtrack_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, g, r in zip(("cand", "clen", "ok"), got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r), name
    assert not got[2][:2].any()


@pytest.mark.cuda
def test_kernel_ties_take_lowest_index(cuda):
    """A complete graph with uniform weights: every choice ties."""
    B, M, P, k = 3, 64, 41, 8
    args = [torch.zeros((B, M, M), device=cuda),
            torch.ones((B, P, M), device=cuda),
            torch.zeros((B, M), device=cuda),
            torch.ones((B, M), dtype=torch.bool, device=cuda),
            (torch.arange(M, dtype=torch.int32, device=cuda) * 5).repeat(B, 1)]
    kw = dict(k=k, cons_len=48, n_candidates=3, t_lo=24, t_hi=40)
    got = dp_backtrack.dp_backtrack_batch(*args, **kw)
    ref = dp_backtrack.dp_backtrack_plain(*args, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    adjW, wt, s0, snk, sel = make_inputs(0, 4, 64, 41, cuda)
    kw = dict(k=8, cons_len=48, n_candidates=3, t_lo=24, t_hi=40)
    with pytest.raises(ValueError, match="contiguous"):
        dp_backtrack.dp_backtrack_batch(adjW.transpose(1, 2), wt, s0, snk, sel, **kw)
    with pytest.raises(ValueError, match="on cpu"):
        dp_backtrack.dp_backtrack_batch(adjW, wt.cpu(), s0, snk, sel, **kw)
    # the widest window the kernels take is MAX_M = 1024; a wider one, or one
    # whose score rows and pointer stack do not fit a block, is refused
    # before any launch
    wide = make_inputs(0, 1, dp_backtrack.MAX_M + 1, 41, cuda)
    with pytest.raises(ValueError, match="exceeds"):
        dp_backtrack.dp_backtrack_batch(*wide, **kw)
    with pytest.raises(ValueError, match="exceeds"):
        heaviest_path.heaviest_path_batch(*wide[:3])
    long = make_inputs(0, 1, 1024, 101, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        dp_backtrack.dp_backtrack_batch(*long, **dict(kw, cons_len=108, t_hi=92))


@pytest.mark.cuda
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("k,M", LADDER_SHAPES)
def test_heaviest_path_matches_plain_at_ladder_shapes(cuda, k, M, B):
    P = KernelParams(k=k, max_kmers=M).positions
    adjW, wt, s0, _, _ = make_inputs(seed=k + M + B, B=B, M=M, P=P, device=cuda)
    before = heaviest_path.launches
    got = heaviest_path.heaviest_path_batch(adjW, wt, s0)
    assert heaviest_path.launches == before + 1
    ref = dp_backtrack.heaviest_path_plain(adjW, wt, s0)
    torch.cuda.synchronize()
    for name, g, r in zip(("scores", "ptrs"), got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r), name
    with pytest.raises(ValueError, match="contiguous"):
        heaviest_path.heaviest_path_batch(adjW.transpose(1, 2), wt, s0)


@pytest.mark.cuda
@pytest.mark.parametrize("M,shift", [(16, 0), (37, 0), (100, 0), (64, 1)])
def test_kernels_match_plain_off_the_ladder_widths(cuda, M, shift):
    """Widths the ladder does not use (padded columns and predecessors; at
    M=37 an adjacency that is no whole number of 16-byte loads), and an
    adjacency whose start is not 16-byte aligned (``shift`` floats)."""
    P, k = 12, 4
    adjW, wt, s0, snk, sel = make_inputs(seed=M, B=3, M=M, P=P, device=cuda)
    buf = torch.empty(adjW.numel() + shift, device=cuda)
    adjW = buf[shift:].view(adjW.shape).copy_(adjW)
    args = (adjW, wt, s0, snk, sel)
    kw = dict(k=k, cons_len=P - 1 + k, n_candidates=3, t_lo=3, t_hi=P - 1)
    got = dp_backtrack.dp_backtrack_batch(*args, **kw)
    ref = dp_backtrack.dp_backtrack_plain(*args, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    got = heaviest_path.heaviest_path_batch(*args[:3])
    ref = dp_backtrack.heaviest_path_plain(*args[:3])
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="exceeds"):
        heaviest_path.heaviest_path_batch(*make_inputs(0, 1, 1030, 4, cuda)[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 133])
@pytest.mark.parametrize("M", [257, 384, 512, 1024])
def test_wide_kernels_match_plain(cuda, M, B):
    """Top-M above 256: two threads a column up to 512, one above, the
    adjacency bits sharing their shared memory with the fused kernel's
    score rows and pointer stack."""
    p = KernelParams(k=8, max_kmers=M)
    t_lo, t_hi = p.t_range
    args = make_inputs(seed=M + B, B=B, M=M, P=p.positions, device=cuda)
    kw = dict(k=8, cons_len=p.cons_len, n_candidates=p.n_candidates,
              t_lo=t_lo, t_hi=t_hi)
    got = dp_backtrack.dp_backtrack_batch(*args, **kw)
    ref = dp_backtrack.dp_backtrack_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, g, r in zip(("cand", "clen", "ok"), got, ref):
        assert torch.equal(g, r), name
    got = heaviest_path.heaviest_path_batch(*args[:3])
    ref = dp_backtrack.heaviest_path_plain(*args[:3])
    torch.cuda.synchronize()
    for name, g, r in zip(("scores", "ptrs"), got, ref):
        assert torch.equal(g, r), name


def rescore_inputs(seed: int, B: int, C: int, CL: int, D: int, L: int):
    """Windows of noisy copies of their first candidate (tests/
    test_torch_rescore.py holds the plain version to JAX on such inputs)."""
    rng = np.random.default_rng(seed)
    cand = np.full((B, C, CL), 4, np.int8)
    clen = np.zeros((B, C), np.int32)
    ok = rng.random((B, C)) < 0.8
    ok[1] = False
    seqs = np.full((B, D, L), 4, np.int8)
    lens = np.zeros((B, D), np.int32)
    for b in range(B):
        for c in range(C):
            n = int(rng.integers(max(CL - 12, 0), CL + 1))
            cand[b, c, :n] = rng.integers(0, 4, n)
            clen[b, c] = n
        clen[b, 0] = 0 if b == 2 else clen[b, 0]
        for d in range(0 if b == 0 else int(rng.integers(1, D + 1))):
            n = int(clen[b, 0])
            m = 0 if d == 1 else int(rng.integers(max(n - 6, 0), min(L, n + 6) + 1))
            src = np.resize(cand[b, 0, :max(n, 1)], m)
            seqs[b, d, :m] = np.where(rng.random(m) < 0.12, rng.integers(0, 4, m), src)
            lens[b, d] = m
    nsegs = (lens > 0).sum(axis=1).astype(np.int32)
    return seqs, lens, nsegs, cand, clen, ok


@pytest.mark.cuda
@pytest.mark.parametrize("CL,L,D,C", [(48, 64, 32, 3), (63, 64, 32, 3), (64, 80, 16, 3),
                                      (72, 80, 40, 5), (130, 140, 8, 2), (256, 264, 12, 32),
                                      (512, 520, 8, 32), (48, 64, 32, 11)])
def test_rescore_kernel_matches_plain(cuda, CL, L, D, C):
    """One launch == the torch rescore, bit for bit, across one to eight
    64-bit words, more segments than a warp's lanes, more candidates than a
    block's warps, and windows with no ok candidate, an empty candidate or
    no segment."""
    B = 300
    host = rescore_inputs(CL + D, B, C, CL, D, L)
    args = [torch.as_tensor(a, device=cuda) for a in host]
    p = KernelParams(wlen=CL - 8, max_err=0.16)
    before = rescore.launches
    got = rescore.rescore_pick(*args, p)
    assert rescore.launches == before + 1
    ref = rescore.rescore_pick_plain(*args, p)
    torch.cuda.synchronize()
    for key in ("cons", "cons_len", "err", "solved"):
        assert got[key].dtype == ref[key].dtype and torch.equal(got[key], ref[key]), key
    assert 0 < int(got["solved"].sum()) < B
    cpu = rescore.rescore_pick(*(torch.as_tensor(a) for a in host), p)
    assert all(torch.equal(got[k].cpu(), cpu[k]) for k in cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2048, 615])
@pytest.mark.parametrize("shift", [0, 1])
def test_rescore_kernel_matches_plain_at_path_batches(cuda, B, shift):
    """Tier 0's shape (C=3, CL=48, D=32, L=64) at B=2048 and the path's
    batch, with the tile 16-byte aligned (vector loads) and one byte off
    (byte loads)."""
    host = rescore_inputs(B + shift, B, 3, 48, 32, 64)
    args = [torch.as_tensor(a, device=cuda) for a in host]
    buf = torch.empty(args[0].numel() + shift, dtype=torch.int8, device=cuda)
    args[0] = buf[shift:].view(args[0].shape).copy_(args[0])
    p = KernelParams(wlen=40, max_err=0.16)
    got = rescore.rescore_pick(*args, p)
    ref = rescore.rescore_pick_plain(*args, p)
    torch.cuda.synchronize()
    for key in ("cons", "cons_len", "err", "solved"):
        assert torch.equal(got[key], ref[key]), key
    assert 0 < int(got["solved"].sum()) < B


def kid_inputs(seed: int, B: int, M: int, D: int, npos: int, O: int, P: int):
    """prep_batch's kept index of each k-mer position (most unkept, so most
    counts are zero, and one k-mer at one offset in every segment) and a
    table with values down to subnormal size (no flush to zero)."""
    rng = np.random.default_rng(seed)
    kid = np.where(rng.random((B, D, npos)) < 0.6, -1,
                   rng.integers(0, M, (B, D, npos))).astype(np.int32)
    kid[:, :, min(3, npos - 1)] = M - 1
    ol = (rng.random((P, O)) * 10.0 ** rng.integers(-44, 0, (P, O))).astype(np.float32)
    return kid, ol


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,D,npos,O,P", [(2048, 64, 32, 57, 56, 41), (133, 64, 32, 57, 56, 41),
                                            (264, 64, 32, 57, 56, 41),
                                            (2048, 256, 32, 57, 56, 41),
                                            (133, 256, 32, 57, 56, 41), (5, 7, 3, 95, 90, 5),
                                            (4, 33, 4, 31, 30, 20), (3, 9, 2, 21, 20, 100),
                                            (2, 5, 2, 30, 20, 150), (3, 1024, 40, 53, 56, 41)])
def test_position_weights_kernel_matches_the_cpu(cuda, B, M, D, npos, O, P):
    """The W kernel on the card == the plain W on the card and on the CPU,
    bit for bit, at the ladder's shapes at B=2048 and the escalation tiers'
    batch, and at widths with one to five column slices and two or three
    offset chunks."""
    kid, ol = kid_inputs(B + M, B, M, D, npos, O, P)
    tk, tol = torch.as_tensor(kid, device=cuda), torch.as_tensor(ol, device=cuda)
    before = position_weights.launches
    got = position_weights.position_weights(tk, tol, M)
    assert position_weights.launches == before + 1
    plain = position_weights.position_weights_plain(tk, tol, M)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    ref = position_weights.position_weights(torch.as_tensor(kid), torch.as_tensor(ol), M)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_ladder_on_the_card_equals_the_cpu_ladder(cuda, tmp_path):
    """With W in one order on both sides, a whole ladder call on the card
    gives the CPU ladder's packed result, bit for bit."""
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.kernels.tiers import TierLadder, ladder_core, pack_result
    from daccord_tpu_torch.runtime.pipeline import (PipelineConfig,
                                                    estimate_profile_for_shard,
                                                    iter_pile_blocks)
    from daccord_tpu_torch.sim import SimConfig, make_dataset

    d = make_dataset(str(tmp_path), SimConfig(genome_len=3000, coverage=20,
                                              read_len_mean=1000, seed=3))
    db, las = read_db(d["db"]), LasFile(d["las"])
    cfg = PipelineConfig(device="cpu")
    prof = estimate_profile_for_shard(db, las, cfg)
    blocks = [(s[n >= 3], ln[n >= 3], n[n >= 3]) for _, _, s, ln, n in
              iter_pile_blocks(db, las, cfg)]
    seqs, lens, nsegs = (np.concatenate([b[i] for b in blocks])[:512] for i in range(3))
    packed = []
    for dev in ("cpu", cuda):
        lad = TierLadder.from_config(prof, cfg.consensus, device=dev)
        tables = tuple(lad.tables[p.k] for p in lad.params)
        packed.append(pack_result(ladder_core(
            *(torch.as_tensor(a, device=dev) for a in (seqs, lens, nsegs)),
            tables, tuple(lad.params))).cpu())
    assert torch.equal(packed[0], packed[1])


TRAP = """
import sys, torch
from daccord_tpu_torch.kernels import dp_backtrack, heaviest_path
kernel, M, bad = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
adjW = torch.full((3, M, M), -1e30, device="cuda")
adjW[:, :, 0] = 0.0
adjW[1, 2, 5] = bad
wt = torch.ones((3, 41, M), device="cuda")
s0 = torch.zeros((3, M), device="cuda")
if kernel == "dp_backtrack":
    dp_backtrack.dp_backtrack_batch(
        adjW, wt, s0, torch.ones((3, M), dtype=torch.bool, device="cuda"),
        torch.zeros((3, M), dtype=torch.int32, device="cuda"), k=8, cons_len=48,
        n_candidates=3, t_lo=24, t_hi=40)
else:
    heaviest_path.heaviest_path_batch(adjW, wt, s0)
torch.cuda.synchronize()
print("no trap")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,M,bad", [("dp_backtrack", 64, "1.0"),
                                          ("heaviest_path", 256, "1.0"),
                                          ("dp_backtrack", 256, "-0.0"),
                                          ("heaviest_path", 64, "-0.0")])
def test_kernels_trap_on_adjacency_the_bits_cannot_hold(cuda, kernel, M, bad):
    """An adjW value other than +0.0 or -1e30 stops the kernel (in a child
    process: a trap leaves that process's CUDA context unusable)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", TRAP, kernel, str(M), bad], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode != 0 and "no trap" not in res.stdout, res.stdout
    args = make_inputs(seed=1, B=2, M=M, P=9, device=cuda)
    got = heaviest_path.heaviest_path_batch(*args[:3])
    ref = dp_backtrack.heaviest_path_plain(*args[:3])
    torch.cuda.synchronize()
    assert all(torch.equal(g, r) for g, r in zip(got, ref)), "this context survives"


@pytest.mark.cuda
@pytest.mark.parametrize("PL,offset", [(16, 0), (16, 1), (8, 0), (4, 2), (32, 0),
                                       (3, 0)])
def test_gather_pages_matches_plain(cuda, PL, offset):
    """Every page length and alignment: the widest vector that divides the
    page and both addresses, down to single bytes."""
    rng = np.random.default_rng(PL + offset)
    N, B, PPW = 300, 37, 19
    buf = torch.as_tensor(rng.integers(-128, 128, N * PL + offset).astype(np.int8),
                          device=cuda)
    pool = buf[offset:].view(N, PL)
    table = torch.as_tensor(rng.integers(0, N, (B, PPW)).astype(np.int32), device=cuda)
    before = gather_pages.launches
    got = gather_pages.gather_pages(pool, table)
    assert gather_pages.launches == before + 1
    ref = gather_pages.gather_pages_plain(pool, table)
    torch.cuda.synchronize()
    assert got.shape == (B, PPW, PL) and torch.equal(got, ref)


@pytest.mark.cuda
def test_gather_windows_rebuilds_the_dense_tile(cuda):
    rng = np.random.default_rng(4)
    B, D, L = 40, 32, 64
    seqs = np.full((B, D, L), 4, np.int8)
    lens = np.zeros((B, D), np.int32)
    for b in range(B):
        for d in range(int(rng.integers(0, D + 1))):
            n = int(rng.integers(0, L + 1))
            seqs[b, d, :n] = rng.integers(0, 4, n)
            lens[b, d] = n
    from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch

    dense = WindowBatch(seqs=seqs, lens=lens, nsegs=(lens > 0).sum(1).astype(np.int32),
                        shape=BatchShape(depth=D, seg_len=L, wlen=40),
                        read_ids=np.arange(B), wstarts=np.zeros(B, np.int64))
    pb = paging.pack_paged(dense, paging.ShapeFamily(depth=D, pages=128))
    got = paging.gather_windows(*(torch.as_tensor(a, device=cuda)
                                  for a in (pb.pool, pb.table, pb.lens)),
                                page_len=16, seg_len=L)
    assert torch.equal(got.cpu(), torch.as_tensor(seqs))


@pytest.mark.cuda
def test_dispatcher_stream_matches_sync_run(cuda, tmp_path):
    """The ladder calls on the dispatcher's own stream (``max_inflight``
    8, the results copied into pinned memory behind an event) write the
    FASTA the synchronous run (``max_inflight`` 1) writes, byte for byte, and
    a failing call re-raises at ``fetch``."""
    from daccord_tpu_torch.kernels import tiers
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig, correct_to_fasta
    from daccord_tpu_torch.sim import SimConfig, make_dataset

    d = make_dataset(str(tmp_path), SimConfig(genome_len=1000, coverage=20,
                                              read_len_mean=500, seed=7))
    texts = []
    for mi in (1, 8):
        out = str(tmp_path / f"inflight{mi}.fasta")
        # audit off: with it, calls whose audit rows lag stay queued past
        # max_inflight (up to pipeline.AUDIT_LAG times), which the ladder's
        # graphs make the common case
        st = correct_to_fasta(d["db"], d["las"], out,
                              PipelineConfig(batch_size=64, max_inflight=mi, audit_rate=0))
        assert st.peak_inflight == mi and st.n_solved > 0
        with open(out) as fh:
            texts.append(fh.read())
    assert texts[0] == texts[1]

    class Boom(RuntimeError):
        pass

    def boom(batch, ladder, *args):
        raise Boom("ladder call failed")

    lad = tiers.TierLadder.from_numpy({8: np.zeros((37, 56), np.float32)},
                                      [dict(k=8)], device=cuda)
    real, tiers._ladder_packed = tiers._ladder_packed, boom
    try:
        with tiers.LadderDispatcher(cuda) as disp:
            with pytest.raises(Boom):
                tiers.fetch(tiers.solve_ladder_async(None, lad, disp))
    finally:
        tiers._ladder_packed = real


TRAP_RUN = """
import json, os, sys
from daccord_tpu_torch.kernels import window_kernel
from daccord_tpu_torch.tools.cli import daccord_run

real, calls = window_kernel.prep_batch, [0]


def prep(seqs, lens, nsegs, ol, p):
    g = real(seqs, lens, nsegs, ol, p)
    if g["adjW"].is_cuda:
        calls[0] += 1
        if calls[0] == 3:
            g["adjW"][0, 0, 0] = 1.0   # no bit holds it: the DP kernel traps
    return g


window_kernel.prep_batch = prep
stats, _ = daccord_run(sys.argv[1:])
print("STATS " + json.dumps(dict(degraded=stats.degraded, reason=stats.fallback_reason)))
"""


@pytest.mark.cuda
def test_real_trap_fails_over_to_the_cpu_ladder(cuda, tmp_path):
    """A trapped DP kernel poisons its process's CUDA context (in a child
    process here): the supervisor maps the error to device loss at once,
    fails over to the port's ladder on the CPU, replays the calls in flight
    and writes the clean run's FASTA byte for byte."""
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig, estimate_profile_for_shard
    from daccord_tpu_torch.sim import SimConfig, make_dataset
    from daccord_tpu_torch.tools.cli import daccord_run

    d = make_dataset(str(tmp_path), SimConfig(genome_len=3000, coverage=15,
                                              read_len_mean=800, seed=5))
    eprof = str(tmp_path / "e.json")
    estimate_profile_for_shard(read_db(d["db"]), LasFile(d["las"]),
                               PipelineConfig(device="cpu")).save(eprof)
    args = [d["db"], d["las"], "-E", eprof, "-b", "64", "--audit-rate", "0"]
    clean = str(tmp_path / "clean.fasta")
    daccord_run([*args, "-o", clean])
    out = str(tmp_path / "trap.fasta")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", TRAP_RUN, *args, "-o", out,
                          "--failover-backend", "cpu"], cwd=root, capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "DACCORD_COMPCACHE": str(tmp_path / "cc")})
    assert "STATS " in res.stdout, res.stdout[-2000:] + res.stderr[-3000:]
    st = json.loads(res.stdout.split("STATS ", 1)[1].splitlines()[0])
    assert st["degraded"] and "injected" not in st["reason"], st
    with open(out) as a, open(clean) as b:
        assert a.read() == b.read()


@pytest.mark.cuda
def test_kernel_launch_error_raises_through_the_supervisor(cuda, tmp_path, monkeypatch):
    """A launch the card refuses without poisoning the context (a W table
    too large for one block's shared memory) raises ``KernelError`` through
    the supervisor: no probe, no retry, no failover, and the card runs the
    next launch."""
    from daccord_tpu_torch.kernels.nvcc import KernelError
    from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch
    from daccord_tpu_torch.runtime.supervisor import DeviceSupervisor, SupervisorConfig
    from daccord_tpu_torch.utils.obs import NullLogger

    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc"))
    kid = torch.zeros((2, 4, 300), dtype=torch.int32, device=cuda)
    ol = torch.ones((300, 300), device=cuda)        # 462 KB of shared memory
    batch = WindowBatch(seqs=np.zeros((2, 2, 8), np.int8), lens=np.zeros((2, 2), np.int32),
                        nsegs=np.zeros(2, np.int32),
                        shape=BatchShape(depth=2, seg_len=8, wlen=8),
                        read_ids=np.arange(2, dtype=np.int64),
                        wstarts=np.zeros(2, np.int64))
    probes, built = [], []
    sup = DeviceSupervisor(
        lambda b: position_weights.position_weights(kid, ol, 4),
        lambda h: torch.cuda.synchronize() or h,
        fallback_factory=lambda: built.append(1) or (lambda b: b),
        log=NullLogger(), cfg=SupervisorConfig(), faults=None,
        probe_fn=lambda: probes.append(1) or True)
    try:
        with pytest.raises(KernelError, match="position_weights launch failed"):
            sup.fetch(sup.dispatch(batch))
    finally:
        sup.close()
    assert not sup.failed_over and not built and not probes
    # segment d holds k-mer d at each of 56 positions: a count of 1 at every
    # offset of row d
    kid = torch.arange(4, dtype=torch.int32, device=cuda).view(1, 4, 1).expand(2, 4, 56).contiguous()
    got = position_weights.position_weights(kid, ol[:41, :56].contiguous(), 4)
    assert torch.equal(got.cpu(), torch.full((2, 4, 41), 56.0))
