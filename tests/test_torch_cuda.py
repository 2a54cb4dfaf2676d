"""Tests of the port that need a CUDA card: the hand-written kernels
(``dp_backtrack``, ``heaviest_path``, ``gather_pages``) have no CPU form.
Each test skips without a card.

This file imports neither jax nor ``daccord_tpu``, so it also runs on a
machine without JAX; there the JAX-configuring ``tests/conftest.py`` is left
out:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from daccord_tpu_torch.kernels import dp_backtrack, gather_pages, heaviest_path, paging
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
        heaviest_path.heaviest_path_batch(*make_inputs(0, 1, 260, 4, cuda)[:3])


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
        st = correct_to_fasta(d["db"], d["las"], out,
                              PipelineConfig(batch_size=64, max_inflight=mi))
        assert st.peak_inflight == mi and st.n_solved > 0
        with open(out) as fh:
            texts.append(fh.read())
    assert texts[0] == texts[1]

    class Boom(RuntimeError):
        pass

    def boom(batch, ladder):
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
