"""The arithmetic of the port's CUDA DP kernels (``csrc/dp_bits.cuh``),
transcribed to torch here, against the plain DP and the JAX package's Pallas
DP kernel in interpret mode.

The kernels read the adjacency once as bits and split each column's
predecessors over S threads, each running K compare chains over groups of
G=4 terms; none of that can run on the CPU. :func:`bits_dp` does the same
steps in the same order: the bits from ``adjW`` (+0.0 set, -1e30 clear),
the terms cur[u] + 0.0 and cur[u] + NEG selected by the bit, each group's
maximum and a strict '>' over the groups in ascending u within each chain,
the chains merged in u order, the first u of the winning group whose term
is the maximum, and the S parts merged by the kernel's shuffle butterfly,
the larger value or, on equal values, the lower u. It must give the plain
DP's stacks bit for bit. The CUDA kernels themselves are held against the
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from daccord_tpu.kernels.pallas_dp import heaviest_path_batch as pallas_hp
from daccord_tpu_torch.kernels.dp_backtrack import NEG, heaviest_path_plain

NEG_BITS = int(torch.tensor(NEG, dtype=torch.float32).view(torch.int32))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The tier-1 run puts several test files side by side on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def bits_dp(adjW: torch.Tensor, wt: torch.Tensor, s0: torch.Tensor, S: int, K: int,
            G: int = 4):
    """The kernels' DP, with S parts of K chains that walk groups of G
    terms: (scores [B,P,M] f32, ptrs [B,P,M] i32)."""
    B, M, _ = adjW.shape
    P = wt.shape[1]
    raw = adjW.view(torch.int32)
    assert bool(((raw == 0) | (raw == NEG_BITS)).all()), "the kernel traps"
    U = -(-M // S)                              # predecessors of one part
    assert U % (K * G) == 0
    L = U // K                                  # predecessors of one chain
    MP = S * U
    bits = torch.zeros((B, MP, M), dtype=torch.bool)
    bits[:, :M] = raw == 0
    pad = torch.full((B, MP - M), float("-inf"))
    start = (torch.arange(K) * L).view(1, 1, K, 1)
    s = s0
    scores, ptrs = [s0], [torch.zeros((B, M), dtype=torch.int32)]
    for t in range(1, P):
        # the two possible terms of each u, added once; each cell selects one
        z = torch.cat([s + 0.0, pad], dim=1)
        n = torch.cat([s + NEG, pad], dim=1)
        term = torch.where(bits, z[:, :, None], n[:, :, None])          # [B, u, v]
        dense = s[:, :, None] + torch.where(bits[:, :M], 0.0, NEG)
        assert torch.equal(term[:, :M].view(torch.int32), dense.view(torch.int32))
        # K chains in each of S parts: each group's maximum, then a strict
        # '>' over the groups in ascending u (the first group reaching it)
        gm = term.view(B, S, K, L // G, G, M).amax(dim=4)
        bv = gm[:, :, :, 0]
        bg = torch.zeros_like(bv, dtype=torch.int64)
        for j in range(1, L // G):
            up = gm[:, :, :, j] > bv
            bv = torch.where(up, gm[:, :, :, j], bv)
            bg = torch.where(up, j * G, bg)
        bg = bg + start
        # chains in u order: a later one wins only on a strictly larger value
        best, g = bv[:, :, 0], bg[:, :, 0]                               # [B, S, M]
        for kk in range(1, K):
            up = bv[:, :, kk] > best
            best = torch.where(up, bv[:, :, kk], best)
            g = torch.where(up, bg[:, :, kk], g)
        # the first u of the winning group whose term is the maximum
        at = g[:, :, None, :] + torch.arange(G).view(1, 1, G, 1)
        vals = term.view(B, S, U, M).gather(2, at)
        first = torch.where(vals == best[:, :, None, :], torch.arange(G).view(1, 1, G, 1),
                            G).amin(dim=2)
        bu = (torch.arange(S).view(1, S, 1) * U + g + first).to(torch.int32)
        # the S parts by the shuffle butterfly (xor 1, 2, ...)
        off = 1
        while off < S:
            mate = torch.arange(S) ^ off
            ob, ou = best[:, mate], bu[:, mate]
            take = (ob > best) | ((ob == best) & (ou < bu))
            best = torch.where(take, ob, best)
            bu = torch.where(take, ou, bu)
            off <<= 1
        assert bool((best == best[:, :1]).all() and (bu == bu[:, :1]).all())
        best, bu = best[:, 0], bu[:, 0]
        s = torch.where(best > NEG / 2, best + wt[:, t], torch.tensor(NEG))
        scores.append(s)
        ptrs.append(bu)
    return torch.stack(scores, dim=1), torch.stack(ptrs, dim=1)


def make_inputs(seed: int, B: int, M: int, P: int, density: float = 0.2):
    """Random DP inputs with integer-valued weights (equal path sums tie
    exactly). In window 0 the columns 0..2 have no set bit, so their
    pointers are those of NEG cells; s0 holds -0.0 beside +0.0."""
    rng = np.random.default_rng(seed)
    adjW = np.where(rng.random((B, M, M)) < density, 0, -1e30).astype(np.float32)
    adjW[0, :, :3] = -1e30
    wt = np.rint(rng.random((B, P, M)) * 3).astype(np.float32)
    s0 = np.where(rng.random((B, M)) < 0.4, np.rint(rng.random((B, M)) * 2),
                  -1e30).astype(np.float32)
    s0[:, 1::7] = -0.0
    s0[:, 2::7] = 0.0
    return adjW, wt, s0


def check(adjW, wt, s0, S, K, G, pallas: bool = True):
    """bits_dp == the plain DP (and the Pallas kernel), bit for bit."""
    ta, tw, ts = (torch.as_tensor(a) for a in (adjW, wt, s0))
    got_s, got_p = bits_dp(ta, tw, ts, S, K, G)
    ref_s, ref_p = heaviest_path_plain(ta, tw, ts)
    assert torch.equal(got_s, ref_s) and torch.equal(got_p, ref_p)
    assert torch.equal(got_s.view(torch.int32), ref_s.view(torch.int32))
    if pallas:
        pal_s, pal_p = pallas_hp(jnp.asarray(adjW), jnp.asarray(wt), jnp.asarray(s0),
                                 interpret=True)
        np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                      np.asarray(pal_s).view(np.int32))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(pal_p))
    return got_s, got_p


# (M, S, K, G): the kernels' own splits -- S=2 parts, K=2 chains at M=64 and
# K=4 at M=256, groups of G=4 -- splits into 2 and 4 parts around them, and
# G=1, a strict '>' over every u
SPLITS = [(16, 2, 1, 4), (16, 2, 2, 1), (16, 4, 2, 1), (64, 2, 2, 4), (64, 2, 2, 1),
          (64, 4, 2, 4), (256, 2, 4, 4), (256, 4, 2, 4), (256, 2, 4, 1)]


@pytest.mark.parametrize("M,S,K,G", SPLITS)
def test_bits_step_matches_plain_and_pallas(M, S, K, G):
    B, P = (3, 12) if M < 256 else (2, 9)
    adjW, wt, s0 = make_inputs(seed=M * 10 + S + K + G, B=B, M=M, P=P)
    scores, ptrs = check(adjW, wt, s0, S, K, G)
    assert (scores[0, 1:, :3] == NEG).all(), "columns with no set bit stay NEG"
    assert (ptrs[0, 1:, :3] > 0).any(), "a NEG cell's pointer is still compared"


@pytest.mark.parametrize("M,S,K,G", SPLITS)
def test_ties_across_split_boundaries(M, S, K, G):
    """Every score equal and each column's only edges on both sides of a part
    boundary (u = U-1, U), a chain boundary (L-1, L) or a group boundary
    (G-1, G), and at the end of the range: the lower u must win each tie."""
    B, P = 2, 4
    U = -(-M // S)
    L = U // K
    adjW = np.full((B, M, M), -1e30, np.float32)
    pairs = [(U - 1, U), (L - 1, L), (G - 1, G), (M - 2, M - 1), (U, M - 1), (0, U),
             (G, G + 1)]
    for v in range(M):
        a, b = pairs[v % len(pairs)]
        if 0 <= a < M and 0 <= b < M:
            adjW[:, a, v] = 0.0
            adjW[:, b, v] = 0.0
    wt = np.zeros((B, P, M), np.float32)
    s0 = np.ones((B, M), np.float32)
    s0[1] = -0.0
    _, ptrs = check(adjW, wt, s0, S, K, G)
    a, _ = pairs[0]
    assert int(ptrs[0, 1, 0]) == a


@pytest.mark.parametrize("M", [16, 64, 256])
def test_complete_graph_uniform_weights(M):
    """Every choice ties: every pointer is 0 under every split."""
    B, P = 2, 6
    adjW = np.zeros((B, M, M), np.float32)
    wt = np.ones((B, P, M), np.float32)
    s0 = np.zeros((B, M), np.float32)
    for S, K, G in ((2, 1, 4), (2, 2, 1), (4, 2, 1)):
        _, ptrs = check(adjW, wt, s0, S, K, G, pallas=G == 4)
        assert int(ptrs.abs().sum()) == 0


def test_bits_refuse_other_adjacency_values():
    """The kernels trap on a value the bits cannot hold; so does the
    transcription, which asserts the same rule."""
    adjW, wt, s0 = (torch.as_tensor(a) for a in make_inputs(1, 1, 16, 4))
    for bad in (1.0, -0.0):
        a = adjW.clone()
        a[0, 3, 5] = bad
        with pytest.raises(AssertionError, match="traps"):
            bits_dp(a, wt, s0, 2, 2, 4)
