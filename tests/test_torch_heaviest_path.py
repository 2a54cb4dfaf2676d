"""The scan route of the port: the heaviest-path DP alone
(``kernels/heaviest_path.py``, plain version on the CPU) and the torch
candidate backtrack, against the JAX package's Pallas DP kernel in interpret
mode, its scan-route DP ``_dp_scan_one`` and its default-route solver.

The CUDA kernel itself is held against the plain version by
``tests/test_torch_cuda.py`` (skipped without a card) and by
``chip_smoke.py`` on the H100.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daccord_tpu.kernels.pallas_dp import heaviest_path_batch as pallas_hp
from daccord_tpu.kernels.window_kernel import KernelParams as JaxKernelParams
from daccord_tpu.kernels.window_kernel import _dp_scan_one, _prep_one, solve_window_batch
from daccord_tpu.oracle.profile import ErrorProfile
from daccord_tpu.oracle.profile import OffsetLikely as JaxOffsetLikely
from daccord_tpu_torch.kernels import dp_backtrack, heaviest_path, window_kernel
from daccord_tpu_torch.kernels.window_kernel import KernelParams, solve_batch_core


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The tier-1 run puts several test files side by side on the CPU; a
    torch thread pool the size of the machine in each oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def make_inputs(seed: int, B: int, M: int, P: int):
    """Random DP inputs with integer-valued weights (equal path sums tie
    exactly); window 0 has no sink-admissible end state and window 1 no start
    state, so no admissible state at all."""
    rng = np.random.default_rng(seed)
    adjW = np.where(rng.random((B, M, M)) < 0.2, 0, -1e30).astype(np.float32)
    wt = np.rint(rng.random((B, P, M)) * 3).astype(np.float32)
    s0 = np.where(rng.random((B, M)) < 0.4, np.rint(rng.random((B, M)) * 2),
                  -1e30).astype(np.float32)
    snk = rng.random((B, M)) < 0.5
    snk[0] = False
    s0[1] = -1e30
    sel = np.sort(rng.integers(0, 4**6, (B, M)), axis=1).astype(np.int32)
    return adjW, wt, s0, snk, sel


@pytest.mark.parametrize("B,M,P", [(5, 16, 12), (3, 64, 41), (2, 64, 37)])
def test_plain_dp_matches_pallas_and_scan(B, M, P):
    adjW, wt, s0, _, _ = make_inputs(seed=M + P, B=B, M=M, P=P)
    pal_s, pal_p = pallas_hp(jnp.asarray(adjW), jnp.asarray(wt), jnp.asarray(s0),
                             interpret=True)
    scan_s, scan_p = jax.jit(jax.vmap(_dp_scan_one))(
        jnp.asarray(adjW), jnp.asarray(np.swapaxes(wt, 1, 2)), jnp.asarray(s0))
    before = heaviest_path.launches
    got_s, got_p = heaviest_path.heaviest_path_batch(
        torch.as_tensor(adjW), torch.as_tensor(wt), torch.as_tensor(s0))
    assert heaviest_path.launches == before, "CPU tensors never launch the kernel"
    assert got_s.dtype == torch.float32 and got_p.dtype == torch.int32
    for ref_s, ref_p in ((pal_s, pal_p), (scan_s, scan_p)):
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    assert (got_s[1] < -5e29).all(), "no start state: no admissible state"


@pytest.mark.parametrize("B,M,P,k,t_lo,t_hi", [(4, 16, 12, 4, 3, 11),
                                               (3, 64, 41, 8, 24, 40)])
def test_dp_then_backtrack_is_the_fused_plain(B, M, P, k, t_lo, t_hi):
    """candidates_backtrack over the DP's stacks gives the fused plain
    version's candidates bit for bit, masked windows included."""
    args = [torch.as_tensor(a) for a in make_inputs(seed=B * M, B=B, M=M, P=P)]
    kw = dict(k=k, cons_len=P - 1 + k, n_candidates=3, t_lo=t_lo, t_hi=t_hi)
    scores, ptrs = heaviest_path.heaviest_path_batch(*args[:3])
    got = dp_backtrack.candidates_backtrack(scores, ptrs, args[3], args[4], **kw)
    ref = dp_backtrack.dp_backtrack_plain(*args, **kw)
    for name, g, r in zip(("cand", "clen", "ok"), got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r), name
    assert not got[2][0].any() and not got[2][1].any()
    with pytest.raises(ValueError):
        dp_backtrack.candidates_backtrack(scores, ptrs, args[3], args[4],
                                          **{**kw, "t_hi": P})


def test_wrapper_rejects_bad_inputs():
    adjW, wt, s0 = (torch.as_tensor(a) for a in make_inputs(0, 2, 16, 12)[:3])
    with pytest.raises(TypeError):
        heaviest_path.heaviest_path_batch(adjW.double(), wt, s0)
    with pytest.raises(ValueError):
        heaviest_path.heaviest_path_batch(adjW, wt[:, :, :5], s0)
    with pytest.raises(ValueError):
        heaviest_path.heaviest_path_batch(adjW, wt, s0[:1])


def _windows(seed: int, B: int = 16, D: int = 12, L: int = 64, wlen: int = 40):
    """Noisy copies of one true sequence per window; every fifth window is
    shallow (depth 3), so the escalation tiers run in a ladder."""
    rng = np.random.default_rng(seed)
    seqs = np.full((B, D, L), 4, np.int8)
    lens = np.zeros((B, D), np.int32)
    for b in range(B):
        true = rng.integers(0, 4, wlen).astype(np.int8)
        for d in range(3 if b % 5 == 0 else D):
            s = true.copy()
            for _ in range(4):
                s[rng.integers(0, wlen)] = rng.integers(0, 4)
            seqs[b, d, :wlen] = s
            lens[b, d] = wlen
    return seqs, lens, (lens > 0).sum(1).astype(np.int32)


def test_scan_route_matches_jax_default_route(monkeypatch):
    """The port's scan-route solve equals the JAX package's default (scan)
    route bit for bit, once both see the JAX ``W`` (an f32 reduction whose
    order differs between XLA and torch)."""
    seqs, lens, nsegs = _windows(3)
    fields = dict(k=8, wlen=40, max_kmers=32)
    jp, tp = JaxKernelParams(**fields), KernelParams(**fields)
    ol = JaxOffsetLikely(ErrorProfile(0.08, 0.04, 0.015), positions=jp.positions,
                         max_offset=56).table
    args = (jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(nsegs), jnp.asarray(ol))
    ref = {k: np.asarray(v) for k, v in solve_window_batch(*args, params=jp).items()}
    g = jax.vmap(functools.partial(_prep_one, p=jp), in_axes=(0, 0, 0, None))(*args)
    real_prep = window_kernel.prep_batch

    def prep(*a):
        out = real_prep(*a)
        out["W"] = torch.as_tensor(np.array(g["W"]))
        out["score0"] = torch.as_tensor(np.array(g["score0"]))
        return out

    monkeypatch.setattr(window_kernel, "prep_batch", prep)
    got = solve_batch_core(torch.as_tensor(seqs), torch.as_tensor(lens),
                           torch.as_tensor(nsegs), torch.as_tensor(ol), tp,
                           route="scan")
    assert ref["solved"].any()
    for key in ("cons", "cons_len", "err", "solved", "m_overflow"):
        np.testing.assert_array_equal(got[key].numpy(), ref[key], err_msg=key)
    with pytest.raises(ValueError, match="route"):
        solve_batch_core(torch.as_tensor(seqs), torch.as_tensor(lens),
                         torch.as_tensor(nsegs), torch.as_tensor(ol), tp,
                         route="pallas")


@pytest.mark.parametrize("overflow_rescue", [False, True])
def test_scan_ladder_equals_fused_ladder(overflow_rescue):
    """The whole ladder on the scan route packs the fused route's result bit
    for bit, escalation tiers and the wide rescue included."""
    from daccord_tpu_torch.kernels.tiers import TierLadder, ladder_core, pack_result
    from daccord_tpu_torch.oracle import ConsensusConfig
    from daccord_tpu_torch.oracle import ErrorProfile as PortErrorProfile

    seqs, lens, nsegs = (torch.as_tensor(a) for a in _windows(5, B=20, D=8))
    lad = TierLadder.from_config(PortErrorProfile(0.08, 0.04, 0.015),
                                 ConsensusConfig(), max_kmers=32,
                                 rescue_max_kmers=64,
                                 overflow_rescue=overflow_rescue, device="cpu")
    tables = tuple(lad.tables[p.k] for p in lad.params)
    packed = {route: pack_result(ladder_core(seqs, lens, nsegs, tables,
                                             tuple(lad.params), lad.wide_p0,
                                             route=route))
              for route in ("fused", "scan")}
    assert torch.equal(packed["scan"], packed["fused"])
    assert dataclasses.replace(lad, route="scan").route == "scan"
