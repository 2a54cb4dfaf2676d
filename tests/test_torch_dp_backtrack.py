"""The fused DP/backtrack of the port against the JAX Pallas kernel.

The plain torch version (what the wrapper runs on CPU tensors) must be
bit-equal to ``pallas_window.dp_backtrack_batch`` in interpret mode. The
CUDA kernel itself is held against the plain version by
``tests/test_torch_cuda.py`` (skipped without a card) and by
``chip_smoke.py`` on the H100.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from daccord_tpu.kernels.pallas_window import dp_backtrack_batch as pallas_dp
from daccord_tpu_torch.kernels import dp_backtrack


def make_inputs(seed: int, B: int, M: int, P: int):
    """Random DP inputs with integer-valued weights (so equal path sums tie
    exactly), one window with no sink-admissible end state, and one whose
    start scores are all NEG (no path at all)."""
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


def _both(args, **kw):
    ref = pallas_dp(*[jnp.asarray(a) for a in args], interpret=True, **kw)
    got = dp_backtrack.dp_backtrack_batch(*[torch.as_tensor(a) for a in args],
                                          **kw)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("B,M,P,k,t_lo,t_hi", [(4, 16, 12, 4, 3, 11),
                                               (3, 64, 41, 8, 24, 40)])
def test_plain_matches_pallas_interpret(B, M, P, k, t_lo, t_hi):
    args = make_inputs(seed=M, B=B, M=M, P=P)
    kw = dict(k=k, cons_len=P - 1 + k, n_candidates=3, t_lo=t_lo, t_hi=t_hi)
    before = dp_backtrack.launches
    ref, got = _both(args, **kw)
    assert dp_backtrack.launches == before, "CPU tensors never launch the kernel"
    for name, r, g in zip(("cand", "clen", "ok"), ref, got):
        assert r.dtype == g.dtype, (name, r.dtype, g.dtype)
        np.testing.assert_array_equal(g, r, err_msg=name)
    ok = ref[2]
    assert not ok[0].any() and not ok[1].any(), "masked windows must fail"
    assert ok[2:].any(), "the other windows should find paths"


def test_plain_ties_take_lowest_index():
    """Uniform weights on a complete graph: every DP step and every end
    state ties, so only the first-index rules decide the candidates."""
    B, M, P, k = 2, 16, 12, 4
    adjW = np.zeros((B, M, M), np.float32)
    wt = np.ones((B, P, M), np.float32)
    s0 = np.zeros((B, M), np.float32)
    snk = np.ones((B, M), bool)
    sel = np.tile(np.arange(M, dtype=np.int32) * 5, (B, 1))
    kw = dict(k=k, cons_len=P - 1 + k, n_candidates=3, t_lo=3, t_hi=11)
    ref, got = _both((adjW, wt, s0, snk, sel), **kw)
    for name, r, g in zip(("cand", "clen", "ok"), ref, got):
        np.testing.assert_array_equal(g, r, err_msg=name)
    # t-major argmax over scores rising with t: the last step, v = 0, 1, 2
    np.testing.assert_array_equal(ref[1], np.full((B, 3), 11 + k))


def test_wrapper_rejects_bad_inputs():
    adjW, wt, s0, snk, sel = (torch.as_tensor(a) for a in make_inputs(0, 2, 16, 12))
    kw = dict(k=4, cons_len=15, n_candidates=3, t_lo=3, t_hi=11)
    with pytest.raises(TypeError):
        dp_backtrack.dp_backtrack_batch(adjW.double(), wt, s0, snk, sel, **kw)
    with pytest.raises(ValueError):
        dp_backtrack.dp_backtrack_batch(adjW, wt[:, :5], s0, snk, sel, **kw)
    with pytest.raises(ValueError):
        dp_backtrack.dp_backtrack_batch(adjW, wt, s0, snk, sel,
                                        **{**kw, "t_hi": 12})

