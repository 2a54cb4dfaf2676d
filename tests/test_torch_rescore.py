"""The port's rescore and position weights against the JAX package, on the
CPU (the plain versions the kernels ``csrc/rescore.cu`` and
``csrc/position_weights.cu`` are held to on the card).

The multi-word Myers rescore at candidate lengths on both sides of one and
two 64-bit words, against the JAX two-word Myers (CL <= 64) and its
anti-diagonal form (CL > 64); the fixed-order position weights against a
float64 reference and against JAX's ``W``. Inputs are numpy from fixed
seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daccord_tpu.kernels.window_kernel import (_edit_distance_antidiag,
                                               _edit_distance_myers,
                                               _rescore_pick_one)
from daccord_tpu.kernels.window_kernel import KernelParams as JaxKernelParams
from daccord_tpu_torch.kernels.position_weights import (position_weights,
                                                        position_weights_plain)
from daccord_tpu_torch.kernels.rescore import (edit_distance_myers, rescore_pick,
                                               rescore_pick_plain)
from daccord_tpu_torch.kernels.window_kernel import KernelParams


def distance_cases(CL: int, SL: int, seed: int):
    """Candidates of length 0..CL (PAD after), segments of length 0..SL, half
    of them noisy copies of their candidate; the edge lengths included."""
    rng = np.random.default_rng(seed)
    cases = [(0, 17), (5, 0), (0, 0), (1, 1), (CL, SL), (CL, 0), (CL - 1, SL),
             (min(CL, 31), SL), (min(CL, 32), SL), (min(CL, 33), SL)]
    cases += [(int(rng.integers(0, CL + 1)), int(rng.integers(0, SL + 1)))
              for _ in range(70)]
    cands = np.full((len(cases), CL), 4, np.int8)
    segs = np.full((len(cases), SL), 4, np.int8)
    cls = np.zeros(len(cases), np.int32)
    sls = np.zeros(len(cases), np.int32)
    for i, (cl, sl) in enumerate(cases):
        cands[i, :cl] = rng.integers(0, 4, cl)
        if i % 2 and sl:
            src = np.resize(cands[i, :max(cl, 1)], sl)
            flip = rng.random(sl) < 0.15
            segs[i, :sl] = np.where(flip, rng.integers(0, 4, sl), src)
        else:
            segs[i, :sl] = rng.integers(0, 4, sl)
        cls[i], sls[i] = cl, sl
    return cands, cls, segs, sls


@pytest.mark.parametrize("CL,SL,ref", [
    (48, 64, _edit_distance_myers), (63, 64, _edit_distance_myers),
    (64, 80, _edit_distance_myers), (72, 64, _edit_distance_antidiag),
    (100, 112, _edit_distance_antidiag), (130, 140, _edit_distance_antidiag)])
def test_myers_any_length_matches_jax(CL, SL, ref):
    """The multi-word Myers == JAX's two-word Myers up to 64 and its exact
    anti-diagonal DP above, with PAD after every length and empty
    candidates and segments."""
    cands, cls, segs, sls = distance_cases(CL, SL, seed=CL)
    want = np.asarray(jax.jit(jax.vmap(ref))(
        jnp.asarray(cands), jnp.asarray(cls), jnp.asarray(segs), jnp.asarray(sls)))
    got = edit_distance_myers(torch.as_tensor(cands), torch.as_tensor(cls),
                              torch.as_tensor(segs), torch.as_tensor(sls))
    np.testing.assert_array_equal(got.numpy(), want)


def rescore_inputs(seed: int, B: int, C: int, CL: int, D: int, L: int):
    """Windows of noisy copies of their first candidate, with ragged depths,
    candidates that are not ok, windows without any ok candidate, and
    empty and shallow windows."""
    rng = np.random.default_rng(seed)
    cand = np.full((B, C, CL), 4, np.int8)
    clen = np.zeros((B, C), np.int32)
    ok = rng.random((B, C)) < 0.8
    ok[1] = False
    seqs = np.full((B, D, L), 4, np.int8)
    lens = np.zeros((B, D), np.int32)
    for b in range(B):
        for c in range(C):
            n = int(rng.integers(CL - 12, CL + 1))
            cand[b, c, :n] = rng.integers(0, 4, n)
            clen[b, c] = n
        depth = 0 if b == 0 else int(rng.integers(1, D + 1))
        for d in range(depth):
            n = int(clen[b, 0])
            m = 0 if d == 1 else int(rng.integers(n - 6, min(L, n + 6) + 1))
            src = np.resize(cand[b, 0, :max(clen[b, 0], 1)], m)
            flip = rng.random(m) < 0.12
            seqs[b, d, :m] = np.where(flip, rng.integers(0, 4, m), src)
            lens[b, d] = m
    nsegs = (lens > 0).sum(axis=1).astype(np.int32)
    return seqs, lens, nsegs, cand, clen, ok


@pytest.mark.parametrize("CL,L", [(48, 64), (63, 64), (64, 80), (72, 80)])
def test_rescore_pick_matches_jax(CL, L):
    """The batched rescore and pick == JAX's per-window ``_rescore_pick_one``
    (which takes the anti-diagonal form above CL 64); max_err high enough
    that accepted and rejected windows both occur."""
    seqs, lens, nsegs, cand, clen, ok = rescore_inputs(CL, B=40, C=3, CL=CL, D=12, L=L)
    fields = dict(wlen=CL - 8, max_err=0.16)
    jp, tp = JaxKernelParams(**fields), KernelParams(**fields)
    ref = jax.jit(jax.vmap(lambda *a: _rescore_pick_one(*a, p=jp)))(
        *(jnp.asarray(a) for a in (seqs, lens, nsegs, cand, clen, ok)))
    got = rescore_pick(*(torch.as_tensor(a) for a in (seqs, lens, nsegs, cand, clen, ok)),
                       tp)
    for key in ("cons", "cons_len", "err", "solved"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    solved = got["solved"].numpy()
    assert solved.any() and not solved.all()


def test_rescore_wrapper_checks_its_inputs():
    seqs, lens, nsegs, cand, clen, ok = (torch.as_tensor(a) for a in
                                         rescore_inputs(3, B=4, C=3, CL=48, D=4, L=64))
    p = KernelParams()
    assert all(torch.equal(a, b) for a, b in zip(
        rescore_pick(seqs, lens, nsegs, cand, clen, ok, p).values(),
        rescore_pick_plain(seqs, lens, nsegs, cand, clen, ok, p).values()))
    with pytest.raises(ValueError, match="disagree"):
        rescore_pick(seqs, lens[:, :3], nsegs, cand, clen, ok, p)


def test_rescore_kernel_limits_are_refused_before_any_work():
    """The rescore kernel takes any C and CL up to MAX_CL at any D and L (its
    tile stays in global memory and registers); the W kernel counts in 16
    bits. ``daccord --device cuda`` refuses other widths, a window whose
    counts could overflow, and a top-M the DP kernels cannot take, at its
    argument check."""
    from daccord_tpu_torch.kernels import position_weights as pw
    from daccord_tpu_torch.kernels import rescore
    from daccord_tpu_torch.tools import cli

    rescore.check_shape(32, 64, 32, rescore.MAX_CL)
    rescore.check_shape(64, 256, 64, 64)
    rescore.check_shape(512, 512, 3, 48)
    pw.check_shape(32, 57, 56)
    pw.check_shape(1024, 57, 56)
    for args, why in (((32, 64, 3, rescore.MAX_CL + 1), "outside"),
                      ((32, 64, 0, 48), "at least 1")):
        with pytest.raises(ValueError, match=why):
            rescore.check_shape(*args)
    with pytest.raises(ValueError, match="above the kernel's 65535"):
        pw.check_shape(512, 505, 56)
    for bad, why in ((["-w", "600"], "-w 600"),
                     (["--candidates", "0"], "at least 1"),
                     (["--depth", "512", "--seg-len", "512"], "above the kernel's 65535"),
                     (["-M", "1025"], "exceeds the kernels' 1024")):
        with pytest.raises(SystemExit, match=why):
            cli.main(["daccord", "no.db", "no.las", "--device", "cuda", *bad])


def weight_inputs(seed: int, B: int, M: int, O: int, P: int, D: int = 32):
    """prep_batch's kept index of each k-mer position (-1 for about a third,
    the kept k-mers clustered at a few offsets as real windows hold them)
    and an OffsetLikely-like table with values down to subnormal size."""
    rng = np.random.default_rng(seed)
    npos = O + 1
    kid = rng.integers(0, M, (B, D, npos))
    kid = np.where(rng.random((B, D, npos)) < 0.35, -1, kid).astype(np.int32)
    ol = (rng.random((P, O)) * 10.0 ** rng.integers(-40, 0, (P, O))).astype(np.float32)
    return kid, ol


def counts(kid: np.ndarray, M: int, O: int) -> np.ndarray:
    """occ [B, M, O] of ``kid`` by a numpy loop (offsets from O-1 on count at
    O-1)."""
    B, D, npos = kid.shape
    occ = np.zeros((B, M, O), np.float32)
    b, d, i = np.nonzero(kid >= 0)
    np.add.at(occ, (b, kid[b, d, i], np.minimum(i, O - 1)), 1.0)
    return occ


@pytest.mark.parametrize("B,M,O,P", [(3, 64, 56, 41), (2, 256, 56, 41), (2, 7, 90, 5)])
def test_position_weights_fixed_order(B, M, O, P):
    """The plain W is the ascending-o f32 sum of rounded products (a numpy
    loop in that order gives the same bits) and within f32 rounding of the
    float64 product."""
    kid, ol = weight_inputs(B * M, B, M, O, P)
    occ = counts(kid, M, O)
    got = position_weights(torch.as_tensor(kid), torch.as_tensor(ol), M).numpy()
    want = np.zeros((B, M, P), np.float32)
    for o in range(O):
        want = (want + (occ[:, :, o, None] * ol[None, None, :, o]).astype(np.float32)
                ).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    exact = np.einsum("bmo,po->bmp", occ.astype(np.float64), ol.astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=O * 2.0 ** -23, atol=1e-38)
    assert torch.equal(position_weights_plain(torch.as_tensor(kid), torch.as_tensor(ol), M),
                       torch.as_tensor(got))


def test_top_m_512_run_matches_jax(tmp_path):
    """``-M 512`` (one D=32 bucket, which holds 32 * 57 k-mer positions) on
    the first quarter of the piles: the JAX run's solved count and FASTA
    within ROADMAP's drift bound."""
    from daccord_tpu_torch.formats.las import shard_ranges
    from daccord_tpu_torch.sim import SimConfig, make_dataset

    from _torch_wide_common import both_runs, within_drift

    d = make_dataset(str(tmp_path), SimConfig(genome_len=1000, coverage=10,
                                              read_len_mean=500, seed=5))
    start, end = shard_ranges(d["las"], 4)[0]
    js, ps, jr, pr = both_runs(d, str(tmp_path), "M512", M=512, rescue_M=512,
                               depth_buckets=(), start=start, end=end)
    assert ps.n_windows == js.n_windows > 0 and ps.n_solved == js.n_solved > 0
    assert within_drift(js, ps, jr, pr)
