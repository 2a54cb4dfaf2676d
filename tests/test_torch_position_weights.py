"""Why the W kernel (``csrc/position_weights.cu``) may skip the zero
occurrence counts: a numpy loop that adds only the nonzero terms, in
ascending offset order as the kernel does, is bit-equal to
``position_weights_plain``'s dense loop while every table entry is finite,
negative and subnormal entries included; the ladder refuses a table that is
not finite. On the CPU, with numpy inputs from fixed seeds.
"""

import numpy as np
import pytest
import torch

from daccord_tpu_torch.kernels.position_weights import (occurrence_counts,
                                                        position_weights_plain)
from daccord_tpu_torch.kernels.tiers import TierLadder


def sparse_inputs(seed: int, B: int, D: int, npos: int, M: int, O: int, P: int):
    """kid with most positions unkept (so most counts are zero) and some
    k-mers repeated at one offset, and a table of both signs with entries
    down to subnormal size, exact zeros and opposite pairs that cancel."""
    rng = np.random.default_rng(seed)
    kid = np.where(rng.random((B, D, npos)) < 0.8, -1,
                   rng.integers(0, M, (B, D, npos))).astype(np.int32)
    kid[kid == M - 1] = -1              # a kept k-mer with no occurrence: W = +0
    kid[:, :, 3] = 1                    # one k-mer at one offset in every segment
    mag = rng.random((P, O)) * 10.0 ** rng.integers(-45, 1, (P, O)).astype(np.float64)
    ol = (np.where(rng.random((P, O)) < 0.5, -1.0, 1.0) * mag).astype(np.float32)
    ol[:, 5] = 0.0
    ol[:, 6] = -ol[:, 7]
    return kid, ol


def skipping_loop(occ: np.ndarray, ol: np.ndarray) -> np.ndarray:
    """The kernel's order: for each row, the nonzero counts in ascending
    offset order, one f32-rounded product and one f32-rounded add each."""
    B, M, O = occ.shape
    W = np.zeros((B, M, ol.shape[0]), np.float32)
    for b in range(B):
        for m in range(M):
            acc = np.zeros(ol.shape[0], np.float32)
            for o in np.flatnonzero(occ[b, m]):
                acc = (acc + (np.float32(occ[b, m, o]) * ol[:, o]).astype(np.float32)
                       ).astype(np.float32)
            W[b, m] = acc
    return W


@pytest.mark.parametrize("B,D,npos,M,O,P", [(3, 32, 57, 64, 56, 41), (2, 8, 80, 256, 56, 41),
                                            (2, 5, 40, 9, 90, 70)])
def test_skipping_zero_counts_keeps_the_plain_bits(B, D, npos, M, O, P):
    kid, ol = sparse_inputs(B + M + O, B, D, npos, M, O, P)
    occ = occurrence_counts(torch.as_tensor(kid), M, O).numpy()
    assert (occ == 0).mean() > 0.8 and occ.max() >= D
    plain = position_weights_plain(torch.as_tensor(kid), torch.as_tensor(ol), M).numpy()
    got = skipping_loop(occ, ol)
    # bit for bit: the sign of zero and every subnormal included
    assert np.array_equal(got.view(np.uint32), plain.view(np.uint32))
    assert (plain == 0).any() and (plain < 0).any()
    assert not np.signbit(plain[plain == 0]).any()


def test_occurrence_counts_count_each_offset():
    kid, _ = sparse_inputs(5, 2, 6, 30, 11, 20, 4)
    occ = occurrence_counts(torch.as_tensor(kid), 11, 20).numpy()
    want = np.zeros((2, 11, 20), np.float32)
    for b, d, i in zip(*np.nonzero(kid >= 0)):
        want[b, kid[b, d, i], min(i, 19)] += 1
    assert np.array_equal(occ, want)


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
def test_ladder_refuses_a_table_that_is_not_finite(bad):
    table = np.ones((37, 56), np.float32)
    table[3, 9] = bad
    with pytest.raises(ValueError, match="non-finite"):
        TierLadder.from_numpy({8: table}, [dict(k=8)], device="cpu")
