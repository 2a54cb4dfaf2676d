"""The frozen byte and operation counts against the bound column of
PERF.md's kernel table (ms at B=2048, 3.35 TB/s against 67 T/s)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import roofline  # noqa: E402

C, CL, W, SLACK, L, D, O = 3, 48, 40, 8, 64, 32, 56


def ms(n_bytes, ops):
    return roofline.least_s(n_bytes, ops) * 1e3


@pytest.mark.parametrize("M,k,B,bound", [(64, 8, 2048, 0.017146), (64, 10, 2048, 0.016833),
                                         (64, 12, 2048, 0.016520), (256, 8, 2048, 0.187696),
                                         (512, 8, 256, 0.086944)])
def test_dp_backtrack_bound(M, k, B, bound):
    P = W - k + 1 + SLACK
    t_lo, t_hi = roofline.t_range(k, W, SLACK)
    assert ms(*roofline.dp_backtrack(B, M, P, C, CL, t_hi - t_lo + 1)) == pytest.approx(bound, abs=1e-6)


@pytest.mark.parametrize("M,k,bound", [(64, 8, 0.008650), (64, 10, 0.008258),
                                       (64, 12, 0.007867), (256, 8, 0.027900)])
def test_position_weights_bound_and_its_operations_never_bind(M, k, bound):
    P = W - k + 1 + SLACK
    n_bytes, _ = roofline.position_weights(2048, D, L, k, M, P, O)
    assert ms(n_bytes, 0) == pytest.approx(bound, abs=1e-6)
    # two operations a count and column, every position of every segment
    ops_most = 2 * 2048 * D * (L - k + 1) * P
    assert ops_most / roofline.F32_FLOP_S < n_bytes / roofline.HBM_BYTES_S


def test_rescore_bound():
    assert ms(roofline.rescore_bytes(2048, D, L, C, CL), 0) == pytest.approx(0.001465, abs=1e-6)
    # full tiles of 32 segments of 44 bases bind it by operations
    ops = roofline.rescore_ops(C, CL, 2048 * D * 44)
    assert ops / roofline.F32_FLOP_S > roofline.rescore_bytes(2048, D, L, C, CL) / roofline.HBM_BYTES_S


def test_share_is_least_over_measured_time():
    ls = [dict(kernel="rescore", M=64, dur_s=2.0, least_s=0.5),
          dict(kernel="rescore", M=64, dur_s=2.0, least_s=0.1),
          dict(kernel="dp_backtrack", M=256, dur_s=1.0, least_s=0.2)]
    assert roofline.share(ls, "rescore") == pytest.approx(15.0)
    assert roofline.share(ls, "dp_backtrack", 256) == pytest.approx(20.0)
    assert roofline.share(ls, "dp_backtrack", 64) is None
    assert roofline.share(None, "rescore") is None
