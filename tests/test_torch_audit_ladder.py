"""The audit worker's numpy ladder (``audit/ladder.py``) against the port's
torch ladder on the CPU (``kernels/tiers.py``, the shadow audit's byte-exact
reference): the whole ladder with and without the wide rescue, the W by
rank against ``position_weights_plain`` (negative and subnormal table
entries), the multi-word Myers distance and the rescore, bit for bit.
Inputs are numpy from fixed seeds; the windows are the ones
``tests/test_torch_ladder.py`` holds the torch ladder to the JAX package
with.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from daccord_tpu_torch.audit import ladder as np_ladder
from daccord_tpu_torch.kernels.position_weights import position_weights_plain
from daccord_tpu_torch.kernels.rescore import edit_distance_myers, rescore_pick_plain
from daccord_tpu_torch.kernels.tiers import (TierLadder, ladder_core, pack_result,
                                             unpack_result)
from daccord_tpu_torch.kernels.window_kernel import KernelParams
from daccord_tpu_torch.oracle.consensus import ConsensusConfig
from daccord_tpu_torch.oracle.profile import ErrorProfile

from test_torch_ladder import _batch
from test_torch_position_weights import sparse_inputs
from test_torch_rescore import distance_cases, rescore_inputs


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _bits_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        assert np.array_equal(a, b), k


def test_audit_package_imports_no_torch():
    """The worker's modules load numpy only: no torch, jax or
    ``daccord_tpu`` (the worker's start is an interpreter and numpy)."""
    code = ("import sys\n"
            "import daccord_tpu_torch.audit.worker, daccord_tpu_torch.audit.ladder\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'daccord_tpu')))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stderr


@pytest.mark.parametrize("overflow_rescue", [False, True])
def test_numpy_ladder_bit_equal_to_torch_ladder(overflow_rescue):
    seqs, lens, nsegs = _batch()
    # a small tier-0 active set binds the top-M cap on many windows, so the
    # wide rescue and the escalation tiers all run
    tl = TierLadder.from_config(ErrorProfile(0.08, 0.04, 0.015), ConsensusConfig(),
                                max_kmers=40, rescue_max_kmers=64,
                                overflow_rescue=overflow_rescue, device="cpu")
    out = ladder_core(torch.as_tensor(seqs), torch.as_tensor(lens), torch.as_tensor(nsegs),
                      tuple(tl.tables[p.k] for p in tl.params), tuple(tl.params),
                      tl.wide_p0)
    want = unpack_result(pack_result(out).numpy(), tl.params[0].cons_len)
    got = np_ladder.solve_ladder(tl.spec(), seqs, lens, nsegs)
    _bits_equal(got, want)
    tiers = set(want["tier"].tolist())
    assert 0 in tiers and any(t >= 1 for t in tiers), tiers
    assert want["m_ovf"].any() and not want["solved"][-4:].any()


@pytest.mark.parametrize("B,D,npos,M,O,P", [(3, 32, 57, 64, 56, 41), (2, 8, 80, 256, 56, 41),
                                            (2, 5, 40, 9, 90, 70)])
def test_weights_by_rank_keep_the_plain_bits(B, D, npos, M, O, P):
    kid, ol = sparse_inputs(B + M + O + 1, B, D, npos, M, O, P)
    want = position_weights_plain(torch.as_tensor(kid), torch.as_tensor(ol), M).numpy()
    b, d, i = np.nonzero(kid >= 0)
    got = np_ladder.position_weights(b * M + kid[b, d, i], np.minimum(i, O - 1), ol,
                                     B * M).reshape(B, M, P)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (want == 0).any() and (want < 0).any()


@pytest.mark.parametrize("CL,SL", [(48, 64), (63, 64), (64, 80), (72, 64), (130, 140)])
def test_myers_bit_equal_to_torch(CL, SL):
    cands, cls, segs, sls = distance_cases(CL, SL, seed=CL + SL + 1)
    want = edit_distance_myers(torch.as_tensor(cands), torch.as_tensor(cls),
                               torch.as_tensor(segs), torch.as_tensor(sls)).numpy()
    got = np_ladder.edit_distance_myers(cands, cls, segs, sls)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("CL,L", [(48, 64), (72, 80)])
def test_rescore_bit_equal_to_torch(CL, L):
    seqs, lens, nsegs, cand, clen, ok = rescore_inputs(CL + L, 9, 3, CL, 12, L)
    p = KernelParams(max_err=0.3, min_depth=3)
    want = rescore_pick_plain(*(torch.as_tensor(a) for a in
                                (seqs, lens, nsegs, cand, clen, ok)), p)
    got = np_ladder.rescore_pick(seqs, lens, nsegs, cand, clen, ok,
                                 dict(max_err=0.3, min_depth=3))
    _bits_equal(got, {k: v.numpy() for k, v in want.items()})
