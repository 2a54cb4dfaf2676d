"""The port's batched window solver (torch) against the JAX package.

Graph construction (``prep_batch``) against ``vmap(_prep_one)`` for every
ladder k and both active-set sizes, and the int64 Myers rescore against the
JAX two-word form. Inputs are numpy from fixed seeds; both sides run on the
CPU.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daccord_tpu.kernels.window_kernel import KernelParams as JaxKernelParams
from daccord_tpu.kernels.window_kernel import _edit_distance_myers, _prep_one
from daccord_tpu.oracle.profile import ErrorProfile
from daccord_tpu.oracle.profile import OffsetLikely as JaxOffsetLikely
from daccord_tpu_torch.kernels.window_kernel import (
    KernelParams, edit_distance_myers, prep_batch)


def make_windows(seed: int, B: int, D: int, L: int, wlen: int = 40,
                 n_err: int = 3):
    """Windows of noisy copies of a random true sequence, with ragged
    depths and lengths; window 0 is empty, window 1 has one segment, and
    every third window mixes three sequences (a repeat-like pile whose k-mers
    overflow a small active set)."""
    rng = np.random.default_rng(seed)
    seqs = np.full((B, D, L), 4, dtype=np.int8)
    lens = np.zeros((B, D), dtype=np.int32)
    for b in range(2, B):
        trues = [rng.integers(0, 4, wlen + 8).astype(np.int8)
                 for _ in range(3 if b % 3 == 0 else 1)]
        depth = D if b % 3 == 0 else int(rng.integers(2, D + 1))
        for d in range(depth):
            s = list(trues[d % len(trues)])
            for _ in range(n_err):
                op, at = rng.integers(0, 3), int(rng.integers(0, len(s)))
                if op == 0:
                    s[at] = rng.integers(0, 4)
                elif op == 1:
                    s.insert(at, rng.integers(0, 4))
                else:
                    del s[at]
            s = np.asarray(s[: int(rng.integers(wlen - 6, min(L, wlen + 8) + 1))],
                           np.int8)
            seqs[b, d, : len(s)] = s
            lens[b, d] = len(s)
    seqs[1, 0, :wlen] = np.resize(np.array([0, 1, 2, 3], np.int8), wlen)
    lens[1, 0] = wlen
    nsegs = (lens > 0).sum(axis=1).astype(np.int32)
    return seqs, lens, nsegs


@functools.lru_cache(maxsize=None)
def _windows():
    return make_windows(seed=11, B=24, D=16, L=64, n_err=4)


@pytest.mark.parametrize("k,M,min_count", [(8, 64, 2), (10, 64, 2), (12, 64, 2),
                                           (8, 256, 1), (10, 256, 1),
                                           (12, 256, 1)])
def test_prep_batch_matches_jax(k, M, min_count):
    seqs, lens, nsegs = _windows()
    fields = dict(k=k, min_count=min_count, edge_min_count=min_count,
                  max_kmers=M, wlen=40)
    jp, tp = JaxKernelParams(**fields), KernelParams(**fields)
    ol = JaxOffsetLikely(ErrorProfile(0.08, 0.04, 0.015), positions=jp.positions,
                         max_offset=56).table
    prep = jax.jit(jax.vmap(functools.partial(_prep_one, p=jp),
                            in_axes=(0, 0, 0, None)))
    ref = {key: np.asarray(v) for key, v in prep(
        jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(nsegs),
        jnp.asarray(ol)).items()}
    got = {key: v.numpy() for key, v in prep_batch(
        torch.as_tensor(seqs), torch.as_tensor(lens), torch.as_tensor(nsegs),
        torch.as_tensor(ol), tp).items()}
    for key in ("sel", "adjW", "snk_ok", "m_overflow"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    # W = occ @ OL.T is an f32 reduction whose order differs between XLA and
    # torch; occ is exact (integer counts), so the products agree to rounding
    # (rtol). XLA's CPU backend also flushes subnormal products to zero and
    # torch keeps them, which moves weights below ~1e-36 (atol)
    for key in ("W", "score0"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-30,
                                   err_msg=key)
    assert ref["sel"].shape == (seqs.shape[0], M)
    assert (ref["sel"][0] == 4**k).all(), "the empty window keeps no k-mer"
    if M == 64:
        assert ref["m_overflow"].any(), "the top-M cap should bind somewhere"


def test_myers_matches_jax():
    """int64 one-word Myers == the JAX two-uint32-word Myers, including empty
    candidates/segments and lengths straddling 32 bits."""
    rng = np.random.default_rng(7)
    CN, SN = 48, 64
    cases = [(0, 17), (5, 0), (0, 0), (1, 1), (31, 40), (32, 40), (33, 64),
             (48, 64), (48, 0)]
    cases += [(int(rng.integers(0, CN + 1)), int(rng.integers(0, SN + 1)))
              for _ in range(60)]
    cands = np.full((len(cases), CN), 4, np.int8)
    segs = np.full((len(cases), SN), 4, np.int8)
    cls = np.zeros(len(cases), np.int32)
    sls = np.zeros(len(cases), np.int32)
    for i, (cl, sl) in enumerate(cases):
        cands[i, :cl] = rng.integers(0, 4, cl)
        # half the segments are noisy copies of the candidate
        if i % 2 and sl:
            src = np.resize(cands[i, :max(cl, 1)], sl)
            flip = rng.random(sl) < 0.15
            segs[i, :sl] = np.where(flip, rng.integers(0, 4, sl), src)
        else:
            segs[i, :sl] = rng.integers(0, 4, sl)
        cls[i], sls[i] = cl, sl
    ref = np.asarray(jax.jit(jax.vmap(_edit_distance_myers))(
        jnp.asarray(cands), jnp.asarray(cls), jnp.asarray(segs),
        jnp.asarray(sls)))
    got = edit_distance_myers(torch.as_tensor(cands), torch.as_tensor(cls),
                              torch.as_tensor(segs), torch.as_tensor(sls))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_port_imports_no_jax():
    """The port and every one of its modules (the telemetry readers,
    ``utils/obs``, the serve plane, ``utils/lease``, the fleet, the router,
    netio, the autoscaler and the kernel cache among them) import without
    jax or daccord_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import daccord_tpu_torch\n"
        "for m in pkgutil.walk_packages(daccord_tpu_torch.__path__, 'daccord_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'daccord_tpu_torch.parallel.launch' in sys.modules\n"
        "assert 'daccord_tpu_torch.tools.lastools' in sys.modules\n"
        "for m in ('utils.obs', 'tools.trace', 'tools.prof', 'tools.top', 'tools.sentinel',\n"
        "          'serve', 'serve.service', 'serve.batcher', 'serve.http', 'utils.lease',\n"
        "          'parallel.fleet', 'serve.netio', 'serve.router', 'serve.autoscale',\n"
        "          'serve.aotcache'):\n"
        "    assert 'daccord_tpu_torch.' + m in sys.modules, m\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'daccord_tpu' or m.startswith('daccord_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
