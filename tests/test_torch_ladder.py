"""The port's escalation ladder against the JAX ``_ladder_packed_jit``.

Both ladders solve the same windows with the same OffsetLikely tables
(``TierLadder.from_numpy``). The only stage whose bits differ between the
frameworks is ``W = occ @ OL.T`` (an f32 reduction in another order), so the
JAX ``W``/``score0`` are injected into the port's ``prep_batch``; from
identical inputs on, the packed results must be bit-equal.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daccord_tpu.kernels.tiers import TierLadder as JaxTierLadder
from daccord_tpu.kernels.tiers import _ladder_packed_jit
from daccord_tpu.kernels.tiers import pack_result as jax_pack_result
from daccord_tpu.kernels.window_kernel import _prep_one
from daccord_tpu.oracle.consensus import ConsensusConfig as JaxConsensusConfig
from daccord_tpu.oracle.profile import ErrorProfile as JaxErrorProfile
from daccord_tpu_torch.kernels import window_kernel
from daccord_tpu_torch.kernels.tensorize import BatchShape, tensorize_windows
from daccord_tpu_torch.kernels.tiers import (TierLadder, ladder_core,
                                             pack_result, unpack_result)
from daccord_tpu_torch.oracle import cut_windows, refine_overlap
from daccord_tpu_torch.sim import SimConfig, simulate


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The tier-1 run puts several test files side by side on the CPU; a
    torch thread pool the size of the machine in each oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _batch():
    """Every window of the longest read of a small simulated genome, plus
    four empty rows (nsegs 0)."""
    cfg = SimConfig(genome_len=2500, coverage=16, read_len_mean=700, seed=21)
    res = simulate(cfg)
    aread = max(range(len(res.reads)), key=lambda i: len(res.reads[i].seq))
    a = res.reads[aread].seq
    refined = [refine_overlap(o, a, res.reads[o.bread].seq, cfg.tspace)
               for o in res.overlaps if o.aread == aread]
    windows = cut_windows(a, refined, w=40, adv=10)
    b = tensorize_windows([(aread, ws) for ws in windows],
                          BatchShape(depth=32, seg_len=64, wlen=40))
    pad = lambda x, fill: np.concatenate([x, np.full((4,) + x.shape[1:], fill, x.dtype)])
    return pad(b.seqs, 4), pad(b.lens, 0), pad(b.nsegs, 0)


def _row_key(seqs, lens, i):
    return seqs[i].tobytes() + lens[i].tobytes()


def _inject_jax_weights(monkeypatch, jl, seqs, lens, nsegs):
    """Make the port's prep_batch return the JAX W/score0 of each row (keyed
    by the row's contents, so compacted sub-batches find their rows)."""
    by_params = {}
    for p in list(jl.params) + ([jl.wide_p0] if jl.wide_p0 is not None else []):
        prep = jax.jit(jax.vmap(functools.partial(_prep_one, p=p),
                                in_axes=(0, 0, 0, None)))
        g = prep(jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(nsegs),
                 jl.tables[p.k])
        W, s0 = np.asarray(g["W"]), np.asarray(g["score0"])
        by_params[(p.k, p.max_kmers, p.min_count, p.edge_min_count)] = {
            _row_key(seqs, lens, i): (W[i], s0[i]) for i in range(len(nsegs))}
    real_prep = window_kernel.prep_batch

    def prep(s, ln, ns, ol, p):
        g = real_prep(s, ln, ns, ol, p)
        table = by_params[(p.k, p.max_kmers, p.min_count, p.edge_min_count)]
        s_np, l_np = s.numpy(), ln.numpy()
        rows = [table[_row_key(s_np, l_np, i)] for i in range(s_np.shape[0])]
        g["W"] = torch.as_tensor(np.stack([r[0] for r in rows]))
        g["score0"] = torch.as_tensor(np.stack([r[1] for r in rows]))
        return g

    monkeypatch.setattr(window_kernel, "prep_batch", prep)


@pytest.mark.parametrize("overflow_rescue", [False, True])
def test_ladder_packed_bit_equal_to_jax(monkeypatch, overflow_rescue):
    seqs, lens, nsegs = _batch()
    B = len(nsegs)
    # a small tier-0 active set binds the top-M cap on many windows, so the
    # wide rescue and the escalation tiers all run
    jl = JaxTierLadder.from_config(JaxErrorProfile(0.08, 0.04, 0.015),
                                   JaxConsensusConfig(), max_kmers=40,
                                   rescue_max_kmers=64,
                                   overflow_rescue=overflow_rescue)
    ref = np.asarray(_ladder_packed_jit(
        jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(nsegs),
        tuple(jl.tables[p.k] for p in jl.params), tuple(jl.params), B, False,
        False, jl.wide_p0))

    tl = TierLadder.from_numpy(
        {k: np.asarray(t) for k, t in jl.tables.items()},
        [dataclasses.asdict(p) for p in jl.params],
        wide_p0=None if jl.wide_p0 is None else dataclasses.asdict(jl.wide_p0),
        device="cpu")
    _inject_jax_weights(monkeypatch, jl, seqs, lens, nsegs)
    out = ladder_core(torch.as_tensor(seqs), torch.as_tensor(lens),
                      torch.as_tensor(nsegs),
                      tuple(tl.tables[p.k] for p in tl.params),
                      tuple(tl.params), tl.wide_p0)
    got = pack_result(out).numpy()
    np.testing.assert_array_equal(got, ref)

    res = unpack_result(got, tl.params[0].cons_len)
    tiers = set(res["tier"].tolist())
    assert 0 in tiers and any(t >= 1 for t in tiers), tiers
    assert not res["solved"][-4:].any(), "empty rows never solve"


def test_pack_result_matches_jax():
    rng = np.random.default_rng(3)
    B, CL = 7, 50
    out = dict(cons=rng.integers(0, 5, (B, CL)).astype(np.int8),
               cons_len=rng.integers(0, CL + 1, B).astype(np.int32),
               err=rng.random(B).astype(np.float32),
               tier=np.asarray([0, 1, 2, 3, -1, 0, 30], np.int32),
               m_ovf=np.asarray([1, 0, 1, 0, 1, 0, 1], bool))
    out["err"][2] = np.inf
    ref = np.asarray(jax_pack_result(
        {**{k: jnp.asarray(v) for k, v in out.items()},
         "esc_overflow": jnp.int32(12345)}))
    got = pack_result({**{k: torch.as_tensor(v) for k, v in out.items()},
                       "esc_overflow": 12345}).numpy()
    np.testing.assert_array_equal(got, ref)
    back = unpack_result(got, CL)
    np.testing.assert_array_equal(back["cons"], out["cons"])
    np.testing.assert_array_equal(back["tier"], out["tier"])
    assert back["esc_overflow"] == 12345


def test_ladder_from_config_needs_cuda_unless_cpu():
    from daccord_tpu_torch.oracle import ConsensusConfig, ErrorProfile

    prof = ErrorProfile(0.08, 0.04, 0.015)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TierLadder.from_config(prof, ConsensusConfig())
    lad = TierLadder.from_config(prof, ConsensusConfig(), device="cpu")
    assert [p.max_kmers for p in lad.params] == [64, 64, 64, 256]
    assert lad.device.type == "cpu"


@pytest.mark.parametrize("overflow_rescue", [False, True])
def test_ladder_from_config_matches_jax(overflow_rescue):
    """The port's own copy of the OffsetLikely tables and tier parameters is
    the JAX package's, bit for bit."""
    from daccord_tpu_torch.oracle import ConsensusConfig, ErrorProfile

    fields = dict(p_ins=0.071, p_del=0.043, p_sub=0.012, hp_slope=0.3,
                  hp_base=0.02)
    jl = JaxTierLadder.from_config(JaxErrorProfile(**fields),
                                   JaxConsensusConfig(),
                                   overflow_rescue=overflow_rescue)
    tl = TierLadder.from_config(ErrorProfile(**fields), ConsensusConfig(),
                                overflow_rescue=overflow_rescue, device="cpu")
    assert sorted(tl.tables) == sorted(jl.tables)
    for k, t in jl.tables.items():
        np.testing.assert_array_equal(tl.tables[k].numpy(), np.asarray(t))
    assert [dataclasses.asdict(p) for p in tl.params] == \
        [dataclasses.asdict(p) for p in jl.params]
    assert (tl.wide_p0 is None) == (jl.wide_p0 is None)
    if jl.wide_p0 is not None:
        assert dataclasses.asdict(tl.wide_p0) == dataclasses.asdict(jl.wide_p0)
