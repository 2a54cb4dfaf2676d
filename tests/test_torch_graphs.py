"""The ladder with no host sync in a stage, and its CUDA graphs.

On the CPU, against the JAX package: the sync-free ``prep_batch`` (every
position adds to a slot of its own window, a miss adds 0) equals JAX's
``_prep_one``, and the fixed-capacity ``ladder_core`` (compaction into a
fixed ``[E]`` index, fill slots with no segments, stale writes to a trash
row) packs bit-equal to ``_ladder_packed_jit`` at ``esc_cap = E`` for
widths below, at and above the failure count, and for a batch with no
failure, with and without the overflow rescue. The packed result is also
the one the ladder gave before the change (compaction to the exact count
with ``torch.nonzero``), transcribed below.

On the card (``cuda``-marked, skipped here): the graph replay is bit-equal
to the eager ladder, and the kernels' launch counts after replays are the
eager run's. That case imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_graphs.py -m cuda -q --noconftest
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from daccord_tpu_torch.kernels import graphs, window_kernel
from daccord_tpu_torch.kernels.tensorize import BatchShape, WindowBatch, tensorize_windows
from daccord_tpu_torch.kernels.tiers import (TierLadder, ladder_core, pack_result,
                                             unpack_result)
from daccord_tpu_torch.kernels.window_kernel import KernelParams, solve_batch_core
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
    """Every window of the longest read of a small simulated genome (numpy,
    from a seed), plus four empty rows (nsegs 0)."""
    cfg = SimConfig(genome_len=2500, coverage=16, read_len_mean=700, seed=21)
    res = simulate(cfg)
    aread = max(range(len(res.reads)), key=lambda i: len(res.reads[i].seq))
    a = res.reads[aread].seq
    refined = [refine_overlap(o, a, res.reads[o.bread].seq, cfg.tspace)
               for o in res.overlaps if o.aread == aread]
    b = tensorize_windows([(aread, ws) for ws in cut_windows(a, refined, w=40, adv=10)],
                          BatchShape(depth=32, seg_len=64, wlen=40))
    pad = lambda x, fill: np.concatenate([x, np.full((4,) + x.shape[1:], fill, x.dtype)])
    return pad(b.seqs, 4), pad(b.lens, 0), pad(b.nsegs, 0)


def _jax():
    import jax
    import jax.numpy as jnp

    from daccord_tpu.kernels import tiers as jax_tiers
    from daccord_tpu.kernels import window_kernel as jax_wk
    from daccord_tpu.oracle.consensus import ConsensusConfig
    from daccord_tpu.oracle.profile import ErrorProfile

    return jax, jnp, jax_tiers, jax_wk, ConsensusConfig, ErrorProfile


def _ladders(overflow_rescue: bool):
    """The JAX ladder (a small tier-0 active set, so the top-M cap binds and
    the rescues run) and the port's from its tables and parameters."""
    _, _, jax_tiers, _, ConsensusConfig, ErrorProfile = _jax()
    jl = jax_tiers.TierLadder.from_config(ErrorProfile(0.08, 0.04, 0.015),
                                          ConsensusConfig(), max_kmers=40,
                                          rescue_max_kmers=64,
                                          overflow_rescue=overflow_rescue)
    tl = TierLadder.from_numpy(
        {k: np.asarray(t) for k, t in jl.tables.items()},
        [dataclasses.asdict(p) for p in jl.params],
        wide_p0=None if jl.wide_p0 is None else dataclasses.asdict(jl.wide_p0),
        device="cpu")
    return jl, tl


def _inject_jax_weights(monkeypatch, jl, seqs, lens, nsegs):
    """The port's prep_batch returns the JAX W/score0 of each row (keyed by
    the row's bytes, so compacted and filled sub-batches find theirs): W is
    an f32 reduction whose order differs between XLA and torch."""
    jax, jnp, _, jax_wk, _, _ = _jax()
    by_params = {}
    for p in list(jl.params) + ([jl.wide_p0] if jl.wide_p0 is not None else []):
        prep = jax.jit(jax.vmap(functools.partial(jax_wk._prep_one, p=p),
                                in_axes=(0, 0, 0, None)))
        g = prep(jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(nsegs),
                 jl.tables[p.k])
        W, s0 = np.asarray(g["W"]), np.asarray(g["score0"])
        by_params[(p.k, p.max_kmers, p.min_count)] = {
            seqs[i].tobytes() + lens[i].tobytes(): (W[i], s0[i]) for i in range(len(nsegs))}
    real_prep = window_kernel.prep_batch

    def prep(s, ln, ns, ol, p):
        g = real_prep(s, ln, ns, ol, p)
        table = by_params[(p.k, p.max_kmers, p.min_count)]
        rows = [table[s[i].numpy().tobytes() + ln[i].numpy().tobytes()]
                for i in range(s.shape[0])]
        g["W"] = torch.as_tensor(np.stack([r[0] for r in rows]))
        g["score0"] = torch.as_tensor(np.stack([r[1] for r in rows]))
        return g

    monkeypatch.setattr(window_kernel, "prep_batch", prep)


def _windows(seed: int, B: int, D: int, L: int):
    """Noisy copies of random sequences, ragged depths; a third of the rows
    mix three sequences (k-mers past a small active set), row 0 is empty and
    row 1 holds one segment of a period-4 repeat (one k-mer, every position
    a hit)."""
    rng = np.random.default_rng(seed)
    seqs = np.full((B, D, L), 4, np.int8)
    lens = np.zeros((B, D), np.int32)
    for b in range(2, B):
        trues = [rng.integers(0, 4, 48) for _ in range(3 if b % 3 == 0 else 1)]
        for d in range(int(rng.integers(2, D + 1))):
            s = trues[d % len(trues)].copy()
            s[rng.integers(0, 48, 3)] = rng.integers(0, 4, 3)
            n = int(rng.integers(34, 49))
            seqs[b, d, :n] = s[:n]
            lens[b, d] = n
    seqs[1, 0, :40] = np.resize(np.arange(4), 40)
    lens[1, 0] = 40
    return seqs, lens, (lens > 0).sum(1).astype(np.int32)


@pytest.mark.parametrize("k,M,min_count", [(8, 16, 2), (10, 64, 2), (12, 256, 1)])
def test_sync_free_prep_batch_matches_jax(k, M, min_count):
    """Small M wraps a miss's spread slot (position mod M) many times; M=256
    is larger than a window's positions. Every integer field is exact; W and
    score0 are within the reduction order's rounding."""
    jax, jnp, _, jax_wk, _, ErrorProfile = _jax()
    from daccord_tpu.oracle.profile import OffsetLikely

    seqs, lens, nsegs = _windows(5, 20, 12, 56)
    fields = dict(k=k, min_count=min_count, edge_min_count=min_count, max_kmers=M,
                  wlen=40)
    jp = jax_wk.KernelParams(**fields)
    ol = OffsetLikely(ErrorProfile(0.08, 0.04, 0.015), positions=jp.positions,
                      max_offset=50).table
    ref = jax.jit(jax.vmap(functools.partial(jax_wk._prep_one, p=jp),
                           in_axes=(0, 0, 0, None)))(
        jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(nsegs), jnp.asarray(ol))
    got = window_kernel.prep_batch(torch.as_tensor(seqs), torch.as_tensor(lens),
                                   torch.as_tensor(nsegs), torch.as_tensor(ol),
                                   KernelParams(**fields))
    for key in ("sel", "adjW", "snk_ok", "m_overflow"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    for key in ("W", "score0"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-5,
                                   atol=1e-30, err_msg=key)
    # the anchors reach score0: a kept k-mer with a source-admissible
    # position has a finite start score on both sides
    assert (np.asarray(ref["score0"]) > -1e29).any()


def test_widths_and_pick_width():
    assert graphs.widths(2048) == (128, 512, 2048)
    assert graphs.widths(256) == (128, 256) and graphs.widths(64) == (64,)
    assert [graphs.pick_width(n, 2048) for n in (1, 128, 129, 512, 513, 2048)] == \
        [128, 128, 512, 512, 2048, 2048]
    assert graphs.pick_width(5000, 2048) == 2048


def _fail_count(tl, seqs, lens, nsegs) -> int:
    """Tier-0 failures at depth, with the port's own weights."""
    p0 = tl.params[0]
    out0 = solve_batch_core(torch.as_tensor(seqs), torch.as_tensor(lens),
                            torch.as_tensor(nsegs), tl.tables[p0.k], p0)
    return int((~out0["solved"] & (torch.as_tensor(nsegs) >= p0.min_depth)).sum())


@pytest.mark.parametrize("overflow_rescue,width", [(False, "below"), (False, "above"),
                                                   (True, "below"), (True, "batch"),
                                                   (False, "none")])
def test_fixed_capacity_ladder_matches_jax_at_width(monkeypatch, overflow_rescue, width):
    """``below``: E under the failure count (the overflow count rides row 0,
    the first E failures solve); ``above``: E over it (fill slots, which
    must write nothing); ``batch``: E = B; ``none``: a batch whose rows all
    solve at tier 0 (the escalation has nothing to do)."""
    jax, jnp, jax_tiers, _, _, _ = _jax()
    seqs, lens, nsegs = _batch()
    jl, tl = _ladders(overflow_rescue)
    if width == "none":
        # every row replaced by a row tier 0 solves (B stays, so the JAX
        # program at this shape and width is the one already compiled)
        p0 = tl.params[0]
        out0 = solve_batch_core(torch.as_tensor(seqs), torch.as_tensor(lens),
                                torch.as_tensor(nsegs), tl.tables[p0.k], p0)
        ok = np.nonzero(out0["solved"].numpy())[0]
        pick = np.resize(ok, len(nsegs))
        seqs, lens, nsegs = seqs[pick], lens[pick], nsegs[pick]
    B = len(nsegs)
    n_fail = _fail_count(tl, seqs, lens, nsegs)
    E = {"below": max(n_fail // 2, 1), "above": n_fail + 7, "batch": B,
         "none": 24}[width]
    ref = np.asarray(jax_tiers._ladder_packed_jit(
        jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(nsegs),
        tuple(jl.tables[p.k] for p in jl.params), tuple(jl.params), E, False, False,
        jl.wide_p0))
    _inject_jax_weights(monkeypatch, jl, seqs, lens, nsegs)
    out = ladder_core(torch.as_tensor(seqs), torch.as_tensor(lens), torch.as_tensor(nsegs),
                      tuple(tl.tables[p.k] for p in tl.params), tuple(tl.params),
                      tl.wide_p0, esc_cap=E)
    got = pack_result(out).numpy()
    np.testing.assert_array_equal(got, ref)
    res = unpack_result(got, tl.params[0].cons_len)
    if width == "below" and overflow_rescue:
        # the wide rescue solves some tier-0 failures before the escalation
        assert 0 < res["esc_overflow"] <= n_fail - E
    elif width == "below":
        assert res["esc_overflow"] == n_fail - E > 0
    else:
        assert res["esc_overflow"] == 0
    if width == "none":
        assert n_fail == 0 and (res["tier"] == 0).all()
    else:
        assert n_fail > 0 and (res["tier"] >= 1).any()


def _ladder_before(seqs, lens, nsegs, tables, params, wide_p0=None) -> dict:
    """The ladder as it was before the fixed-capacity form: failures
    compacted to their exact count with ``torch.nonzero``, each escalation
    tier over the windows still unsolved."""
    p0 = params[0]
    out0 = solve_batch_core(seqs, lens, nsegs, tables[0], p0)
    solved, cons = out0["solved"], out0["cons"]
    cons_len, err = out0["cons_len"], out0["err"]
    tier = torch.where(solved, 0, -1).to(torch.int32)
    m_ovf = out0["m_overflow"]
    if wide_p0 is not None:
        idx = torch.nonzero(m_ovf & (nsegs >= p0.min_depth)).flatten()
        if idx.numel():
            out_w = solve_batch_core(seqs[idx], lens[idx], nsegs[idx], tables[0], wide_p0)
            take = out_w["solved"]
            it = idx[take]
            cons[it], cons_len[it] = out_w["cons"][take], out_w["cons_len"][take]
            err[it], solved[it], tier[it] = out_w["err"][take], True, 0
            m_ovf[idx[take & ~out_w["m_overflow"]]] = False
    idx = torch.nonzero(~solved & (nsegs >= p0.min_depth)).flatten()
    e_movf = torch.zeros(idx.numel(), dtype=torch.bool)
    live = torch.arange(idx.numel())
    for ti in range(1, len(params)):
        if live.numel() == 0:
            break
        rows = idx[live]
        out_t = solve_batch_core(seqs[rows], lens[rows], nsegs[rows], tables[ti], params[ti])
        e_movf[live] |= out_t["m_overflow"]
        take = out_t["solved"]
        rt = rows[take]
        cons[rt], cons_len[rt] = out_t["cons"][take], out_t["cons_len"][take]
        err[rt], solved[rt], tier[rt] = out_t["err"][take], True, ti
        live = live[~take]
    m_ovf[idx] = m_ovf[idx] | e_movf
    return dict(cons=cons, cons_len=cons_len, err=err, solved=solved, tier=tier,
                m_ovf=m_ovf, esc_overflow=0)


@pytest.mark.parametrize("overflow_rescue", [False, True])
def test_fixed_capacity_ladder_packs_what_the_compacting_ladder_did(overflow_rescue):
    _, tl = _ladders(overflow_rescue)
    seqs, lens, nsegs = (torch.as_tensor(a) for a in _batch())
    tables = tuple(tl.tables[p.k] for p in tl.params)
    want = pack_result(_ladder_before(seqs, lens, nsegs, tables, tuple(tl.params),
                                      tl.wide_p0))
    got = pack_result(ladder_core(seqs, lens, nsegs, tables, tuple(tl.params),
                                  tl.wide_p0))
    assert torch.equal(got, want)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the port's kernels have no "
                    "CPU form")
    return torch.device("cuda")


def _host_batch(seqs, lens, nsegs) -> WindowBatch:
    B = len(nsegs)
    return WindowBatch(seqs=seqs, lens=lens, nsegs=nsegs,
                       shape=BatchShape(depth=seqs.shape[1], seg_len=seqs.shape[2]),
                       read_ids=np.zeros(B, np.int64), wstarts=np.zeros(B, np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("overflow_rescue", [False, True])
def test_graph_replay_equals_the_eager_ladder_and_counts_its_launches(cuda,
                                                                     overflow_rescue):
    """Three calls of one batch through the graphs (the first captures, two
    replay) against the same calls eagerly: the packed results are bit-equal
    and every kernel's launch counts (by shape, and windows by shape) are
    the eager run's."""
    from daccord_tpu_torch.kernels.tiers import _ladder_packed
    from daccord_tpu_torch.oracle import ConsensusConfig, ErrorProfile

    seqs, lens, nsegs = _batch()
    batch = _host_batch(seqs, lens, nsegs)
    prof = ErrorProfile(0.08, 0.04, 0.015)
    lad = {g: TierLadder.from_config(prof, ConsensusConfig(), max_kmers=40,
                                     rescue_max_kmers=64, overflow_rescue=overflow_rescue,
                                     device=cuda, graphs=g) for g in (True, False)}
    cache = graphs.GraphCache()
    runs = {}
    for g in (False, True):
        for m in graphs._counter_modules():
            m.launches = 0
            m.launches_by_shape.clear()
            getattr(m, "windows_by_shape", {}).clear()
        if g:
            packed = [cache.run(batch, lad[g]) for _ in range(3)]
        else:
            packed = [_ladder_packed(batch, lad[g]) for _ in range(3)]
        torch.cuda.synchronize()
        runs[g] = (packed, graphs.launch_counts())
    for a, b in zip(*(runs[g][0] for g in (False, True))):
        assert torch.equal(a, b)
    assert cache.captures >= 2 and cache.replays == 2 * cache.captures
    want, got = runs[False][1], runs[True][1]
    for m in want:
        assert got[m] == want[m], m.__name__
    assert want[graphs._counter_modules()[0]][0] > 0
