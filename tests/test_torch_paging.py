"""The port's paged batching (``kernels/paging.py``, ``gather_pages``, the
paged ladder and the family router) against the JAX package, on the CPU.

The host side is numpy in both packages and must agree exactly; the device
gather must rebuild the dense tile bit for bit, as the JAX gather does with
its Pallas kernel in interpret mode; and a paged run must write the same
FASTA as a dense one.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from daccord_tpu.kernels import paging as jax_paging
from daccord_tpu.kernels.pallas_window import gather_pages as jax_gather_pages
from daccord_tpu.kernels.tensorize import BatchShape as JaxBatchShape
from daccord_tpu.kernels.tensorize import WindowBatch as JaxWindowBatch
from daccord_tpu_torch.kernels import gather_pages, paging
from daccord_tpu_torch.kernels.tensorize import (BatchShape, WindowBatch,
                                                 pad_batch, slice_batch)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The tier-1 run puts several test files side by side on the CPU; a
    torch thread pool the size of the machine in each oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def ragged(seed: int, B: int = 23, D: int = 8, L: int = 64, max_seg: int = 70,
           max_nseg: int = 10):
    """Dense arrays of random ragged windows: empty windows, zero-length
    segments and depth-capped windows all appear."""
    rng = np.random.default_rng(seed)
    seqs = np.full((B, D, L), 4, np.int8)
    lens = np.zeros((B, D), np.int32)
    nsegs = np.zeros(B, np.int32)
    for b in range(B):
        n = min(int(rng.integers(0, max_nseg)), D)
        nsegs[b] = n
        for d in range(n):
            ln = min(int(rng.integers(0, max_seg)), L)
            seqs[b, d, :ln] = rng.integers(0, 4, ln)
            lens[b, d] = ln
    return seqs, lens, nsegs


def both_batches(seqs, lens, nsegs):
    B, D, L = seqs.shape
    ids = np.arange(B, dtype=np.int64)
    port = WindowBatch(seqs=seqs, lens=lens, nsegs=nsegs,
                       shape=BatchShape(depth=D, seg_len=L, wlen=40),
                       read_ids=ids, wstarts=ids * 10)
    jax = JaxWindowBatch(seqs=seqs, lens=lens, nsegs=nsegs,
                         shape=JaxBatchShape(depth=D, seg_len=L, wlen=40),
                         read_ids=ids, wstarts=ids * 10)
    return port, jax


def covering(lens, D, page_len=16, pool_pages=0):
    top = max(int(paging.window_pages(lens, page_len).max(initial=1)), 1)
    return dict(depth=D, pages=1 << (top - 1).bit_length(), page_len=page_len,
                pool_pages=pool_pages)


@pytest.mark.parametrize("seed,D,L,page_len,target", [
    (0, 8, 64, 16, None), (1, 32, 64, 16, 40), (2, 4, 32, 8, None),
    (3, 8, 64, 32, 30), (4, 16, 64, 4, None)])
def test_pack_paged_matches_jax(seed, D, L, page_len, target):
    seqs, lens, nsegs = ragged(seed, D=D, L=L)
    port_b, jax_b = both_batches(seqs, lens, nsegs)
    fam = covering(lens, D, page_len)
    pb = paging.pack_paged(port_b, paging.ShapeFamily(**fam), target_rows=target)
    jb = jax_paging.pack_paged(jax_b, jax_paging.ShapeFamily(**fam),
                               target_rows=target)
    n_used = int(paging.window_pages(lens, page_len).sum())
    for name in ("table", "lens", "nsegs", "read_ids", "wstarts"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(jb, name), name)
    assert pb.pool.shape == jb.pool.shape
    # rows past 1 + n_used are np.empty by design
    np.testing.assert_array_equal(pb.pool[:1 + n_used], jb.pool[:1 + n_used])
    assert pb.pad_waste() == jb.pad_waste() and pb.shipped_cells == jb.shipped_cells
    assert port_b.pad_waste() == pytest.approx(1 - lens.sum() / seqs.size)


@pytest.mark.parametrize("seed,D,L,page_len", [(0, 8, 64, 16), (1, 32, 64, 16),
                                               (2, 4, 32, 8), (3, 8, 64, 64)])
def test_roundtrip_pack_unpack_is_dense(seed, D, L, page_len):
    seqs, lens, nsegs = ragged(seed, D=D, L=L)
    dense, _ = both_batches(seqs, lens, nsegs)
    pb = paging.pack_paged(dense, paging.ShapeFamily(**covering(lens, D, page_len)),
                           target_rows=len(nsegs) + 5)
    rt = paging.unpack_paged(pb)
    B = len(nsegs)
    np.testing.assert_array_equal(rt.seqs[:B], seqs)
    np.testing.assert_array_equal(rt.lens[:B], lens)
    assert (rt.seqs[B:] == 4).all() and (rt.read_ids[B:] == -1).all()
    # slice and pad work on table rows; the pool is shared
    sl = slice_batch(pb, 3, 9)
    assert sl.pool is pb.pool and sl.size == 6
    np.testing.assert_array_equal(sl.to_dense().seqs, seqs[3:9])
    padded = pad_batch(sl, 12)
    assert padded.size == 12 and (padded.table[6:] == 0).all()
    np.testing.assert_array_equal(padded.to_dense().seqs[:6], seqs[3:9])


def test_pack_invariant_violations_raise():
    seqs, lens, nsegs = ragged(1)
    dense, _ = both_batches(seqs, lens, nsegs)
    pg = paging.window_pages(lens)
    with pytest.raises(ValueError, match="page budget"):
        paging.pack_paged(dense, paging.ShapeFamily(depth=8, pages=int(pg.max()) - 1))
    with pytest.raises(ValueError, match="depth"):
        paging.pack_paged(dense, paging.ShapeFamily(depth=4, pages=1024))
    with pytest.raises(ValueError, match="divide"):
        paging.pack_paged(dense, paging.ShapeFamily(depth=8, pages=1024, page_len=24))
    with pytest.raises(ValueError, match="pool budget"):
        paging.pack_paged(dense, paging.ShapeFamily(**covering(lens, 8, pool_pages=1)))


def _families_equal(port, jax):
    assert [dataclasses.astuple(f) for f in port] == \
        [dataclasses.astuple(f) for f in jax]


@pytest.mark.parametrize("seed,budget,max_depth,max_pages", [
    (3, 4, 32, 128), (4, 2, 32, 128), (5, 6, 24, 96), (6, 1, 32, 128),
    (7, 4, 32, 128)])
def test_derive_families_matches_jax(seed, budget, max_depth, max_pages):
    rng = np.random.default_rng(seed)
    n = 0 if seed == 7 else 300
    nsegs = np.concatenate([rng.integers(1, 8, n // 2),
                            rng.integers(3, max_depth + 1, n - n // 2)])
    pages = np.concatenate([rng.integers(1, 12, n // 2),
                            rng.integers(8, max_pages + 1, n - n // 2)])
    kw = dict(max_depth=max_depth, max_pages=max_pages, budget=budget)
    fams = paging.derive_families(nsegs, pages, **kw)
    jfams = jax_paging.derive_families(nsegs, pages, **kw)
    _families_equal(fams, jfams)
    np.testing.assert_array_equal(paging.assign_family(fams, nsegs, pages),
                                  jax_paging.assign_family(jfams, nsegs, pages))
    with pytest.raises(ValueError, match="fits no family"):
        paging.assign_family(fams, np.array([max_depth + 1]), np.array([1]))


@functools.lru_cache(maxsize=None)
def _slice_dataset(root: str):
    from daccord_tpu_torch.sim import SimConfig, make_dataset

    return make_dataset(root, SimConfig(genome_len=3000, coverage=12,
                                        read_len_mean=1500, seed=3))


def test_families_from_sample_match_jax(tmp_path_factory):
    """On a simulated dataset, the port's shared pile sample and the shape
    families derived from it are the JAX package's."""
    from daccord_tpu.formats.dazzdb import read_db as jax_read_db
    from daccord_tpu.formats.las import LasFile as JaxLasFile
    from daccord_tpu.runtime import pipeline as jax_pipe
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.runtime import pipeline as pipe

    d = _slice_dataset(str(tmp_path_factory.mktemp("fam")))
    cfg = pipe.PipelineConfig(device="cpu", paged="on")
    jcfg = jax_pipe.PipelineConfig(paged="on")
    _, win = pipe._sample_windows(read_db(d["db"]), LasFile(d["las"]), cfg)
    _, jwin = jax_pipe._sample_windows(jax_read_db(d["db"]), JaxLasFile(d["las"]),
                                       jcfg, None, None)
    assert len(win) == len(jwin) > 0
    fams = pipe.families_from_windows(win, cfg)
    _families_equal(fams, jax_pipe.families_from_windows(jwin, jcfg))
    _families_equal(pipe.derive_families_for_shard(read_db(d["db"]),
                                                   LasFile(d["las"]), cfg), fams)


def test_gather_pages_plain_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    pool = rng.integers(-128, 128, (50, 16)).astype(np.int8)
    table = rng.integers(0, 50, (6, 9)).astype(np.int32)
    ref = np.asarray(jax_gather_pages(jnp.asarray(pool), jnp.asarray(table),
                                      interpret=True))
    before = gather_pages.launches
    got = gather_pages.gather_pages(torch.as_tensor(pool), torch.as_tensor(table))
    assert gather_pages.launches == before, "CPU tensors never launch the kernel"
    assert got.dtype == torch.int8 and got.shape == (6, 9, 16)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gather_pages_checks_its_inputs():
    pool = torch.zeros((10, 16), dtype=torch.int8)
    table = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        gather_pages.gather_pages(pool.to(torch.int32), table)
    with pytest.raises(TypeError):
        gather_pages.gather_pages(pool, table.long())
    with pytest.raises(ValueError):
        gather_pages.gather_pages(pool.view(-1), table)
    gather_pages.check_table(np.array([[0, 9]]), 10)
    for bad in ([[0, 10]], [[-1, 0]]):
        with pytest.raises(ValueError, match="outside the pool"):
            gather_pages.check_table(np.array(bad), 10)
    with pytest.raises(IndexError):
        gather_pages.gather_pages(pool, torch.tensor([[0, 10]], dtype=torch.int32))


@pytest.mark.parametrize("seed,D,page_len", [(7, 8, 16), (8, 32, 16), (9, 8, 8)])
def test_gather_windows_matches_jax_and_dense(seed, D, page_len):
    seqs, lens, nsegs = ragged(seed, B=16, D=D)
    port_b, jax_b = both_batches(seqs, lens, nsegs)
    fam = covering(lens, D, page_len)
    pb = paging.pack_paged(port_b, paging.ShapeFamily(**fam))
    jb = jax_paging.pack_paged(jax_b, jax_paging.ShapeFamily(**fam))
    ref = np.asarray(jax_paging.gather_windows(
        jnp.asarray(jb.pool), jnp.asarray(jb.table), jnp.asarray(jb.lens),
        page_len=page_len, seg_len=64, use_pallas=True, interpret=True))
    got = paging.gather_windows(torch.as_tensor(pb.pool), torch.as_tensor(pb.table),
                                torch.as_tensor(pb.lens), page_len=page_len,
                                seg_len=64)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(ref, seqs)
    np.testing.assert_array_equal(got.numpy(), seqs)


def _windows_batch():
    from daccord_tpu_torch.oracle import cut_windows, refine_overlap
    from daccord_tpu_torch.kernels.tensorize import tensorize_windows
    from daccord_tpu_torch.sim import SimConfig, simulate

    cfg = SimConfig(genome_len=2500, coverage=16, read_len_mean=700, seed=21)
    res = simulate(cfg)
    aread = max(range(len(res.reads)), key=lambda i: len(res.reads[i].seq))
    a = res.reads[aread].seq
    refined = [refine_overlap(o, a, res.reads[o.bread].seq, cfg.tspace)
               for o in res.overlaps if o.aread == aread]
    windows = cut_windows(a, refined, w=40, adv=10)[:32]
    return tensorize_windows([(aread, ws) for ws in windows],
                             BatchShape(depth=32, seg_len=64, wlen=40))


@pytest.mark.parametrize("route", ["fused", "scan"])
def test_ladder_core_paged_equals_dense(route):
    """The paged ladder (gather, then the unchanged ladder) packs the same
    result as the dense ladder on the dense tile, bit for bit."""
    from daccord_tpu_torch.kernels.tiers import (TierLadder, ladder_core,
                                                 ladder_core_paged, pack_result,
                                                 solve_ladder)
    from daccord_tpu_torch.oracle import ConsensusConfig, ErrorProfile

    dense = _windows_batch()
    lad = TierLadder.from_config(ErrorProfile(0.08, 0.04, 0.015), ConsensusConfig(),
                                 max_kmers=40, rescue_max_kmers=64,
                                 overflow_rescue=True, device="cpu", route=route)
    fam = paging.ShapeFamily(**covering(dense.lens, 32))
    pb = paging.pack_paged(dense, fam, target_rows=dense.size + 3)
    tables = tuple(lad.tables[p.k] for p in lad.params)
    t = lambda a: torch.as_tensor(a)
    paged = pack_result(ladder_core_paged(
        t(pb.pool), t(pb.table), t(pb.lens), t(pb.nsegs), tables, tuple(lad.params),
        page_len=16, seg_len=64, wide_p0=lad.wide_p0, route=route))
    full = pad_batch(dense, dense.size + 3)
    ref = pack_result(ladder_core(t(full.seqs), t(full.lens), t(full.nsegs), tables,
                                  tuple(lad.params), lad.wide_p0, route=route))
    assert torch.equal(paged, ref)
    out = solve_ladder(pb, lad)
    assert out["solved"][:dense.size].any() and not out["solved"][dense.size:].any()
    assert (out["tier"] >= 1).any() and out["m_ovf"].any(), "escalations ran"
    bad = dataclasses.replace(pb, table=pb.table + pb.pool.shape[0])
    with pytest.raises(ValueError, match="outside the pool"):
        solve_ladder(bad, lad)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's CPU runs on the dataset of ``test_torch_slice.py``, dense
    and paged: {mode: (fasta path, stats)}."""
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig, correct_to_fasta

    root = str(tmp_path_factory.mktemp("pagedrun"))
    d = _slice_dataset(root)
    runs = {}
    for mode in ("off", "on"):
        out = f"{root}/{mode}.fasta"
        runs[mode] = (out, correct_to_fasta(
            d["db"], d["las"], out,
            PipelineConfig(device="cpu", batch_size=512, paged=mode)))
    return d, runs


def test_paged_cpu_run_writes_dense_fasta(port_runs):
    """``paged="on"`` on the CPU writes the bytes ``paged="off"`` writes, and
    ships fewer dead cells and fewer bytes."""
    _, runs = port_runs
    with open(runs["off"][0], "rb") as a, open(runs["on"][0], "rb") as b:
        assert a.read() == b.read()
    off, on = runs["off"][1], runs["on"][1]
    assert on.paged and not off.paged
    assert on.n_solved == off.n_solved > 0
    assert on.pad_waste < off.pad_waste and on.h2d_bytes < off.h2d_bytes
    print(f"paged run: pad waste {off.pad_waste:.4f} -> {on.pad_waste:.4f}, "
          f"bytes to the ladder {off.h2d_bytes} -> {on.h2d_bytes}, batches "
          f"{off.n_batches} -> {on.n_batches}")


def test_paged_run_within_drift_of_jax_paged_run(port_runs, tmp_path):
    """The port's paged run against the JAX package's paged run, with the
    drift bounds of ``test_torch_slice.py``: the two differ only where the
    f32 ``W`` reduction order moves a DP tie."""
    from daccord_tpu.runtime.pipeline import PipelineConfig as JaxPipelineConfig
    from daccord_tpu.runtime.pipeline import correct_to_fasta as jax_correct_to_fasta
    from daccord_tpu_torch.formats.fasta import read_fasta

    d, runs = port_runs
    out, ps = runs["on"]
    jax_out = str(tmp_path / "jax_paged.fasta")
    js = jax_correct_to_fasta(d["db"], d["las"], jax_out,
                              JaxPipelineConfig(audit_rate=0, use_native=False,
                                                paged="on"))
    assert js.paged and ps.n_windows == js.n_windows
    jrec = {r.name: r.seq for r in read_fasta(jax_out)}
    prec = {r.name: r.seq for r in read_fasta(out)}
    same = sum(prec.get(n) == s for n, s in jrec.items())
    print(f"paged port vs paged JAX: solved {ps.n_solved} / {js.n_solved}, bases "
          f"{ps.bases_out} / {js.bases_out}, identical records {same}/{len(jrec)}")
    assert abs(ps.n_solved - js.n_solved) <= 0.005 * js.n_windows
    assert abs(ps.bases_out - js.bases_out) <= 0.005 * js.bases_out
    assert same >= 0.95 * len(jrec) and abs(len(prec) - len(jrec)) <= 0.05 * len(jrec)


def test_paged_option_validation():
    from daccord_tpu_torch.runtime.pipeline import PipelineConfig, paged_enabled
    from daccord_tpu_torch.tools import cli

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not paged_enabled(PipelineConfig(paged="auto"), cpu)
    assert paged_enabled(PipelineConfig(paged="auto"), cuda)
    assert paged_enabled(PipelineConfig(paged="on"), cpu)
    with pytest.raises(ValueError, match="expected on"):
        paged_enabled(PipelineConfig(paged="yes"), cpu)
    with pytest.raises(ValueError, match="divide"):
        paged_enabled(PipelineConfig(paged="on", page_len=24), cpu)
    with pytest.raises(SystemExit, match="divide"):
        cli.daccord_run(["x.db", "x.las", "--paged", "on", "--page-len", "24",
                         "--device", "cpu"])


@pytest.mark.parametrize("D,M", [(1, 64), (4, 256)])
def test_shallow_family_fails_in_both_packages(D, M):
    """A shape family too shallow for the active set (D * (L - k + 1) < M
    k-mer positions) raises in both packages; neither truncates silently."""
    import jax

    from daccord_tpu.kernels.window_kernel import KernelParams as JaxKernelParams
    from daccord_tpu.kernels.window_kernel import _prep_one
    from daccord_tpu_torch.kernels.window_kernel import KernelParams, prep_batch

    seqs = np.full((2, D, 64), 4, np.int8)
    lens = np.zeros((2, D), np.int32)
    nsegs = np.zeros(2, np.int32)
    p = KernelParams(k=8, max_kmers=M)
    ol = np.zeros((p.positions, 56), np.float32)
    with pytest.raises(ValueError, match="cannot fill"):
        prep_batch(*(torch.as_tensor(a) for a in (seqs, lens, nsegs, ol)), p)
    jp = JaxKernelParams(k=8, max_kmers=M)
    with pytest.raises(ValueError, match="top_k"):
        jax.vmap(functools.partial(_prep_one, p=jp), in_axes=(0, 0, 0, None))(
            seqs, lens, nsegs, ol)
