"""The port's host library (``daccord_tpu_torch/native``) and the feeders on it,
against the JAX package's library and feeder on the same inputs, on the CPU.

Entry point by entry point, the port's copy of the library returns what the
JAX package's returns, and each numpy form (``oracle/align.py *_plain``)
equals its native form. The native feeder writes the bytes of the numpy
feeder, threaded or not, and ``daccord`` writes one FASTA on every feeder
route. With a JAX-written ``inqual`` track, the port's QV depth ranking
orders piles as JAX's does.
"""

import functools
import json

import numpy as np
import pytest
import torch

from daccord_tpu.formats.dazzdb import read_db as jax_read_db
from daccord_tpu.formats.las import LasFile as JaxLasFile
from daccord_tpu_torch import native
from daccord_tpu_torch.formats.dazzdb import read_db
from daccord_tpu_torch.formats.fasta import read_fasta
from daccord_tpu_torch.formats.las import LasFile
from daccord_tpu_torch.native.api import ColumnarLas, decode_reads_batch, process_pile_native
from daccord_tpu_torch.oracle import align, windows
from daccord_tpu_torch.runtime import pipeline
from daccord_tpu_torch.runtime.pipeline import PipelineConfig, correct_to_fasta
from daccord_tpu_torch.sim import SimConfig, make_dataset


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """A torch thread pool the size of the machine in each test worker
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _dataset(root: str, tspace: int):
    return make_dataset(root, SimConfig(genome_len=3000, coverage=14, read_len_mean=900,
                                        tspace=tspace, seed=19))


@pytest.fixture(scope="module", params=[100, 200], ids=["tspace100", "tspace200"])
def dataset(request, tmp_path_factory):
    """tspace 200 stores its trace points in two bytes."""
    return _dataset(str(tmp_path_factory.mktemp(f"native{request.param}")), request.param)


def _jax_native():
    from daccord_tpu import native as jax_native
    from daccord_tpu.native import api as jax_api

    if not jax_native.available():
        raise RuntimeError("the JAX package's host library did not build")
    return jax_api


def _rank_order(col, s, e):
    span = np.maximum(col.aepos[s:e] - col.abpos[s:e], 1)
    return np.argsort(pipeline._rank_scores(col.diffs[s:e], span, None), kind="stable")


def test_columnar_las_equals_jax(dataset):
    jax_api = _jax_native()
    col, ref = ColumnarLas(dataset["las"]), jax_api.ColumnarLas(dataset["las"])
    assert col.novl == ref.novl > 0 and col.tspace == ref.tspace == LasFile(dataset["las"]).tspace
    for f in ("aread", "bread", "abpos", "aepos", "bbpos", "bepos", "comp", "diffs",
              "trace_off", "trace_flat", "pile_starts"):
        np.testing.assert_array_equal(getattr(col, f), getattr(ref, f), err_msg=f)
        assert getattr(col, f).dtype == getattr(ref, f).dtype, f
    assert list(col.piles()) == list(ref.piles())
    # and the port's own streaming reader
    for i, o in enumerate(LasFile(dataset["las"])):
        tr = col.trace_flat[col.trace_off[i]:col.trace_off[i + 1]].reshape(-1, 2)
        np.testing.assert_array_equal(tr, o.trace)


def test_decode_reads_batch_equals_jax_and_read_bases(dataset):
    jax_api = _jax_native()
    db = read_db(dataset["db"])
    ids = list(range(db.nreads)) + [0, db.nreads - 1, 3]
    got = db.read_bases_batch(ids)
    boffs = np.asarray([db.reads[i].boff for i in ids], np.int64)
    rlens = np.asarray([db.reads[i].rlen for i in ids], np.int32)
    ref = jax_api.decode_reads_batch(db.bps, boffs, rlens)
    assert len(got) == len(ref) == len(ids)
    assert any(r.rlen % 4 for r in db.reads)
    for i, g, r in zip(ids, got, ref):
        assert g.dtype == np.int8
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, db.read_bases(i))
    assert decode_reads_batch(db.bps, boffs[:0], rlens[:0]) == []
    with pytest.raises(ValueError, match="outside the base store"):
        decode_reads_batch(db.bps, np.asarray([len(db.bps)]), np.asarray([8]))


@pytest.mark.parametrize("ordered", [False, True], ids=["file_order", "ranked"])
def test_process_pile_equals_jax(dataset, ordered):
    """Every pile, byte-equal to the JAX package's process_pile_native."""
    jax_api = _jax_native()
    db = read_db(dataset["db"])
    col, jcol = ColumnarLas(dataset["las"]), jax_api.ColumnarLas(dataset["las"])
    n = 0
    for aread, s, e in col.piles():
        a = db.read_bases(aread)
        order = _rank_order(col, s, e) if ordered else None
        idxs = np.arange(s, e) if order is None else s + order
        b_reads = db.read_bases_batch(col.bread[idxs])
        got = process_pile_native(a, col, s, e, b_reads, 40, 10, 32, 64, order=order)
        ref = jax_api.process_pile_native(a, jcol, s, e, b_reads, 40, 10, 32, 64,
                                          order=order)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
        n += int((got[2] > 1).sum())
    assert n > 0


def test_process_pile_rejects_bad_input(dataset):
    db = read_db(dataset["db"])
    col = ColumnarLas(dataset["las"])
    aread, s, e = next(iter(col.piles()))
    a = db.read_bases(aread)
    b_reads = db.read_bases_batch(col.bread[s:e])
    with pytest.raises(ValueError, match="order"):
        process_pile_native(a, col, s, e, b_reads, 40, 10, 32, 64,
                            order=np.arange(e - s) + 1)
    with pytest.raises(ValueError, match="B reads"):
        process_pile_native(a, col, s, e, b_reads[1:], 40, 10, 32, 64)
    with pytest.raises(ValueError, match="outside its reads"):
        process_pile_native(a[: int(col.aepos[s]) - 1], col, s, e, b_reads,
                            40, 10, 32, 64)


def _pairs():
    """Seeded pairs: noisy copies and unrelated sequences, empty sides, and
    B sides past 256 bases (the banded matrix branch of align_path)."""
    rng = np.random.default_rng(11)
    out = [(np.zeros(0, np.int8), np.zeros(0, np.int8)),
           (np.zeros(0, np.int8), rng.integers(0, 4, 7).astype(np.int8)),
           (rng.integers(0, 4, 9).astype(np.int8), np.zeros(0, np.int8)),
           (np.asarray([2], np.int8), np.asarray([2], np.int8))]
    for n in (1, 5, 40, 63, 64, 65, 100, 130, 257, 300, 420):
        a = rng.integers(0, 4, n).astype(np.int8)
        b = a.copy()
        for _ in range(max(1, n // 7)):
            at = int(rng.integers(0, len(b) + 1))
            op = int(rng.integers(0, 3))
            if op == 0 and at < len(b):
                b[at] = rng.integers(0, 4)
            elif op == 1:
                b = np.insert(b, at, rng.integers(0, 4))
            elif len(b) > 1:
                b = np.delete(b, min(at, len(b) - 1))
        out.append((a, b))
        out.append((a, rng.integers(0, 4, int(rng.integers(1, 2 * n + 2))).astype(np.int8)))
    assert any(len(b) > 256 for _, b in out)
    return out


def _jax_align():
    _jax_native()
    from daccord_tpu.oracle import align as jax_align
    return jax_align


@pytest.mark.parametrize("fn", ["align_path", "edit_distance", "infix_distance",
                                "overlap_suffix_prefix"])
def test_align_native_equals_plain_and_jax(fn):
    jax_align = _jax_align()
    native_fn, plain_fn = getattr(align, fn), getattr(align, f"{fn}_plain")
    ref_fn = getattr(jax_align, fn)
    for a, b in _pairs():
        for x, y in ((a, b), (b, a)):
            got, plain, ref = native_fn(x, y), plain_fn(x, y), ref_fn(x, y)
            if fn == "align_path":
                assert got[0] == plain[0] == ref[0], (len(x), len(y))
                np.testing.assert_array_equal(got[1], plain[1])
                np.testing.assert_array_equal(got[1], ref[1])
            else:
                assert got == plain == ref, (fn, len(x), len(y), got, plain, ref)


def test_edit_distance_sum_native_equals_plain_and_jax():
    jax_align = _jax_align()
    pairs = _pairs()
    segs = [b for _, b in pairs]
    for cand, _ in pairs[::3]:
        want = align.edit_distance_sum_plain(cand, segs)
        assert align.edit_distance_sum(cand, segs) == want
        assert align.edit_distance_sum(cand, align.pack_segments(segs)) == want
        assert jax_align.edit_distance_sum(cand, segs) == want
    assert align.edit_distance_sum(pairs[5][0], []) == 0


def _blocks(db, las, cfg, threads=0, qvr=None):
    it = (pipeline.iter_pile_blocks_threaded(db, las, cfg, threads, qvr) if threads
          else pipeline.iter_pile_blocks(db, las, cfg, qvr))
    return list(it)


def _assert_blocks_equal(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g[0] == r[0]
        for x, y in zip(g[1:], r[1:]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_native_feeder_equals_numpy_feeder(dataset, monkeypatch):
    """Native blocks == the numpy feeder's with the numpy align_path, and
    three feeder threads == none."""
    db, las = read_db(dataset["db"]), LasFile(dataset["las"])
    cfg = PipelineConfig(device="cpu")
    got = _blocks(db, las, cfg)
    _assert_blocks_equal(_blocks(db, las, cfg, threads=3), got)
    monkeypatch.setattr(windows, "align_path", align.align_path_plain)
    _assert_blocks_equal(_blocks(db, las, PipelineConfig(device="cpu", use_native=False)),
                         got)


@functools.lru_cache(maxsize=None)
def _qv_dataset(root: str):
    """A dataset whose DB carries an ``inqual`` track written by the JAX
    package (the port does not compute the track)."""
    from daccord_tpu.tools.lastools import compute_intrinsic_qv

    d = make_dataset(root, SimConfig(genome_len=3000, coverage=12, read_len_mean=1500,
                                     seed=3))
    compute_intrinsic_qv(jax_read_db(d["db"]), JaxLasFile(d["las"]), depth=15)
    return d


@pytest.fixture(scope="module")
def qv_dataset(tmp_path_factory):
    return _qv_dataset(str(tmp_path_factory.mktemp("qv")))


def test_qv_ranker_equals_jax(qv_dataset):
    from daccord_tpu.runtime import pipeline as jax_pipeline

    d = qv_dataset
    db, las = read_db(d["db"]), LasFile(d["las"])
    qvr = pipeline.load_qv_ranker(db, las, PipelineConfig(device="cpu"))
    jqvr = jax_pipeline.load_qv_ranker(jax_read_db(d["db"]), JaxLasFile(d["las"]),
                                       jax_pipeline.PipelineConfig())
    assert qvr is not None and jqvr is not None
    assert pipeline.load_qv_ranker(db, las, PipelineConfig(qv_track=None)) is None
    assert pipeline.load_qv_ranker(db, las, PipelineConfig(depth_rank=False)) is None
    assert pipeline.load_qv_ranker(db, las, PipelineConfig(qv_track="absent")) is None
    col = ColumnarLas(d["las"])
    rates = qvr.rates(col.bread, col.bbpos, col.bepos, col.comp)
    np.testing.assert_array_equal(rates, jqvr.rates(col.bread, col.bbpos, col.bepos,
                                                    col.comp))
    assert np.isfinite(rates).mean() > 0.5
    moved = 0
    for _, s, e in col.piles():
        span = np.maximum(col.aepos[s:e] - col.abpos[s:e], 1)
        bq = qvr.rates(col.bread[s:e], col.bbpos[s:e], col.bepos[s:e], col.comp[s:e])
        got = np.argsort(pipeline._rank_scores(col.diffs[s:e], span, bq), kind="stable")
        ref = np.argsort(jax_pipeline._rank_scores(col.diffs[s:e], span, bq), kind="stable")
        np.testing.assert_array_equal(got, ref)
        moved += int((got != _rank_order(col, s, e)).any())
    assert moved > 0     # the track changed some pile's order
    # both feeders rank alike, threaded or not
    cfg = PipelineConfig(device="cpu")
    ranked = _blocks(db, las, cfg, qvr=qvr)
    _assert_blocks_equal(_blocks(db, las, cfg, threads=2, qvr=qvr), ranked)
    _assert_blocks_equal(_blocks(db, las, PipelineConfig(device="cpu", use_native=False),
                                 qvr=qvr), ranked)


def test_qv_ranked_slice_within_drift_of_jax(qv_dataset, tmp_path):
    """The QV-ranked run of the port against JAX's, within the slice's drift
    bound (tests/test_torch_slice.py)."""
    from daccord_tpu.runtime.pipeline import PipelineConfig as JaxPipelineConfig
    from daccord_tpu.runtime.pipeline import correct_to_fasta as jax_correct_to_fasta

    d = qv_dataset
    jax_out, port_out = str(tmp_path / "jax.fasta"), str(tmp_path / "port.fasta")
    js = jax_correct_to_fasta(d["db"], d["las"], jax_out, JaxPipelineConfig(audit_rate=0))
    ps = correct_to_fasta(d["db"], d["las"], port_out,
                          PipelineConfig(device="cpu", batch_size=512, feeder_threads=2))
    assert js.qv_ranked and ps.qv_ranked and ps.native_host
    assert ps.n_windows == js.n_windows and ps.n_skipped_shallow == js.n_skipped_shallow
    jrec = {r.name: r.seq for r in read_fasta(jax_out)}
    prec = {r.name: r.seq for r in read_fasta(port_out)}
    same = sum(prec.get(n) == s for n, s in jrec.items())
    assert abs(ps.bases_out - js.bases_out) <= 0.005 * js.bases_out
    assert same >= 0.95 * len(jrec) and abs(len(prec) - len(jrec)) <= 0.05 * len(jrec)


def test_daccord_fasta_identical_across_feeders(tmp_path, capsys):
    from daccord_tpu_torch.tools import cli

    d = make_dataset(str(tmp_path), SimConfig(genome_len=1000, coverage=10,
                                              read_len_mean=500, seed=5))
    eprof = str(tmp_path / "eprof.json")
    texts, lines = {}, {}
    for tag, extra in (("default", []), ("no_native", ["--no-native"]),
                       ("threads", ["-t", "3"])):
        out = str(tmp_path / f"{tag}.fasta")
        assert cli.main(["daccord", d["db"], d["las"], "-o", out, "-E", eprof, "-b", "64",
                         "--device", "cpu", *extra]) == 0
        lines[tag] = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
        with open(out) as fh:
            texts[tag] = fh.read()
    assert texts["default"].startswith(">read")
    assert texts["no_native"] == texts["default"] == texts["threads"]
    assert [lines[t]["native_host"] for t in texts] == [True, False, True]
    assert [lines[t]["threads"] for t in texts] == [0, 0, 3]
    assert not lines["default"]["qv_ranked"]
    with pytest.raises(SystemExit, match="-t needs"):
        cli.main(["daccord", d["db"], d["las"], "--device", "cpu", "--no-native",
                  "-t", "2"])
    with pytest.raises(ValueError, match="feeder_threads"):
        list(pipeline.correct_shard(read_db(d["db"]), LasFile(d["las"]),
                                    PipelineConfig(device="cpu", use_native=False,
                                                   feeder_threads=2)))


@pytest.mark.parametrize("compiler", ["/nonexistent/bin/g++", "false"])
def test_failed_build_raises(tmp_path, compiler):
    """A compiler that is missing or fails raises with what it said, and
    leaves no library behind; nothing falls back."""
    with pytest.raises(RuntimeError, match="compiler|failed to build"):
        native.build(compiler=compiler, build_dir=str(tmp_path))
    assert not [f for f in tmp_path.iterdir() if f.name.endswith(".so")]


def test_build_key_names_the_host_cpu(monkeypatch, tmp_path):
    """-march=native: a library built on another CPU is never loaded, because
    the file name carries the CPU's model name and flags."""
    here = native.library_path(str(tmp_path))
    assert native.library_path(str(tmp_path)) == here
    key = native.cpu_key()
    assert "\n" in key and len(key) > 10
    monkeypatch.setattr(native, "cpu_key", lambda: key + " avx512f")
    assert native.library_path(str(tmp_path)) != here
