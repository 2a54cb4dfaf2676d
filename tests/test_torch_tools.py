"""The port's LAS and DB tools (``tools/lastools.py``, the tools of
``tools/cli.py``) against the JAX package's on the same files.

Every tool of the upstream workflow runs once through the JAX package's
entry point and once through the port's, each in its own copy of a small
seeded set with a planted two-copy repeat and chimeras; the files each
writes (tracks, LAS, DB triples, FASTA) and its standard output are
byte-identical. The port's host-library passes equal their ``*_plain``
python versions (whole DB and per block, whole file and chunked), a
``mem:`` LAS takes the python path, the planted repeat is found, the QV gate
masks as the JAX package's does, every tool answers ``--help`` and ``python
-m daccord_tpu_torch.tools.cli`` dispatches.
"""

import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from daccord_tpu.tools import cli as jax_cli
from daccord_tpu_torch.formats.dazzdb import (db_blocks, read_db, read_track, split_db,
                                              write_track)
from daccord_tpu_torch.formats.fasta import FastaRecord, write_fasta
from daccord_tpu_torch.formats.las import LasFile, write_las
from daccord_tpu_torch.sim import SimConfig, make_dataset
from daccord_tpu_torch.tools import cli, lastools
from daccord_tpu_torch.utils import aio
from daccord_tpu_torch.utils.bases import ints_to_seq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 6 kb / 14x set, 900-base reads, a two-copy repeat over 40% of the
    genome at 8% divergence and 3% chimeras; a shuffled copy of its LAS, a
    FASTA with N runs and the reads named as corrected reads."""
    d = str(tmp_path_factory.mktemp("torch_tools"))
    cfg = SimConfig(genome_len=6000, coverage=14, read_len_mean=900,
                    repeat_fraction=0.4, repeat_divergence=0.08, p_chimera=0.03,
                    seed=45)
    out = make_dataset(d, cfg, name="t")
    las = LasFile(out["las"])
    ovls = list(las)
    perm = np.random.default_rng(5).permutation(len(ovls))
    write_las(os.path.join(d, "shuf.las"), las.tspace, [ovls[i] for i in perm])
    db = read_db(out["db"])
    recs = [FastaRecord(f"read{i}/0", ints_to_seq(db.read_bases(i))) for i in range(db.nreads)]
    write_fasta(os.path.join(d, "reads.fasta"), recs)
    noisy = [FastaRecord(r.name, r.seq[:50] + "NNnnRY" + r.seq[56:]) for r in recs[:12]]
    write_fasta(os.path.join(d, "noisy.fasta"), noisy)
    bad = ovls[:40]
    bad[3].aepos = bad[3].abpos          # a degenerate span
    write_las(os.path.join(d, "bad.las"), las.tspace, bad)
    assert las.novl > 500
    return out, d


def _copy(src: str, dst: str) -> str:
    os.makedirs(dst)
    for f in glob.glob(os.path.join(src, "*")) + glob.glob(os.path.join(src, ".*")):
        if os.path.isfile(f):
            shutil.copy(f, dst)
    return dst


def _files(d: str) -> dict:
    """Every file of ``d`` but the sidecars neither package rewrites."""
    return {os.path.basename(f): open(f, "rb").read()
            for f in glob.glob(os.path.join(d, "*")) + glob.glob(os.path.join(d, ".*"))
            if os.path.isfile(f)}


def _run_both(dataset, tmp_path, capsys, steps):
    """Run ``steps`` (argv lists, ``{d}`` = the working copy) with the JAX
    package's tools in one copy of the set and the port's in another;
    returns both copies' files and each step's (exit code, stdout)."""
    _, d = dataset
    got = {}
    for name, tools in (("jax", jax_cli._TOOLS), ("port", cli._TOOLS)):
        w = _copy(d, str(tmp_path / name))
        outs = []
        for step in steps:
            step = [a.replace("{d}", w) for a in step]
            # a step naming {i} runs once per DB block; {parts} is every
            # block's p.<i>.las
            nb = len(db_blocks(f"{w}/t.db"))
            parts = [f"{w}/p.{i}.las" for i in range(1, nb + 1)]
            step = [x for a in step for x in (parts if a == "{parts}" else [a])]
            each = range(1, nb + 1) if any("{i}" in a for a in step) else [None]
            for i in each:
                argv = [a.replace("{i}", str(i)) for a in step]
                try:
                    rc = tools[argv[0]](argv[1:])
                except SystemExit as e:
                    rc = e.code
                outs.append((rc, capsys.readouterr().out.replace(w, "{d}")))
        got[name] = (_files(w), outs)
    return got["jax"], got["port"]


_DB, _LAS = "{d}/t.db", "{d}/t.las"
_INQUAL = ["inqual", _DB, _LAS, "-d", "14"]
_REPEATS = ["repeats", _DB, _LAS, "-d", "14", "--factor", "1.5"]
_FILTER = ["filter", _DB, _LAS, "{d}/f.las"]
_DBSPLIT = ["dbsplit", _DB, "-s", "0.025"]     # 3-4 blocks of the 84 kb of reads

CASES = {
    "inqual": [_INQUAL],
    "repeats_qv_gate": [_INQUAL, _REPEATS],
    "repeats_no_gate": [_REPEATS + ["--qv-track", "", "--grow", "1"]],
    "filter": [_INQUAL, _REPEATS, _FILTER],
    "filter_chunked": [_INQUAL, _REPEATS, _FILTER + ["--mem-records", "97"]],
    "filter_max_err": [_REPEATS, _FILTER + ["--max-err", "0.2", "--rep-margin", "0.03"]],
    "filtersym": [_REPEATS, _FILTER, ["filtersym", "{d}/f.las", "{d}/s.las", "--db", _DB]],
    "filtersym_external": [_REPEATS, _FILTER, ["filtersym", "{d}/f.las", "{d}/s.las",
                                               "--db", _DB, "--mem-records", "50"]],
    "filtersym_no_db": [_REPEATS, _FILTER, ["filtersym", "{d}/f.las", "{d}/s.las"]],
    "lassort_memory": [["lassort", "{d}/shuf.las", "{d}/o.las"]],
    "lassort_external": [["lassort", "{d}/shuf.las", "{d}/o.las", "--mem-records", "50"]],
    "lassort_multilevel": [["lassort", "{d}/shuf.las", "{d}/o.las", "--mem-records", "7"]],
    "dbsplit_lassplit_lasmerge": [_DBSPLIT, ["lassplit", _LAS, _DB, "{d}/p.#.las"],
                                  ["lasmerge", "{d}/m.las", "{parts}"]],
    "inqual_blocks_catrack": [_DBSPLIT, _INQUAL + ["--block", "{i}"],
                              ["catrack", _DB, "inqual", "-d"]],
    "repeats_blocks": [_DBSPLIT, _INQUAL, _REPEATS + ["--block", "{i}"]],
    "lasindex": [["lasindex", _LAS]],
    "fasta2db_db2fasta": [["db2fasta", _DB, "-o", "{d}/back.fasta"],
                          ["fasta2db", "{d}/back.fasta", "{d}/re.db"],
                          ["fasta2db", "{d}/back.fasta", "{d}/cut.db", "--cutoff", "900"]],
    "fillfasta": [["fillfasta", "{d}/noisy.fasta", "{d}/filled.fasta", "--seed", "3"]],
    "lasshow": [["lasshow", _LAS, "-n", "40", "--trace"]],
    "lascheck": [["lascheck", _LAS, "--db", _DB], ["lascheck", "{d}/shuf.las"],
                 ["lascheck", "{d}/bad.las", "--db", _DB]],
    "dbstats": [_DBSPLIT, ["dbstats", _DB]],
    "dbshow": [["dbshow", _DB, "3", "5-9"], ["dbshow", _DB, "-o", "{d}/all.fasta"]],
    "qveval": [["qveval", "{d}/reads.fasta", "{d}/t.truth.npz", "--raw-db", _DB]],
}


@pytest.mark.parametrize("case", list(CASES))
def test_tool_writes_the_jax_packages_bytes(dataset, tmp_path, capsys, case):
    (jf, jout), (pf, pout) = _run_both(dataset, tmp_path, capsys, CASES[case])
    assert pout == jout
    assert all(rc in (0, 1) for rc, _ in pout)
    assert sorted(pf) == sorted(jf)
    differ = [n for n in jf if jf[n] != pf[n]]
    assert differ == []


def test_block_tracks_merge_into_the_whole_db_track(dataset, tmp_path, capsys):
    (_, _), (pf, _) = _run_both(dataset, tmp_path, capsys,
                                CASES["inqual_blocks_catrack"])
    (_, _), (whole, _) = _run_both(dataset, tmp_path / "w", capsys, [_INQUAL])
    assert pf[".t.inqual.anno"] == whole[".t.inqual.anno"]
    assert pf[".t.inqual.data"] == whole[".t.inqual.data"]
    assert not any(".1.inqual" in n for n in pf)     # catrack -d removed them


def test_lassplit_refuses_overlaps_outside_the_block_partition(dataset, tmp_path):
    out, _ = dataset
    las = LasFile(out["las"])
    stray = list(las)[:2]
    stray[1].aread = read_db(out["db"], load_bases=False).nreads + 5
    p = str(tmp_path / "stray.las")
    write_las(p, las.tspace, stray)
    msgs = []
    for tools in (jax_cli._TOOLS, cli._TOOLS):
        with pytest.raises(SystemExit) as e:
            tools["lassplit"]([p, out["db"], str(tmp_path / "s.#.las")])
        msgs.append(e.value.code)
    assert msgs[0] == msgs[1] and "fall outside" in msgs[1]


def test_track_and_block_partition_files_equal_the_jax_packages(tmp_path):
    """``tests/test_formats.py``'s track round trip and DBsplit partition on
    the port: the same .anno/.data and .db stub bytes as the JAX package's,
    blocks at read edges, bounded, covering every read."""
    from daccord_tpu.formats import dazzdb as jax_dazzdb
    from daccord_tpu_torch.formats import dazzdb

    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 4, int(n), dtype=np.int8)
            for n in rng.integers(200, 1200, size=40)]
    payloads = [np.array([1, 2, 3], np.uint8), np.array([], np.uint8),
                np.array([9], np.uint8)] * 13 + [np.array([7], np.uint8)]
    files = {}
    for name, mod in (("jax", jax_dazzdb), ("port", dazzdb)):
        os.makedirs(tmp_path / name)
        db_path = str(tmp_path / name / "b.db")
        mod.write_db(db_path, seqs)
        mod.write_track(db_path, "inqual", payloads)
        blocks = mod.split_db(db_path, block_bases=5000)
        mod.write_track(db_path, "inqual", payloads[:blocks[0][1]], block=1)
        files[name] = (_files(str(tmp_path / name)), blocks)
    assert files["port"] == files["jax"]
    back = dazzdb.read_track(str(tmp_path / "port" / "b.db"), "inqual")
    assert all(np.array_equal(a, b) for a, b in zip(payloads, back))
    blocks = files["port"][1]
    assert blocks == dazzdb.db_blocks(str(tmp_path / "port" / "b.db"))
    assert blocks[0][0] == 0 and blocks[-1][1] == len(seqs)
    assert all(e == s2 for (_, e), (s2, _) in zip(blocks, blocks[1:]))
    assert all(sum(map(len, seqs[s:e])) <= 5000 or e - s == 1 for s, e in blocks)
    db = read_db(str(tmp_path / "port" / "b.db"))
    assert np.array_equal(db.read_bases(0), seqs[0])
    lean = read_db(str(tmp_path / "port" / "b.db"), load_bases=False)
    assert np.array_equal(dazzdb.decode_reads_from_bps(lean, [0])[0], seqs[0])
    with pytest.raises(ValueError, match="load_bases=False"):
        lean.read_bases(0)


def test_lascheck_reports_a_file_cut_mid_record(dataset, tmp_path, capsys):
    out, _ = dataset
    cut = str(tmp_path / "cut.las")
    raw = open(out["las"], "rb").read()
    open(cut, "wb").write(raw[: len(raw) - 3])
    assert cli.main(["lascheck", cut]) == jax_cli._TOOLS["lascheck"]([cut]) == 1
    err = capsys.readouterr().err.splitlines()
    assert err[: len(err) // 2] == err[len(err) // 2:] and "BAD" in err[-1]


@pytest.mark.parametrize("which", ["inqual", "inqual_block", "repeats", "filter",
                                   "filter_chunked"])
def test_host_library_passes_equal_their_plain_versions(dataset, tmp_path, which):
    _, d = dataset
    w = _copy(d, str(tmp_path / "w"))
    db, las = read_db(f"{w}/t.db", load_bases=False), LasFile(f"{w}/t.las")
    lastools.compute_intrinsic_qv(db, las, depth=14)
    if which.startswith("filter"):
        lastools.detect_repeats(db, las, depth=14, cov_factor=1.5)
        mem = 97 if which == "filter_chunked" else None
        na = lastools.filter_alignments(db, las, f"{w}/a.las", mem_records=mem)
        nb = lastools.filter_alignments_plain(db, las, f"{w}/b.las", mem_records=mem)
        assert 0 < na == nb < las.novl
        assert open(f"{w}/a.las", "rb").read() == open(f"{w}/b.las", "rb").read()
        return
    if which == "inqual":
        pairs = [(lastools.compute_intrinsic_qv(db, las, depth=14, track="a"),
                  lastools.compute_intrinsic_qv_plain(db, las, depth=14, track="b"))]
    elif which == "inqual_block":
        split_db(f"{w}/t.db", 25_000)
        pairs = [(lastools.compute_intrinsic_qv(db, las, depth=14, block=b, track="a"),
                  lastools.compute_intrinsic_qv_plain(db, las, depth=14, block=b,
                                                      track="b"))
                 for b in (1, 3)]
    else:
        pairs = [(lastools.detect_repeats(db, las, depth=14, cov_factor=1.5, track="a"),
                  lastools.detect_repeats_plain(db, las, depth=14, cov_factor=1.5,
                                                track="b"))]
    for a, b in pairs:
        assert len(a) == len(b) and sum(len(x) for x in a) > 0
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_a_mem_las_takes_the_python_path(dataset, tmp_path):
    out, d = dataset
    w = _copy(d, str(tmp_path / "w"))
    db, las = read_db(f"{w}/t.db", load_bases=False), LasFile(f"{w}/t.las")
    lastools.detect_repeats(db, las, depth=14, cov_factor=1.5)
    url = "mem:tools-test.las"
    aio.put_mem(url, open(out["las"], "rb").read())
    try:
        n_file = lastools.filter_alignments(db, las, f"{w}/f.las")
        n_mem = lastools.filter_alignments(db, LasFile(url), "mem:tools-f.las")
        with aio.open_input("mem:tools-f.las") as fh:
            assert fh.read() == open(f"{w}/f.las", "rb").read()
        assert n_mem == n_file > 0
        qa = lastools.compute_intrinsic_qv(db, LasFile(url), depth=14, track="m")
        qb = lastools.compute_intrinsic_qv(db, las, depth=14, track="f")
        assert all(np.array_equal(x, y) for x, y in zip(qa, qb))
    finally:
        for u in (url, "mem:tools-f.las"):
            aio.remove(u)


def test_planted_repeat_is_found_and_the_qv_gate_masks(dataset, tmp_path):
    """The planted repeat yields intervals; an all-good QV track leaves them,
    an all-NOCOV track masks every one, ``qv_track=None`` restores them (the
    JAX package's ``test_detect_repeats_qv_gate``)."""
    _, d = dataset
    w = _copy(d, str(tmp_path / "w"))
    db, las = read_db(f"{w}/t.db"), LasFile(f"{w}/t.las")
    tspace = las.tspace

    def uniform(v):
        return [np.full((db.read_length(i) + tspace - 1) // tspace, v, np.uint8)
                for i in range(db.nreads)]

    def reps(**kw):
        lastools.detect_repeats(db, las, depth=14, cov_factor=1.5, **kw)
        return lastools.read_repeat_track(db)

    base = reps()
    assert sum(len(r) for r in base) > 0
    assert all(0 <= s < e for r in base for s, e in r)
    write_track(db.path, "inqual", uniform(10))
    assert all(np.array_equal(a, b) for a, b in zip(base, reps()))
    write_track(db.path, "inqual", uniform(lastools.QV_NOCOV))
    assert sum(len(r) for r in reps()) == 0
    assert all(np.array_equal(a, b) for a, b in zip(base, reps(qv_track=None)))
    assert read_track(db.path, "inqual")[0].max() == lastools.QV_NOCOV


def test_stream_median_matches_numpy():
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 100, 1001):
        vals = np.round(rng.random(n) * 0.4, 6)
        sm = lastools._StreamMedian()
        for c in np.array_split(vals, 3):
            sm.add(c)
        sm.plan()
        for c in np.array_split(vals, 3):
            sm.collect(c)
        assert sm.result() == float(np.median(vals)), n
    vals = np.asarray([0.15] * 50 + [0.1] * 10 + [0.2] * 10)
    sm = lastools._StreamMedian()
    sm.add(vals)
    sm.plan()
    sm.collect(vals)
    assert sm.result() == float(np.median(vals))


@pytest.mark.parametrize("tool", list(cli._TOOLS))
def test_every_tool_answers_help(tool, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([tool, "--help"])
    assert e.value.code == 0 and "usage" in capsys.readouterr().out.lower()


def test_the_jax_packages_workflow_tools_are_all_here():
    assert set(jax_cli._TOOLS) - set(cli._TOOLS) == {"fleet", "serve", "router"}


def test_the_module_dispatches_and_refuses_an_unknown_tool(dataset):
    out, _ = dataset
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "daccord_tpu_torch.tools.cli", "lasshow",
                        out["las"], "-n", "3"], capture_output=True, text=True, env=env,
                       cwd=ROOT)
    assert r.returncode == 0 and r.stdout.startswith(f"{LasFile(out['las']).novl} records")
    r = subprocess.run([sys.executable, "-m", "daccord_tpu_torch.tools.cli", "nope"],
                       capture_output=True, text=True, env=env, cwd=ROOT)
    assert r.returncode == 2 and "unknown tool" in r.stderr
