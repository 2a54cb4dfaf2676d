"""The port's ingest layer (``formats/ingest.py``, the validated LAS and DB
readers, the aread index and byte-range sharding) against the JAX package's
on the same files, on the CPU.

Every corruption is made with the JAX package's fault helpers
(``daccord_tpu.runtime.faults``, as ``tests/test_ingest.py`` makes them) on
a copy of one small simulated dataset. The scan reports are compared field
by field: issue kinds, details, byte offsets and piles, clean segments,
clean pile ranges and quarantine markers must be equal (tolerance: none).
"""

import os
import shutil

import numpy as np
import pytest

from daccord_tpu.formats import ingest as jax_ingest
from daccord_tpu.formats.dazzdb import db_blocks as jax_db_blocks
from daccord_tpu.formats.dazzdb import read_db as jax_read_db
from daccord_tpu.formats.las import LasFile as JaxLasFile
from daccord_tpu.formats.las import index_las as jax_index_las
from daccord_tpu.formats.las import range_for_areads as jax_range_for_areads
from daccord_tpu.formats.las import shard_ranges as jax_shard_ranges
from daccord_tpu.runtime import faults
from daccord_tpu_torch.formats import ingest
from daccord_tpu_torch.formats.dazzdb import db_blocks, read_db
from daccord_tpu_torch.formats.ingest import IngestError
from daccord_tpu_torch.formats.las import (LasFile, index_las, range_for_areads,
                                           shard_ranges)
from daccord_tpu_torch.sim import SimConfig, make_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_ingest"))
    return make_dataset(d, SimConfig(genome_len=1500, coverage=10, read_len_mean=500,
                                     min_overlap=200, seed=7), name="t"), d


@pytest.fixture(scope="module")
def rlens(dataset):
    db = read_db(dataset[0]["db"])
    return np.fromiter((r.rlen for r in db.reads), np.int64, db.nreads)


def _second_pile_record(las_path: str) -> int:
    """1-based index of the first record of the file's second pile."""
    idx = jax_index_las(las_path, use_sidecar=False)
    offs = faults._las_record_offsets(open(las_path, "rb").read())
    return offs.index(int(idx[1, 1])) + 1


def _cut_at_record_boundary(p: str) -> None:
    data = open(p, "rb").read()
    open(p, "wb").write(data[: faults._las_record_offsets(data)[-1]])


# every corruption of tests/test_ingest.py's scanner cases (the fault-plan and
# checkpoint cases need modules the port does not have yet)
CORRUPTIONS = {
    "clean": lambda p: None,
    "bad_coords": lambda p: faults.corrupt_las_bitflip(p, 5),
    "absurd_tlen": lambda p: faults.corrupt_las_bitflip(p, 5, field="tlen", bit=30),
    "negative_tlen": lambda p: faults.corrupt_las_bitflip(p, 3, field="tlen", bit=31),
    "bread_out_of_bounds": lambda p: faults.corrupt_las_bitflip(p, 3, field="bread", bit=30),
    "pile_boundary_coords": lambda p: faults.corrupt_las_bitflip(p, _second_pile_record(p)),
    "pile_boundary_aread": lambda p: faults.corrupt_las_bitflip(
        p, _second_pile_record(p), field="aread", bit=30),
    "doubly_corrupt": lambda p: (faults.corrupt_las_bitflip(p, 5, field="bread", bit=30),
                                 faults.corrupt_las_bitflip(p, 5, field="tlen", bit=31)),
    "opening_record_tlen": lambda p: faults.corrupt_las_bitflip(p, 1, field="tlen", bit=30),
    "truncated_mid_record": lambda p: faults.corrupt_las_truncate(
        p, JaxLasFile(p).novl - 3),
    "header_count_mismatch": _cut_at_record_boundary,
    "two_issues": lambda p: (faults.corrupt_las_bitflip(p, 5),
                             faults.corrupt_las_bitflip(p, JaxLasFile(p).novl - 4,
                                                        field="tlen", bit=30)),
}


def _assert_reports_equal(got, ref) -> None:
    issues = lambda rep: [(i.kind, i.path, i.offset, i.detail, i.aread, i.record)
                          for i in rep.issues]
    assert issues(got) == issues(ref)
    assert got.segments == ref.segments
    assert got.pile_ranges == ref.pile_ranges
    assert (got.n_records, got.n_piles, got.start, got.end) == \
        (ref.n_records, ref.n_piles, ref.start, ref.end)


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_scan_report_equals_jax(case, dataset, rlens, tmp_path):
    """``scan_las_range`` over the whole file and over the middle shard of
    three: the port's report equals JAX's on every corruption."""
    p = str(tmp_path / f"{case}.las")
    shutil.copy(dataset[0]["las"], p)
    s0, e0 = jax_shard_ranges(dataset[0]["las"], 3)[1]
    CORRUPTIONS[case](p)
    for start, end in ((None, None), (s0, e0)):
        got = ingest.scan_las_range(LasFile(p), start, end, rlens=rlens)
        ref = jax_ingest.scan_las_range(JaxLasFile(p), start, end, rlens=rlens)
        _assert_reports_equal(got, ref)
    full = ingest.scan_las_range(LasFile(p), rlens=rlens)
    assert full.ok == (case == "clean")
    if case != "clean":
        assert any(s[0] == "quarantine" for s in full.segments)


def test_scan_with_db_garbage_read_equals_jax(dataset, tmp_path):
    """A DB read record of 0xFF garbage: strict ``read_db`` raises in both
    packages, non-strict marks the same bad read, and ``scan_with_db``
    quarantines the same piles."""
    d = str(tmp_path / "db")
    shutil.copytree(dataset[1], d)
    db_path, las_path = os.path.join(d, "t.db"), os.path.join(d, "t.las")
    faults.corrupt_db_garbage(db_path, 3)
    db, jdb = read_db(db_path, strict=False), jax_read_db(db_path, strict=False)
    assert db.bad_reads == jdb.bad_reads == {2}
    got = ingest.scan_with_db(db, LasFile(las_path))
    ref = jax_ingest.scan_with_db(jdb, JaxLasFile(las_path))
    _assert_reports_equal(got, ref)
    assert {i.kind for i in got.issues} == {"db_read"}


def _torn_header(idx: str) -> None:
    open(idx, "wb").write(b"\x00" * 30)


def _short_records(idx: str) -> None:
    data = open(idx, "rb").read()
    open(idx, "wb").write(data[:-7])


def _insane_header(idx: str) -> None:
    data = bytearray(open(idx, "rb").read())
    data[48:52] = (10 ** 6).to_bytes(4, "little")        # nreads > ureads
    open(idx, "wb").write(bytes(data))


def _read_db_outcome(read, err, path: str, strict: bool):
    """("raises", [(kind, offset, detail)...]) or ("loads", bad read ids)."""
    try:
        db = read(path, strict=strict)
    except err as e:
        return "raises", [(i.kind, i.offset, i.detail) for i in e.issues]
    return "loads", sorted(db.bad_reads)


@pytest.mark.parametrize("damage", ["garbage_read", "torn_header", "short_records",
                                    "insane_header"])
def test_read_db_rejects_what_jax_rejects(damage, dataset, tmp_path):
    d = str(tmp_path / "db")
    shutil.copytree(dataset[1], d)
    db_path, idx = os.path.join(d, "t.db"), os.path.join(d, ".t.idx")
    if damage == "garbage_read":
        faults.corrupt_db_garbage(db_path, 3)
    else:
        {"torn_header": _torn_header, "short_records": _short_records,
         "insane_header": _insane_header}[damage](idx)
    got = {strict: _read_db_outcome(read_db, IngestError, db_path, strict)
           for strict in (True, False)}
    ref = {strict: _read_db_outcome(jax_read_db, jax_ingest.IngestError, db_path, strict)
           for strict in (True, False)}
    assert got == ref
    assert got[True][0] == "raises"
    assert got[False] == (("loads", [2]) if damage == "garbage_read" else got[True])


def test_las_hardening_equals_jax(dataset, tmp_path):
    """A torn header, a corrupt tlen under the indexer and under the record
    iterator: the same structured error (kind, offset) in both packages."""
    torn = str(tmp_path / "torn.las")
    open(torn, "wb").write(b"\x01\x02\x03")
    for cls, err in ((LasFile, IngestError), (JaxLasFile, jax_ingest.IngestError)):
        with pytest.raises(err) as ei:
            cls(torn)
        assert (ei.value.kind, ei.value.offset) == ("truncation", 3)
    p = str(tmp_path / "tl.las")
    shutil.copy(dataset[0]["las"], p)
    faults.corrupt_las_bitflip(p, 5, field="tlen", bit=30)
    with pytest.raises(IngestError) as got:
        index_las(p, use_sidecar=False)
    with pytest.raises(jax_ingest.IngestError) as ref:
        jax_index_las(p, use_sidecar=False)
    assert (got.value.kind, got.value.offset) == (ref.value.kind, ref.value.offset) \
        and got.value.kind == "bad_tlen"
    faults.corrupt_las_bitflip(p, 7, field="tlen", bit=31)
    with pytest.raises(IngestError) as got:
        list(LasFile(p))
    with pytest.raises(jax_ingest.IngestError) as ref:
        list(JaxLasFile(p))
    assert (got.value.kind, got.value.offset) == (ref.value.kind, ref.value.offset)


def test_torn_sidecar_rebuilds_and_is_reported(dataset, tmp_path):
    """The index sidecar: written in the JAX package's format (each reads
    the other's), a torn one is reported by ``sidecar_issues`` and rebuilt."""
    p = str(tmp_path / "sc.las")
    shutil.copy(dataset[0]["las"], p)
    good = index_las(p)
    np.testing.assert_array_equal(jax_index_las(p), good)   # reads the port's
    open(p + ".idx", "wb").write(b"JUNKxxxxxxxx")
    os.utime(p + ".idx")
    assert [i.kind for i in ingest.sidecar_issues(p)] == ["bad_magic"] == \
        [i.kind for i in jax_ingest.sidecar_issues(p)]
    np.testing.assert_array_equal(index_las(p), good)
    assert ingest.sidecar_issues(p) == []


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_shard_ranges_equal_jax(n, dataset):
    las = dataset[0]["las"]
    assert shard_ranges(las, n) == jax_shard_ranges(las, n)
    ranges = shard_ranges(las, n)
    assert ranges[0][0] == 16 and ranges[-1][1] == os.path.getsize(las)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_range_for_areads_and_blocks_equal_jax(dataset):
    db_path, las = dataset[0]["db"], dataset[0]["las"]
    assert db_blocks(db_path) == jax_db_blocks(db_path)
    n = read_db(db_path).nreads
    for lo, hi in ((0, n), (0, 3), (3, 9), (n - 2, n), (5, 5), (n, n + 4)):
        assert range_for_areads(las, lo, hi) == jax_range_for_areads(las, lo, hi)


def test_mem_las_scans_as_the_file(dataset, rlens):
    """A LAS held in memory (``mem:`` URL, ``utils/aio.py``) reads and scans
    as the file does; the sidecar index is never written for it."""
    from daccord_tpu_torch.utils import aio

    path = dataset[0]["las"]
    url = "mem:torch_ingest/t.las"
    with open(path, "rb") as fh:
        aio.put_mem(url, fh.read())
    assert aio.getsize(url) == os.path.getsize(path)
    got = ingest.scan_las_range(LasFile(url), rlens=rlens)
    ref = ingest.scan_las_range(LasFile(path), rlens=rlens)
    assert (got.segments, got.pile_ranges, got.n_records) == \
        (ref.segments, ref.pile_ranges, ref.n_records) and got.ok
    np.testing.assert_array_equal(index_las(url), index_las(path, use_sidecar=False))
    assert [(o.aread, o.bread, o.abpos) for o in LasFile(url)] == \
        [(o.aread, o.bread, o.abpos) for o in LasFile(path)]
    assert ingest.sidecar_issues(url) == []
    with pytest.raises(ValueError):
        aio.put_mem(path, b"")
