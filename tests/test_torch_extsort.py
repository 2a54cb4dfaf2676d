"""The port's external LAS sort and merge and its partitioned symmetric
filter (``formats/extsort.py``, the host library's ``las_sort`` and
``las_merge``) against their python versions and the JAX package's
(``tests/test_extsort.py`` on the port).

The host library's sort equals ``sort_las_plain`` and the JAX package's
python sort at the same ``mem_records``: in memory, with on-disk runs, with
more than 64 runs (the multi-level merge), at a wide tspace (2-byte trace
points) and on a foreign file with garbage in its pad bytes. The merge
equals the ``heapq.merge`` path and refuses a truncated input; the
partitioned ``filtersym`` equals the in-memory one; a ``mem:`` path takes
the python path.
"""

import heapq
import os

import numpy as np
import pytest

from daccord_tpu.formats import extsort as jax_extsort
from daccord_tpu_torch.formats.dazzdb import read_db
from daccord_tpu_torch.formats.extsort import (filter_symmetric_external, merge_las,
                                               merge_las_plain, sort_las_external,
                                               sort_las_plain)
from daccord_tpu_torch.formats.las import LasFile, Overlap, write_las
from daccord_tpu_torch.native.api import las_merge_native
from daccord_tpu_torch.sim import SimConfig, make_dataset
from daccord_tpu_torch.tools import lastools
from daccord_tpu_torch.utils import aio


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The JAX test's set (4 kb / 14x, 700-base reads, seed 29) and a seeded
    shuffle of its LAS."""
    d = str(tmp_path_factory.mktemp("torch_ext"))
    out = make_dataset(d, SimConfig(genome_len=4000, coverage=14, read_len_mean=700,
                                    seed=29), name="x")
    las = LasFile(out["las"])
    ovls = list(las)
    perm = np.random.default_rng(5).permutation(len(ovls))
    shuffled = os.path.join(d, "shuf.las")
    write_las(shuffled, las.tspace, [ovls[i] for i in perm])
    assert las.novl > 200
    return out, d, shuffled


def _bytes(p: str) -> bytes:
    return open(p, "rb").read()


def _in_memory_sort(src: str, dst: str) -> None:
    las = LasFile(src)
    write_las(dst, las.tspace, sorted(las, key=lambda o: (o.aread, o.bread, o.abpos)))


@pytest.mark.parametrize("mem", [10_000_000, 50, 5])
def test_sort_equals_the_plain_sort_and_the_jax_packages(dataset, tmp_path, mem):
    """A single chunk, five-plus runs, and more than 64 runs (multi-level)."""
    out, _, shuffled = dataset
    ref = str(tmp_path / "ref.las")
    _in_memory_sort(shuffled, ref)
    nat, plain, jax = (str(tmp_path / f"{n}.las") for n in ("nat", "plain", "jax"))
    n = sort_las_external(shuffled, nat, mem_records=mem)
    assert n == sort_las_plain(shuffled, plain, mem_records=mem) == LasFile(out["las"]).novl
    jax_extsort.sort_las_external(shuffled, jax, mem_records=mem, use_native=False)
    assert _bytes(nat) == _bytes(plain) == _bytes(jax) == _bytes(ref)
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".lassort.")]


def test_sort_of_an_empty_las(tmp_path):
    empty = str(tmp_path / "empty.las")
    write_las(empty, 100, [])
    assert sort_las_external(empty, str(tmp_path / "s.las"), mem_records=10) == 0
    assert LasFile(str(tmp_path / "s.las")).novl == 0


def test_sort_normalizes_foreign_pad_bytes(tmp_path):
    """Another producer's LAS may carry garbage in the header and record pad
    bytes; both sorts write zeros there."""
    p = str(tmp_path / "pad.las")
    ovls = [Overlap(aread=a, bread=1, abpos=0, aepos=100, bbpos=0, bepos=100,
                    trace=np.asarray([[2, 100]], np.int32)) for a in (3, 1, 2)]
    write_las(p, 100, ovls)
    raw = bytearray(_bytes(p))
    raw[12:16] = b"\xde\xad\xbe\xef"
    off = 16
    for _ in ovls:
        raw[off + 36 : off + 40] = b"\xca\xfe\xba\xbe"
        off += 40 + 2
    open(p, "wb").write(bytes(raw))
    nat, plain, jax = (str(tmp_path / f"{n}.las") for n in ("nat", "plain", "jax"))
    sort_las_external(p, nat, mem_records=2)
    sort_las_plain(p, plain, mem_records=2)
    jax_extsort.sort_las_external(p, jax, mem_records=2, use_native=False)
    assert _bytes(nat) == _bytes(plain) == _bytes(jax)
    assert _bytes(nat)[12:16] == b"\0\0\0\0"


def test_sort_at_a_wide_tspace(tmp_path):
    """tspace > 125 stores 2-byte trace points."""
    rng = np.random.default_rng(13)
    ovls = [Overlap(aread=int(rng.integers(0, 50)), bread=int(rng.integers(0, 50)),
                    abpos=0, aepos=300, bbpos=0, bepos=300,
                    trace=np.asarray([[int(rng.integers(0, 400)), 150],
                                      [int(rng.integers(0, 400)), 150]], np.int32))
            for _ in range(200)]
    p = str(tmp_path / "wide.las")
    write_las(p, 150, ovls)
    nat, plain, jax = (str(tmp_path / f"{n}.las") for n in ("nat", "plain", "jax"))
    assert sort_las_external(p, nat, mem_records=50) == 200
    assert sort_las_plain(p, plain, mem_records=50) == 200
    jax_extsort.sort_las_external(p, jax, mem_records=50, use_native=False)
    assert _bytes(nat) == _bytes(plain) == _bytes(jax)


def _three_parts(dataset, tmp_path) -> list[str]:
    out, _, _ = dataset
    las = LasFile(out["las"])
    ovls = list(las)
    parts = [str(tmp_path / f"{n}.las") for n in "abc"]
    for r, p in enumerate(parts):
        write_las(p, las.tspace, [o for o in ovls if o.aread % 3 == r])
    return parts


def test_merge_equals_the_plain_merge(dataset, tmp_path):
    out, _, _ = dataset
    parts = _three_parts(dataset, tmp_path)
    ref = str(tmp_path / "ref.las")
    write_las(ref, LasFile(out["las"]).tspace,
              heapq.merge(*(iter(LasFile(p)) for p in parts),
                          key=lambda o: (o.aread, o.bread, o.abpos)))
    nat, plain = str(tmp_path / "nat.las"), str(tmp_path / "plain.las")
    assert merge_las(parts, nat) == merge_las_plain(parts, plain) == LasFile(out["las"]).novl
    assert _bytes(nat) == _bytes(plain) == _bytes(ref) == _bytes(out["las"])


@pytest.mark.parametrize("why", ["truncated", "output_is_an_input", "tspace"])
def test_merge_refuses(dataset, tmp_path, why):
    out, _, _ = dataset
    las = LasFile(out["las"])
    good = str(tmp_path / "good.las")
    write_las(good, las.tspace, list(las)[:20])
    if why == "truncated":
        bad = str(tmp_path / "bad.las")
        open(bad, "wb").write(_bytes(good)[:-7])       # cut mid-trace
        with pytest.raises(IOError):
            las_merge_native([bad], str(tmp_path / "m.las"), las.tspace)
        with pytest.raises(IOError):
            merge_las([good, bad], str(tmp_path / "m.las"))
    elif why == "output_is_an_input":
        with pytest.raises(ValueError, match="must not be one of the inputs"):
            merge_las([good], good)
    else:
        wide = str(tmp_path / "wide.las")
        write_las(wide, 200, [])
        with pytest.raises(ValueError, match="mismatched tspace"):
            merge_las([good, wide], str(tmp_path / "m.las"))


@pytest.mark.parametrize("mem,batch", [(64, 50), (10, 7)])
def test_partitioned_filtersym_equals_the_in_memory_one(dataset, tmp_path, mem, batch):
    out, _, _ = dataset
    db = read_db(out["db"], load_bases=False)
    las = LasFile(out["las"])
    asym = str(tmp_path / "asym.las")
    write_las(asym, las.tspace, [o for i, o in enumerate(las) if i % 7 != 3])
    ref, ext, jax = (str(tmp_path / f"{n}.las") for n in ("ref", "ext", "jax"))
    n_mem = lastools.filter_symmetric(asym, ref, db=db)
    n_ext = filter_symmetric_external(asym, ext, db, mem_records=mem, batch=batch)
    jax_extsort.filter_symmetric_external(asym, jax, db, mem_records=mem, batch=batch)
    assert n_ext == n_mem > 0 and n_mem < LasFile(asym).novl
    assert _bytes(ext) == _bytes(ref) == _bytes(jax)


def test_mem_paths_take_the_python_path(dataset, tmp_path):
    out, _, shuffled = dataset
    src, dst = "mem:ext-shuf.las", "mem:ext-sorted.las"
    aio.put_mem(src, _bytes(shuffled))
    try:
        assert sort_las_external(src, dst, mem_records=50) == LasFile(shuffled).novl
        with aio.open_input(dst) as fh:
            assert fh.read() == _bytes(out["las"])
        parts = _three_parts(dataset, tmp_path)
        assert merge_las(parts, "mem:ext-merged.las") == LasFile(out["las"]).novl
        with aio.open_input("mem:ext-merged.las") as fh:
            assert fh.read() == _bytes(out["las"])
    finally:
        for u in (src, dst, "mem:ext-merged.las"):
            if aio.exists(u):
                aio.remove(u)
