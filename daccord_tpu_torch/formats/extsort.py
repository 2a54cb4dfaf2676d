"""External-memory LAS sort and merge, and the symmetric filter.

The port's copy of ``daccord_tpu/formats/extsort.py``: the scale-capable
forms of ``lassort``, ``lasmerge`` and ``filtersym``, whose in-memory forms
fail on inputs larger than RAM.

- :func:`sort_las_external`: sorted runs of ``mem_records`` records on disk,
  then a k-way merge (fan-in 64, multi-level beyond). It runs in the host
  library (``native/dazz_native.cpp las_sort``); :func:`sort_las_plain` is
  its python version, byte-equal at the same ``mem_records`` (the same runs,
  a stable sort, the earliest run first on ties).
- :func:`merge_las`: the k-way merge of sorted LAS files, in the host
  library (``las_merge``); :func:`merge_las_plain` is its ``heapq.merge``
  version.
- :func:`filter_symmetric_external`: the A->B iff B->A semi-join,
  hash-partitioned on the match key so each partition's key set fits in
  memory; byte-equal to ``tools.lastools.filter_symmetric`` with a DB.

The tools require the host library, as the whole port does: no build
raises, nothing falls back to python. The one exception is a ``mem:`` path,
which the C++ code cannot open: it takes the python path. Temporary files
live next to the output (the same filesystem, and big-input temp space where
the output goes).
"""

from __future__ import annotations

import heapq
import os
import tempfile

import numpy as np

from ..utils.aio import is_mem, local_path
from .las import LasFile, Overlap, invalidate_index, write_las


def _sort_key(o: Overlap):
    """The sort key of las-sort, las-merge and the external runs."""
    return (o.aread, o.bread, o.abpos)


def sort_las_external(in_path: str, out_path: str,
                      mem_records: int = 2_000_000) -> int:
    """Sort a LAS by (aread, bread, abpos), stable, with at most
    ``mem_records`` records in memory; returns the record count. The host
    library sorts (a ``mem:`` path takes :func:`sort_las_plain`)."""
    if is_mem(in_path) or is_mem(out_path):
        return sort_las_plain(in_path, out_path, mem_records)
    from ..native.api import las_sort_native

    out_fs = local_path(out_path)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(out_fs)),
                                     prefix=".lassort.") as td:
        n = las_sort_native(local_path(in_path), out_fs, td, mem_records)
    invalidate_index(out_path)
    return n


def sort_las_plain(in_path: str, out_path: str, mem_records: int = 2_000_000) -> int:
    """The python version of :func:`sort_las_external`: every
    ``mem_records`` records become one sorted run on disk, and the runs
    merge (fan-in 64) straight into ``out_path``."""
    las = LasFile(in_path)
    out_dir = os.path.dirname(os.path.abspath(local_path(out_path)))
    with tempfile.TemporaryDirectory(dir=out_dir, prefix=".lassort.") as td:
        runs: list[str] = []
        chunk: list[Overlap] = []

        def flush():
            if not chunk:
                return
            chunk.sort(key=_sort_key)
            rp = os.path.join(td, f"run{len(runs)}.las")
            write_las(rp, las.tspace, chunk)
            runs.append(rp)
            chunk.clear()

        for o in las:
            chunk.append(o)
            if len(chunk) >= mem_records:
                flush()
        if not runs:
            # the whole input fit one chunk: sort and write it directly
            chunk.sort(key=_sort_key)
            return write_las(out_path, las.tspace, chunk)
        flush()
        # each open run holds a file descriptor for the whole merge, so the
        # fan-in stays well under the process limit (64^2 runs of the 2M
        # default cover 8G records)
        FANIN = 64
        gen = len(runs)
        while len(runs) > FANIN:
            merged: list[str] = []
            for g0 in range(0, len(runs), FANIN):
                group = runs[g0 : g0 + FANIN]
                gen += 1
                rp = os.path.join(td, f"run{gen}.las")
                write_las(rp, las.tspace,
                          heapq.merge(*(iter(LasFile(r)) for r in group), key=_sort_key))
                for r in group:
                    os.remove(r)
                merged.append(rp)
            runs = merged
        return write_las(out_path, las.tspace,
                         heapq.merge(*(iter(LasFile(r)) for r in runs), key=_sort_key))


def _merge_inputs(in_paths: list[str], out_path: str) -> int:
    """The common tspace of ``in_paths``; refuses an output among the inputs
    and inputs of different tspace."""
    if os.path.abspath(local_path(out_path)) in {os.path.abspath(local_path(p))
                                                 for p in in_paths}:
        raise ValueError("the output path must not be one of the inputs (inputs "
                         "are streamed while the output is written)")
    tspaces = {LasFile(p).tspace for p in in_paths}
    if len(tspaces) != 1:
        raise ValueError(f"mismatched tspace across inputs: {sorted(tspaces)}")
    return tspaces.pop()


def merge_las(in_paths: list[str], out_path: str) -> int:
    """Merge aread-sorted LAS files into one (the LAmerge role) in the host
    library; returns the record count. A ``mem:`` path takes
    :func:`merge_las_plain`; a truncated input raises."""
    if any(is_mem(p) for p in [out_path, *in_paths]):
        return merge_las_plain(in_paths, out_path)
    from ..native.api import las_merge_native

    tspace = _merge_inputs(in_paths, out_path)
    n = las_merge_native([local_path(p) for p in in_paths], local_path(out_path), tspace)
    invalidate_index(out_path)
    return n


def merge_las_plain(in_paths: list[str], out_path: str) -> int:
    """The python version of :func:`merge_las` (``heapq.merge`` of the
    record streams, the earliest input first on ties)."""
    tspace = _merge_inputs(in_paths, out_path)
    return write_las(out_path, tspace,
                     heapq.merge(*(iter(LasFile(p)) for p in in_paths), key=_sort_key))


# --------------------------------------------------------------------------
# Symmetric filter, hash-partitioned
# --------------------------------------------------------------------------

# exact 3-word packing of the 7-field match key (unsigned: aread<<33 must
# not overflow for read ids up to 2^31):
#   k0 = aread<<33 | bread<<1 | comp
#   k1 = abpos<<32 | aepos                (positions < 2^31, non-negative)
#   k2 = bbpos<<32 | bepos
_KEY_DT = np.dtype([("k0", "<u8"), ("k1", "<u8"), ("k2", "<u8")])
_IDX_DT = np.dtype([("k0", "<u8"), ("k1", "<u8"), ("k2", "<u8"), ("i", "<i8")])


def _pack(a, b, comp, ab, ae, bb, be) -> np.ndarray:
    out = np.empty(len(a), dtype=_KEY_DT)
    out["k0"] = ((a.astype(np.uint64) << np.uint64(33))
                 | (b.astype(np.uint64) << np.uint64(1))
                 | comp.astype(np.uint64))
    out["k1"] = (ab.astype(np.uint64) << np.uint64(32)) | ae.astype(np.uint64)
    out["k2"] = (bb.astype(np.uint64) << np.uint64(32)) | be.astype(np.uint64)
    return out


def _batch_arrays(batch: list[Overlap], db):
    """(own_keys, mirror_keys) for one record batch (the exact mirror through
    the read lengths for complemented overlaps, as in
    ``lastools.filter_symmetric``)."""
    n = len(batch)
    a = np.fromiter((o.aread for o in batch), np.int64, n)
    b = np.fromiter((o.bread for o in batch), np.int64, n)
    comp = np.fromiter((o.is_comp for o in batch), np.int64, n)
    ab = np.fromiter((o.abpos for o in batch), np.int64, n)
    ae = np.fromiter((o.aepos for o in batch), np.int64, n)
    bb = np.fromiter((o.bbpos for o in batch), np.int64, n)
    be = np.fromiter((o.bepos for o in batch), np.int64, n)
    own = _pack(a, b, comp, ab, ae, bb, be)
    alen = np.fromiter((db.read_length(o.aread) for o in batch), np.int64, n)
    blen = np.fromiter((db.read_length(o.bread) for o in batch), np.int64, n)
    # mirror of (a,b,[ab,ae),[bb,be)): plain overlaps swap the intervals;
    # complemented overlaps also flip both through their read length
    m_ab = np.where(comp == 1, blen - be, bb)
    m_ae = np.where(comp == 1, blen - bb, be)
    m_bb = np.where(comp == 1, alen - ae, ab)
    m_be = np.where(comp == 1, alen - ab, ae)
    mirror = _pack(b, a, comp, m_ab, m_ae, m_bb, m_be)
    return own, mirror


def filter_symmetric_external(las_path: str, out_path: str, db,
                              mem_records: int = 2_000_000,
                              batch: int = 65536) -> int:
    """Keep A->B overlaps iff the matching B->A record exists, with bounded
    memory: keys hash-partition onto disk, each partition joins in memory,
    matches set bits in a novl-bit bitmap, and a final streaming pass writes
    the kept records. ``db`` supplies read lengths for the complement-space
    mirror (required — the exact semantics of the in-memory path).

    Memory bound: the per-partition join holds ~max(mem_records, novl/nparts)
    keys at once, plus the always-resident novl-byte keep bitmap. nparts is
    sized so the first term stays at mem_records, capped only by the process
    fd limit (the scatter phase keeps 2 files per partition open at once);
    at the default ulimit of 1024 that caps nparts near 480, i.e. ~1e9
    records before partitions start exceeding mem_records."""
    las = LasFile(las_path)
    novl = las.novl
    try:
        import resource
        soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
        if soft < 0 or soft == resource.RLIM_INFINITY:
            soft = 4096   # unlimited: RLIM_INFINITY is -1 on Linux
        fd_cap = max(16, (soft - 64) // 2)
    except Exception:
        fd_cap = 256
    nparts = min(fd_cap, max(1, (novl + mem_records - 1) // mem_records))
    keep = np.zeros(novl, dtype=bool)

    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(out_path)),
            prefix=".filtersym.") as td:
        kf = [open(os.path.join(td, f"k{p}.bin"), "wb") for p in range(nparts)]
        mf = [open(os.path.join(td, f"m{p}.bin"), "wb") for p in range(nparts)]
        try:
            idx0 = 0
            buf: list[Overlap] = []

            def emit():
                nonlocal idx0
                if not buf:
                    return
                own, mirror = _batch_arrays(buf, db)
                # partition by the key the join runs on: a record's OWN key
                # and another record's MIRROR key land in the same partition
                po = (own["k0"] ^ own["k1"] ^ own["k2"]) % nparts
                pm = (mirror["k0"] ^ mirror["k1"] ^ mirror["k2"]) % nparts
                rows = np.empty(len(buf), dtype=_IDX_DT)
                rows["k0"], rows["k1"], rows["k2"] = (
                    mirror["k0"], mirror["k1"], mirror["k2"])
                rows["i"] = np.arange(idx0, idx0 + len(buf))
                for p in range(nparts):
                    sel = po == p
                    if sel.any():
                        kf[p].write(own[sel].tobytes())
                    sel = pm == p
                    if sel.any():
                        mf[p].write(rows[sel].tobytes())
                idx0 += len(buf)
                buf.clear()

            for o in las:
                buf.append(o)
                if len(buf) >= batch:
                    emit()
            emit()
        finally:
            for fh in kf + mf:
                fh.close()

        for p in range(nparts):
            keys = np.sort(np.fromfile(os.path.join(td, f"k{p}.bin"),
                                       dtype=_KEY_DT))
            rows = np.fromfile(os.path.join(td, f"m{p}.bin"), dtype=_IDX_DT)
            if len(keys) == 0 or len(rows) == 0:
                continue
            mk = rows[["k0", "k1", "k2"]].astype(_KEY_DT)
            pos = np.searchsorted(keys, mk)
            pos = np.minimum(pos, len(keys) - 1)
            hit = keys[pos] == mk
            keep[rows["i"][hit]] = True

    return write_las(out_path, las.tspace,
                     (o for i, o in enumerate(las) if keep[i]))
