"""The reference's rows for the whole pool, and the comparison that decides
``correct``: every row a job fetched, against the reference's row of the
window it sent. Two numbers: the windows of the pool whose fetched
consensus (``cons``, ``cons_len``, ``solved``, ``tier``) differs from the
reference's in any fetch, and the widest relative gap of ``err`` over the
fetched rows whose consensus agrees. The reference is a transcription of the
port's own numpy ladder (``audit/ladder.py``), which the port's card ladder
matches bit for bit today; the limits leave room for a float32 summation
order of another kernel and none for the bfloat16 control (``PERF.md``
gives the readings). Imports numpy only: the solves run in fresh
interpreters (``python -m portbench.reference.check``) that load this
package alone.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import threading

import numpy as np

from . import ladder

FIELDS = ("cons", "cons_len", "solved", "tier", "err")
CONSENSUS = ("cons", "cons_len", "solved", "tier")
CHUNK = 256
#: at most this many windows of the pool may fetch another consensus than
#: the reference's: midway between sound runs (0) and the control's fewest
WINDOWS_LIMIT = 18
#: the widest relative gap of ``err`` where the consensus agrees: above a
#: float32 rounding (6e-8), under the control's bfloat16 rounding
ERR_LIMIT = 1e-4
#: the error rate below which a gap of ``err`` is taken as absolute
ERR_FLOOR = 1e-3


def solve_chunks(spec: tuple, chunks: list) -> list[dict]:
    """The reference's rows of each (seqs, lens, nsegs) chunk."""
    outs = []
    for seqs, lens, nsegs in chunks:
        out = ladder.solve_ladder(spec, seqs, lens, nsegs)
        outs.append({k: out[k] for k in FIELDS})
    return outs


def _in_processes(spec: tuple, chunks: list, processes: int,
                  module: str = "portbench.reference.check") -> list[dict]:
    """:func:`solve_chunks` dealt over ``processes`` fresh interpreters
    (``python -m module``), the chunks in turn; each is sent its share on
    its standard input and answers on its standard output."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    shares = [list(range(i, len(chunks), processes)) for i in range(processes)]
    results: list = [None] * processes
    errors: list = []

    def one(i: int) -> None:
        proc = subprocess.Popen([sys.executable, "-m", module],
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, env=env, cwd=root)
        out, err = proc.communicate(pickle.dumps((spec, [chunks[j] for j in shares[i]])))
        if proc.returncode != 0:
            errors.append(err.decode(errors="replace")[-2000:])
            return
        results[i] = pickle.loads(out)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(processes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"a reference process failed: {errors[0]}")
    outs: list = [None] * len(chunks)
    for i, share in enumerate(shares):
        for j, o in zip(share, results[i]):
            outs[j] = o
    return outs


def solve_pool(spec: tuple, buckets: dict, processes: int,
               module: str = "portbench.reference.check") -> dict:
    """{depth: {field: rows}} over every window of the pool, in chunks
    over ``processes`` processes of ``module`` (this one below 2)."""
    jobs = [(d, lo) for d in sorted(buckets) for lo in range(0, buckets[d].size, CHUNK)]
    chunks = [(buckets[d].seqs[lo:lo + CHUNK], buckets[d].lens[lo:lo + CHUNK],
               buckets[d].nsegs[lo:lo + CHUNK]) for d, lo in jobs]
    if processes < 2:
        outs = solve_chunks(spec, chunks)
    else:
        outs = _in_processes(spec, chunks, min(processes, len(chunks)), module)
    ref: dict = {}
    for (d, _), o in zip(jobs, outs):
        ref.setdefault(d, []).append(o)
    return {d: {k: np.concatenate([o[k] for o in parts]) for k in FIELDS}
            for d, parts in ref.items()}


def differing(got: dict, want: dict) -> np.ndarray:
    """Per row: whether the consensus differs (``cons``, ``cons_len``,
    ``solved``, ``tier``)."""
    bad = np.zeros(len(want["tier"]), bool)
    for k in CONSENSUS:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.shape != w.shape:
            return np.ones(len(bad), bool)
        bad |= (g != w).reshape(len(bad), -1).any(axis=1)
    return bad


def err_gap(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Per row: |got - want| over max(|want|, :data:`ERR_FLOOR`); 0 where
    they are equal (both infinite included), infinite where one is."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    with np.errstate(invalid="ignore"):
        gap = np.abs(g - w) / np.maximum(np.abs(w), ERR_FLOOR)
    gap = np.where(np.isfinite(g) & np.isfinite(w), gap, np.inf)
    return np.where(g == w, 0.0, gap)


class Comparison:
    """The comparison over every fetched block: rows compared, the pool's
    windows whose consensus differs in any fetch, the widest ``err`` gap
    where it agrees, and the first difference described."""

    def __init__(self, ref: dict):
        self.ref = ref
        self.bad = {d: np.zeros(len(v["tier"]), bool) for d, v in ref.items()}
        self.rows = 0
        self.err_gap = 0.0
        self.first = ""

    @property
    def windows(self) -> int:
        return int(sum(b.sum() for b in self.bad.values()))

    def add(self, d: int, lo: int, hi: int, out: dict) -> None:
        want = {k: v[lo:hi] for k, v in self.ref[d].items()}
        self.rows += hi - lo
        try:
            got = {k: np.asarray(out[k]) for k in FIELDS}
            rows = differing(got, want)
            gap = err_gap(got["err"], want["err"]) if len(got["err"]) == hi - lo else None
        except (KeyError, ValueError, TypeError) as e:
            got, rows, gap = None, np.ones(hi - lo, bool), None
            self.first = self.first or f"D={d} rows {lo}-{hi}: {type(e).__name__}: {e}"[:300]
        if gap is None:
            gap = np.where(rows, 0.0, np.inf)
        self.bad[d][lo:hi] |= rows
        ok = ~rows
        if ok.any():
            self.err_gap = max(self.err_gap, float(gap[ok].max()))
        if rows.any() and not self.first:
            i = int(np.argmax(rows))
            self.first = (f"D={d} row {lo + i}: got cons_len {got['cons_len'][i]} tier "
                          f"{got['tier'][i]} err {got['err'][i]!r}, reference cons_len "
                          f"{want['cons_len'][i]} tier {want['tier'][i]} err {want['err'][i]!r}")


def compare(blocks: list, ref: dict) -> Comparison:
    """``blocks``: (depth, lo, hi, result) of every fetched block."""
    c = Comparison(ref)
    for d, lo, hi, out in blocks:
        c.add(d, lo, hi, out)
    return c


if __name__ == "__main__":
    spec_, chunks_ = pickle.loads(sys.stdin.buffer.read())
    sys.stdout.buffer.write(pickle.dumps(solve_chunks(spec_, chunks_)))
