"""Residual-error anatomy: where do a corrected FASTA's errors live?

The port of ``daccord_tpu/tools/hperrors.py`` (numpy over the port's
``oracle/align.py align_path``; no device).

Diagnostic for the hp rescue ceiling (BASELINE.md r5): aligns each corrected
fragment to its truth infix (same protocol as qveval), walks the edit path,
and classifies every error by the truth-side homopolymer run length at its
position and by op type. If the hp-regime residual were still run-length
miscalls, the long-run buckets would dominate; if it is spread across
runlen 1-2 substitutions/indels, the damage is below the run-length-vote
mechanism (compressed-space solve quality / acceptance bias), which is the
r5 measured finding.

Run: ``python -m daccord_tpu_torch.tools.hperrors corrected.fasta truth.npz``
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def classify(frag: np.ndarray, tr: np.ndarray, buckets: dict) -> None:
    from ..oracle.align import align_path

    n, m = len(frag), len(tr)
    if n == 0 or m == 0:
        return
    # locate the best infix start/end with the semi-global DP row, then get
    # an exact path against that truth slice (with a small safety margin)
    D = np.empty((2, m + 1), dtype=np.int32)
    D[0] = 0
    prev = D[0]
    cur = D[1]
    for i in range(1, n + 1):
        cur[0] = i
        sub = prev[:m] + (tr != frag[i - 1])
        dele = prev[1:] + 1
        best = np.minimum(sub, dele)
        vals = np.concatenate(([cur[0]], best))
        ar = np.arange(m + 1, dtype=np.int32)
        vals[1:] -= ar[1:]
        cur[1:] = (np.minimum.accumulate(vals) + ar)[1:]
        prev, cur = cur, prev
    end = int(np.argmin(prev))
    start = max(0, end - n - int(0.3 * n) - 8)
    sl = tr[start:end]
    _, a2b = align_path(frag, sl)
    # truth run lengths per truth position
    if len(sl) == 0:
        return
    st = np.concatenate(([0], np.flatnonzero(sl[1:] != sl[:-1]) + 1))
    rl = np.repeat(np.diff(np.concatenate((st, [len(sl)]))),
                   np.diff(np.concatenate((st, [len(sl)]))))

    def bucket(L: int) -> str:
        return "run1-2" if L <= 2 else ("run3-5" if L <= 5 else "run6+")

    steps = np.diff(a2b)
    for i in range(len(frag)):
        lo, hi = int(a2b[i]), int(a2b[i + 1])
        if steps[i] == 0:
            # fragment base consumes no truth: an inserted (spurious) base;
            # blame the run at the insertion point
            L = int(rl[min(lo, len(rl) - 1)])
            buckets[f"ins_{bucket(L)}"] = buckets.get(f"ins_{bucket(L)}", 0) + 1
        else:
            if frag[i] != sl[lo]:
                L = int(rl[lo])
                buckets[f"sub_{bucket(L)}"] = buckets.get(f"sub_{bucket(L)}", 0) + 1
            for j in range(lo + 1, hi):
                # extra truth bases consumed: deletions from the fragment
                L = int(rl[j])
                buckets[f"del_{bucket(L)}"] = buckets.get(f"del_{bucket(L)}", 0) + 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fasta")
    ap.add_argument("truth")
    ap.add_argument("--max-frags", type=int, default=400,
                    help="fragments sampled (the anatomy stabilizes fast)")
    args = ap.parse_args(argv)

    from ..formats.fasta import read_fasta
    from ..utils.bases import revcomp_ints, seq_to_ints

    t = np.load(args.truth)
    genome, starts, ends, strands = (t["genome"], t["starts"], t["ends"],
                                     t["strands"])
    buckets: dict = {}
    n = 0
    for rec in read_fasta(args.fasta):
        name = rec.name.split()[0]
        try:
            rid = int(name.removeprefix("read").split("/")[0])
            tr = genome[starts[rid]:ends[rid]]
            if strands[rid] == 1:
                tr = revcomp_ints(tr)
        except (ValueError, IndexError):
            continue
        classify(seq_to_ints(rec.seq), tr, buckets)
        n += 1
        if n >= args.max_frags:
            break
    tot = sum(buckets.values())
    line = {"fragments": n, "errors": tot,
            **{k: buckets[k] for k in sorted(buckets)},
            "long_run_share": round(sum(v for k, v in buckets.items()
                                        if not k.endswith("run1-2"))
                                    / max(tot, 1), 3)}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
