"""daccord-audit: offline re-verification of a committed run's integrity
chain.

The port's copy of ``daccord_tpu/tools/audit.py``. Given a committed shard
directory it re-walks every durable link: each shard manifest's sha256
against the FASTA bytes on disk, a ``fleet.json``'s merged digest against
the merged output, and the result digests of serve job manifests under
``jobs/`` (directories the JAX package's fleet and service write audit the
same way). With ``--db/--las --resolve K`` it re-solves the first K piles of
a shard on the port's CPU ladder (``runtime.pipeline.correct_shard``, which
is bit-equal to the card's) and compares the fragments byte for byte with
what the shard committed. Exit 0: every link verified; 1: at least one
mismatch (each printed); 2: nothing auditable found.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys


def _check(ok: bool, label: str, detail: str, report: list[dict],
           quiet: bool) -> bool:
    report.append({"check": label, "ok": bool(ok), "detail": detail})
    if not quiet:
        print(f"  [{'ok' if ok else 'FAIL'}] {label}: {detail}")
    return ok


def audit_outdir(outdir: str, nshards: int | None = None,
                 merged: str | None = None, quiet: bool = False
                 ) -> tuple[list[dict], int]:
    """Verify every durable digest link under ``outdir``. Returns
    ``(report_rows, n_audited)`` — failures are rows with ``ok: False``."""
    from ..parallel.launch import load_shard_manifest, shard_paths
    from ..utils.obs import sha256_file

    report: list[dict] = []
    n = 0

    # fleet manifest: shard roster + the merged-output digest link
    fleet = None
    fj = os.path.join(outdir, "fleet.json")
    if os.path.exists(fj):
        try:
            with open(fj) as fh:
                fleet = json.load(fh)
        except (OSError, ValueError):
            _check(False, "fleet.json", "torn or unreadable", report, quiet)
        if fleet is not None and nshards is None:
            nshards = fleet.get("nshards")

    if nshards is None:
        found = [f for f in glob.glob(os.path.join(outdir, "shard*.json"))
                 if re.fullmatch(r"shard\d+\.json", os.path.basename(f))]
        nshards = len(found)

    for s in range(nshards or 0):
        m, why = load_shard_manifest(outdir, s)
        if m is None:
            # a fleet-poisoned shard legitimately has no output; anything
            # else (torn manifest, belied byte count) is a broken link
            poisoned = bool(fleet and s in (fleet.get("poison") or []))
            if not poisoned:
                _check(False, f"shard {s}",
                       why or "manifest missing", report, quiet)
                n += 1
            continue
        n += 1
        sha = m.get("fasta_sha256")
        if sha is None:
            _check(True, f"shard {s}",
                   "pre-digest manifest (byte counts only)", report, quiet)
            continue
        actual = sha256_file(shard_paths(outdir, s)["fasta"])
        _check(actual == sha, f"shard {s}",
               f"fasta sha256 {'verified' if actual == sha else 'MISMATCH'}"
               f" ({m.get('fasta_bytes', '?')} bytes)", report, quiet)

    # merged output: fleet.json's digest (or an explicitly named file that
    # must then match the per-shard concatenation digests indirectly)
    mpath = merged or (fleet or {}).get("merged_fasta")
    msha = (fleet or {}).get("merged_sha256")
    if mpath and os.path.exists(mpath):
        n += 1
        if msha:
            actual = sha256_file(mpath)
            _check(actual == msha, "merged",
                   f"{os.path.basename(mpath)} sha256 "
                   f"{'verified' if actual == msha else 'MISMATCH'}",
                   report, quiet)
        else:
            _check(True, "merged",
                   f"{os.path.basename(mpath)}: no recorded digest "
                   "(pre-digest fleet manifest)", report, quiet)
    elif mpath:
        n += 1
        _check(False, "merged", f"{mpath}: recorded but missing on disk",
               report, quiet)

    # serve jobs committed under this dir (a serve workdir audits the same
    # way: every done manifest carries the result digest)
    for mf in sorted(glob.glob(os.path.join(outdir, "jobs", "*",
                                            "manifest.json"))):
        try:
            with open(mf) as fh:
                jm = json.load(fh)
        except (OSError, ValueError):
            _check(False, f"job {os.path.basename(os.path.dirname(mf))}",
                   "torn manifest", report, quiet)
            n += 1
            continue
        sha, fpath = jm.get("fasta_sha256"), jm.get("fasta")
        if not sha or not fpath:
            continue
        n += 1
        ok = os.path.exists(fpath) and sha256_file(fpath) == sha
        _check(ok, f"job {jm.get('job', '?')}",
               f"result sha256 {'verified' if ok else 'MISMATCH'}",
               report, quiet)
    return report, n


def resolve_sample(outdir: str, shard: int, db_path: str, las_path: str,
                   k: int, report: list[dict], quiet: bool = False) -> None:
    """Re-solve the first ``k`` piles of ``shard`` on the CPU ladder and
    compare their fragments with the committed shard FASTA: the offline twin
    of the supervisor's shadow audit. Sound because the CPU ladder is
    bit-equal to the card's and each read's fragments are independent (a
    shard written with ``--paged on`` may differ within the paged route's
    drift bound)."""
    from ..formats import LasFile, read_db
    from ..parallel.launch import load_shard_manifest, shard_paths
    from ..runtime.pipeline import PipelineConfig, correct_shard
    from ..utils.bases import ints_to_seq

    m, why = load_shard_manifest(outdir, shard)
    if m is None:
        _check(False, f"resolve shard {shard}", why or "no manifest",
               report, quiet)
        return
    # committed fragments keyed the way correct_to_fasta names them
    committed: dict[str, str] = {}
    name = None
    with open(shard_paths(outdir, shard)["fasta"]) as fh:
        for line in fh:
            if line.startswith(">"):
                name = line[1:].strip()
                committed[name] = ""
            elif name:
                committed[name] += line.strip()
    start, end = m.get("byte_range") or (None, None)
    db = read_db(db_path)
    las = LasFile(las_path)
    # the reference: the CPU ladder, no supervisor (and so no audit): it is
    # the reference, there is nothing to escalate to
    cfg = PipelineConfig(supervise=False, device="cpu")
    done = 0
    for rid, frags, _ in correct_shard(db, las, cfg, start, end):
        for fi, f in enumerate(frags):
            key = f"read{rid}/{fi}"
            got = ints_to_seq(f)
            want = committed.get(key)
            if want is None:
                _check(False, f"resolve read{rid}",
                       f"fragment {fi} absent from committed FASTA",
                       report, quiet)
            elif got != want:
                _check(False, f"resolve read{rid}",
                       f"fragment {fi} bytes differ from committed FASTA",
                       report, quiet)
        done += 1
        if done >= k:
            break
    _check(True, f"resolve shard {shard}",
           f"{done} pile(s) re-solved on the reference path", report, quiet)


def audit_main(argv=None) -> int:
    """daccord-audit: re-verify a committed run's digests offline, and
    optionally re-solve a sample of piles on the reference path."""
    p = argparse.ArgumentParser(prog="daccord-audit",
                                description=audit_main.__doc__)
    p.add_argument("outdir", help="shard/fleet outdir or serve workdir")
    p.add_argument("--nshards", type=int, default=None,
                   help="shard count (default: fleet.json, else glob)")
    p.add_argument("--merged", default=None, metavar="FASTA",
                   help="merged output to verify against fleet.json's "
                        "recorded digest (default: the recorded path)")
    p.add_argument("--db", default=None, help="Dazzler DB (for --resolve)")
    p.add_argument("--las", default=None, help="LAS file (for --resolve)")
    p.add_argument("--resolve", type=int, default=0, metavar="K",
                   help="re-solve the first K piles of --shard on the CPU "
                        "ladder and byte-compare (requires --db/--las)")
    p.add_argument("--shard", type=int, default=0,
                   help="which shard --resolve samples (default 0)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report on stdout")
    args = p.parse_args(argv)

    report, n = audit_outdir(args.outdir, nshards=args.nshards,
                             merged=args.merged, quiet=args.json)
    if args.resolve > 0:
        if not (args.db and args.las):
            p.error("--resolve requires --db and --las")
        resolve_sample(args.outdir, args.shard, args.db, args.las,
                       args.resolve, report, quiet=args.json)
    failed = [r for r in report if not r["ok"]]
    if args.json:
        print(json.dumps({"audited": n, "checks": report,
                          "failed": len(failed)}))
    else:
        print(f"daccord-audit: {len(report)} check(s), "
              f"{len(failed)} failure(s)", file=sys.stderr)
    if failed:
        return 1
    return 0 if n else 2


if __name__ == "__main__":
    raise SystemExit(audit_main())
