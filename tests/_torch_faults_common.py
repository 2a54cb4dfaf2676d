"""Shared helpers of the port's fault-matrix tests
(``test_torch_supervisor.py``, ``test_torch_sdc.py``): one small dataset and
profile, the port's and the JAX package's ``daccord`` runs on it under a
``DACCORD_FAULT`` spec, and what their event logs record."""

import json
import os

import torch

from daccord_tpu.oracle.profile import ErrorProfile as JaxErrorProfile
from daccord_tpu.runtime import pipeline as jax_pipeline
from daccord_tpu_torch.formats.dazzdb import read_db
from daccord_tpu_torch.formats.las import LasFile
from daccord_tpu_torch.oracle.profile import ErrorProfile
from daccord_tpu_torch.runtime import pipeline
from daccord_tpu_torch.sim import SimConfig, make_dataset

B = 64      # small batches: one run makes ~18 ladder calls in two buckets


def make_base(root: str) -> dict:
    """The dataset (two dense buckets fill), one profile for every run, and
    the port's clean run."""
    d = make_dataset(root, SimConfig(genome_len=600, coverage=20, read_len_mean=500,
                                     min_overlap=200, seed=7), name="t")
    eprof = os.path.join(root, "eprof.json")
    pipeline.estimate_profile_for_shard(read_db(d["db"]), LasFile(d["las"]),
                                        pipeline.PipelineConfig(device="cpu")).save(eprof)
    base = dict(root=root, d=d, eprof=eprof)
    base["clean"] = run(base, "port", "clean", None, audit_rate=0)
    return base


def run(base: dict, pkg: str, tag: str, spec: str | None, **kw) -> dict:
    """One ``daccord`` run of the port (``pkg='port'``) or the JAX package
    on the CPU under ``spec``, with a cold-shape registry of its own; its
    FASTA text, stats, and event log (the ``sup_state`` chain, the
    ``sup_done`` counters, every record)."""
    root = base["root"]
    ev = os.path.join(root, f"{pkg}_{tag}.events.jsonl")
    out = os.path.join(root, f"{pkg}_{tag}.fasta")
    env = {"DACCORD_COMPCACHE": os.path.join(root, f"cc_{pkg}_{tag}"),
           "DACCORD_SUP_BACKOFF_S": "0.01"}
    if spec:
        env["DACCORD_FAULT"] = spec
    saved = {k: os.environ.get(k) for k in (*env, "DACCORD_FAULT")}
    os.environ.pop("DACCORD_FAULT", None)
    os.environ.update(env)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        if pkg == "port":
            cfg = pipeline.PipelineConfig(device="cpu", batch_size=B, events_path=ev, **kw)
            stats = pipeline.correct_to_fasta(base["d"]["db"], base["d"]["las"], out, cfg,
                                              profile=ErrorProfile.load(base["eprof"]))
        else:
            cfg = jax_pipeline.PipelineConfig(batch_size=B, events_path=ev, **kw)
            stats = jax_pipeline.correct_to_fasta(
                base["d"]["db"], base["d"]["las"], out, cfg,
                profile=JaxErrorProfile.load(base["eprof"]))
    finally:
        torch.set_num_threads(n)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    recs = [json.loads(x) for x in open(ev)]
    with open(out) as fh:
        text = fh.read()
    return dict(text=text, stats=stats, ev=ev, recs=recs,
                chain=[(r["state_from"], r["state_to"]) for r in recs
                       if r["event"] == "sup_state"],
                done=[{k: v for k, v in r.items() if k not in ("t", "ts", "audit_s")}
                      for r in recs if r["event"] == "sup_done"])
