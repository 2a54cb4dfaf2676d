"""Shared corpus of the port's mesh runs against the JAX package's
(``test_torch_mesh_parity.py``, ``test_torch_mesh_faults.py``): the corpus of
``tests/test_mesh.py`` (seed 47, ``batch_size=64``, ``depth_buckets=(16,)``),
one profile for both packages, and each package's ``correct_shard`` run on
it, on the CPU (the port's mesh members are CPU devices, the JAX package's
the forced host devices ``tests/conftest.py`` makes)."""

import json
import os

import torch

from daccord_tpu.formats import LasFile as JaxLasFile
from daccord_tpu.formats import read_db as jax_read_db
from daccord_tpu.oracle.profile import ErrorProfile as JaxErrorProfile
from daccord_tpu.runtime import pipeline as jax_pipeline
from daccord_tpu_torch.formats.dazzdb import read_db
from daccord_tpu_torch.formats.las import LasFile
from daccord_tpu_torch.runtime import pipeline
from daccord_tpu_torch.sim import SimConfig, make_dataset

BASE = dict(batch_size=64, depth_buckets=(16,))


def make_corpus(root: str) -> dict:
    d = make_dataset(root, SimConfig(genome_len=1500, coverage=10, read_len_mean=700,
                                     min_overlap=300, seed=47), name="mesh")
    db, las = read_db(d["db"]), LasFile(d["las"])
    prof = pipeline.estimate_profile_for_shard(db, las,
                                               pipeline.PipelineConfig(device="cpu", **BASE))
    eprof = os.path.join(root, "eprof.json")
    prof.save(eprof)
    return dict(root=root, paths=d, db=db, las=las, profile=prof,
                jax=dict(db=jax_read_db(d["db"]), las=JaxLasFile(d["las"]),
                         profile=JaxErrorProfile.load(eprof)))


def run(corpus: dict, pkg: str = "port", events: str | None = None, **kw) -> list:
    """One ``correct_shard`` of the corpus: ``[(aread, [fragment bytes])]``.
    ``pkg='jax'`` runs the JAX package's. Two torch threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        if pkg == "port":
            cfg = pipeline.PipelineConfig(device="cpu", events_path=events, **BASE, **kw)
            it = pipeline.correct_shard(corpus["db"], corpus["las"], cfg,
                                        profile=corpus["profile"])
        else:
            j = corpus["jax"]
            cfg = jax_pipeline.PipelineConfig(events_path=events, **BASE, **kw)
            it = jax_pipeline.correct_shard(j["db"], j["las"], cfg, profile=j["profile"])
        return [(rid, [f.tobytes() for f in frags]) for rid, frags, _ in it]
    finally:
        torch.set_num_threads(n)


def events(path: str) -> list:
    return [json.loads(x) for x in open(path)]
