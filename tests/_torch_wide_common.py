"""Shared runner of the port's wide-setting tests (``test_torch_wide.py``,
``test_torch_rescore.py``): one ``daccord`` run of each package on the CPU
with the same consensus width, segment length and top-M caps."""

import torch

from daccord_tpu.oracle.consensus import ConsensusConfig as JaxConsensusConfig
from daccord_tpu.runtime import pipeline as jax_pipeline
from daccord_tpu_torch.formats.fasta import read_fasta
from daccord_tpu_torch.oracle.consensus import ConsensusConfig
from daccord_tpu_torch.runtime import pipeline


def both_runs(d: dict, root: str, tag: str, w: int = 40, seg_len: int = 64,
              M: int = 64, rescue_M: int = 256, depth_buckets=(8, 16),
              start=None, end=None):
    """(JAX stats, port stats, JAX records, port records)."""
    got = []
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        for name, mod, cc in (("jax", jax_pipeline, JaxConsensusConfig(w=w)),
                              ("port", pipeline, ConsensusConfig(w=w))):
            kw = dict(consensus=cc, seg_len=seg_len, max_kmers=M, rescue_max_kmers=rescue_M,
                      depth_buckets=depth_buckets, batch_size=128, audit_rate=0)
            cfg = (mod.PipelineConfig(device="cpu", **kw) if name == "port"
                   else mod.PipelineConfig(**kw))
            out = f"{root}/{tag}_{name}.fasta"
            got.append((mod.correct_to_fasta(d["db"], d["las"], out, cfg, start, end),
                        {r.name: r.seq for r in read_fasta(out)}))
    finally:
        torch.set_num_threads(n)
    (js, jr), (ps, pr) = got
    return js, ps, jr, pr


def within_drift(js, ps, jr, pr) -> bool:
    """ROADMAP's drift bound: at least 95% of records identical, bases
    within 0.5%, record counts within 5%."""
    same = sum(pr.get(n) == s for n, s in jr.items())
    return (same >= 0.95 * len(jr) and abs(ps.bases_out - js.bases_out) <= 0.005 * js.bases_out
            and abs(len(pr) - len(jr)) <= 0.05 * max(len(jr), 1))
