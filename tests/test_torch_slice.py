"""The whole slice: the port's ``correct_to_fasta`` against the JAX package's
on one simulated dataset, both on the CPU.

The two runs window the same piles, estimate the same profile and build the
same OffsetLikely tables; they differ only where ``W = occ @ OL.T`` (an f32
reduction whose order differs between XLA and torch) moves a DP tie. So the
bounds are on drift: at most 0.5% of windows differ, total corrected bases
agree within 0.5%, and at least 95% of FASTA records are byte-identical.
"""

import functools

import numpy as np
import pytest
import torch

from daccord_tpu.runtime.pipeline import PipelineConfig as JaxPipelineConfig
from daccord_tpu.runtime.pipeline import correct_to_fasta as jax_correct_to_fasta
from daccord_tpu_torch.formats.fasta import read_fasta
from daccord_tpu_torch.runtime.pipeline import PipelineConfig, correct_to_fasta
from daccord_tpu_torch.sim import SimConfig, make_dataset


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The tier-1 run puts several test files side by side on the CPU; a
    torch thread pool the size of the machine in each oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _dataset(root: str):
    return make_dataset(root, SimConfig(genome_len=3000, coverage=12,
                                        read_len_mean=1500, seed=3))


def _record(batch, out, sink):
    for i in range(batch.size):
        if batch.read_ids[i] < 0 or batch.nsegs[i] == 0:
            continue
        seq = (bytes(np.asarray(out["cons"][i][: out["cons_len"][i]]))
               if out["solved"][i] else None)
        sink[(int(batch.read_ids[i]), int(batch.wstarts[i]))] = seq


def _capture_windows(monkeypatch, module, attr, sink):
    """Record every (read, window start) -> consensus a pipeline scatters,
    by wrapping the ladder entry the pipeline calls: the JAX package's
    ``solve_tiered(batch, ladder)``, the port's ``fetch_many(handles)``
    (each handle carries its batch)."""
    real = getattr(module, attr)

    if attr == "fetch_many":
        def wrapped(handles):
            outs = real(handles)
            for h, out in zip(handles, outs):
                _record(h.batch, out, sink)
            return outs

        # the supervisor fetches a drain of one call alone
        monkeypatch.setattr(module, "fetch", lambda h: wrapped([h])[0])
    else:
        def wrapped(batch, ladder, *a, **kw):
            out = real(batch, ladder, *a, **kw)
            _record(batch, out, sink)
            return out

    monkeypatch.setattr(module, attr, wrapped)


def test_slice_matches_jax_pipeline(tmp_path_factory, monkeypatch):
    root = str(tmp_path_factory.mktemp("slice"))
    d = _dataset(root)
    from daccord_tpu.kernels import tiers as jax_tiers
    from daccord_tpu_torch.runtime import pipeline as port_pipeline

    jax_w, port_w = {}, {}
    _capture_windows(monkeypatch, jax_tiers, "solve_tiered", jax_w)
    _capture_windows(monkeypatch, port_pipeline, "fetch_many", port_w)

    jax_out, port_out = f"{root}/jax.fasta", f"{root}/port.fasta"
    js = jax_correct_to_fasta(d["db"], d["las"], jax_out,
                              JaxPipelineConfig(audit_rate=0, use_native=False))
    ps = correct_to_fasta(d["db"], d["las"], port_out,
                          PipelineConfig(device="cpu", batch_size=512))

    assert ps.n_reads == js.n_reads and ps.n_windows == js.n_windows
    assert ps.n_skipped_shallow == js.n_skipped_shallow
    assert set(port_w) == set(jax_w) and len(port_w) > 0
    n_diff = sum(port_w[k] != jax_w[k] for k in jax_w)
    jrec = {r.name: r.seq for r in read_fasta(jax_out)}
    prec = {r.name: r.seq for r in read_fasta(port_out)}
    same = sum(prec.get(n) == s for n, s in jrec.items())
    print(f"slice: reads {ps.n_reads}, windows {ps.n_windows} "
          f"(solved jax {js.n_solved} / port {ps.n_solved}), "
          f"windows differing {n_diff}/{len(jax_w)}, bases jax {js.bases_out} "
          f"/ port {ps.bases_out}, identical records {same}/{len(jrec)} "
          f"(port has {len(prec)})")
    assert n_diff <= 0.005 * len(jax_w)
    assert abs(ps.bases_out - js.bases_out) <= 0.005 * js.bases_out
    assert same >= 0.95 * len(jrec) and abs(len(prec) - len(jrec)) <= 0.05 * len(jrec)


def test_error_profile_file_is_shared(tmp_path):
    """``-E`` files written by either package load in the other unchanged."""
    from daccord_tpu.oracle.profile import ErrorProfile as JaxErrorProfile
    from daccord_tpu_torch.oracle.profile import ErrorProfile

    fields = dict(p_ins=0.0712, p_del=0.0431, p_sub=0.0123, hp_slope=0.31,
                  hp_base=0.021, hp_cap=6)
    JaxErrorProfile(**fields).save(str(tmp_path / "jax.json"))
    ErrorProfile(**fields).save(str(tmp_path / "port.json"))
    assert vars(ErrorProfile.load(str(tmp_path / "jax.json"))) == fields
    assert vars(JaxErrorProfile.load(str(tmp_path / "port.json"))) == fields


def test_cli_daccord_on_cpu(tmp_path, capsys):
    """The ``daccord`` command line end to end on the CPU: ``-E`` writes the
    profile on the first run and drives the second, which writes the same
    FASTA; without CUDA the default device raises instead of falling back."""
    import json

    from daccord_tpu_torch.tools import cli

    d = make_dataset(str(tmp_path), SimConfig(genome_len=1000, coverage=10,
                                              read_len_mean=500, seed=5))
    eprof = str(tmp_path / "eprof.json")
    outs = [str(tmp_path / f"out{i}.fasta") for i in range(2)]
    for out in outs:
        assert cli.main(["daccord", d["db"], d["las"], "-o", out, "-E", eprof,
                         "-b", "64", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["reads"] > 0 and line["solved"] > 0
    with open(outs[0]) as a, open(outs[1]) as b:
        text = a.read()
        assert text.startswith(">read") and text == b.read()
    assert cli.main([]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["daccord", d["db"], d["las"], "-o", outs[0], "-E", eprof])
