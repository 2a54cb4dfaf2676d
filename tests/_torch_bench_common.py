"""Shared by the port's bench and decision tool tests: the micro dataset's
shape, the two tool caches moved under the test's directory, and ROADMAP's
drift bound between a JAX run's FASTA and the port's."""

import pytest
import torch

from daccord_tpu.tools import ladderbench as jax_lb
from daccord_tpu_torch.formats.fasta import read_fasta
from daccord_tpu_torch.tools import ladderbench as torch_lb

#: the micro dataset the tools run on (~550 windows: each CPU ladder run
#: pays its escalation tiers once per depth bucket, so windows cost little
#: and runs much)
MICRO = dict(genome_len=800, coverage=12, read_len_mean=500, seed=9)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The tier-1 run puts several test files side by side on the CPU; a
    torch thread pool the size of the machine in each oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' dataset caches under ``tmp_path``: (jax, torch)."""
    j, t = tmp_path / "jax_cache", tmp_path / "torch_cache"
    monkeypatch.setattr(jax_lb, "CACHE", str(j))
    monkeypatch.setattr(torch_lb, "CACHE", str(t))
    return j, t


def records(path) -> dict:
    return {r.name: r.seq for r in read_fasta(str(path))}


def fasta_drift(jax_fa, torch_fa) -> bool:
    """Assert ROADMAP's drift bound between the two FASTA files (at least
    95% of records byte-identical, corrected bases within 0.5%); returns
    whether they are byte-identical."""
    a, b = records(jax_fa), records(torch_fa)
    same = sum(1 for k, v in a.items() if b.get(k) == v)
    assert same >= 0.95 * max(len(a), 1), (same, len(a), len(b))
    na, nb = sum(map(len, a.values())), sum(map(len, b.values()))
    assert abs(na - nb) <= 0.005 * max(na, 1), (na, nb)
    with open(jax_fa, "rb") as fa, open(torch_fa, "rb") as fb:
        return fa.read() == fb.read()


def same_q(jq, tq, identical: bool) -> None:
    """Q within 0.1, and equal where the FASTA files are byte-identical."""
    if identical:
        assert jq == tq
    else:
        assert abs(jq - tq) <= 0.1, (jq, tq)
