"""Window widths and top-M caps beyond the defaults, through the port's
``daccord`` on the CPU against the JAX package's run.

At ``-w 55`` and ``-w 56 --seg-len 80`` the consensus length is 63 and 64
(the multi-word rescore: the JAX package keeps two 32-bit words there), and
at ``-M 300`` the top-M exceeds 256 (the plain DP takes any width; the
first half of the piles, to keep the file short); each run gives the JAX
run's window and solved counts and its FASTA within ROADMAP's drift bound,
on the set of ROADMAP Queue 3 item 2.
"""

import pytest

from daccord_tpu_torch.sim import SimConfig, make_dataset

from _torch_wide_common import both_runs, within_drift


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_wide"))
    return root, make_dataset(root, SimConfig(genome_len=1000, coverage=10,
                                              read_len_mean=500, seed=5))


@pytest.mark.parametrize("tag,kw", [("w55", dict(w=55)),
                                    ("w56", dict(w=56, seg_len=80)),
                                    ("M300", dict(M=300, rescue_M=300))])
def test_wide_run_matches_jax(data, tag, kw):
    from daccord_tpu_torch.formats.las import shard_ranges

    root, d = data
    if tag == "M300":
        kw = dict(kw, start=shard_ranges(d["las"], 2)[0][0], end=shard_ranges(d["las"], 2)[0][1])
    js, ps, jr, pr = both_runs(d, root, tag, **kw)
    assert ps.n_windows == js.n_windows > 0
    assert ps.n_solved == js.n_solved
    assert within_drift(js, ps, jr, pr)
    if tag == "M300":
        assert ps.n_solved > 0
