"""The port's homopolymer rescue against the JAX package's, on the CPU.

``oracle/hp.py`` function by function on seeded windows (damaged by a
length-dependent run-length channel, and clean), the host library's
``hp_rescue_windows`` against the JAX package's copy and against the port's
python loop for each vote and acceptance, and the pipeline's hp pass end to
end on an hp-sloped simulation: a ``--device cpu --hp-rescue`` run rescues
windows, lowers the error and stays within ROADMAP's drift bound of the JAX
package's ``--hp-rescue`` run on its CPU ladder, and the python loop
(``--no-native``) and the split ladder write the same records.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from daccord_tpu.oracle import hp as jax_hp
from daccord_tpu.oracle.consensus import ConsensusConfig as JaxConsensusConfig
from daccord_tpu.oracle.consensus import make_offset_likely as jax_make_offset_likely
from daccord_tpu.oracle.profile import ErrorProfile as JaxErrorProfile
from daccord_tpu_torch.formats.dazzdb import read_db
from daccord_tpu_torch.formats.fasta import read_fasta
from daccord_tpu_torch.native.api import NativeLadder
from daccord_tpu_torch.oracle import hp
from daccord_tpu_torch.oracle.align import edit_distance_sum
from daccord_tpu_torch.oracle.consensus import ConsensusConfig, make_offset_likely
from daccord_tpu_torch.oracle.profile import ErrorProfile
from daccord_tpu_torch.runtime.pipeline import PipelineConfig, _hp_pass
from daccord_tpu_torch.sim import SimConfig, make_dataset, score_vs_truth
from daccord_tpu_torch.tools import cli

#: a fitted profile with length-dependent indels (the posterior's gate is a
#: slope of 0.1), and one of clean data
HP_PROFILE = dict(p_ins=0.061, p_del=0.043, p_sub=0.012, hp_slope=0.62,
                  hp_base=0.031, hp_cap=8)
FLAT_PROFILE = dict(p_ins=0.071, p_del=0.041, p_sub=0.015, hp_slope=0.02,
                    hp_base=0.0, hp_cap=8)
VOTES = [("median", "rescore"), ("posterior", "rescore"), ("posterior", "likelihood")]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The tier-1 run puts several test files side by side on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _truth(rng, n: int = 40) -> np.ndarray:
    """A window's true bases, built run by run (runs of 1-7 bases)."""
    out, last = [], -1
    while len(out) < n:
        b = int(rng.integers(0, 4))
        if b == last:
            continue
        out.extend([b] * int(min(7, rng.geometric(0.45))))
        last = b
    return np.asarray(out[:n], dtype=np.int8)


def _noisy(rng, seg, slope: float, p_ind: float = 0.12, p_sub: float = 0.02):
    """Length-dependent run-length noise (the simulator's hp channel in
    miniature): per-base deletions and geometric same-base insertions, both
    scaled by 1 + slope * (run - 1), insertions 2:1 over deletions."""
    c, runs = hp.hp_compress(seg)
    out = []
    for b, r in zip(c, runs):
        f = 1 + slope * min(int(r) - 1, 8)
        pd = min(0.45, p_ind * f / 3)
        pi = min(0.45, 2 * p_ind * f / 3)
        rr = 0
        for _ in range(int(r)):
            if rng.random() >= pd:
                rr += 1
            rr += rng.geometric(1 - pi) - 1
        out.extend([b] * rr)
    s = np.asarray(out, dtype=np.int8)
    subm = rng.random(len(s)) < p_sub
    if subm.any():
        s[subm] = (s[subm] + rng.integers(1, 4, subm.sum())) % 4
    return s[:64]


@functools.lru_cache(maxsize=None)
def _windows(seed: int, n: int = 24, depth: int = 18):
    """(truth, segments) windows: the first two thirds hp-damaged, the rest
    clean (slope 0, fewer indels)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = _truth(rng)
        slope, p_ind = (1.0, 0.12) if i < 2 * n // 3 else (0.0, 0.04)
        out.append((t, [_noisy(rng, t, slope, p_ind) for _ in range(depth)]))
    return out


def _profiles(fields: dict):
    return ErrorProfile(**fields), JaxErrorProfile(**fields)


def _direct(truth: np.ndarray, rng) -> np.ndarray:
    """A plausible wrong direct consensus: one run of the truth one base
    longer or shorter."""
    c, runs = hp.hp_compress(truth)
    i = int(rng.integers(0, len(runs)))
    runs = runs.copy()
    runs[i] = max(1, runs[i] + (1 if rng.random() < 0.5 else -1))
    return hp.hp_expand(c, runs)


def test_compress_expand_and_max_run_equal_jax():
    for truth, segs in _windows(1):
        for s in [truth, *segs, np.zeros(0, np.int8), truth[:1]]:
            c, r = hp.hp_compress(s)
            jc, jr = jax_hp.hp_compress(s)
            assert np.array_equal(c, jc) and np.array_equal(r, jr)
            assert c.dtype == jc.dtype and r.dtype == jr.dtype
            assert np.array_equal(hp.hp_expand(c, r), s)
            assert np.array_equal(hp.hp_expand(c, r), jax_hp.hp_expand(jc, jr))
            assert hp.max_run(s) == jax_hp.max_run(s)
    assert hp.HP_TIER == jax_hp.HP_TIER == 29
    assert (hp.HP_HEAT_LO, hp.HP_HEAT_HI, hp.HP_HEAT_STEP, hp.HP_HEAT_N) == (
        jax_hp.HP_HEAT_LO, jax_hp.HP_HEAT_HI, jax_hp.HP_HEAT_STEP, jax_hp.HP_HEAT_N)


@pytest.mark.parametrize("fields", [HP_PROFILE, FLAT_PROFILE], ids=["hp", "flat"])
def test_length_tables_and_heat_equal_jax(fields):
    prof, jprof = _profiles(fields)
    for mult in (1.0, 1.25, 2.0, 3.0):
        t = hp.hp_length_tables(prof, mult=mult)
        jt = jax_hp.hp_length_tables(jprof, mult=mult)
        assert t.dtype == jt.dtype and np.array_equal(t.view(np.uint64), jt.view(np.uint64))
    for derr in (0.0, 0.05, 0.13, 0.2874, 0.6, float("inf")):
        for p_err in (0.0, 0.0005, 0.12):
            assert hp.hp_heat(derr, p_err) == jax_hp.hp_heat(derr, p_err)


def test_votes_and_loglik_equal_jax():
    prof, jprof = _profiles(HP_PROFILE)
    rng = np.random.default_rng(7)
    n_posterior_moves = 0
    for truth, segs in _windows(2):
        comp = [hp.hp_compress(s) for s in segs]
        jcomp = [jax_hp.hp_compress(s) for s in segs]
        for cand in (truth, _direct(truth, rng)):
            cc = hp.hp_compress(cand)[0]
            med = hp.vote_runs(cc, comp)
            assert np.array_equal(med, jax_hp.vote_runs(cc, jcomp))
            for mult in (1.0, 2.5):
                ltab = hp.hp_length_tables(prof, mult=mult)
                post = hp.vote_runs_posterior(cc, comp, ltab)
                assert np.array_equal(post, jax_hp.vote_runs_posterior(
                    cc, jcomp, jax_hp.hp_length_tables(jprof, mult=mult)))
                n_posterior_moves += int(np.any(post != med))
                for lam in (1.0, 3.0):
                    a = hp.hp_loglik(cand, comp, ltab, lam)
                    b = jax_hp.hp_loglik(cand, jcomp, jax_hp.hp_length_tables(
                        jprof, mult=mult), lam)
                    assert np.float64(a).view(np.uint64) == np.float64(b).view(np.uint64)
    assert n_posterior_moves > 0, "the posterior vote never differed from the median"


@pytest.mark.parametrize("vote,accept", VOTES)
def test_hp_candidate_equals_jax(vote, accept):
    prof, jprof = _profiles(HP_PROFILE)
    cfg = ConsensusConfig(hp_rescue=True, hp_vote=vote, hp_accept=accept)
    jcfg = JaxConsensusConfig(hp_rescue=True, hp_vote=vote, hp_accept=accept)
    ols, jols = make_offset_likely(prof, cfg), jax_make_offset_likely(jprof, jcfg)
    rng = np.random.default_rng(11)
    n_taken = n_seen = 0
    for truth, segs in _windows(3):
        tot = sum(len(s) for s in segs)
        for direct in (None, _direct(truth, rng), truth):
            derr = (float("inf") if direct is None
                    else edit_distance_sum(direct, segs) / tot)
            a = hp.hp_candidate(segs, direct, derr, ols, cfg)
            b = jax_hp.hp_candidate(segs, direct, derr, jols, jcfg)
            n_seen += 1
            assert (a is None) == (b is None)
            if a is not None:
                n_taken += 1
                assert np.array_equal(a.seq, b.seq) and a.seq.dtype == b.seq.dtype
                assert a.err == b.err and (a.k, a.reason) == (b.k, b.reason)
    assert 0 < n_taken < n_seen


def _batch(seed: int):
    """The windows of :func:`_windows` as a dense [B, D, L] batch."""
    wins = _windows(seed)
    B, D, L = len(wins), max(len(s) for _, s in wins), 64
    seqs = np.full((B, D, L), 4, dtype=np.int8)
    lens = np.zeros((B, D), dtype=np.int32)
    nsegs = np.zeros(B, dtype=np.int32)
    for b, (_, segs) in enumerate(wins):
        nsegs[b] = len(segs)
        for d, s in enumerate(segs):
            seqs[b, d, :len(s)] = s
            lens[b, d] = len(s)
    return SimpleNamespace(seqs=seqs, lens=lens, nsegs=nsegs)


@pytest.mark.parametrize("vote,accept", VOTES)
def test_native_hp_rescue_equals_jax_and_python_loop(vote, accept):
    """``NativeLadder.hp_rescue`` (the host library) equals the JAX
    package's C++ pass and the pipeline's python loop on the same direct
    results: rows, lengths, errors and tiers."""
    from daccord_tpu.native import available as jax_native_available

    prof, jprof = _profiles(HP_PROFILE)
    cfg = ConsensusConfig(hp_rescue=True, hp_vote=vote, hp_accept=accept)
    ols = make_offset_likely(prof, cfg)
    batch = _batch(4)
    nl = NativeLadder(ols, cfg, max_kmers=64)
    direct = nl.solve(batch, n_threads=2)
    assert direct["solved"].any() and (direct["err"][direct["solved"]] > cfg.hp_err).any()

    def copy():
        return {k: np.array(v) for k, v in direct.items()}

    port = copy()
    n_port = nl.hp_rescue(batch, port, n_threads=2)
    loop = copy()
    n_loop = _hp_pass(loop, batch.seqs, batch.lens, batch.nsegs,
                      PipelineConfig(consensus=cfg), ols, None, 1)
    assert n_port == n_loop > 0
    rows = [port]
    if jax_native_available():
        from daccord_tpu.native.api import NativeLadder as JaxNativeLadder

        jcfg = JaxConsensusConfig(hp_rescue=True, hp_vote=vote, hp_accept=accept)
        jax_out = copy()
        n_jax = JaxNativeLadder(jax_make_offset_likely(jprof, jcfg), jcfg,
                                max_kmers=64).hp_rescue(batch, jax_out, n_threads=2)
        assert n_jax == n_port
        rows.append(jax_out)
    for other in rows:
        assert np.array_equal(other["tier"], loop["tier"])
        assert np.array_equal(other["cons_len"], loop["cons_len"])
        assert np.array_equal(other["err"].view(np.uint32), loop["err"].view(np.uint32))
        assert np.array_equal(other["solved"], loop["solved"])
        for i in np.nonzero(loop["solved"])[0]:
            n = int(loop["cons_len"][i])
            assert np.array_equal(other["cons"][i, :n], loop["cons"][i, :n])


def test_config_validation_equals_jax():
    for kw in (dict(hp_vote="mean"), dict(hp_accept="ratio"),
               dict(tiers=((8, 2, 2),) * 30)):
        with pytest.raises(ValueError) as ours:
            ConsensusConfig(**kw)
        with pytest.raises(ValueError) as theirs:
            JaxConsensusConfig(**kw)
        assert str(ours.value) == str(theirs.value)
    ConsensusConfig(tiers=((8, 2, 2),) * 29)


# ---------------------------------------------------------------------------
# the pipeline on an hp-sloped simulation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hp_set(tmp_path_factory):
    """The JAX package's hp end-to-end set, its profile estimated once (with
    the hp rescue on, as an hp run estimates it) and shared by every run."""
    root = tmp_path_factory.mktemp("hp")
    d = make_dataset(str(root), SimConfig(genome_len=4000, coverage=18,
                                          read_len_mean=900, min_overlap=300,
                                          hp_indel_slope=1.0, seed=31), name="hp")
    eprof = str(root / "eprof.json")
    assert cli.daccord_run([d["db"], d["las"], "-E", eprof, "--eprof-only",
                            "--device", "cpu", "--hp-rescue"])[0] is None
    return dict(d=d, root=root, eprof=eprof, runs={})


def _port(hp_set, name: str, *extra):
    """One port run over the set (cached by name): (stats, records)."""
    runs = hp_set["runs"]
    if name not in runs:
        out = str(hp_set["root"] / f"{name}.fasta")
        stats, _ = cli.daccord_run([hp_set["d"]["db"], hp_set["d"]["las"], "-o", out,
                                    "-E", hp_set["eprof"], "-b", "256", *extra])
        runs[name] = (stats, out, {r.name: r.seq for r in read_fasta(out)})
    return runs[name]


def _error(hp_set, fasta: str) -> float:
    d = hp_set["d"]
    return score_vs_truth(fasta, d["truth"], read_db(d["db"]))[0]


def test_cpu_hp_run_rescues_and_matches_jax(hp_set):
    from daccord_tpu.runtime.pipeline import PipelineConfig as JaxPipelineConfig
    from daccord_tpu.runtime.pipeline import correct_to_fasta as jax_correct_to_fasta

    on, f_on, rec_on = _port(hp_set, "cpu_hp", "--device", "cpu", "--hp-rescue")
    off, f_off, _ = _port(hp_set, "cpu", "--device", "cpu")
    assert on.n_hp_rescued > 0 and on.tier_histogram.get(hp.HP_TIER, 0) > 0
    assert off.n_hp_rescued == 0 and on.hp_wall_s > 0
    e_on, e_off = _error(hp_set, f_on), _error(hp_set, f_off)
    assert e_on < e_off, (e_on, e_off)

    jax_out = str(hp_set["root"] / "jax_cpu_hp.fasta")
    js = jax_correct_to_fasta(
        hp_set["d"]["db"], hp_set["d"]["las"], jax_out,
        JaxPipelineConfig(batch_size=256, audit_rate=0,
                          consensus=JaxConsensusConfig(hp_rescue=True)),
        profile=JaxErrorProfile.load(hp_set["eprof"]))
    jrec = {r.name: r.seq for r in read_fasta(jax_out)}
    same = sum(rec_on.get(n) == s for n, s in jrec.items())
    print(f"hp: rescued port {on.n_hp_rescued} / jax {js.n_hp_rescued}, error "
          f"{e_on:.5f} (off {e_off:.5f}), identical records {same}/{len(jrec)}, "
          f"bases port {on.bases_out} / jax {js.bases_out}")
    assert abs(on.n_hp_rescued - js.n_hp_rescued) <= 0.005 * on.n_windows
    assert abs(on.bases_out - js.bases_out) <= 0.005 * js.bases_out
    assert same >= 0.95 * len(jrec) and abs(len(rec_on) - len(jrec)) <= 0.05 * len(jrec)


@pytest.mark.parametrize("extra", [("--no-native",), ("--ladder", "split")],
                         ids=["python-loop", "split"])
def test_hp_variants_write_the_same_records(hp_set, extra):
    """The python hp loop and the split ladder (its Stream A rows get their
    hp pass when their Stream B rows land) write the records the host
    library's pass over the fused ladder writes; a shard keeps it short."""
    _, _, rec_on = _port(hp_set, "cpu_hp", "--device", "cpu", "--hp-rescue")
    stats, _, rec = _port(hp_set, "shard_" + "_".join(extra), "--device", "cpu",
                          "--hp-rescue", "-J", "0,3", *extra)
    assert stats.n_hp_rescued > 0 and len(rec) > 0
    reads = {n.split("/")[0] for n in rec}
    assert rec == {n: s for n, s in rec_on.items() if n.split("/")[0] in reads}


def test_hp_profile_pass_equals_jax(hp_set):
    """With the hp rescue on, the profile pass's sample windows go through
    ``solve_window``'s hp branch in both packages: the same profile."""
    from daccord_tpu.formats.dazzdb import read_db as jax_read_db
    from daccord_tpu.formats.las import LasFile as JaxLasFile
    from daccord_tpu.runtime.pipeline import PipelineConfig as JaxPipelineConfig
    from daccord_tpu.runtime.pipeline import estimate_profile_for_shard as jax_estimate
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.runtime.pipeline import estimate_profile_for_shard

    d = hp_set["d"]
    jp = jax_estimate(jax_read_db(d["db"]), JaxLasFile(d["las"]),
                      JaxPipelineConfig(consensus=JaxConsensusConfig(hp_rescue=True)))
    pp = estimate_profile_for_shard(read_db(d["db"]), LasFile(d["las"]),
                                    PipelineConfig(device="cpu",
                                                   consensus=ConsensusConfig(hp_rescue=True)))
    assert vars(pp) == vars(jp)
    assert vars(ErrorProfile.load(hp_set["eprof"])) == vars(pp)
    assert pp.hp_slope >= 0.1
