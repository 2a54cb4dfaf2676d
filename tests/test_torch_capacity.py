"""The port's capacity governor through its ``daccord`` on the CPU,
against the JAX package's run under the same ``DACCORD_FAULT`` spec.

``device_oom`` (the governor bisects every shape that reaches the injected
ceiling, ratchets and merges) writes the port's clean FASTA byte for byte,
with the JAX run's ``sup_state`` transitions and counters; ``host_rss``
force-flushes without changing a byte, and ``monster_pile`` contains the
pile the JAX run contains.
"""

import pytest

from daccord_tpu_torch.tools.eventcheck import validate_events

from _torch_faults_common import make_base, run


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return make_base(str(tmp_path_factory.mktemp("torch_capacity")))


@pytest.fixture(scope="module")
def jax_clean(base):
    """The JAX package's clean run (compiles its ladder for the module)."""
    return run(base, "jax", "clean", None, audit_rate=0)


def test_device_oom_matches_clean_and_jax(base, jax_clean):
    spec = "device_oom:3"
    port = run(base, "port", "oom", spec, audit_rate=0)
    ref = run(base, "jax", "oom", spec, audit_rate=0)
    assert port["text"] == base["clean"]["text"]
    assert validate_events(port["ev"], strict=True) == []
    assert port["chain"] == ref["chain"] and port["chain"]
    assert port["done"] == ref["done"]
    st, done = port["stats"], port["done"][0]
    # the ceiling (half of 64) stays: every shape classifies once, then
    # dispatches at its ratcheted width
    assert st.n_capacity_events == done["gov_classify"] >= 1
    assert set(st.governor_ratchet.values()) == {32} and st.batch_effective == 32
    assert not st.degraded and done["retries"] == 0 and done["gov_shrink"] >= 1


def test_host_rss_and_monster_pile(base, jax_clean):
    """An injected hard memory watermark force-flushes every bucket and
    call in flight, with the clean bytes; an injected monster pile is the
    same pile the JAX run contains."""
    port = run(base, "port", "rss", "host_rss:3", audit_rate=0)
    assert port["text"] == base["clean"]["text"]
    bp = [r for r in port["recs"] if r["event"] == "governor.backpressure"]
    assert len(bp) == 1 and bp[0]["level"] == "hard" and port["stats"].n_backpressure == 1
    port = run(base, "port", "monster", "monster_pile:4", audit_rate=0)
    ref = run(base, "jax", "monster", "monster_pile:4", audit_rate=0)
    contained = [r["aread"] for r in port["recs"] if r["event"] == "governor.monster"]
    assert contained == [r["aread"] for r in ref["recs"] if r["event"] == "governor.monster"]
    assert len(contained) == 1 and port["stats"].n_monster_piles == 1
    assert f">read{contained[0]}/0" in port["text"]
