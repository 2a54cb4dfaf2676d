"""The port's supervisor through its ``daccord`` on the CPU, against the
JAX package's run under the same ``DACCORD_FAULT`` spec.

For ``device_lost`` (failover to the port's ladder on the CPU),
``fetch_hang`` and ``dispatch_error`` (retry and recover): the FASTA is
byte-identical to the port's clean run, the event log passes
``eventcheck --strict``, and the ``sup_state`` transitions and the
supervisor's counters are the JAX run's. ``tests/test_torch_sdc.py`` holds
the capacity, corruption and audit kinds, ``tests/test_torch_failover.py``
the failover engines, the ledger and the flags.
"""

import pytest

from daccord_tpu_torch.tools.eventcheck import validate_events

from _torch_faults_common import make_base, run


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return make_base(str(tmp_path_factory.mktemp("torch_supervisor")))


@pytest.fixture(scope="module")
def jax_clean(base):
    """The JAX package's clean run (compiles its ladder for the module)."""
    return run(base, "jax", "clean", None, audit_rate=0)


@pytest.mark.parametrize("spec", ["device_lost:3", "fetch_hang:2", "dispatch_error:4"])
def test_fault_run_matches_clean_and_jax(base, jax_clean, spec):
    port = run(base, "port", spec.replace(":", "_"), spec, audit_rate=0)
    ref = run(base, "jax", spec.replace(":", "_"), spec, audit_rate=0)
    assert port["text"] == base["clean"]["text"]
    assert validate_events(port["ev"], strict=True) == []
    assert port["chain"] == ref["chain"] and port["chain"]
    assert port["done"] == ref["done"]
    st = port["stats"]
    if spec.startswith("device_lost"):
        assert st.degraded and "device_lost" in st.fallback_reason
        assert port["chain"][-2:] == [("SUSPECT", "LOST"), ("LOST", "DEGRADED")]
        assert port["done"][0]["state"] == "DEGRADED"
        assert any(r["event"] == "sup_failover" and r["fallback"] == "cpu-ladder"
                   for r in port["recs"])
    else:
        assert not st.degraded and st.sup_counters["retries"] == 1
        assert ("SUSPECT", "RETRYING") in port["chain"]
    assert st.sup_counters == {k: v for k, v in port["done"][0].items()
                               if k in st.sup_counters}


def test_clean_run_matches_jax_transitions(base, jax_clean):
    """Unfaulted: each cold shape (a dense bucket's batch shape) is a
    COMPILING -> HEALTHY pair, in both packages."""
    port = base["clean"]
    assert port["chain"] == jax_clean["chain"]
    assert port["chain"].count(("HEALTHY", "COMPILING")) == len(
        port["stats"].batches_by_bucket) >= 2
    assert port["done"] == jax_clean["done"]
    assert not port["stats"].degraded and port["stats"].batch_effective == 64
