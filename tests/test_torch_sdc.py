"""The port's silent-corruption injection and shadow audit through its
``daccord`` on the CPU, against the JAX package's run under the same
``DACCORD_FAULT`` spec.

``sdc`` (the audit catches the corrupted batch and re-solves it on the
reference) and ``compile_stall`` (a cold shape's heartbeat) each write the
port's clean FASTA byte for byte, with the JAX run's ``sup_state``
transitions and counters; an audit of every window of a clean run finds
nothing. ``tests/test_torch_capacity.py`` holds the capacity kinds.
"""

import pytest

from daccord_tpu_torch.tools.eventcheck import validate_events

from _torch_faults_common import make_base, run


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return make_base(str(tmp_path_factory.mktemp("torch_sdc")))


@pytest.fixture(scope="module")
def jax_clean(base):
    """The JAX package's clean run (compiles its ladder for the module)."""
    return run(base, "jax", "clean", None, audit_rate=0)


# sdc corrupts every solved row of one batch; a quarter of each batch is
# audited, so the corrupted batch is caught in both packages (same seeded
# sample, same batches)
CASES = {"sdc:2": 0.25, "compile_stall": 0.0}


@pytest.mark.parametrize("spec", sorted(CASES))
def test_fault_run_matches_clean_and_jax(base, jax_clean, spec):
    port = run(base, "port", spec.replace(":", "_"), spec, audit_rate=CASES[spec])
    ref = run(base, "jax", spec.replace(":", "_"), spec, audit_rate=CASES[spec])
    assert port["text"] == base["clean"]["text"]
    assert validate_events(port["ev"], strict=True) == []
    assert port["chain"] == ref["chain"] and port["chain"]
    assert port["done"] == ref["done"]
    st, done = port["stats"], port["done"][0]
    if spec.startswith("sdc"):
        assert done["sdc_detected"] == 1 and st.sup_counters["audits"] == done["audits"] > 0
        sdc = [r for r in port["recs"] if r["event"] == "sup_sdc"]
        assert len(sdc) == 1 and sdc[0]["culprit"] == -1
        assert [(r["state_from"], r["state_to"]) for r in port["recs"]
                if r["event"] == "trust.state"] == [("TRUSTED", "SUSPECT")]
        assert st.audit_s > 0
    else:
        assert done["heartbeats"] == 1


def test_audit_of_every_window_finds_nothing_on_a_clean_run(base):
    """``--audit-rate 1``: every window solved again on the reference, byte
    for byte the same; no ``sup_sdc``."""
    port = run(base, "port", "audit1", None, audit_rate=1.0)
    assert port["text"] == base["clean"]["text"]
    assert not any(r["event"] == "sup_sdc" for r in port["recs"])
    assert port["done"][0]["audits"] == port["stats"].n_batches
    assert port["done"][0]["sdc_detected"] == 0
