"""The port's ``--mesh 8`` under the shadow audit and the capacity governor
on the CPU, against the JAX package's mesh run, on the corpus of
``tests/test_mesh.py`` (the device-loss arms are in
``test_torch_mesh_faults.py``). Both runs write the JAX package's ``mesh=8``
FASTA byte for byte (which ``test_torch_mesh_parity.py`` holds equal to the
port's single-device FASTA):

- ``sdc:1@2`` at audit rate 1 (the samples solved in the audit worker
  process, as on the card) is caught, attributed to member 2 by the
  per-member re-solve, and strikes member 2's trust (TRUSTED -> SUSPECT),
  persisted in the trust registry under ``cpu:m2``;
- ``device_oom:2`` bisects in mesh multiples and ratchets the ``:m8`` key,
  persisted for the next run.
"""

import pytest

from daccord_tpu_torch.tools.eventcheck import validate_events

from _torch_mesh_common import events, make_corpus, run


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    c = make_corpus(str(tmp_path_factory.mktemp("torch_mesh_audit")))
    c["jax_mesh"] = run(c, "jax", mesh=8)
    assert c["jax_mesh"]
    return c


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    # injected faults' ratchets and trust strikes stay out of the real registry
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc"))
    monkeypatch.setenv("DACCORD_SUP_BACKOFF_S", "0.01")
    monkeypatch.delenv("DACCORD_FAULT", raising=False)
    monkeypatch.delenv("DACCORD_MESH_PIPELINE", raising=False)


def _kinds(evs):
    return [e["event"] for e in evs]


def test_mesh_sdc_detect_attribute_parity(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv("DACCORD_FAULT", "sdc:1@2")
    # below quarantine: this arm detects and attributes
    monkeypatch.setenv("DACCORD_TRUST_STRIKES", "99")
    ev = str(tmp_path / "sdc.events.jsonl")
    assert run(corpus, mesh=8, events=ev, audit_rate=1.0,
               audit_worker=True) == corpus["jax_mesh"]
    evs = events(ev)
    sdc = [e for e in evs if e["event"] == "sup_sdc"]
    assert sdc and sdc[0]["divergent"] >= 1
    attrib = [e for e in evs if e["event"] == "audit.attrib"]
    assert attrib and {e["culprit"] for e in sdc + attrib} == {2}
    trust = [e for e in evs if e["event"] == "trust.state"]
    assert trust and trust[0]["device"] == 2 and (trust[0]["state_from"],
                                                  trust[0]["state_to"]) == ("TRUSTED", "SUSPECT")
    assert "mesh.shrink" not in _kinds(evs) and "audit.disabled" not in _kinds(evs)
    done = [e for e in evs if e["event"] == "sup_done"][-1]
    assert done["sdc_detected"] >= 1 and done["audits"] >= 1
    from daccord_tpu_torch.utils.obs import trust_registry

    assert trust_registry()["cpu:m2"]["state"] == "SUSPECT"
    assert validate_events(ev, strict=True) == []


def test_mesh_device_oom_bisect_and_ratchet(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv("DACCORD_FAULT", "device_oom:2")
    monkeypatch.setenv("DACCORD_GOV_MIN_WIDTH", "2")
    ev = str(tmp_path / "oom.events.jsonl")
    assert run(corpus, mesh=8, events=ev) == corpus["jax_mesh"]
    evs = events(ev)
    assert "sup_failover" not in _kinds(evs)
    shrinks = [e for e in evs if e["event"] == "governor.shrink"]
    assert shrinks and all(e["width_to"] % 8 == 0 for e in shrinks)
    rats = [e for e in evs if e["event"] == "governor.ratchet"]
    assert rats and ":m8" in rats[0]["key"]
    from daccord_tpu_torch.runtime.governor import load_ratchets

    persisted = {k: v for k, v in load_ratchets().items() if ":m8" in k}
    assert persisted and list(persisted.values())[0] == rats[-1]["width"]
    assert validate_events(ev, strict=True) == []
