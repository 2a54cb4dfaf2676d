"""The port's ``--mesh 8`` under device loss on the CPU, against the JAX
package's runs, on the corpus of ``tests/test_mesh.py``.

Every run writes the JAX package's ``mesh=8`` FASTA byte for byte (which
``test_torch_mesh_parity.py`` holds equal to the port's single-device
FASTA):

- ``device_lost:2`` shrinks the mesh 8 -> 4 (the partial-mesh rung), with
  no failover, the later shapes cold under ``:m4``; this run also takes the
  unstaged dispatch (``DACCORD_MESH_PIPELINE=0``: no ``dispatch.*`` rows);
- ``device_lost:2@3`` lands while the stager holds the next batch: the mesh
  shrinks around member 3 (``lost``), the host batch replays at ``:m4``,
  the staging goes on past the shrink; its ``mesh.*`` events, supervisor
  state chain and counters are the JAX run's.

The shadow audit's and the capacity governor's arms are in
``test_torch_mesh_audit.py``.
"""

import pytest

from daccord_tpu_torch.tools.eventcheck import validate_events

from _torch_mesh_common import events, make_corpus, run


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    c = make_corpus(str(tmp_path_factory.mktemp("torch_mesh_faults")))
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


def test_mesh_device_lost_partial_mesh_rung_unstaged(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv("DACCORD_FAULT", "device_lost:2")
    monkeypatch.setenv("DACCORD_MESH_PIPELINE", "0")
    ev = str(tmp_path / "lost.events.jsonl")
    assert run(corpus, mesh=8, events=ev) == corpus["jax_mesh"]
    evs = events(ev)
    kinds = _kinds(evs)
    assert "mesh.init" in kinds and "sup_failover" not in kinds
    shr = [e for e in evs if e["event"] == "mesh.shrink"]
    assert shr and shr[0]["nd_from"] == 8 and shr[0]["nd_to"] == 4 and shr[0]["culprit"] == -1
    done = [e for e in evs if e["event"] == "sup_done"][-1]
    assert done["mesh_shrinks"] >= 1 and not done["degraded"]
    assert any(":m4" in e["key"] for e in evs if e["event"] == "sup_compile")
    # the opt-out dispatches unstaged
    assert not {"dispatch.pipeline", "dispatch.stage", "dispatch.launch"} & set(kinds)
    assert [e["pack_s"] for e in evs if e["event"] == "shard_done"][-1] >= 0
    assert validate_events(ev, strict=True) == []


def _mesh_record(evs):
    """What the mesh and the supervisor did: the mesh.* events (their
    fields but wall clocks and dispatch counts), the state chain, and the
    counters."""
    mesh = [(e["event"], e.get("nd_from"), e.get("nd_to"), e.get("culprit"),
             e.get("device"), e.get("state")) for e in evs
            if e["event"] in ("mesh.shrink", "mesh.restore", "mesh.degrade")
            or (e["event"] == "mesh.device" and e.get("state") != "ok"
                and "rows" not in e)]
    chain = [(e["state_from"], e["state_to"]) for e in evs if e["event"] == "sup_state"]
    done = {k: v for k, v in [e for e in evs if e["event"] == "sup_done"][-1].items()
            if k not in ("t", "ts", "audit_s")}
    return mesh, chain, done


def test_pipelined_staged_replay_device_lost_attributed(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv("DACCORD_FAULT", "device_lost:2@3")
    ev, jev = str(tmp_path / "staged.events.jsonl"), str(tmp_path / "jax.events.jsonl")
    assert run(corpus, mesh=8, events=ev) == corpus["jax_mesh"]
    evs = events(ev)
    kinds = _kinds(evs)
    assert "dispatch.pipeline" in kinds and "sup_failover" not in kinds
    shr = [e for e in evs if e["event"] == "mesh.shrink"]
    assert shr and (shr[0]["nd_from"], shr[0]["nd_to"], shr[0]["culprit"]) == (8, 4, 3)
    lost = [e for e in evs if e["event"] == "mesh.device" and e["state"] == "lost"]
    assert lost and lost[0]["device"] == 3
    last = max(i for i, k in enumerate(kinds) if k == "mesh.shrink")
    assert "dispatch.stage" in kinds[last:]
    assert validate_events(ev, strict=True) == []
    # the JAX package's run under the same spec, its shapes cold too (a
    # registry of its own): the same rung, state chain and counters
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc_jax"))
    assert run(corpus, "jax", mesh=8, events=jev) == corpus["jax_mesh"]
    assert _mesh_record(evs) == _mesh_record(events(jev))
