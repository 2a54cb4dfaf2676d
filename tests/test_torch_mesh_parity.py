"""The port's ``--mesh 8`` on the CPU against the JAX package's, on the
corpus of ``tests/test_mesh.py``: the dense, paged and split runs each write
the port's single-device FASTA and the JAX package's ``mesh=8`` FASTA byte
for byte (windows solve independently, so sharding cannot change a byte).
The dense run also carries the staged dispatch's telemetry
(``dispatch.pipeline`` at depth 2, a ``dispatch.stage`` and a
``dispatch.launch`` row per batch, ``shard_done``'s pack/stage/launch walls
summing to its dispatch wall), each member's ``mesh.device`` row and a
clean ``eventcheck --strict``. The fault arms are in
``test_torch_mesh_faults.py``."""

import pytest

from daccord_tpu_torch.tools.eventcheck import validate_events

from _torch_mesh_common import events, make_corpus, run


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    c = make_corpus(str(tmp_path_factory.mktemp("torch_mesh_parity")))
    c["single"] = run(c)
    c["jax_mesh"] = run(c, "jax", mesh=8)
    assert c["single"] and c["single"] == c["jax_mesh"]
    return c


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("DACCORD_COMPCACHE", str(tmp_path / "cc"))
    monkeypatch.delenv("DACCORD_FAULT", raising=False)
    monkeypatch.delenv("DACCORD_MESH_PIPELINE", raising=False)


def test_mesh_dense_parity_and_staged_telemetry(corpus, tmp_path):
    ev = str(tmp_path / "dense.events.jsonl")
    assert run(corpus, mesh=8, events=ev) == corpus["single"]
    evs = events(ev)
    init = [e for e in evs if e["event"] == "mesh.init"]
    assert init and init[0]["nd"] == 8 and init[0]["devices"] == "mesh8-cpu-ladder"
    assert init[0]["esc_cap"] == 8                # 64 rows over 8 members
    pipe = [e for e in evs if e["event"] == "dispatch.pipeline"]
    assert pipe and pipe[0]["depth"] == 2
    stg = [e for e in evs if e["event"] == "dispatch.stage"]
    lch = [e for e in evs if e["event"] == "dispatch.launch"]
    assert stg and len(stg) == len(lch) and all(e["stage_s"] >= 0 and e["rows"] > 0
                                                for e in stg)
    done = [e for e in evs if e["event"] == "shard_done"][-1]
    sub = done["pack_s"] + done["stage_s"] + done["launch_s"]
    assert abs(sub - done["dispatch_s"]) <= max(0.05, 0.05 * done["dispatch_s"])
    assert done["restaged"] == 0 and done["mesh"] == 8
    dev = [e for e in evs if e["event"] == "mesh.device"]
    assert {e["device"] for e in dev} == set(range(8))
    assert all(e["state"] == "ok" and e["rows"] > 0 and 0.0 <= e["busy_frac"] <= 1.0
               for e in dev)
    sup = [e for e in evs if e["event"] == "sup_done"][-1]
    assert sup["mesh_shrinks"] == 0 and sup["fetch"] < sup["dispatch"]
    assert all(":m8" in e["key"] for e in evs if e["event"] == "sup_compile")
    assert validate_events(ev, strict=True) == []


def test_mesh_paged_parity(corpus):
    """The page table shards, every member gets the pool: same bytes."""
    assert run(corpus, mesh=8, paged="on") == corpus["single"]


def test_mesh_split_ladder_parity(corpus, tmp_path):
    """``:t0`` and ``:m<N>`` compose: Stream A runs tier 0 on every member,
    the rescue pools flush as mesh-wide Stream B batches."""
    ev = str(tmp_path / "split.events.jsonl")
    assert run(corpus, mesh=8, ladder_mode="split", events=ev) == corpus["single"]
    keys = {e["key"] for e in events(ev) if e["event"] == "sup_compile"}
    assert any(k.endswith(":t0:m8") for k in keys) and any(
        k.endswith(":m8") and ":t0" not in k for k in keys)
