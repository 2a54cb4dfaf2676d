"""The shared-filesystem lease protocol of the port (``utils/lease.py``)
against the JAX package's, on the CPU.

Each test of ``tests/test_lease.py`` has a counterpart of the same name
here. The protocol units run on the port's module; the cross-package tests
hold the two modules to one file format: a lease one package claims, the
other reads, refuses to steal while fresh, takes over once stale and
releases only as its holder (the JAX fleet's shard leases included, so a
port serve peer and a JAX fleet share one lease directory).
"""

import json
import os

import pytest

from daccord_tpu.utils import lease as jax_lease
from daccord_tpu_torch.utils import lease


def test_lease_claim_renew_takeover_units(tmp_path):
    p = str(tmp_path / "leases" / "job.lease")
    ok, takeover = lease.claim(p, "hostA", ttl_s=60.0)
    assert ok and takeover is None
    # a live lease loses the race
    ok, takeover = lease.claim(p, "hostB", ttl_s=60.0)
    assert not ok and takeover is None
    # a stale lease is taken over, reporting the previous holder
    lease.backdate(p, age_s=120.0)
    ok, takeover = lease.claim(p, "hostB", ttl_s=60.0)
    assert ok and takeover["prev_host"] == "hostA"
    assert takeover["stale_s"] > 60.0
    lease.release(p)
    ok, _ = lease.claim(p, "hostC", ttl_s=60.0)
    assert ok


def test_lease_payload_extra_and_read(tmp_path):
    """The payload carries host, pid and claimed_t plus the caller's extras;
    the JAX package reads the port's payload field for field."""
    p = str(tmp_path / "j.lease")
    ok, _ = lease.claim(p, "me", 60.0, extra={"job": "j00001", "nbytes": 42})
    assert ok
    info = lease.read(p)
    assert info["host"] == "me" and info["pid"] == os.getpid()
    assert info["job"] == "j00001" and info["nbytes"] == 42
    assert isinstance(info["claimed_t"], float)
    assert jax_lease.read(p) == info
    assert lease.read_result(p) == jax_lease.read_result(p) == (info, "ok")


def test_holder_checked_release(tmp_path):
    """A holder that was taken over must not delete the taker's lease, in
    either package's hands."""
    for claimer, taker in ((lease, jax_lease), (jax_lease, lease)):
        p = str(tmp_path / f"j-{claimer.__name__.split('.')[0]}.lease")
        claimer.claim(p, "old", 60.0)
        claimer.backdate(p, 120.0)
        ok, tk = taker.claim(p, "taker", 60.0)
        assert ok and tk["prev_host"] == "old"
        claimer.release(p, host="old")      # the old holder's release: refused
        assert lease.read(p)["host"] == "taker"
        taker.release(p, host="taker")      # the taker's own: allowed
        assert lease.read(p) is None and jax_lease.read(p) is None


def test_torn_lease_still_takeover_able(tmp_path):
    """A killed claimer's torn (non-JSON) lease reads as None (``torn`` in
    both packages) and is taken over once stale, the previous holder
    unknown."""
    p = str(tmp_path / "j.lease")
    with open(p, "w") as fh:
        fh.write('{"host": "torn')
    assert lease.read(p) is None
    assert lease.read_result(p) == jax_lease.read_result(p) == (None, "torn")
    assert lease.read_result(str(tmp_path / "none")) == (None, "absent")
    lease.backdate(p, 120.0)
    ok, tk = lease.claim(p, "taker", 60.0)
    assert ok and tk["prev_host"] == "?"
    assert lease.read(p)["host"] == "taker"


def test_renew_and_stale_s(tmp_path):
    p = str(tmp_path / "j.lease")
    assert lease.stale_s(p) is None
    lease.claim(p, "me", 60.0)
    lease.backdate(p, 30.0)
    s = lease.stale_s(p)
    assert s is not None and 29.0 < s < 35.0
    assert abs(jax_lease.stale_s(p) - s) < 5.0
    assert lease.renew(p)
    assert lease.stale_s(p) < 5.0
    # a renew of a vanished lease is tolerated (taken over mid-heartbeat)
    lease.release(p)
    assert not lease.renew(p)


def test_fleet_wrappers_delegate(tmp_path):
    """The JAX fleet's (outdir, shard) lease wrappers and the port's module
    share one protocol: a claim made through the fleet's API is visible to
    the port, which cannot steal it while fresh and whose holder-checked
    release leaves it alone; a port claim is the fleet's to read."""
    from daccord_tpu.parallel import fleet as fleet_mod

    d = str(tmp_path)
    ok, _ = fleet_mod.claim_lease(d, 3, "orchA", ttl_s=60.0)
    assert ok
    p = fleet_mod.lease_path(d, 3)
    info = lease.read(p)
    assert info["host"] == "orchA" and info["shard"] == 3
    ok, _ = lease.claim(p, "orchB", 60.0)
    assert not ok
    lease.release(p, host="orchB")                 # not the holder: refused
    assert fleet_mod.read_lease(d, 3)["host"] == "orchA"
    fleet_mod.release_lease(d, 3, host="orchA")
    assert fleet_mod.read_lease(d, 3) is None
    ok, _ = lease.claim(p, "portC", 60.0, extra={"shard": 3})
    assert ok and fleet_mod.read_lease(d, 3)["host"] == "portC"


def test_vacancy_claim_after_release_race(tmp_path):
    """A lease released between a claimant's failed O_EXCL create and its
    stat is a vacancy: the claim wins it."""
    p = str(tmp_path / "j.lease")
    ok, _ = lease.claim(p, "a", 60.0)
    assert ok
    lease.release(p, host="a")
    ok, tk = lease.claim(p, "b", 60.0)
    assert ok and tk is None
    assert json.load(open(p))["host"] == "b"


@pytest.mark.parametrize("kind", ["io_enospc", "io_eio"])
def test_a_refused_claim_or_renew_never_raises(tmp_path, kind):
    """Under an injected refusal of the ``lease`` domain (ENOSPC or a
    transient EIO), a claim and then a renew never raise and end as the JAX
    package's do, file and all."""
    from daccord_tpu.runtime.faults import FaultPlan as JaxFaultPlan
    from daccord_tpu.utils import aio as jax_aio
    from daccord_tpu_torch.runtime.faults import FaultPlan
    from daccord_tpu_torch.utils import aio

    got = []
    for mod, a, plan in ((lease, aio, FaultPlan), (jax_lease, jax_aio, JaxFaultPlan)):
        p = str(tmp_path / f"{mod.__name__.split('.')[0]}.lease")
        a.install_faults(plan.parse(f"{kind}:1@lease,{kind}:2@lease"))
        try:
            claimed = mod.claim(p, "me", 60.0)
            renewed = mod.renew(p)
        finally:
            a.install_faults(None)
        got.append((claimed, renewed, os.path.exists(p)))
    assert got[0] == got[1]
