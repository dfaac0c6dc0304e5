"""The port's transports and multi-host liveness
(``trpo_torch/serve/transport.py``, the leases of ``replicaset.py``)
against ``trpo_tpu``'s, and the contracts of the reference's
``tests/test_multihost_serve.py`` carried over to the port.

The hosts are named, the replicas in process (``TemplateTransport``'s
``launch_fn``), as the reference's own tests build them; a partition is
armed through the transport's ``partition`` gate, which the reference's
fault injector (ROADMAP.md Queue 1 item 18) calls. A session resumed on
the survivor is held within ``ROW_ATOL`` (1e-6) of the uninterrupted
one, categorical actions identical (ROADMAP.md Queue 3).
"""

import time

import numpy as np
import pytest

from test_torch_replicaset import _direct
from test_torch_router import port_agent, post
from trpo_torch.serve import (
    InProcessReplica,
    LocalExecTransport,
    PolicyServer,
    ReplicaSet,
    Router,
    TemplateTransport,
    TransportPartitioned,
    journal_path,
    read_carry_journal,
)
from trpo_tpu.serve import TemplateTransport as TpuTemplateTransport

ROW_ATOL = 1e-6


def _noop(*a):
    return None


@pytest.mark.parametrize("hosts, avoids", [
    (("h1", "h2", "h3"), [(), (), (), (), {"h2"}, {"h2"}, {"h1", "h3"},
                          {"h1", "h2", "h3"}, (), {"h9"}]),
    (("a",), [(), {"a"}, ()]),
    (("x", "y"), [{"x"}, {"x"}, (), {"y"}, ()]),
])
def test_template_transport_placement_matches_reference(hosts, avoids):
    got = []
    for cls in (TpuTemplateTransport, TemplateTransport):
        tr = cls(None, hosts, launch_fn=_noop)
        got.append(([tr.place(avoid=a) for a in avoids],
                    [tr.replica_name(h, "r5") for h in hosts]))
    assert got[1] == got[0]


def test_template_transport_validates_like_the_reference():
    for cls in (TpuTemplateTransport, TemplateTransport):
        for hosts in ((), ("a", "a"), ("a", "")):
            with pytest.raises(ValueError):
                cls(None, hosts, launch_fn=_noop)
        with pytest.raises(ValueError):
            cls("", ("a",))  # no template and no launch_fn
    with pytest.raises(ValueError):
        LocalExecTransport(None)


def test_gate_partition_expires_and_slow_pays_latency():
    tr = TemplateTransport(None, ("h1", "h2"), launch_fn=_noop)
    tr.partition("h1", 0.2)
    with pytest.raises(TransportPartitioned):
        tr.gate("h1")
    tr.gate("h2")
    time.sleep(0.25)
    assert tr.gate("h1") == 0.0  # healed by wall time
    tr.slow("h2", 30.0)
    t0 = time.perf_counter()
    assert tr.gate("h2") == 30.0 and tr.gate_delay("h2") == 30.0
    assert time.perf_counter() - t0 >= 0.025
    tr.slow("h2", 0.0)
    tr.partition("h1", 5.0)
    tr.heal("h1")
    assert tr.gate("h1") == 0.0 and tr.gate("h2") == 0.0
    assert not tr.same_host("h1")
    assert LocalExecTransport(_noop).same_host("local")


def test_local_transport_is_the_default():
    class _H:
        url = "http://127.0.0.1:1"

        def alive(self):
            return True

        def kill(self):
            pass

        def close(self):
            pass

    rs = ReplicaSet(lambda rid: _H(), 2, health_interval=60.0, backoff=0.01)
    try:
        assert isinstance(rs.transport, LocalExecTransport)
        assert rs.lease_ttl is None and rs.suspect_hosts() == frozenset()
        row = rs.snapshot()["replicas"]["r0"]
        assert row["host"] == "local" and row["lease_epoch"] == 0
        rs.note_transport_failure("local")  # untracked on one host
        assert rs.suspect_hosts() == frozenset()
    finally:
        rs.close()


def test_descriptor_discovery_bounded_budget_fails_launch_loudly():
    class _NeverDiscovers:
        def discover(self):
            return None

        def alive(self):
            return True

        def kill(self):
            pass

        def close(self):
            pass

    tr = TemplateTransport(None, ("h1",),
                           launch_fn=lambda host, rid, name:
                           _NeverDiscovers(),
                           discover_attempts=3, discover_backoff=0.01,
                           discover_backoff_cap=0.02)
    rs = ReplicaSet(None, 1, transport=tr, health_interval=60.0,
                    backoff=0.01, max_restarts=1)
    try:
        deadline = time.monotonic() + 30.0
        reasons = set()
        while time.monotonic() < deadline and rs.replicas[
                "r0"].state != "failed":
            rs.tick()
            if rs.replicas["r0"].last_death_reason:
                reasons.add(rs.replicas["r0"].last_death_reason)
            time.sleep(0.02)
        assert rs.replicas["r0"].state == "failed", rs.snapshot()
        assert rs.replicas["r0"].restarts == 1
        assert reasons and all("descriptor discovery" in r
                               for r in reasons), reasons
    finally:
        rs.close()


@pytest.fixture(scope="module")
def rec():
    return port_agent("cartpole-po", policy_gru=8,
                      serve_session_batch_shapes=(1, 4))


def _two_host_set(rec, jdir=None, lease_ttl=0.6, **kw):
    """Two named hosts, one in-process recurrent replica each, leases
    armed."""
    agent, state = rec

    def launch(host, rid, name):
        def factory():
            engine = agent.serve_session_engine()
            engine.load(state.policy_params, None, step=1)
            return PolicyServer(engine, None, port=0, replica_name=name,
                                carry_journal_dir=jdir,
                                carry_sync_every=1), []
        return InProcessReplica(factory)

    tr = TemplateTransport(None, ("h1", "h2"), launch_fn=launch)
    kw.setdefault("health_interval", 0.1)
    kw.setdefault("backoff", 0.1)
    kw.setdefault("max_restarts", 3)
    rs = ReplicaSet(None, 2, transport=tr, lease_ttl=lease_ttl, **kw)
    assert rs.wait_healthy(2, timeout=60.0), rs.snapshot()
    return rs


def test_lease_grant_partition_holds_until_expiry_then_replaces(rec):
    rs = _two_host_set(rec, lease_ttl=0.6)
    try:
        assert {r.host for r in rs.replicas.values()} == {"h1", "h2"}
        assert all(r.lease_epoch == 1 for r in rs.replicas.values())
        victim = next(r.id for r in rs.replicas.values() if r.host == "h1")
        rs.transport.partition("h1", 5.0)
        rs.tick()
        # partitioned is not dead: the lease decides
        assert rs.replicas[victim].state == "healthy"
        assert rs.lease_expiries_total == 0
        rs.tick()  # the second strike: h1 is suspect
        assert rs.suspect_hosts() == frozenset({"h1"})
        time.sleep(0.65)
        rs.tick()
        assert rs.replicas[victim].state == "evicted"
        assert rs.lease_expiries_total == 1
        assert rs.replicas[victim].last_death_reason.startswith(
            "lease expired (epoch 1")
        deadline = time.monotonic() + 15.0
        while (rs.replicas[victim].state != "healthy"
               and time.monotonic() < deadline):
            rs.tick()
            time.sleep(0.05)
        assert rs.replicas[victim].state == "healthy", rs.snapshot()
        assert rs.replicas[victim].host == "h2"  # away from the suspect
        assert rs.replicas[victim].lease_epoch == 2
    finally:
        rs.close()


def test_suspect_host_held_out_of_new_session_placement(rec):
    rs = _two_host_set(rec, lease_ttl=5.0)
    router = Router(rs, port=0)
    try:
        rs.note_transport_failure("h1")
        rs.note_transport_failure("h1")
        assert rs.suspect_hosts() == frozenset({"h1"})
        on_h2 = next(r.id for r in rs.replicas.values() if r.host == "h2")
        for _ in range(6):
            status, out = post(router.url + "/session")
            assert status == 200 and out["replica"] == on_h2, out
        rs.note_transport_failure("h2")
        rs.note_transport_failure("h2")
        assert post(router.url + "/session")[0] == 200  # degraded > dropped
    finally:
        router.close()
        rs.close()


def test_partition_failover_resumes_and_fences_the_zombie(rec, tmp_path):
    agent, state = rec
    jdir = str(tmp_path / "journal")
    rs = _two_host_set(rec, jdir=jdir, lease_ttl=0.6)
    router = Router(rs, port=0, journal_dir=jdir)
    try:
        status, out = post(router.url + "/session")
        sid, pinned = out["session"], out["replica"]
        host = rs.replicas[pinned].host
        zombie = rs.replicas[pinned].handle.server
        obs = np.random.default_rng(300).standard_normal(
            (8,) + agent.obs_shape).astype(np.float32)
        acts, carries = _direct(agent, state, obs)
        for t in range(4):
            status, out = post(router.url + f"/session/{sid}/act",
                               {"obs": obs[t].tolist()})
            assert status == 200 and out["action"] == acts[t]
        assert zombie.sessions.journal.drain(5.0)
        rs.transport.partition(host, 2.5)
        status, out = post(router.url + f"/session/{sid}/act",
                           {"obs": obs[4].tolist()})
        assert status == 200, out
        assert out["resumed"] is True and out["resumed_steps"] == 4
        assert out["action"] == acts[4]
        survivor = router._affinity[sid].replica
        assert rs.replicas[survivor].host != host
        # the partitioned-but-alive zombie answers a split-brain client,
        # but its journal write for the migrated session is fenced
        assert post(zombie.url + f"/session/{sid}/act",
                    {"obs": obs[5].tolist()})[0] == 200
        assert zombie.sessions.journal.drain(5.0)
        assert zombie.sessions.journal.fenced_writes_total >= 1
        entry = read_carry_journal(journal_path(jdir, pinned, host=host))
        assert entry[sid]["steps"] == 4
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            rs.tick()
            recd = rs.replicas[pinned]
            if recd.state == "healthy" and recd.restarts >= 1:
                break
            time.sleep(0.05)
        assert recd.state == "healthy" and recd.host != host
        for t in (5, 6, 7):
            status, out = post(router.url + f"/session/{sid}/act",
                               {"obs": obs[t].tolist()})
            assert status == 200 and out["action"] == acts[t]
        live = rs.replicas[survivor].handle.server.sessions.get(sid).carry
        np.testing.assert_allclose(np.asarray(live), carries[7],
                                   atol=ROW_ATOL, rtol=0)
    finally:
        router.close()
        rs.close()
