"""The port's replica set (``trpo_torch/serve/replicaset.py``) against
``trpo_tpu``'s, and the failover contracts of the reference's
``tests/test_failover.py`` carried over to the port.

The reference calls a session resumed from the carry journal on another
replica bit-exact with the uninterrupted session. Torch does not hold
that bit for bit: the survivor steps the session in an epoch of another
batch width, and the GEMMs round a row differently at another width
(ROADMAP.md Queue 3). So a resumed session is held here within
``ROW_ATOL`` (1e-6) of the uninterrupted one — carries and Gaussian
actions — with categorical actions identical.
"""

import os
import sys
import time

import numpy as np
import pytest

from test_torch_router import (
    make_set,
    port_agent,
    post,
    rec_factory,
)
from trpo_torch.serve import (
    InProcessReplica,
    MicroBatcher,
    PolicyServer,
    ReplicaSet,
    Router,
    SubprocessReplica,
    journal_path,
    read_fences,
    render_launch_argv,
)
from trpo_tpu.serve import ReplicaSet as TpuReplicaSet
from trpo_tpu.serve import render_launch_argv as tpu_render_launch_argv

ROW_ATOL = 1e-6

_TEMPLATES = [
    ("python -m trpo_torch.serve --port {port} --checkpoint-dir "
     "{checkpoint} --replica-name {replica}", dict(replica="r3")),
    ("ssh {host} 'serve --port {port} --ck {checkpoint}/x' --name "
     "{host}--{replica}", dict(replica="r0", host="h1")),
    ("run --port={port} {replica} {host}", dict()),
    ("a\\ b \"c d\" {checkpoint}", dict(host="h")),
]


@pytest.mark.parametrize("k", range(len(_TEMPLATES)))
def test_render_launch_argv_matches_reference(k):
    template, kw = _TEMPLATES[k]
    want = tpu_render_launch_argv(template, port=0, checkpoint="/c k", **kw)
    assert render_launch_argv(template, port=0, checkpoint="/c k",
                              **kw) == want
    for empty in ("", "   "):
        for fn in (tpu_render_launch_argv, render_launch_argv):
            with pytest.raises(ValueError, match="empty"):
                fn(empty, port=0, checkpoint="x")


def test_subprocess_replica_launches_the_port_cli():
    assert SubprocessReplica._build_command(["--port", "0"], None) == [
        sys.executable, "-m", "trpo_torch.serve", "--port", "0"]
    assert SubprocessReplica._build_command([], ["x", "y"]) == ["x", "y"]


@pytest.mark.slow  # spawns a child process
def test_subprocess_replica_discovers_its_descriptor(tmp_path):
    # a stale descriptor from an earlier attempt is never discovered
    d = tmp_path / "r0"
    d.mkdir()
    (d / "run.json").write_text('{"url": "http://stale"}')
    rep = SubprocessReplica([], str(d), command=[
        sys.executable, "-c", "import time; time.sleep(30)"])
    try:
        assert rep.discover() is None and rep.alive()
        (d / "run.json").write_text(
            '{"url": "http://127.0.0.1:9", "uds_path": "/tmp/u"}')
        assert rep.discover() == "http://127.0.0.1:9"
        assert rep.uds_path == "/tmp/u"
    finally:
        rep.kill()
    assert not rep.alive()


@pytest.mark.parametrize("kw", [
    dict(n_replicas=0), dict(health_interval=0), dict(max_restarts=-1),
    dict(backoff=2.0, backoff_cap=1.0), dict(lease_ttl=0.5),
    dict(suspect_after=0), dict(suspect_decay_s=0)])
def test_replicaset_validates_like_the_reference(kw):
    kw = {"n_replicas": 1, **kw}
    n = kw.pop("n_replicas")
    for cls in (TpuReplicaSet, ReplicaSet):
        with pytest.raises(ValueError):
            cls(lambda rid: None, n, **kw)


def test_replicaset_refuses_the_event_bus():
    # the bus is ported (it was refused before): each launch is a
    # schema-valid `router` replica record, as in the reference
    from trpo_torch.obs.events import EventBus, validate_event

    recs = []
    rs = ReplicaSet(lambda rid: None, 2, bus=EventBus(recs.append))
    rs.close()
    assert [(r["replica"], r["state"]) for r in recs] == [
        ("r0", "started"), ("r1", "started")]
    assert all(r["scope"] == "replica" and not validate_event(r)
               for r in recs)


def test_scale_out_ids_are_never_reused_and_drain_lifecycle():
    rs = make_set(_ff_make(*port_agent()), 2)
    try:
        assert rs.begin_drain("r1") and rs.snapshot()["replicas"]["r1"][
            "state"] == "draining"
        assert [r.id for r in rs.in_rotation()] == ["r0"]
        rs.abort_drain("r1")
        assert rs.begin_drain("r1") and rs.finish_drain("r1")
        assert "r1" not in rs.snapshot()["replicas"]
        assert rs.add_replica() == "r2"
        assert rs.wait_healthy(2, timeout=30)
        assert rs.active_size() == 2
        with rs.lock:
            rs.replicas["r0"].canary = True
        assert not rs.begin_drain("r0")  # never the canary
    finally:
        rs.close()


@pytest.fixture(scope="module")
def rec():
    return port_agent("cartpole-po", policy_gru=8,
                      serve_session_batch_shapes=(1, 4))


def _direct(agent, state, obs):
    """Actions and carries of one uninterrupted session stepped alone."""
    carry, acts, carries = None, [], []
    for o in obs:
        a, _, carry = agent.act(state, o, eval_mode=True, policy_carry=carry)
        acts.append(int(a))
        carries.append(carry.numpy().copy())
    return acts, carries


def _journaled_set(rec, jdir, n=2):
    agent, state = rec
    rs = make_set(lambda rid: rec_factory(
        agent, state.policy_params, replica_name=rid,
        carry_journal_dir=jdir), n)
    return rs, Router(rs, port=0, journal_dir=jdir)


def test_pinned_replica_kill_resumes_from_journal(rec, tmp_path):
    agent, state = rec
    jdir = str(tmp_path / "carry")
    rs, router = _journaled_set(rec, jdir)
    try:
        status, out = post(router.url + "/session")
        sid, pinned = out["session"], out["replica"]
        obs = np.random.default_rng(1).standard_normal(
            (8,) + agent.obs_shape).astype(np.float32)
        acts, carries = _direct(agent, state, obs)
        for t in range(5):
            status, out = post(router.url + f"/session/{sid}/act",
                               {"obs": obs[t].tolist()})
            assert status == 200 and out["action"] == acts[t]
        rs.replicas[pinned].handle.server.sessions.journal.drain()
        rs.replicas[pinned].handle.kill()
        status, out = post(router.url + f"/session/{sid}/act",
                           {"obs": obs[5].tolist()})
        assert status == 200, out
        assert out["resumed"] is True and out["resumed_steps"] == 5
        assert out["session_steps"] == 6 and out["action"] == acts[5]
        assert (router.sessions_resumed_total,
                router.sessions_reestablished_total) == (1, 0)
        for t in (6, 7):
            status, out = post(router.url + f"/session/{sid}/act",
                               {"obs": obs[t].tolist()})
            assert status == 200 and "resumed" not in out
            assert out["action"] == acts[t]
        survivor = rs.replicas[({"r0", "r1"} - {pinned}).pop()]
        live = survivor.handle.server.sessions.get(sid).carry
        np.testing.assert_allclose(np.asarray(live), carries[7],
                                   atol=ROW_ATOL, rtol=0)
        # the lost replica's journal is fenced against a zombie writer
        assert sid in read_fences(journal_path(jdir, pinned))
    finally:
        router.close()
        rs.close()


def test_replica_restart_empty_store_resumes_via_journal(rec, tmp_path):
    agent, state = rec
    rs, router = _journaled_set(rec, str(tmp_path / "carry"))
    try:
        status, out = post(router.url + "/session")
        sid, pinned = out["session"], out["replica"]
        obs = np.random.default_rng(2).standard_normal(
            (3,) + agent.obs_shape).astype(np.float32)
        acts, _ = _direct(agent, state, obs)
        for t in range(2):
            assert post(router.url + f"/session/{sid}/act",
                        {"obs": obs[t].tolist()})[0] == 200
        rs.replicas[pinned].handle.server.sessions.journal.drain()
        rs.replicas[pinned].handle.kill()
        rs.tick()
        time.sleep(0.1)
        rs.tick()
        rs.tick()
        assert rs.snapshot()["replicas"][pinned]["state"] == "healthy"
        status, out = post(router.url + f"/session/{sid}/act",
                           {"obs": obs[2].tolist()})
        assert status == 200, out
        assert out["resumed"] is True and out["resumed_steps"] == 2
        assert out["action"] == acts[2]
    finally:
        router.close()
        rs.close()


def test_lost_journal_falls_back_to_a_fresh_carry(rec, tmp_path):
    agent, state = rec
    jdir = str(tmp_path / "carry")
    rs, router = _journaled_set(rec, jdir)
    try:
        status, out = post(router.url + "/session")
        sid, pinned = out["session"], out["replica"]
        obs = np.random.default_rng(3).standard_normal(
            (3,) + agent.obs_shape).astype(np.float32)
        for t in range(2):
            assert post(router.url + f"/session/{sid}/act",
                        {"obs": obs[t].tolist()})[0] == 200
        rs.replicas[pinned].handle.kill()
        os.remove(journal_path(jdir, pinned))
        status, out = post(router.url + f"/session/{sid}/act",
                           {"obs": obs[2].tolist()})
        assert status == 200 and out["reestablished"] is True
        assert "resumed" not in out
        fresh, _ = _direct(agent, state, obs[2:3])
        assert out["action"] == fresh[0]
        assert router.sessions_reestablished_total == 1
    finally:
        router.close()
        rs.close()


def test_typed_refusals_pass_through_the_router(rec, tmp_path):
    """``/act`` on a recurrent set and ``/session`` on a feedforward one
    answer the replica's typed 409 through the router; ``/reload`` on an
    unmanaged replica is a typed 409 ``unmanaged``."""
    rs, router = _journaled_set(rec, str(tmp_path / "carry"), n=1)
    try:
        status, out = post(router.url + "/act", {"obs": [0.0] * 2})
        assert status == 409 and out["code"] == "wrong_protocol"
        assert "/session" in out["error"]
        status, out = post(rs.replicas["r0"].url + "/reload", {"step": 2})
        assert status == 409 and out["code"] == "unmanaged"
    finally:
        router.close()
        rs.close()
    rs = make_set(_ff_make(*port_agent()), 1)
    router = Router(rs, port=0)
    try:
        status, out = post(router.url + "/session")
        assert status == 409 and out["code"] == "wrong_protocol"
        assert router.sessions_created_total == 0
    finally:
        router.close()
        rs.close()


def _loaded(agent, state):
    engine = agent.serve_engine()
    engine.load(state.policy_params, None, step=1)
    return engine


def _ff_make(agent, state):
    def make(rid):
        def factory():
            engine = _loaded(agent, state)
            batcher = MicroBatcher(engine, deadline_ms=5.0)
            return PolicyServer(engine, batcher, port=0), [batcher]
        return factory
    return make


def test_router_retries_5xx_once_and_passes_through_as_last_resort():
    agent, state = port_agent("pendulum")

    def make(broken):
        def inner(rid):
            def factory():
                engine = _loaded(agent, state)
                batcher = MicroBatcher(engine, deadline_ms=5.0)
                if rid in broken:  # an engine failure: the handler's 500
                    batcher.submit = lambda obs: (_ for _ in ()).throw(
                        RuntimeError("wedged"))
                return PolicyServer(engine, batcher, port=0), [batcher]
            return factory
        return inner

    obs = [0.0] * 3
    rs = make_set(make({"r0"}), 2)
    router = Router(rs, port=0)
    try:
        for _ in range(4):
            status, out = post(router.url + "/act", {"obs": obs})
            assert status == 200 and "action" in out
        assert router.retried_total >= 1 and router.failed_total == 0
    finally:
        router.close()
        rs.close()
    rs = make_set(make({"r0"}), 1)
    router = Router(rs, port=0)
    try:
        status, out = post(router.url + "/act", {"obs": obs})
        assert status == 500 and "inference failed" in out["error"]
        assert router.backpressure_total == router.failed_total == 0
    finally:
        router.close()
        rs.close()


def test_canary_fraction_routes_stateless_only():
    rs = make_set(_ff_make(*port_agent()), 2)
    router = Router(rs, port=0, canary_fraction=0.5)
    try:
        with rs.lock:
            rs.replicas["r1"].canary = True
        for _ in range(8):
            assert post(router.url + "/act", {"obs": [0.0] * 4})[0] == 200
        assert len(router.replica_latencies_ms("r1")) == 4
        for _ in range(6):
            rid = router._pick(stateless=False)
            assert rid == "r0"
            router._release(rid)
        with rs.lock:
            rs.replicas["r0"].inflight = router.max_inflight
        assert router._pick(stateless=False) == "r1"  # degraded > dropped
    finally:
        router.close()
        rs.close()


def test_in_process_replica_kill_stops_serving(rec, tmp_path):
    agent, state = rec
    rep = InProcessReplica(rec_factory(
        agent, state.policy_params, replica_name="r0",
        carry_journal_dir=str(tmp_path / "carry")))
    assert rep.alive() and rep.url and rep.uds_path is None
    assert post(rep.url + "/session")[0] == 200
    rep.kill()
    assert not rep.alive()
    with pytest.raises(OSError):
        post(rep.url + "/session", timeout=2.0)
    rep.close()  # a no-op after a kill
