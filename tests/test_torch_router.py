"""The port's routing front end (``trpo_torch/serve/router.py``) against
``trpo_tpu``'s, and the contracts of the reference's
``tests/test_router.py`` carried over to the port.

Parity: the same requests through the port's ``Router`` over two port
replicas and through the reference's ``Router`` over two reference
replicas, on the same params (moved across with ``trpo_torch/convert``):
categorical actions identical, Gaussian actions within ``GAUSS_ATOL``
(1e-6; the matmuls sum in another order on the two CPU backends), the
same statuses, error codes and checkpoint steps. The router's pure
decisions (``_pick`` with its canary stride, the retry budget, deadline
admission) are fed the same inputs in both packages and must agree
exactly. The reference's event bus is ROADMAP.md Queue 1 item 18; where
its tests read events, these read the router's counters and the replica
set's snapshot.

The helpers here (agents with shared params, replica factories, sets
driven by hand) are imported by the other control-plane test files.
"""

import ast
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig
from trpo_torch.convert import policy_params_from_numpy
from trpo_torch.serve import (
    InProcessReplica,
    MicroBatcher,
    PolicyServer,
    ReplicaSet,
    Router,
    wire,
)
from trpo_torch.serve import replicaset as port_replicaset
from trpo_torch.utils.checkpoint import Checkpointer
from trpo_tpu.agent import TRPOAgent as TpuAgent
from trpo_tpu.config import TRPOConfig as TpuConfig
from trpo_tpu.serve import InProcessReplica as TpuInProcessReplica
from trpo_tpu.serve import MicroBatcher as TpuBatcher
from trpo_tpu.serve import PolicyServer as TpuServer
from trpo_tpu.serve import ReplicaSet as TpuReplicaSet
from trpo_tpu.serve import Router as TpuRouter
from trpo_tpu.serve import replicaset as tpu_replicaset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAUSS_ATOL = 1e-6

FF_CFG = dict(
    n_envs=4, batch_timesteps=32, cg_iters=2, vf_train_steps=2,
    policy_hidden=(8,), vf_hidden=(8,), seed=11,
    serve_batch_shapes=(1, 2),
)


def port_agent(env="cartpole", **kw):
    """A CPU port agent and its seed-0 state."""
    agent = TRPOAgent(env, TRPOConfig(**{**FF_CFG, "env": env, **kw}),
                      device="cpu")
    return agent, agent.init_state(seed=0)


def shared_agents(env, **kw):
    """``(ref_agent, ref_params, port_agent, port_params)``: the reference
    agent's seed-0 policy params and the same numbers in torch."""
    cfg = {**FF_CFG, "env": env, **kw}
    ref = TpuAgent(env, TpuConfig(**cfg))
    port = TRPOAgent(env, TRPOConfig(**cfg), device="cpu")
    ref_params = ref.init_state(seed=0).policy_params
    params = policy_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params))
    return ref, ref_params, port, params


def ff_factory(agent, params, step=1, server_cls=PolicyServer,
               batcher_cls=MicroBatcher, **server_kw):
    """``factory()`` of one feedforward replica on ``params``."""
    def factory():
        engine = agent.serve_engine()
        engine.load(params, None, step=step)
        batcher = batcher_cls(engine, deadline_ms=5.0)
        return server_cls(engine, batcher, port=0, **server_kw), [batcher]
    return factory


def rec_factory(agent, params, step=1, server_cls=PolicyServer,
                **server_kw):
    """``factory()`` of one recurrent (session) replica on ``params``."""
    def factory():
        engine = agent.serve_session_engine()
        engine.load(params, None, step=step)
        return server_cls(engine, None, port=0, **server_kw), []
    return factory


def make_set(make_factory, n, set_cls=ReplicaSet,
             replica_cls=InProcessReplica, **kw):
    """A replica set driven by MANUAL ticks (no supervisor thread, a long
    poll interval), so a test decides when supervision happens."""
    kw.setdefault("health_interval", 60.0)
    kw.setdefault("backoff", 0.05)
    kw.setdefault("health_fail_threshold", 1)
    kw.setdefault("max_restarts", 2)
    rs = set_cls(lambda rid: replica_cls(make_factory(rid)), n, **kw)
    assert rs.wait_healthy(n, timeout=60.0), rs.snapshot()
    return rs


def post(url, payload=None, timeout=30.0, headers=None):
    """``(status, body)``, HTTP errors included; ``payload`` may be bytes
    already."""
    data = (payload if isinstance(payload, bytes) else b"" if payload is None
            else json.dumps(payload).encode())
    req = urllib.request.Request(
        url, data=data,
        headers=headers or {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, ctype = r.read(), r.headers.get("Content-Type", "")
            status = r.status
    except urllib.error.HTTPError as e:
        raw, ctype, status = e.read(), e.headers.get("Content-Type", ""), \
            e.code
    if ctype.startswith(wire.WIRE_CONTENT_TYPE):
        scalars, arrays = wire.decode_frame(raw)
        return status, dict(scalars, **{k: v.tolist()
                                        for k, v in arrays.items()})
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, {"text": raw.decode()}


def get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def get_json(url, timeout=10.0):
    return json.loads(get(url, timeout))


def metric_families(text):
    """``{family: sorted label-name tuples}`` of a Prometheus text body."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        labels = ()
        if "{" in line:
            inner = line.split("{", 1)[1].split("}", 1)[0]
            labels = tuple(sorted(kv.split("=", 1)[0]
                                  for kv in inner.split(",")))
        out.setdefault(name, set()).add(labels)
    return out


def both_routed(env, make, n=2, router_kw=None, **agent_kw):
    """The reference's and the port's replica sets and routers over the
    same params: ``[(router, set), (router, set)]``, reference first."""
    ref, ref_params, port, params = shared_agents(env, **agent_kw)
    out = []
    for agent, p, set_cls, rep_cls, router_cls, server_cls, batcher_cls in (
            (ref, ref_params, TpuReplicaSet, TpuInProcessReplica,
             TpuRouter, TpuServer, TpuBatcher),
            (port, params, ReplicaSet, InProcessReplica, Router,
             PolicyServer, MicroBatcher)):
        kw = dict(server_cls=server_cls)
        if make is ff_factory:
            kw["batcher_cls"] = batcher_cls
        rs = make_set(lambda rid: make(agent, p, **kw), n, set_cls=set_cls,
                      replica_cls=rep_cls)
        out.append((router_cls(rs, port=0, **(router_kw or {})), rs))
    return out, port


def close_all(pairs):
    for router, rs in pairs:
        router.close()
        rs.close()


def _act_requests(obs_dim, n=6):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        obs = rng.standard_normal(obs_dim).astype(np.float32)
        out.append(({"obs": obs.tolist()}, None))
        out.append((wire.encode_frame(None, {"obs": obs}),
                    {"Content-Type": wire.WIRE_CONTENT_TYPE,
                     "Accept": wire.WIRE_CONTENT_TYPE}))
    out += [({"obs": [1.0]}, None), (b"nope{", None), ({"nope": 1}, None)]
    return out


@pytest.mark.parametrize("env", ["cartpole", "pendulum"])
def test_act_through_router_matches_reference(env):
    pairs, port = both_routed(env, ff_factory)
    try:
        answers = [[post(router.url + "/act", body, headers=h)
                    for body, h in _act_requests(port.obs_shape[0])]
                   for router, _ in pairs]
        for (ws, want), (gs, got) in zip(*answers):
            assert gs == ws and got.get("code") == want.get("code")
            assert got.get("step") == want.get("step")
            if "action" not in want:
                continue
            if env == "cartpole":
                assert got["action"] == want["action"]
            else:
                np.testing.assert_allclose(got["action"], want["action"],
                                           atol=GAUSS_ATOL, rtol=0)
        status = [get_json(router.url + "/status") for router, _ in pairs]
        assert set(status[1]) == set(status[0])
        for key in ("counters", "data_plane"):
            assert set(status[1][key]) == set(status[0][key])
        assert set(status[1]["replicas"]["r0"]) >= set(
            status[0]["replicas"]["r0"])
        assert status[1]["counters"] == status[0]["counters"]
        fams = [metric_families(get(router.url + "/metrics"))
                for router, _ in pairs]
        assert fams[1] == fams[0]
        assert [json.loads(get(router.url + "/healthz"))
                for router, _ in pairs][1] == json.loads(
                    get(pairs[0][0].url + "/healthz"))
    finally:
        close_all(pairs)


def test_session_through_router_matches_reference():
    pairs, port = both_routed("cartpole-po", rec_factory, policy_gru=8,
                              serve_session_batch_shapes=(1, 4))
    try:
        rng = np.random.default_rng(9)
        obs = rng.standard_normal((20,) + port.obs_shape).astype(np.float32)
        runs = []
        for router, _ in pairs:
            status, out = post(router.url + "/session")
            assert status == 200 and out["replica"] in ("r0", "r1")
            sid, mine = out["session"], []
            for t in range(20):
                binary = t % 2 == 1
                body = (wire.encode_frame(None, {"obs": obs[t]}) if binary
                        else {"obs": obs[t].tolist()})
                headers = ({"Content-Type": wire.WIRE_CONTENT_TYPE,
                            "Accept": wire.WIRE_CONTENT_TYPE}
                           if binary else None)
                status, out = post(router.url + f"/session/{sid}/act",
                                   body, headers=headers)
                assert status == 200, out
                mine.append({k: v for k, v in out.items() if k != "session"})
            runs.append(mine)
        assert runs[1] == runs[0]
    finally:
        close_all(pairs)


# ---------------------------------------------------------------------------
# pure decisions, the same inputs to both packages
# ---------------------------------------------------------------------------


class _FakeSet:
    """The replica set's rotation interface over plain records: its
    ``in_rotation`` is the real set's own method run on these records."""

    def __init__(self, module, rows, suspect=()):
        self._module = module
        self.lock = threading.Lock()
        self.replicas = {}
        for rid, (state, inflight, canary, host) in rows.items():
            rec = module.ReplicaRecord(rid)
            rec.state, rec.inflight, rec.canary, rec.host = (
                state, inflight, canary, host)
            rec.url = "http://127.0.0.1:1"
            self.replicas[rid] = rec
        self._suspect = frozenset(suspect)

    def in_rotation(self):
        return self._module.ReplicaSet.in_rotation(self)

    def suspect_hosts(self):
        return self._suspect

    def get(self, rid):
        return self.replicas.get(rid)

    def snapshot(self):
        return self._module.ReplicaSet.snapshot(self)


_PICK_CASES = {
    "least_loaded": ({"r0": ("healthy", 1, False, "local"),
                      "r1": ("healthy", 0, False, "local")}, (), ()),
    "tie_by_id": ({"r1": ("healthy", 0, False, "local"),
                   "r0": ("healthy", 0, False, "local")}, (), ()),
    "exclusion": ({"r0": ("healthy", 3, False, "local"),
                   "r1": ("healthy", 0, False, "local")}, ("r1",), ()),
    "saturated": ({"r0": ("healthy", 4, False, "local"),
                   "r1": ("healthy", 4, False, "local")}, (), ()),
    "reloading_only": ({"r0": ("reloading", 2, False, "local"),
                        "r1": ("reloading", 1, False, "local"),
                        "r2": ("evicted", 0, False, "local")}, (), ()),
    "healthy_before_reloading": ({"r0": ("reloading", 0, False, "local"),
                                  "r1": ("healthy", 3, False, "local")},
                                 (), ()),
    "suspect_avoided": ({"r0": ("healthy", 0, False, "a"),
                         "r1": ("healthy", 2, False, "b")}, (), ("a",)),
    "only_suspect": ({"r0": ("healthy", 1, False, "a")}, (), ("a",)),
    "draining_skipped": ({"r0": ("draining", 0, False, "local"),
                          "r1": ("healthy", 3, False, "local")}, (), ()),
}


@pytest.mark.parametrize("case", sorted(_PICK_CASES))
def test_pick_matches_reference(case):
    rows, exclude, suspect = _PICK_CASES[case]
    picks = []
    for module, router_cls in ((tpu_replicaset, TpuRouter),
                               (port_replicaset, Router)):
        fake = _FakeSet(module, rows, suspect)
        router = router_cls(fake, port=0, max_inflight=4)
        try:
            got = [router._pick(exclude=exclude) for _ in range(3)]
            picks.append((got, {rid: r.inflight
                                for rid, r in fake.replicas.items()}))
        finally:
            router.close()
    assert picks[1] == picks[0]


def test_canary_stride_over_100_stateless_requests_matches_reference():
    rows = {"r0": ("healthy", 0, False, "local"),
            "r1": ("healthy", 0, True, "local"),
            "r2": ("healthy", 0, False, "local")}
    seqs = []
    for module, router_cls in ((tpu_replicaset, TpuRouter),
                               (port_replicaset, Router)):
        fake = _FakeSet(module, rows)
        router = router_cls(fake, port=0, canary_fraction=0.3)
        try:
            seq = []
            for i in range(100):
                rid = router._pick(stateless=i % 7 != 0)
                router._release(rid)
                seq.append(rid)
            seq.append([router._pick(want_canary=w) for w in (True, False)])
            seqs.append(seq)
        finally:
            router.close()
    assert seqs[1] == seqs[0]
    assert seqs[1].count("r1") == 25  # 0.3 of the 86 stateless picks


def test_retry_budget_bucket_matches_reference():
    # (seconds since the last take, ...): the bucket holds 2, refills 1/s
    script = [0, 0, 0, 0.4, 0.7, 0, 2.5, 0, 0, 0, 10, 0]
    outcomes = []
    for module, router_cls in ((tpu_replicaset, TpuRouter),
                               (port_replicaset, Router)):
        router = router_cls(_FakeSet(module, {}), port=0, retry_budget=2.0,
                            retry_refill_per_sec=1.0)
        try:
            got = []
            for dt in script:
                router._retry_stamp = time.monotonic() - dt
                got.append(router._take_retry_token())
            outcomes.append((got, router.retries_skipped_total))
        finally:
            router.close()
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][0][:4] == [True, True, False, False]


@pytest.mark.parametrize("deadline", [None, 5, 30.0, 49, 51, 1000, True])
def test_admission_check_matches_reference(deadline):
    lats = [float(x) for x in np.linspace(1.0, 50.0, 40)]
    bodies = [json.dumps({"obs": [0.0] * 4, "deadline_ms": deadline}
                         ).encode(),
              b'["deadline_ms"]', b'{"deadline_ms": oops']
    frame = wire.encode_frame({"deadline_ms": deadline},
                              {"obs": np.zeros(4, np.float32)})
    answers = []
    for module, router_cls in ((tpu_replicaset, TpuRouter),
                               (port_replicaset, Router)):
        router = router_cls(_FakeSet(module, {}), port=0,
                            min_latency_samples=16)
        try:
            now = time.monotonic()
            router._adm_lats.extend((now, ms) for ms in lats)
            got = []
            for body in bodies:
                got.append(router._admission_check(body))
            got.append(router._admission_check(frame, headers={
                "Content-Type": wire.WIRE_CONTENT_TYPE}))
            router._adm_lats.clear()
            router._adm_lats.extend((now - 11.0, ms) for ms in lats)
            got.append(router._admission_check(bodies[0]))  # stale window
            answers.append(([None if a is None else (a[0], json.loads(a[2]))
                             for a in got], router.shed_deadline_total))
        finally:
            router.close()
    assert answers[1] == answers[0]


# ---------------------------------------------------------------------------
# the reference's contracts, on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ff():
    return port_agent()


def _ff_set(ff, n, **kw):
    agent, state = ff
    return make_set(lambda rid: ff_factory(agent, state.policy_params), n,
                    **kw)


@pytest.mark.parametrize("core", ["async", "thread"])
def test_least_loaded_dispatch_saturation_and_client_errors(ff, core):
    rs = _ff_set(ff, 2)
    router = Router(rs, port=0, max_inflight=2, core=core)
    try:
        with rs.lock:
            rs.replicas["r0"].inflight = 1
        assert router._pick() == "r1"
        assert router._pick(exclude=("r1",)) == "r0"
        with rs.lock:
            rs.replicas["r0"].inflight = rs.replicas["r1"].inflight = 2
        assert router._pick() is None
        status, out = post(router.url + "/act", {"obs": [0, 0, 0, 0]})
        assert status == 503 and "saturated" in out["error"]
        assert router.backpressure_total == 1
        with rs.lock:
            rs.replicas["r0"].inflight = 1
            rs.replicas["r1"].inflight = 0
        status, out = post(router.url + "/act", {"obs": [0, 0, 0, 0]})
        assert status == 200 and out["step"] == 1
        with rs.lock:
            rs.replicas["r0"].inflight = 0
            assert all(r.inflight == 0 for r in rs.replicas.values())
        # client errors pass through, never retried
        assert post(router.url + "/act", {"obs": [1.0]})[0] == 400
        assert post(router.url + "/act", {"nope": 1})[0] == 400
        assert router.retried_total == 0
        assert post(router.url + "/nope", {})[0] == 404
    finally:
        router.close()
        rs.close()


@pytest.mark.parametrize("core", ["async", "thread"])
def test_retry_on_death_is_exactly_once_with_zero_client_errors(ff, core):
    rs = _ff_set(ff, 2)
    router = Router(rs, port=0, core=core)
    try:
        rs.replicas["r0"].handle.kill()
        errors = [out for status, out in (
            post(router.url + "/act", {"obs": [0, 0, 0, 0]})
            for _ in range(12)) if status != 200]
        assert not errors
        assert router.retried_total == 1 and router.failed_total == 0
        row = rs.snapshot()["replicas"]["r0"]
        assert row["state"] == "evicted"
        assert row["last_death_reason"] == (
            "router observed transport failure")
        time.sleep(0.15)
        rs.tick()  # relaunch
        rs.tick()  # healthz -> healthy
        row = rs.snapshot()["replicas"]["r0"]
        assert row["state"] == "healthy" and row["restarts"] == 1
        assert post(router.url + "/act", {"obs": [0, 0, 0, 0]})[0] == 200
    finally:
        router.close()
        rs.close()


def test_single_replica_death_is_a_failure_not_a_phantom_retry(ff):
    rs = _ff_set(ff, 1)
    router = Router(rs, port=0)
    try:
        rs.replicas["r0"].handle.kill()
        status, out = post(router.url + "/act", {"obs": [0, 0, 0, 0]})
        assert status == 502, out
        assert (router.failed_total, router.retried_total,
                router.backpressure_total) == (1, 0, 0)
        status, out = post(router.url + "/act", {"obs": [0, 0, 0, 0]})
        assert status == 503 and out["error"] == "no replicas in rotation"
    finally:
        router.close()
        rs.close()


def test_crash_budget_fails_the_replica_never_the_set(ff):
    rs = _ff_set(ff, 2, max_restarts=1)
    router = Router(rs, port=0)
    try:
        for _ in range(2):
            rs.replicas["r0"].handle.kill()
            rs.tick()
            time.sleep(0.15)
            rs.tick()
            rs.tick()
        row = rs.snapshot()["replicas"]["r0"]
        assert row["state"] == "failed" and row["restarts"] == 1
        assert "crash budget exhausted (1)" in row["last_death_reason"]
        for _ in range(3):
            assert post(router.url + "/act", {"obs": [0, 0, 0, 0]})[0] == 200
    finally:
        router.close()
        rs.close()


def test_reload_takes_replica_out_of_rotation_zero_drops(ff, tmp_path):
    agent, state = ff
    Checkpointer(str(tmp_path / "ck")).save(1, state)
    gate = threading.Event()

    def make_factory(rid):
        def factory():
            engine = agent.serve_engine()
            batcher = MicroBatcher(engine, deadline_ms=5.0)

            def slow_snapshot(st):
                if rid == "r0":
                    gate.wait(timeout=30.0)  # holds r0's reload open
                return st.policy_params, st.obs_norm

            server = PolicyServer(
                engine, batcher, port=0,
                checkpointer=Checkpointer(str(tmp_path / "ck")),
                template=agent.init_state(), snapshot_fn=slow_snapshot,
                poll_interval=0.05 if rid == "r0" else 60.0)
            return server, [batcher]
        return factory

    gate.set()
    rs = make_set(make_factory, 2)
    router = Router(rs, port=0)
    try:
        gate.clear()
        Checkpointer(str(tmp_path / "ck")).save(2, state)
        deadline = time.time() + 15.0
        while (rs.snapshot()["replicas"]["r0"]["state"] != "reloading"
               and time.time() < deadline):
            rs.tick()
            time.sleep(0.02)
        assert [r.id for r in rs.in_rotation()] == ["r1"]
        for _ in range(8):
            assert post(router.url + "/act", {"obs": [0, 0, 0, 0]})[0] == 200
        gate.set()
        deadline = time.time() + 15.0
        while time.time() < deadline:
            rs.tick()
            row = rs.snapshot()["replicas"]["r0"]
            if row["state"] == "healthy" and row["loaded_step"] == 2:
                break
            time.sleep(0.02)
        assert row["state"] == "healthy" and row["loaded_step"] == 2
        assert row["restarts"] == 0
    finally:
        gate.set()
        router.close()
        rs.close()


def test_session_affinity_ttl_and_dead_replica_reestablishment():
    agent, state = port_agent("cartpole-po", policy_gru=8,
                              serve_session_batch_shapes=(1, 4))
    rs = make_set(lambda rid: rec_factory(
        agent, state.policy_params, replica_name=rid, session_ttl_s=0.25), 2)
    router = Router(rs, port=0)
    try:
        status, out = post(router.url + "/session")
        assert status == 200
        sid, pinned = out["session"], out["replica"]
        rng = np.random.default_rng(0)
        obs = rng.standard_normal((4,) + agent.obs_shape).astype(np.float32)
        direct, carry = [], None
        for o in obs:
            a, _, carry = agent.act(state, o, eval_mode=True,
                                    policy_carry=carry)
            direct.append(int(a))
        for t in range(3):
            status, out = post(router.url + f"/session/{sid}/act",
                               {"obs": obs[t].tolist()})
            assert status == 200 and out["action"] == direct[t]
            assert "reestablished" not in out
        rs.replicas[pinned].handle.kill()
        status, out = post(router.url + f"/session/{sid}/act",
                           {"obs": obs[0].tolist()})
        assert status == 200 and out.get("reestablished") is True
        assert out["action"] == direct[0]  # a fresh carry on the survivor
        assert router.sessions_reestablished_total == 1
        time.sleep(0.6)  # TTL: the replica forgets the idle session
        status, out = post(router.url + f"/session/{sid}/act",
                           {"obs": obs[0].tolist()})
        assert status == 404 and out["code"] == "session_unknown"
        status, out = post(router.url + "/session/feedfeed/act",
                           {"obs": obs[0].tolist()})
        assert status == 404 and out["code"] == "session_unknown"
        for body in ([1, 2], "strings too"):
            assert post(router.url + "/session", body)[0] == 400
        assert post(router.url + "/session", {"session_id": "x"})[0] == 400
    finally:
        router.close()
        rs.close()


def test_router_status_and_metrics_aggregate_the_set(ff):
    rs = _ff_set(ff, 2)
    router = Router(rs, port=0)
    try:
        for _ in range(4):
            assert post(router.url + "/act", {"obs": [0, 0, 0, 0]})[0] == 200
        doc = get_json(router.url + "/status")
        assert doc["size"] == 2 and doc["healthy"] == 2
        assert doc["counters"]["routed_total"] == 4
        assert doc["latency_samples"] == 4 and "0.5" in doc["latency_ms"]
        metrics = get(router.url + "/metrics")
        assert "trpo_router_replicas 2" in metrics
        assert ('trpo_router_replica_state{replica="r0",state="healthy"} 1'
                in metrics)
        assert "trpo_router_routed_total 4" in metrics
        for ln in metrics.splitlines():
            if ln and not ln.startswith("#"):
                float(ln.rsplit(" ", 1)[1])
        assert get_json(router.url + "/healthz") == {
            "ok": True, "healthy": 2, "replicas": 2}
    finally:
        router.close()
        rs.close()


def test_same_host_hops_dial_the_replica_unix_socket(ff, tmp_path,
                                                     monkeypatch):
    agent, state = ff
    # relative to the test's directory: an absolute path under a deep
    # temporary directory can pass AF_UNIX's 107 bytes
    monkeypatch.chdir(tmp_path)
    sock = "s"
    rs = make_set(lambda rid: ff_factory(agent, state.policy_params,
                                         uds_path=f"{sock}.{rid}"), 2)
    router = Router(rs, port=0, uds_path=sock)
    try:
        for _ in range(4):
            assert post(router.url + "/act", {"obs": [0, 0, 0, 0]})[0] == 200
        assert router.dispatch_transport_total == {"tcp": 0, "uds": 4}
        # a socket path past sockaddr_un's limit fails loudly
        long_path = str(tmp_path / ("x" * 120))
        with pytest.raises(ValueError, match="AF_UNIX takes at most 107"):
            Router(rs, port=0, uds_path=long_path)
        rec = rs.replicas["r0"]
        rec.uds_path = long_path
        with pytest.raises(ValueError, match="107"):
            router._dial_plan(rec)
    finally:
        router.close()
        rs.close()


def test_router_refuses_item_18_hooks_and_bad_arguments(ff):
    rs = _ff_set(ff, 1)
    try:
        # the bus, the tracer, the injector and the capture are ported:
        # a capture is taken, not refused
        from trpo_torch.obs.capture import RequestCapture
        from trpo_torch.obs.events import EventBus

        bus = EventBus()
        cap = RequestCapture(bus)
        router = Router(rs, port=0, capture=cap)
        try:
            assert router.capture is cap
        finally:
            router.close()
            cap.close()
            bus.close()
        from trpo_torch.resilience import FaultInjector

        inj = FaultInjector.from_spec("kill_replica@request=9:replica=0")
        router = Router(rs, port=0, injector=inj)
        try:
            assert router.injector is inj and router._chaos_requests == 0
        finally:
            router.close()
        for kw in ({"core": "fast"}, {"max_inflight": 0},
                   {"canary_fraction": 1.5}, {"min_latency_samples": 0},
                   {"retry_budget": -1}):
            with pytest.raises(ValueError):
                Router(rs, port=0, **kw)
    finally:
        rs.close()


def _imports(path):
    """Every module name a source file imports, at any depth of it."""
    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


@pytest.mark.parametrize("module", [
    "trpo_torch/serve/__init__.py", "trpo_torch/serve/__main__.py",
    "trpo_torch/serve/router.py", "trpo_torch/serve/replicaset.py",
    "trpo_torch/serve/autoscaler.py", "trpo_torch/serve/transport.py",
    "trpo_torch/serve/engine.py", "trpo_torch/serve/batcher.py",
    "trpo_torch/serve/server.py", "trpo_torch/serve/session.py",
    "trpo_torch/serve/wire.py", "trpo_torch/utils/exposition.py",
    "trpo_torch/utils/httpd.py"])
def test_control_plane_modules_import_no_jax(module):
    """No import of the module, nor of a ``trpo_torch`` module it imports
    (followed to the end, function-level imports included), names jax or
    ``trpo_tpu``."""
    seen, todo = set(), [os.path.join(REPO, module)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "trpo_tpu"), (path, name)
            if root == "trpo_torch":
                base = os.path.join(REPO, *name.split("."))
                for cand in (base + ".py", os.path.join(base, "__init__.py")):
                    if os.path.exists(cand):
                        todo.append(cand)
