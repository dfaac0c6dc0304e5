"""The port's canary controller (``CanaryController`` in
``trpo_torch/serve/replicaset.py``) against ``trpo_tpu``'s, and the
canary legs of the reference's ``tests/test_failover.py`` and
``tests/test_flywheel.py`` carried over to the port, driven by the
port's own checkpoints.

The gates (``_judge_parity``, ``_judge_reward``) are fed the same
answers and returns in both packages and must reach the same verdict
with the same reason. The reference reads the gate's terminal off its
event bus (ROADMAP.md Queue 1 item 18); these tests read
``promoted_total``, ``rolled_back_total``, ``last_decision`` and
``last_reason``.
"""

import json
import threading
import time
import types

import numpy as np
import pytest

from test_torch_router import make_set, port_agent, post, rec_factory
from trpo_torch.ops.flat import tree_map
from trpo_torch.serve import (
    CanaryController,
    MicroBatcher,
    PolicyServer,
    Router,
)
from trpo_torch.utils.checkpoint import Checkpointer
from trpo_tpu.serve import CanaryController as TpuCanaryController


class _StubRouter:
    def __init__(self, eps=None, bodies=()):
        self.eps = dict(eps or {})
        self.bodies = list(bodies)

    def replica_episode_returns(self, rid):
        return list(self.eps.get(rid, []))

    def reset_replica_episodes(self):
        self.eps.clear()

    def recent_act_bodies(self, n=8):
        return self.bodies[-n:]


def _controllers(router, replicas=None, **kw):
    """The reference's and the port's controller over the same stubs."""
    kw.setdefault("window_requests", 1)
    kw.setdefault("gate_timeout_s", 0.2)
    kw.setdefault("poll_interval", 0.01)
    rs = types.SimpleNamespace(lock=threading.Lock(),
                               replicas=dict(replicas or {}))
    return [cls(rs, router, lambda: None, **kw)
            for cls in (TpuCanaryController, CanaryController)]


_REWARD_CASES = [
    (dict(reward_window_episodes=3, reward_min_episodes=2,
          reward_budget=0.5),
     {"c0": [1.0, 1.2, 0.8], "r0": [1.1], "r1": [1.3]}, 0),
    (dict(reward_window_episodes=3, reward_min_episodes=2,
          reward_budget=0.5),
     {"c0": [0.8, 0.8, 0.8], "r0": [1.1], "r1": [1.3]}, 0),
    (dict(reward_window_episodes=2, reward_budget=0.5),
     {"c0": [0.0, 0.1], "r0": [2.0, 2.2]}, 0),
    (dict(reward_window_episodes=3, reward_min_episodes=2),
     {"c0": [1.0], "r0": [1.0, 1.0]}, 0),
    (dict(reward_window_episodes=3, reward_min_episodes=2),
     {"c0": [1.0, 1.0, 1.0], "r0": [1.0]}, 0),
    (dict(reward_window_episodes=2), {"c0": []}, 1),
    (dict(reward_window_episodes=1, reward_budget=0.0),
     {"c0": [-5.0], "r0": [-5.0], "r1": [-4.0]}, 0),
]


@pytest.mark.parametrize("k", range(len(_REWARD_CASES)))
def test_reward_gate_matches_reference(k):
    kw, eps, restarts = _REWARD_CASES[k]
    verdicts = []
    for ctrl in _controllers(_StubRouter(eps), **kw):
        rec = types.SimpleNamespace(id="c0", state="healthy",
                                    restarts=restarts)
        ok, reason = ctrl._judge_reward(rec, ["r0", "r1"], 0)
        transient = reason is not None and any(
            reason.startswith(t) for t in type(ctrl)._TRANSIENT_REASONS)
        verdicts.append((ok, reason, transient))
    assert verdicts[1] == verdicts[0]


def _answers(canary, incumbent):
    """A ``_post`` stub: the canary's and the incumbent's answer to
    /act, by replica URL, each a function of the body."""
    def post_stub(url, path, payload, timeout=None):
        return (canary if url == "http://canary" else incumbent)(payload)
    return post_stub


def _ok(shift=0.0, nan=False):
    def answer(payload):
        a = np.asarray(payload["obs"], np.float64)[:1] + shift
        if nan:
            a = a * np.nan
        return 200, {"action": a.tolist(), "step": 2}
    return answer


def _refuse(status=400):
    return lambda payload: (status, {"error": "no", "code": "bad_obs"})


_PARITY_CASES = {
    "clean": (_ok(), _ok(), None),
    "within_tol": (_ok(0.05), _ok(), 0.1),
    "over_tol": (_ok(0.5), _ok(), 0.1),
    "nonfinite": (_ok(nan=True), _ok(), None),
    "canary_refuses": (_refuse(500), _ok(), None),
    "both_refuse": (_refuse(), _refuse(), None),
}


@pytest.mark.parametrize("case", sorted(_PARITY_CASES))
def test_parity_gate_matches_reference(case):
    canary, incumbent, tol = _PARITY_CASES[case]
    bodies = [json.dumps({"obs": [0.1 * i, 0.2, 0.3]}).encode()
              for i in range(5)] + [b"not json{"]
    replicas = {"r0": types.SimpleNamespace(state="healthy",
                                            url="http://incumbent")}
    verdicts = []
    for ctrl in _controllers(_StubRouter(bodies=bodies), replicas,
                             parity_samples=6, parity_tol=tol):
        ctrl._post = _answers(canary, incumbent)
        rec = types.SimpleNamespace(id="c0", url="http://canary")
        verdicts.append(ctrl._judge_parity(rec, ["r0"]))
    assert verdicts[1] == verdicts[0]
    assert verdicts[1][0] is (case in ("clean", "within_tol"))


def test_controller_defaults_validate_and_refuse_the_bus():
    ctrl = _controllers(_StubRouter())[1]
    assert (ctrl.reward_window_episodes, ctrl.reward_min_episodes,
            ctrl.reward_budget) == (0, 1, 0.0)
    for kw in (dict(window_requests=0), dict(p99_budget_pct=-1),
               dict(reward_window_episodes=-1),
               dict(reward_min_episodes=0), dict(reward_budget=-0.1)):
        for cls in (TpuCanaryController, CanaryController):
            with pytest.raises(ValueError):
                cls(None, None, lambda: None, **kw)
    # the run-event bus is ported: accepted (the gate's events are
    # tested with the replicated server in test_torch_trace.py)
    from trpo_torch.obs.events import EventBus

    bus = EventBus()
    assert CanaryController(None, None, lambda: None, bus=bus).bus is bus


def test_canary_rejects_a_nan_checkpoint_and_promotes_a_clean_one(
        tmp_path):
    """Three managed replicas serve step 1. A step 2 with NaN params
    answers nonfinite actions on mirrored traffic: rolled back (judged,
    so never re-canaried), the set stays on step 1. A clean step 3 is
    promoted to every replica. Clients see no error throughout."""
    agent, state = port_agent("pendulum")
    ck_dir = str(tmp_path / "ck")
    trainer = Checkpointer(ck_dir)
    trainer.save(1, state)
    incumbent = {"step": None}

    def make(rid):
        def factory():
            engine = agent.serve_engine()
            batcher = MicroBatcher(engine, deadline_ms=5.0)
            return PolicyServer(
                engine, batcher, port=0, checkpointer=Checkpointer(ck_dir),
                template=agent.init_state(), poll_interval=60.0,
                managed_reload=True,
                initial_step=incumbent["step"]), [batcher]
        return factory

    rs = make_set(make, 3)
    # a quarter of the traffic, so the canary carries no more load than
    # each incumbent; the controller's p99 budget over 300 canary
    # requests (the fourth-largest; each incumbent books ~450, inside
    # the router's 512-latency window): below 100 a nearest-rank p99 is
    # the window's largest sample, one scheduling hiccup on a busy host
    # (the p99 gate has its own test below)
    router = Router(rs, port=0, canary_fraction=0.25)
    ctrl = CanaryController(rs, router, Checkpointer(ck_dir).latest_step,
                            incumbent=incumbent, window_requests=300,
                            poll_interval=0.1, gate_timeout_s=30.0)
    stop = threading.Event()
    errors = []

    def client(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set():
            status, out = post(router.url + "/act", {
                "obs": r.standard_normal(agent.obs_shape).tolist()})
            if status != 200:
                errors.append((status, out))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(3)]
    try:
        ctrl.tick()
        assert incumbent["step"] == 1  # the first step is adopted ungated
        for t in threads:
            t.start()
        time.sleep(0.2)
        trainer.save(2, state._replace(policy_params=tree_map(
            lambda t: t * float("nan"), state.policy_params)))
        ctrl.tick()
        assert (ctrl.rolled_back_total, ctrl.promoted_total) == (1, 0)
        assert ctrl.last_decision == "rolled_back" and ctrl.last_step == 2
        assert "nonfinite" in ctrl.last_reason
        assert ctrl.last_decision_s > 0
        snap = rs.snapshot()
        assert all(r["loaded_step"] == 1 and not r["canary"]
                   for r in snap["replicas"].values()), snap
        ctrl.tick()  # a judged rejection is never re-canaried
        assert ctrl.rolled_back_total == 1
        trainer.save(3, state)
        ctrl.tick()
        assert ctrl.promoted_total == 1 and incumbent["step"] == 3
        assert ctrl.last_decision == "promoted" and ctrl.last_reason is None
        c99, i99 = ctrl.last_p99_ms  # the p99 gate passed at its budget
        assert 0 < c99 <= i99 * (1 + ctrl.p99_budget_pct / 100)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            rs.tick()
            steps = {r["loaded_step"]
                     for r in rs.snapshot()["replicas"].values()}
            if steps == {3}:
                break
            time.sleep(0.05)
        assert steps == {3}
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=15.0)
        ctrl.close()
        router.close()
        rs.close()
    assert not errors, errors[:5]


def test_canary_over_its_p99_budget_is_rolled_back(tmp_path):
    """The canary (r0, the fewest sessions, then the first id) answers
    through a 100 ms ``SimulatedCostEngine``, its incumbents at full
    speed: a clean checkpoint is rolled back on the p99 gate at the
    controller's default 50% budget, and the set stays on its step."""
    from trpo_torch.serve import SimulatedCostEngine

    agent, state = port_agent("pendulum")
    ck_dir = str(tmp_path / "ck")
    trainer = Checkpointer(ck_dir)
    trainer.save(1, state)
    incumbent = {"step": None}

    def make(rid):
        def factory():
            engine = agent.serve_engine()
            if rid == "r0":
                engine = SimulatedCostEngine(engine, cost_ms=100.0)
            batcher = MicroBatcher(engine, deadline_ms=1.0)
            return PolicyServer(
                engine, batcher, port=0, checkpointer=Checkpointer(ck_dir),
                template=agent.init_state(), poll_interval=60.0,
                managed_reload=True,
                initial_step=incumbent["step"]), [batcher]
        return factory

    rs = make_set(make, 3)
    router = Router(rs, port=0, canary_fraction=0.5)
    ctrl = CanaryController(rs, router, Checkpointer(ck_dir).latest_step,
                            incumbent=incumbent, window_requests=8,
                            poll_interval=0.1, gate_timeout_s=30.0)
    assert ctrl.p99_budget_pct == 50.0
    stop = threading.Event()
    errors = []

    def client(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set():
            status, out = post(router.url + "/act", {
                "obs": r.standard_normal(agent.obs_shape).tolist()})
            if status != 200:
                errors.append((status, out))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(3)]
    try:
        ctrl.tick()
        assert incumbent["step"] == 1
        for t in threads:
            t.start()
        time.sleep(0.2)
        trainer.save(2, state)
        ctrl.tick()
        assert ctrl.last_decision == "rolled_back" and ctrl.last_step == 2
        assert "over budget" in ctrl.last_reason, ctrl.last_reason
        c99, i99 = ctrl.last_p99_ms
        assert c99 >= 100.0 and c99 > i99 * 1.5
        assert incumbent["step"] == 1
        assert all(r["loaded_step"] == 1 and not r["canary"]
                   for r in rs.snapshot()["replicas"].values())
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=15.0)
        ctrl.close()
        router.close()
        rs.close()
    assert not errors, errors[:5]


def test_session_stride_and_episode_booking():
    agent, state = port_agent("cartpole-po", policy_gru=8,
                              serve_session_batch_shapes=(1, 4))
    rs = make_set(lambda rid: rec_factory(agent, state.policy_params), 2)
    router = Router(rs, port=0, canary_fraction=0.5)
    try:
        with rs.lock:
            rs.replicas["r1"].canary = True
        pins = []
        for _ in range(8):
            status, out = post(router.url + "/session")
            assert status == 200
            pins.append((out["session"], out["replica"]))
        assert sum(1 for _, r in pins if r == "r1") == 4, pins
        obs = np.zeros(agent.obs_shape, np.float32).tolist()
        for sid, rid in pins:
            reward = 1.0 if rid == "r1" else 0.5
            for t in range(3):
                status, out = post(router.url + f"/session/{sid}/act", {
                    "obs": obs, "reward": reward, "done": t == 2})
                assert status == 200, out
        assert sorted(router.replica_episode_returns("r1")) == [3.0] * 4
        assert sorted(router.replica_episode_returns("r0")) == [1.5] * 4
        assert router.episodes_total == 8
        status, out = post(router.url + "/session")
        status, out = post(router.url + f"/session/{out['session']}/act",
                           {"obs": obs, "reward": "seven"})
        assert status == 200 and router.episodes_total == 8
        router.reset_replica_episodes()
        assert router.replica_episode_returns("r1") == []
    finally:
        router.close()
        rs.close()
