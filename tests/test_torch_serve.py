"""The port's stateless serving plane (``trpo_torch/serve``: the engine,
the micro-batcher, ``PolicyServer``, ``python -m trpo_torch.serve``)
against ``trpo_tpu``'s, plus the reference's own single-replica tests of
``tests/test_serve.py`` carried over to the port, and the repair of
``act`` on host-normalized agents.

Tolerances: Gaussian actions within 1e-5 absolute and relative of the
reference (the matmuls sum in another order on the two CPU backends);
categorical actions identical. Where the reference promises that a row's
action does not depend on the rung it padded to, torch's CPU matmul does
not hold it bit for bit: a Gaussian row served at rung 8 differs from the
same row at rung 1 by an f32 ulp or so (measured on this CPU: at most
1.9e-9 over 20 draws, pendulum's 3→64→64→1), so those checks are bitwise
for categorical actions and within ``ROW_ATOL`` (1e-6, five times the
largest drift measured anywhere, 1.8e-7 for a 64-wide GRU's carry on the
H100) for Gaussian ones. ROADMAP.md Queue 3 has the finding.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig, get_preset
from trpo_torch.convert import (
    obs_norm_from_numpy,
    obs_norm_to_numpy,
    policy_params_from_numpy,
)
from trpo_torch.serve import InferenceEngine, MicroBatcher, PolicyServer
from trpo_torch.serve.__main__ import build_parser, config_from_args, main
from trpo_torch.utils.checkpoint import Checkpointer
from trpo_tpu.agent import TRPOAgent as TpuAgent
from trpo_tpu.config import TRPOConfig as TpuConfig
from trpo_tpu.serve import MicroBatcher as TpuBatcher
from trpo_tpu.serve import PolicyServer as TpuServer
from trpo_tpu.utils import normalize as tpu_norm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = RTOL = 1e-5
# a row at another rung: see the module docstring
ROW_ATOL = 1e-6

_CFG = dict(
    n_envs=4, batch_timesteps=32, cg_iters=2, vf_train_steps=2,
    policy_hidden=(8,), vf_hidden=(8,), seed=7,
    serve_batch_shapes=(1, 4, 8),
)


def _agent(env="cartpole", **kw):
    return TRPOAgent(env, TRPOConfig(**{**_CFG, **kw}), device="cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def loaded_engine():
    agent = _agent()
    state = agent.init_state(seed=0)
    engine = agent.serve_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    return agent, engine


def _json_or_text(raw: bytes):
    try:
        return json.loads(raw)
    except ValueError:  # the plain-text 404 of an unknown path
        return {"text": raw.decode()}


def _post(url, payload=None, timeout=30.0, headers=None):
    """``(status, body dict)``, HTTP errors included."""
    data = payload if isinstance(payload, (bytes, type(None))) else \
        json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data or b"",
        headers=headers or {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, _json_or_text(r.read())
    except urllib.error.HTTPError as e:
        return e.code, _json_or_text(e.read())


def _get(url, timeout=10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# ---------------------------------------------------------------------------
# the repair: act on a host-normalized agent
# ---------------------------------------------------------------------------


def test_act_on_host_normalized_agent_matches_reference():
    """A host adapter's observations arrive normalized, so ``act`` must
    apply the policy to ``obs`` as given; it used to normalize a second
    time with the adapter's statistics."""
    kw = dict(n_envs=4, batch_timesteps=16, policy_hidden=(16,),
              vf_hidden=(16,), normalize_obs=True, seed=3)
    ref = TpuAgent("native:pendulum", TpuConfig(env="native:pendulum", **kw))
    port = TRPOAgent("native:pendulum", TRPOConfig(env="native:pendulum",
                                                   **kw), device="cpu")
    assert port._obs_norm_host and not port._obs_norm_on_device
    ref_state = ref.init_state(seed=0)
    rng = np.random.default_rng(5)
    stats = tpu_norm.update_stats(
        tpu_norm.init_stats((3,)),
        jax.numpy.asarray(rng.normal(2.0, 3.0, (64, 3)), jax.numpy.float32))
    ref_state = ref_state._replace(obs_norm=stats)
    state = port.init_state(seed=0)._replace(
        policy_params=policy_params_from_numpy(_np(ref_state.policy_params)),
        obs_norm=obs_norm_from_numpy(_np(stats)))
    obs = np.array([0.5, -0.3, 1.2], np.float32)
    want = np.asarray(ref.act(ref_state, obs, eval_mode=True)[0])
    got = port.act(state, obs, eval_mode=True)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the statistics are not trivial: normalizing would move the action
    normed = port.policy.apply(state.policy_params, torch.as_tensor(
        (obs - stats.mean) / np.sqrt(stats.m2 / stats.count + 1e-8))[None])
    assert abs(float(normed["mean"][0, 0]) - float(got[0])) > 1e-3


def test_host_evaluate_normalizes_once_like_the_reference():
    """``evaluate`` on a host env pushes the state's statistics into the
    adapter and acts on its normalized observations with the raw policy:
    one normalization, as in the reference."""
    kw = dict(n_envs=4, batch_timesteps=16, policy_hidden=(16,),
              vf_hidden=(16,), normalize_obs=True, seed=3,
              max_pathlength=20)
    ref = TpuAgent("native:pendulum", TpuConfig(env="native:pendulum", **kw))
    port = TRPOAgent("native:pendulum", TRPOConfig(env="native:pendulum",
                                                   **kw), device="cpu")
    rng = np.random.default_rng(6)
    stats = tpu_norm.update_stats(
        tpu_norm.init_stats((3,)),
        jax.numpy.asarray(rng.normal(0.5, 2.0, (64, 3)), jax.numpy.float32))
    ref_state = ref.init_state(seed=0)._replace(obs_norm=stats)
    state = port.init_state(seed=0)._replace(
        policy_params=policy_params_from_numpy(_np(ref_state.policy_params)),
        obs_norm=obs_norm_from_numpy(_np(stats)))
    want = ref.evaluate(ref_state, n_steps=40, seed=2)
    got = port.evaluate(state, n_steps=40, seed=2)
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)


def test_obs_norm_round_trips_through_convert():
    stats = tpu_norm.update_stats(tpu_norm.init_stats((4,)),
                                  jax.numpy.ones((3, 4)))
    back = obs_norm_to_numpy(obs_norm_from_numpy(_np(stats)))
    for name in ("count", "mean", "m2"):
        np.testing.assert_array_equal(back[name],
                                      np.asarray(getattr(stats, name)))
    assert obs_norm_from_numpy(None) is None


# ---------------------------------------------------------------------------
# engine parity against trpo_tpu
# ---------------------------------------------------------------------------

_FAMILIES = {
    "mlp-gaussian": ("pendulum", dict(policy_hidden=(16, 16)), False),
    "mlp-gaussian-norm": ("pendulum", dict(policy_hidden=(16, 16),
                                           normalize_obs=True), False),
    "mlp-categorical": ("cartpole", dict(policy_hidden=(16,)), False),
    "conv-uint8": ("catch", dict(policy_hidden=(16,)), True),
    "moe": ("cartpole", dict(policy_hidden=(16,), policy_experts=4), False),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_engine_matches_reference_at_every_rung(family):
    env, kw, pixels = _FAMILIES[family]
    kw = {**_CFG, **kw, "env": env}
    ref = TpuAgent(env, TpuConfig(**kw))
    port = TRPOAgent(env, TRPOConfig(**kw), device="cpu")
    ref_state = ref.init_state(seed=0)
    rng = np.random.default_rng(11)
    n_max = 20  # past the top rung: chunked 8 + 8 + 4
    if pixels:
        obs = rng.integers(0, 256, (n_max,) + port.obs_shape, dtype=np.uint8)
    else:
        obs = rng.normal(0, 1.5, (n_max,) + port.obs_shape).astype(
            np.float32)
    stats = None
    if kw.get("normalize_obs"):
        stats = tpu_norm.update_stats(
            tpu_norm.init_stats(port.obs_shape),
            jax.numpy.asarray(rng.normal(1.0, 2.0, (32,) + port.obs_shape),
                              jax.numpy.float32))
    ref_engine = ref.serve_engine(obs_dtype=np.uint8 if pixels else None)
    ref_engine.load(ref_state.policy_params, stats, step=3)
    engine = port.serve_engine()
    assert engine.obs_dtype == (np.uint8 if pixels else np.float32)
    assert engine.with_obs_norm == ref_engine.with_obs_norm
    engine.load(policy_params_from_numpy(_np(ref_state.policy_params)),
                obs_norm_from_numpy(None if stats is None else _np(stats)),
                step=3)
    for n in (1, 3, 4, 8, n_max):
        want, want_step = ref_engine.infer(obs[:n], return_step=True)
        got, step = engine.infer(obs[:n], return_step=True)
        assert step == want_step == 3
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert dict(engine.shape_counts) == dict(ref_engine.shape_counts)


# ---------------------------------------------------------------------------
# the reference's engine tests (tests/test_serve.py), on the port
# ---------------------------------------------------------------------------


def test_engine_ladder_padding_and_chunking(loaded_engine):
    _, engine = loaded_engine
    assert engine.batch_shapes == (1, 4, 8)
    assert [engine.padded_shape(n) for n in (1, 2, 5, 64)] == [1, 4, 8, 8]
    rng = np.random.RandomState(0)
    for n in (1, 3, 8, 20):
        actions = engine.infer(rng.randn(n, 4).astype(np.float32))
        assert actions.shape == (n,) and actions.dtype == np.int32


def test_engine_actions_independent_of_padding_rung(loaded_engine):
    _, engine = loaded_engine
    obs = np.random.RandomState(1).randn(8, 4).astype(np.float32)
    a8 = engine.infer(obs)
    a1 = np.stack([engine.infer(obs[i:i + 1])[0] for i in range(8)])
    a4 = np.concatenate([engine.infer(obs[:4]), engine.infer(obs[4:])])
    np.testing.assert_array_equal(a8, a1)
    np.testing.assert_array_equal(a8, a4)


def test_gaussian_rows_across_rungs_within_stated_tolerance():
    agent = _agent("pendulum", policy_hidden=(64, 64))
    state = agent.init_state(seed=0)
    engine = agent.serve_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    obs = np.random.RandomState(2).randn(8, 3).astype(np.float32)
    a8 = engine.infer(obs)
    a1 = np.concatenate([engine.infer(obs[i:i + 1]) for i in range(8)])
    np.testing.assert_allclose(a8, a1, rtol=0, atol=ROW_ATOL)
    eager = agent.act(state, obs, eval_mode=True)[0].numpy()
    np.testing.assert_array_equal(a8, eager)  # the same batch: bitwise


def test_engine_is_deterministic(loaded_engine):
    _, engine = loaded_engine
    obs = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    np.testing.assert_array_equal(engine.infer(obs), engine.infer(obs))


def test_engine_infer_never_captures_and_snapshot_is_owned():
    agent = _agent()
    state = agent.init_state(seed=1)
    engine = agent.serve_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    captures = engine.captures_total  # 0 on the CPU: eager programs
    obs = np.random.RandomState(3).randn(5, 4).astype(np.float32)
    before = engine.infer(obs)
    for n in (1, 2, 4, 7, 8, 11):
        engine.infer(np.random.RandomState(n).randn(n, 4).astype(np.float32))
    assert engine.captures_total == captures
    # the engine copied the params: updating the state in place later
    # cannot reach the served snapshot
    with torch.no_grad():
        for layer in state.policy_params["net"]["layers"]:
            layer["w"].add_(1.0)
    np.testing.assert_array_equal(engine.infer(obs), before)
    engine.load(agent.init_state(seed=2).policy_params, None, step=1)
    assert engine.loaded_step == 1 and engine.last_load_ms is not None


def test_engine_rollback_is_one_shot(loaded_engine):
    agent, _ = loaded_engine
    engine = agent.serve_engine()
    with pytest.raises(RuntimeError, match="no previous snapshot"):
        engine.rollback()
    s1, s2 = agent.init_state(seed=1), agent.init_state(seed=2)
    engine.load(s1.policy_params, None, step=1)
    engine.load(s2.policy_params, None, step=2)
    obs = np.random.RandomState(4).randn(8, 4).astype(np.float32)
    assert engine.rollback() == 1 and engine.loaded_step == 1
    want = agent.act(s1, obs, eval_mode=True)[0].numpy()
    np.testing.assert_array_equal(engine.infer(obs), want)
    with pytest.raises(RuntimeError, match="no previous snapshot"):
        engine.rollback()


def test_engine_rejects_unloaded_and_bad_shapes(loaded_engine):
    _, engine = loaded_engine
    fresh = _agent().serve_engine()
    with pytest.raises(RuntimeError, match="no params snapshot"):
        fresh.infer(np.zeros((1, 4), np.float32))
    with pytest.raises(ValueError, match="obs must be"):
        engine.infer(np.zeros((2, 5), np.float32))
    with pytest.raises(ValueError, match="obs must be"):
        engine.infer(np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="batch_shapes"):
        InferenceEngine(None, (4,), batch_shapes=(), device="cpu")
    with pytest.raises(ValueError, match="batch_shapes"):
        InferenceEngine(None, (4,), batch_shapes=(0, 4), device="cpu")


def test_engine_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(None, (4,))


def test_engine_obs_norm_presence_contract():
    agent_n = _agent(normalize_obs=True)
    state_n = agent_n.init_state(seed=0)
    eng_n = agent_n.serve_engine()
    assert eng_n.with_obs_norm
    with pytest.raises(ValueError, match="obs_norm=None"):
        eng_n.load(state_n.policy_params, None)
    eng_n.load(state_n.policy_params, state_n.obs_norm, step=0)
    assert eng_n.infer(np.zeros((2, 4), np.float32)).shape == (2,)
    agent_r = _agent()
    eng_r = agent_r.serve_engine()
    with pytest.raises(ValueError, match="with_obs_norm=True"):
        eng_r.load(agent_r.init_state(seed=0).policy_params,
                   state_n.obs_norm)


def test_engine_families_refuse_the_wrong_protocol():
    rec = _agent("cartpole-po", policy_gru=8)
    with pytest.raises(ValueError, match="feedforward"):
        rec.serve_engine()
    with pytest.raises(ValueError, match="recurrent policies only"):
        _agent().serve_session_engine()


# ---------------------------------------------------------------------------
# micro-batcher
# ---------------------------------------------------------------------------


class _InstantEngine:
    obs_shape = (2,)
    obs_dtype = np.dtype(np.float32)
    max_batch = 8

    def __init__(self, fail_first=False):
        self.fail_next = fail_first

    def padded_shape(self, n):
        return 8 if n > 1 else 1

    def infer(self, obs, return_step=False):
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("boom")
        out = np.zeros(len(obs), np.int32)
        return (out, 7) if return_step else out


def test_batcher_coalesces_to_full_rung(loaded_engine):
    _, engine = loaded_engine
    batcher = MicroBatcher(engine, deadline_ms=5000.0)
    try:
        rng = np.random.RandomState(4)
        futures = [batcher.submit(rng.randn(4).astype(np.float32))
                   for _ in range(8)]
        results = [f.result(timeout=30.0) for f in futures]
        assert all(a.shape == () and step == 0 for a, step in results)
        assert batcher.batches_total == 1 and batcher.requests_total == 8
        assert engine.shape_counts[8] >= 1
    finally:
        batcher.close()


def test_batcher_deadline_flushes_partial_batch(loaded_engine):
    _, engine = loaded_engine
    batcher = MicroBatcher(engine, deadline_ms=40.0)
    try:
        t0 = time.perf_counter()
        action, _ = batcher.submit(np.zeros(4, np.float32)).result(
            timeout=30.0)
        assert action.shape == () and time.perf_counter() - t0 < 5.0
        assert batcher.batches_total == 1
    finally:
        batcher.close()


def test_batcher_engine_failure_fails_only_that_batch():
    batcher = MicroBatcher(_InstantEngine(fail_first=True), deadline_ms=5.0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            batcher.submit(np.zeros(2, np.float32)).result(timeout=30.0)
        assert batcher.errors_total == 1
        action, step = batcher.submit(np.zeros(2, np.float32)).result(
            timeout=30.0)
        assert action == 0 and step == 7
    finally:
        batcher.close()


def test_batcher_adaptive_deadline_cuts_idle_wait():
    deadline_ms = 80.0

    def p50(batcher, n=9):
        lats = []
        for _ in range(n):
            t0 = time.perf_counter()
            batcher.submit(np.zeros(2, np.float32)).result(timeout=30.0)
            lats.append((time.perf_counter() - t0) * 1e3)
        return sorted(lats)[len(lats) // 2]

    fixed = MicroBatcher(_InstantEngine(), deadline_ms=deadline_ms)
    adaptive = MicroBatcher(_InstantEngine(), deadline_ms=deadline_ms,
                            adaptive_deadline=True)
    try:
        adaptive.submit(np.zeros(2, np.float32)).result(timeout=30.0)
        assert adaptive.dispatch_cost_ema_ms is not None
        fixed_p50, adaptive_p50 = p50(fixed), p50(adaptive)
        assert fixed_p50 >= deadline_ms / 2 * 0.8, fixed_p50
        assert adaptive_p50 < fixed_p50 / 2, (adaptive_p50, fixed_p50)
        assert adaptive._effective_half_budget_ms() <= deadline_ms / 2
    finally:
        fixed.close()
        adaptive.close()
    with pytest.raises(ValueError, match="adaptive_headroom"):
        MicroBatcher(_InstantEngine(), adaptive_headroom=0)
    with pytest.raises(ValueError, match="cost_ema_alpha"):
        MicroBatcher(_InstantEngine(), cost_ema_alpha=0)


def test_batcher_close_drains_then_rejects(loaded_engine):
    _, engine = loaded_engine
    batcher = MicroBatcher(engine, deadline_ms=1000.0)
    futures = [batcher.submit(np.zeros(4, np.float32)) for _ in range(3)]
    batcher.close()
    for f in futures:
        assert f.result(timeout=5.0)[0].shape == ()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(np.zeros(4, np.float32))


def test_batcher_rejects_bad_config_shapes_and_a_bus(loaded_engine):
    _, engine = loaded_engine
    with pytest.raises(ValueError, match="deadline_ms"):
        MicroBatcher(engine, deadline_ms=0)
    with pytest.raises(ValueError, match="max_queue"):
        MicroBatcher(engine, max_queue=0)
    # the bus is ported: one schema-valid `serve` record per dispatch
    from trpo_torch.obs.events import EventBus, validate_event

    recs = []
    bus_batcher = MicroBatcher(engine, bus=EventBus(recs.append))
    try:
        bus_batcher.submit(np.zeros(engine.obs_shape, np.float32)).result(
            timeout=30.0)
    finally:
        bus_batcher.close()
    assert [(r["kind"], r["requests"]) for r in recs] == [("serve", 1)]
    assert not validate_event(recs[0])
    batcher = MicroBatcher(engine, deadline_ms=5.0)
    try:
        with pytest.raises(ValueError, match="obs must have shape"):
            batcher.submit(np.zeros((2, 4), np.float32))
    finally:
        batcher.close()


# ---------------------------------------------------------------------------
# PolicyServer against trpo_tpu's
# ---------------------------------------------------------------------------


class _Failing:
    """An engine whose inference raises (the 500 path)."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def infer(self, obs, return_step=False):
        raise RuntimeError("engine down")


def _exchanges(url, obs_dim):
    """The same requests to either server: ``[(status, code, action)]``."""
    from trpo_torch.serve import wire

    out = []
    obs = np.linspace(-1, 1, obs_dim).astype(np.float32)
    for payload in ({"obs": obs.tolist()}, {"obs": [1.0, 2.0]}, b"nope{",
                    {"nope": 1}, {"obs": obs.tolist(), "seq": 1}):
        status, body = _post(url + "/act", payload)
        out.append((status, body.get("code"), body.get("action")))
    frame = wire.encode_frame(None, {"obs": obs})
    headers = {"Content-Type": wire.WIRE_CONTENT_TYPE,
               "Accept": wire.WIRE_CONTENT_TYPE}
    req = urllib.request.Request(url + "/act", data=frame, headers=headers)
    with urllib.request.urlopen(req, timeout=30) as r:
        scalars, arrays = wire.decode_frame(r.read())
        out.append((r.status, None, arrays["action"].tolist()))
    bad = b"TW\x01\x00\xff\xff\xff\xff{}"
    status, body = _post(url + "/act", bad, headers=headers)
    out.append((status, body.get("code"), None))
    for path, payload in (("/session", None), ("/session/x/act", {"obs": 1}),
                          ("/reload", {"step": 1}), ("/drain", None),
                          ("/nope", {})):
        status, body = _post(url + path, payload)
        out.append((status, body.get("code"), None))
    return out


def _metric_families(url):
    status, text = _get(url + "/metrics")
    assert status == 200
    return sorted(line.split()[2] for line in text.splitlines()
                  if line.startswith("# TYPE"))


@pytest.mark.parametrize("env", ["pendulum", "cartpole"])
def test_server_answers_like_the_reference(env):
    kw = {**_CFG, "env": env, "policy_hidden": (8,)}
    ref = TpuAgent(env, TpuConfig(**kw))
    port = TRPOAgent(env, TRPOConfig(**kw), device="cpu")
    ref_state = ref.init_state(seed=0)
    ref_engine = ref.serve_engine()
    engine = port.serve_engine()
    servers = []
    try:
        for eng, batcher_cls, server_cls in (
                (ref_engine, TpuBatcher, TpuServer),
                (engine, MicroBatcher, PolicyServer)):
            batcher = batcher_cls(eng, deadline_ms=2.0)
            servers.append((server_cls(eng, batcher, port=0), batcher))
        (ref_srv, _), (srv, _) = servers
        # 503 before the first load, then load the same params
        for s in (ref_srv, srv):
            assert _post(s.url + "/act",
                         {"obs": [0.0] * port.obs_shape[0]})[0] == 503
            assert _get(s.url + "/healthz")[0] == 503
        ref_engine.load(ref_state.policy_params, None, step=5)
        engine.load(policy_params_from_numpy(_np(ref_state.policy_params)),
                    None, step=5)
        want, got = (_exchanges(s.url, port.obs_shape[0])
                     for s in (ref_srv, srv))
        for (ws, wc, wa), (gs, gc, ga) in zip(want, got):
            assert (gs, gc) == (ws, wc)
            if wa is not None:
                np.testing.assert_allclose(np.asarray(ga), np.asarray(wa),
                                           rtol=RTOL, atol=ATOL)
        health = [json.loads(_get(s.url + "/healthz")[1])
                  for s in (ref_srv, srv)]
        assert set(health[0]) == set(health[1])
        assert health[1]["ok"] and health[1]["step"] == 5
        assert _metric_families(ref_srv.url) == _metric_families(srv.url)
        # an engine failure is a scoped 500 in both
        for s in (ref_srv, srv):
            s.batcher.engine = _Failing(s.batcher.engine)
            status, body = _post(s.url + "/act",
                                 {"obs": [0.0] * port.obs_shape[0]})
            assert status == 500 and "inference failed" in body["error"]
    finally:
        for s, b in servers:
            s.close()
            b.close()


def test_server_routes_and_errors(loaded_engine):
    _, engine = loaded_engine
    batcher = MicroBatcher(engine, deadline_ms=5.0)
    srv = PolicyServer(engine, batcher, port=0)
    try:
        status, out = _post(srv.url + "/act", {"obs": [0.1, 0.2, 0.3, 0.4]})
        assert status == 200 and isinstance(out["action"], int)
        assert out["step"] == engine.loaded_step
        for payload in ({"obs": [1.0, 2.0]}, b"not json{", {"nope": 1}):
            assert _post(srv.url + "/act", payload)[0] == 400
        assert _post(srv.url + "/nope", {"obs": [0, 0, 0, 0]})[0] == 404
        health = json.loads(_get(srv.url + "/healthz")[1])
        assert health["ok"] and health["requests_total"] >= 1
        status, body = _get(srv.url + "/metrics")
        assert "trpo_serve_requests_total" in body
        assert 'trpo_serve_batch_shape_total{shape="1"}' in body
        assert "trpo_serve_dispatch_cost_ema_ms" in body
        for ln in body.splitlines():
            if ln and not ln.startswith("#"):
                float(ln.rsplit(" ", 1)[1])  # prometheus-parseable
    finally:
        srv.close()
        batcher.close()


def test_server_refuses_unported_hooks_and_unpaired_checkpointer(
        loaded_engine):
    _, engine = loaded_engine
    batcher = MicroBatcher(engine, deadline_ms=5.0)
    try:
        with pytest.raises(ValueError, match="come together"):
            PolicyServer(engine, batcher, port=0, checkpointer=object())
        # the bus and the tracer are ported; the injector and capture
        # still refuse, naming their sub-items
        for hook, item in (("injector", "item 18.4"),
                           ("capture", "item 18.5")):
            with pytest.raises(NotImplementedError, match=item):
                PolicyServer(engine, batcher, port=0, **{hook: object()})
    finally:
        batcher.close()


def _trained(agent, state):
    return agent.run_iteration(state)[0]


def test_hot_reload_under_concurrent_load(tmp_path):
    agent = _agent()
    trainer_ck = Checkpointer(str(tmp_path / "ck"))
    state = _trained(agent, agent.init_state(seed=0))
    trainer_ck.save(1, state)
    engine = agent.serve_engine()
    batcher = MicroBatcher(engine, deadline_ms=5.0)
    srv = PolicyServer(engine, batcher, port=0,
                       checkpointer=Checkpointer(str(tmp_path / "ck")),
                       template=agent.init_state(), poll_interval=0.05)
    errors, answers = [], []
    try:
        assert engine.loaded_step == 1  # synchronous first load

        def client(seed):
            r = np.random.RandomState(seed)
            for _ in range(12):
                o = r.randn(4).astype(np.float32)
                status, out = _post(srv.url + "/act", {"obs": o.tolist()},
                                    timeout=30)
                if status != 200:
                    errors.append(status)
                else:
                    answers.append((o, out["action"], out["step"]))

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(4)]
        for t in threads:
            t.start()
        state2 = _trained(agent, state)
        trainer_ck.save(2, state2)
        deadline = time.time() + 30.0
        while engine.loaded_step != 2 and time.time() < deadline:
            time.sleep(0.02)
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive()
        assert engine.loaded_step == 2 and srv.reloads_total >= 2
        assert not errors and batcher.errors_total == 0
        by_step = {1: state, 2: state2}
        for o, action, step in answers:  # each labelled with its params
            assert action == int(agent.act(by_step[step], o,
                                           eval_mode=True)[0])
        status, out = _post(srv.url + "/act", {"obs": [0, 0, 0, 0]})
        assert status == 200 and out["step"] == 2
    finally:
        srv.close()
        batcher.close()


def test_reload_failure_keeps_serving_last_good(tmp_path, capfd):
    agent = _agent()
    trainer_ck = Checkpointer(str(tmp_path / "ck"))
    state = agent.init_state(seed=0)
    trainer_ck.save(1, state)
    engine = agent.serve_engine()
    engine.load(state.policy_params, state.obs_norm, step=1)
    batcher = MicroBatcher(engine, deadline_ms=5.0)
    srv = PolicyServer(engine, batcher, port=0,
                       checkpointer=Checkpointer(str(tmp_path / "ck")),
                       template={"totally": "wrong structure"},
                       poll_interval=0.05)
    try:
        trainer_ck.save(2, state)
        deadline = time.time() + 10.0
        while time.time() < deadline and srv.reload_failures_total == 0:
            time.sleep(0.02)
        assert srv.reload_failures_total >= 1
        assert engine.loaded_step == 1
        assert _post(srv.url + "/act", {"obs": [0, 0, 0, 0]})[0] == 200
    finally:
        srv.close()
        batcher.close()
    assert "failed to load" in capfd.readouterr().err


def test_managed_reload_step_and_rollback(tmp_path):
    agent = _agent()
    ck = Checkpointer(str(tmp_path / "ck"))
    s1, s2 = agent.init_state(seed=1), agent.init_state(seed=2)
    ck.save(1, s1)
    ck.save(2, s2)
    engine = agent.serve_engine()
    batcher = MicroBatcher(engine, deadline_ms=2.0)
    srv = PolicyServer(engine, batcher, port=0, checkpointer=ck,
                       template=agent.init_state(), poll_interval=0.05,
                       managed_reload=True, initial_step=1)
    try:
        assert engine.loaded_step == 1
        time.sleep(0.2)  # the watcher must not follow latest by itself
        assert engine.loaded_step == 1
        assert _post(srv.url + "/reload", {"step": 2}) == \
            (200, {"ok": True, "step": 2})
        assert _post(srv.url + "/reload", {"rollback": True}) == \
            (200, {"ok": True, "step": 1, "rolled_back": True})
        status, body = _post(srv.url + "/reload", {"rollback": True})
        assert status == 409 and body["code"] == "no_previous_snapshot"
        assert _post(srv.url + "/reload", {"step": "x"})[0] == 400
        assert _post(srv.url + "/reload", {"step": 9}) == \
            (500, {"ok": False, "step": 1})
    finally:
        srv.close()
        batcher.close()


def test_server_answers_on_a_unix_socket(loaded_engine, tmp_path,
                                         monkeypatch):
    import http.client
    import socket

    _, engine = loaded_engine
    batcher = MicroBatcher(engine, deadline_ms=2.0)
    # relative to the test's directory: an absolute path under a deep
    # temporary directory can pass AF_UNIX's 107 bytes
    monkeypatch.chdir(tmp_path)
    path = "s.sock"
    srv = PolicyServer(engine, batcher, port=0, uds_path=path)

    class Conn(http.client.HTTPConnection):
        def connect(self):
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.sock.settimeout(10)
            self.sock.connect(path)

    try:
        assert srv.uds_path == path
        conn = Conn("localhost", timeout=10)
        conn.request("POST", "/act", body=json.dumps(
            {"obs": [0.1, 0.2, 0.3, 0.4]}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert json.loads(resp.read())["action"] == int(engine.infer(
            np.array([[0.1, 0.2, 0.3, 0.4]], np.float32))[0])
        conn.close()
        text = _get(srv.url + "/metrics")[1]
        assert 'trpo_serve_transport_requests_total{transport="uds"} 1' \
            in text
    finally:
        srv.close()
        batcher.close()


# ---------------------------------------------------------------------------
# python -m trpo_torch.serve
# ---------------------------------------------------------------------------


def test_cli_parser_overrides_and_refusals():
    with pytest.raises(SystemExit):
        build_parser().parse_args([])
    args = build_parser().parse_args([
        "--checkpoint-dir", "/tmp/ck", "--n-envs", "4",
        "--policy-hidden", "32,32", "--vf-hidden", "16",
        "--batch-shapes", "1,2,4", "--deadline-ms", "7.5",
        "--poll-interval", "0.2", "--serve-seconds", "1",
        "--no-adaptive-deadline", "--session-batch-shapes", "1,8"])
    assert args.device == "cuda" and args.port == 0
    cfg = config_from_args(args)
    assert cfg.n_envs == 4 and cfg.policy_hidden == (32, 32)
    assert cfg.vf_hidden == (16,) and cfg.serve_batch_shapes == (1, 2, 4)
    assert cfg.serve_deadline_ms == 7.5 and cfg.serve_poll_interval == 0.2
    assert cfg.serve_adaptive_deadline is False
    assert cfg.serve_session_batch_shapes == (1, 8)
    # the control plane's flags parse and build its config now
    for flags, field, value in (
            (["--replicas", "2"], "serve_replicas", 2),
            (["--max-replicas", "3"], "serve_max_replicas", 3),
            (["--hosts", "a,b"], "serve_hosts", ("a", "b")),
            (["--replica-cmd", "x"], "serve_replica_cmd", "x"),
            (["--slo-p99-ms", "5"], "serve_slo_p99_ms", 5.0),
            (["--lease-ttl", "3"], "serve_lease_ttl", 3.0),
            (["--canary-fraction", "0.5"], "serve_canary_fraction", 0.5)):
        cfg = config_from_args(build_parser().parse_args(
            ["--checkpoint-dir", "/nonexistent", *flags]))
        assert getattr(cfg, field) == value
    assert build_parser().parse_args(
        ["--checkpoint-dir", "x", "--router-core", "thread"]
    ).router_core == "thread"
    # --metrics-jsonl and --trace-sample-rate are ported (the rate needs
    # the event log); --capture and --inject-faults refuse by sub-item
    for flags, item in ((["--capture"], "item 18.5"),
                        (["--inject-faults", "x"], "item 18.4")):
        with pytest.raises(NotImplementedError, match=item):
            main(["--checkpoint-dir", "/nonexistent", *flags])
    assert main(["--checkpoint-dir", "/nonexistent", "--device", "cpu",
                 "--trace-sample-rate", "1"]) == 2


def test_cli_serves_a_checkpoint_and_exits_on_sigterm(tmp_path):
    agent = TRPOAgent("cartpole", get_preset("cartpole").replace(
        policy_hidden=(8,), vf_hidden=(8,), n_envs=4), device="cpu")
    state = agent.init_state(seed=0)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(3, state)
    run_json = tmp_path / "run.json"
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    child = subprocess.Popen(
        [sys.executable, "-m", "trpo_torch.serve", "--device", "cpu",
         "--checkpoint-dir", str(tmp_path / "ck"), "--port", "0",
         "--policy-hidden", "8", "--vf-hidden", "8", "--n-envs", "4",
         "--run-descriptor", str(run_json)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + 120
        while not run_json.exists():
            assert child.poll() is None, child.stdout.read()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        desc = json.loads(run_json.read_text())
        assert desc["pid"] == child.pid and desc["device"] == "cpu"
        assert json.loads(_get(desc["url"] + "/healthz")[1])["step"] == 3
        obs = [0.1, 0.2, 0.3, 0.4]
        status, out = _post(desc["url"] + "/act", {"obs": obs})
        want = int(agent.act(state, np.asarray(obs, np.float32),
                             eval_mode=True)[0])
        assert status == 200 and out == {"step": 3, "action": want}
        child.send_signal(signal.SIGTERM)
        out_text, _ = child.communicate(timeout=60)
        assert child.returncode == 0, out_text
        assert "served 1 requests" in out_text
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)


def test_background_httpd_post_limits_and_handler_errors():
    from trpo_torch.utils.httpd import BackgroundHTTPServer

    def boom():
        raise RuntimeError("handler bug")

    def echo(body):
        return 200, "application/json", body or b"{}"

    srv = BackgroundHTTPServer(0, get={"/boom": boom}, post={"/echo": echo},
                               max_body_bytes=64)
    try:
        assert _post(srv.url + "/echo", {"x": 1}) == (200, {"x": 1})
        assert _get(srv.url + "/boom")[0] == 500
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                srv.url + "/echo", data=json.dumps({"x": "y" * 200})
                .encode()), timeout=10)
        assert e.value.code == 413
        assert _post(srv.url + "/echo", {"x": 2})[0] == 200
    finally:
        srv.close()


def _async_exchanges(server_cls, headers_fn, transport, sock_path):
    """Every route kind of ``server_cls`` (an ``AsyncBackgroundServer``)
    answered over one keep-alive connection on ``transport``: a list of
    ``(status, content type, body, connection header)``, and the
    server's per-transport request counts."""
    import http.client
    import socket

    def sync_echo(body):
        return 200, "application/json", json.dumps({
            "body": body.decode(),
            "trace": headers_fn().get("X-Trace-Id")}).encode()

    def sync_prefix(path, body):
        return 200, "text/plain", f"{path}:{body.decode()}".encode()

    async def fast(path, body, headers):
        return 200, "text/plain", (
            f"{path}:{body.decode()}:{headers.get('X-Trace-Id')}".encode())

    async def fast_boom(path, body, headers):
        raise KeyError("handler bug")

    def boom():
        raise RuntimeError("handler bug")

    srv = server_cls(
        0, get={"/hello": lambda: (200, "text/plain", b"hi"), "/boom": boom},
        post={"/echo": sync_echo}, post_prefix={"/sess/": sync_prefix},
        async_post={"/fast": fast, "/aboom": fast_boom},
        async_post_prefix={"/fastp/": fast}, max_body_bytes=64,
        uds_path=sock_path if transport == "uds" else None)

    class Conn(http.client.HTTPConnection):
        def connect(self):
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.sock.settimeout(10)
            self.sock.connect(sock_path)

    conn = (Conn("localhost", timeout=10) if transport == "uds" else
            http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10))
    trace = {"X-Trace-Id": "t-1"}
    requests = [
        ("GET", "/hello", None, {}), ("GET", "/boom", None, {}),
        ("GET", "/nope", None, {}), ("POST", "/echo", b"abc", trace),
        ("POST", "/sess/s1/act", b"x", {}), ("POST", "/fast", b"f", trace),
        ("POST", "/fastp/z", b"p", {}), ("POST", "/aboom", b"", {}),
        ("POST", "/nope", b"", {}),
        ("POST", "/echo", b"last", {"Connection": "close"}),
        ("POST", "/echo", b"y" * 200, {}),
    ]
    out = []
    try:
        for method, path, body, headers in requests:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            out.append((resp.status, resp.getheader("Content-Type"),
                        resp.read(), resp.getheader("Connection")))
            if resp.getheader("Connection") == "close":
                conn.close()
        counts = dict(srv.transport_requests_total)
    finally:
        conn.close()
        srv.close()
    return out, counts


@pytest.mark.parametrize("transport", ["tcp", "uds"])
def test_async_httpd_answers_like_the_reference(transport, tmp_path,
                                               monkeypatch):
    """The port's copy of ``AsyncBackgroundServer`` against
    ``trpo_tpu``'s: the same status, content type, body and connection
    header for sync, prefix and async routes, handler failures, unknown
    paths, ``Connection: close`` and an oversized body (413)."""
    from trpo_torch.utils import httpd
    from trpo_tpu.utils import httpd as tpu_httpd

    # socket paths relative to the test's directory: an absolute path
    # under a deep temporary directory can pass AF_UNIX's 107 bytes
    monkeypatch.chdir(tmp_path)
    got = _async_exchanges(httpd.AsyncBackgroundServer,
                           httpd.request_headers, transport, "port.sock")
    want = _async_exchanges(tpu_httpd.AsyncBackgroundServer,
                            tpu_httpd.request_headers, transport,
                            "ref.sock")
    assert got == want
    statuses = [s for s, *_ in got[0]]
    assert statuses == [200, 500, 404, 200, 200, 200, 200, 500, 404, 200,
                        413]
    assert json.loads(got[0][3][2]) == {"body": "abc", "trace": "t-1"}
    assert got[1][transport] == 10  # the 413 is refused before it counts


def test_simulated_cost_engine_matches_the_reference():
    """``SimulatedCostEngine`` charges its cost per ``infer`` and answers
    what the wrapped engine answers, as the reference's does."""
    from trpo_torch.serve.engine import SimulatedCostEngine
    from trpo_tpu.serve.engine import SimulatedCostEngine as TpuCostEngine

    kw = {**_CFG, "env": "pendulum"}
    ref = TpuAgent("pendulum", TpuConfig(**kw))
    port = TRPOAgent("pendulum", TRPOConfig(**kw), device="cpu")
    ref_state = ref.init_state(seed=0)
    ref_engine = ref.serve_engine()
    ref_engine.load(ref_state.policy_params, None, step=5)
    engine = port.serve_engine()
    engine.load(policy_params_from_numpy(_np(ref_state.policy_params)),
                None, step=5)
    slow, ref_slow = (SimulatedCostEngine(engine, 20.0),
                      TpuCostEngine(ref_engine, 20.0))
    assert slow.batch_shapes == engine.batch_shapes
    obs = np.random.default_rng(2).normal(size=(5, 3)).astype(np.float32)
    t0 = time.perf_counter()
    got, step = slow.infer(obs, return_step=True)
    assert time.perf_counter() - t0 >= 0.02
    want, want_step = ref_slow.infer(obs, return_step=True)
    assert step == want_step == 5
    np.testing.assert_array_equal(got, engine.infer(obs))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    for cls in (SimulatedCostEngine, TpuCostEngine):
        with pytest.raises(ValueError, match="cost_ms"):
            cls(engine, -1.0)


def test_config_serve_fields_round_trip_the_reference():
    port_fields = {f.name for f in __import__("dataclasses").fields(
        TRPOConfig)}
    ref_fields = {f.name for f in __import__("dataclasses").fields(
        TpuConfig)}
    serve = {f for f in ref_fields if f.startswith("serve_")}
    assert serve and serve <= port_fields
    for name in serve:
        assert getattr(TRPOConfig(), name) == getattr(TpuConfig(), name)
    for bad in ({"serve_batch_shapes": (0, 4)}, {"serve_deadline_ms": 0},
                {"serve_session_batch_shapes": ()},
                {"serve_canary_fraction": 2.0},
                {"serve_max_replicas": 1, "serve_min_replicas": 2},
                {"serve_hosts": ("a", "a"), "serve_lease_ttl": 5.0},
                {"serve_hosts": ("a",), "serve_lease_ttl": 0.1},
                {"serve_replica_cmd": "  "}, {"serve_max_sessions": 0}):
        with pytest.raises(ValueError):
            TpuConfig(**bad)
        with pytest.raises(ValueError):
            TRPOConfig(**bad)


def test_concurrent_infers_across_reloads_never_mix_snapshots():
    """Many threads infer while another reloads back and forth: every
    answer must be the eager action of the snapshot its step names (the
    snapshot is read once per call and swapped whole)."""
    agent = _agent("pendulum", policy_hidden=(16,))
    states = {1: agent.init_state(seed=1), 2: agent.init_state(seed=2)}
    engine = agent.serve_engine()
    engine.load(states[1].policy_params, None, step=1)
    answers, errors = [], []
    started, done = threading.Barrier(13), threading.Event()

    def client(k):
        rng = np.random.RandomState(k)
        try:
            started.wait(timeout=30)
            while not done.is_set():
                obs = rng.randn(1 + k % 6, 3).astype(np.float32)
                actions, step = engine.infer(obs, return_step=True)
                answers.append((obs, actions, step))
        except Exception as e:  # collected and checked below
            errors.append(repr(e))

    def reloader():
        try:
            started.wait(timeout=30)
            for k in range(40):
                step = 2 - k % 2
                engine.load(states[step].policy_params, None, step=step)
                time.sleep(0.005)  # let the clients answer between swaps
        finally:
            done.set()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(12)]
        threads.append(threading.Thread(target=reloader, daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        done.set()
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    assert {step for *_, step in answers} == {1, 2}
    for obs, actions, step in answers:
        want = agent.act(states[step], obs, eval_mode=True)[0].numpy()
        np.testing.assert_allclose(actions, want, rtol=0, atol=ROW_ATOL)
