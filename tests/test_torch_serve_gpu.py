"""The serving engines' CUDA graphs against eager ``act`` on the card.

They need a CUDA card; elsewhere each test skips with the reason (decided
in the fixture, never at import). On the card:
``python -m pytest tests/test_torch_serve_gpu.py -q -m gpu --noconftest``.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from trpo_torch.agent import TRPOAgent
from trpo_torch.config import get_preset
from trpo_torch.ops.flat import tree_map
from trpo_torch.serve import MicroBatcher, PolicyServer
from trpo_torch.utils.checkpoint import Checkpointer

pytestmark = pytest.mark.gpu

# eager act and the graph run the same ops; cuBLAS may pick another
# kernel per width (measured on the H100: ≤ 1.8e-7)
ATOL = 1e-5

_FAMILIES = {
    "mlp": ("pendulum", dict(policy_hidden=(64, 64))),
    "conv": ("catch", dict(policy_hidden=(32,))),
    "moe": ("cartpole", dict(policy_experts=4)),
    "gru": ("cartpole-po", dict(policy_gru=16)),
    "lstm": ("cartpole-po", dict(policy_gru=16, policy_cell="lstm")),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the engines capture CUDA graphs)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _agent(card, env, **kw):
    cfg = get_preset(env).replace(n_envs=4, batch_timesteps=64, **kw)
    return TRPOAgent(env, cfg, device=card)


def _obs(agent, n, seed):
    rng = np.random.default_rng(seed)
    if len(agent.obs_shape) == 3:
        return rng.integers(0, 256, (n,) + agent.obs_shape, dtype=np.uint8)
    return rng.standard_normal((n,) + agent.obs_shape).astype(np.float32)


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_graphs_match_eager_act_and_never_capture_on_infer(card, family):
    env, kw = _FAMILIES[family]
    agent = _agent(card, env, **kw)
    state = agent.init_state(seed=0)
    n = 70  # past the top rung
    obs = _obs(agent, n, 1)
    if agent.is_recurrent:
        engine = agent.serve_session_engine()
        engine.load(state.policy_params, state.obs_norm, step=0)
        assert engine.captures_total == 3
        carries = np.random.default_rng(2).standard_normal(
            (n, engine.state_size)).astype(np.float32)
        for width in (1, 5, 8, 64, n):
            a, c = engine.step_batch(carries[:width], obs[:width])
            want_a, _, want_c = agent.act(
                state, obs[:width], eval_mode=True,
                policy_carry=torch.as_tensor(carries[:width], device=card))
            np.testing.assert_array_equal(a, want_a.cpu().numpy())
            np.testing.assert_allclose(c, want_c.cpu().numpy(), rtol=0,
                                       atol=ATOL)
        # device-resident carries stay on the card
        dev_c = torch.as_tensor(carries[:5], device=card)
        _, c_dev = engine.step_batch(dev_c, obs[:5])
        assert c_dev.is_cuda
        np.testing.assert_array_equal(
            c_dev.cpu().numpy(), engine.step_batch(carries[:5], obs[:5])[1])
    else:
        engine = agent.serve_engine()
        engine.load(state.policy_params, state.obs_norm, step=0)
        assert engine.captures_total == 3
        for width in (1, 5, 8, 64, n):
            got = engine.infer(obs[:width])
            want = agent.act(state, obs[:width], eval_mode=True)[0]
            want = want.cpu().numpy()
            if np.issubdtype(want.dtype, np.integer):
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert engine.captures_total == 3  # no capture on the request path


def test_hot_reload_under_load_labels_every_answer(card, tmp_path):
    agent = _agent(card, "pendulum", policy_hidden=(64, 64))
    s1 = agent.init_state(seed=0)
    gen = torch.Generator(device=card).manual_seed(1)
    s2 = s1._replace(policy_params=tree_map(
        lambda t: t + 0.05 * torch.randn(t.shape, generator=gen,
                                         device=card), s1.policy_params))
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, s1)
    engine = agent.serve_engine()
    batcher = MicroBatcher(engine, deadline_ms=2.0, adaptive_deadline=True)
    server = PolicyServer(engine, batcher, port=0,
                          checkpointer=Checkpointer(str(tmp_path / "ck")),
                          template=agent.init_state(), poll_interval=0.05)
    answers, fails = [], []
    stop = threading.Event()

    def client(k):
        rng = np.random.default_rng(k)
        while not stop.is_set():
            o = rng.standard_normal(3).astype(np.float32)
            req = urllib.request.Request(
                server.url + "/act", data=json.dumps(
                    {"obs": o.tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    out = json.loads(r.read())
                answers.append((o, out["action"], out["step"]))
            except Exception as e:  # collected and checked below
                fails.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(8)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.5)
        ck.save(2, s2)
        deadline = time.monotonic() + 30
        while engine.loaded_step != 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        server.close()
        batcher.close()
    assert engine.loaded_step == 2 and not fails, fails[:3]
    assert engine.captures_total == 6  # 3 rungs at each of two loads
    states = {1: s1, 2: s2}
    assert {step for *_, step in answers} == {1, 2}
    for o, action, step in answers:
        want = agent.act(states[step], o, eval_mode=True)[0].cpu().numpy()
        np.testing.assert_allclose(np.float32(action), want, rtol=0,
                                   atol=ATOL)
