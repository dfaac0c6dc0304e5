"""The port's gymnasium adapter against the reference's
(``tests/test_pipeline_rollout.py``, ``tests/test_host_env_checkpoint.py``,
``tests/test_render_and_gym_errors.py``): bitwise-equal steps on the same
seeds and actions, the shared obs-norm fold, the MuJoCo state restore, the
fleet cap and the actionable errors.
"""

import importlib.util
import sys

import numpy as np
import pytest

gymnasium = pytest.importorskip("gymnasium")

from trpo_tpu.envs.gym_adapter import GymVecEnv as TpuGymVecEnv  # noqa: E402
from trpo_torch import envs  # noqa: E402
from trpo_torch.agent import TRPOAgent  # noqa: E402
from trpo_torch.config import TRPOConfig, get_preset  # noqa: E402
from trpo_torch.envs.gym_adapter import GymVecEnv  # noqa: E402

needs_mujoco = pytest.mark.skipif(
    importlib.util.find_spec("mujoco") is None, reason="mujoco unavailable")


def _actions(env, rng, n):
    spec = env.action_spec
    if hasattr(spec, "n"):
        return rng.integers(0, spec.n, size=n)
    # beyond the Box on purpose: the adapters clip
    return rng.uniform(-1.5, 1.5, size=(n, spec.dim)).astype(np.float32)


@pytest.mark.parametrize("env_id, steps", [
    ("Pendulum-v1", 230),  # crosses the 200-step truncation
    pytest.param("HalfCheetah-v4", 60, marks=needs_mujoco),
])
@pytest.mark.parametrize("normalize_obs", [False, True])
def test_port_steps_equal_reference_bitwise(env_id, steps, normalize_obs):
    n = 3
    port = GymVecEnv(env_id, n_envs=n, seed=5, normalize_obs=normalize_obs)
    ref = TpuGymVecEnv(env_id, n_envs=n, seed=5, normalize_obs=normalize_obs)
    assert port.obs_shape == ref.obs_shape
    assert port.action_spec.dim == ref.action_spec.dim
    np.testing.assert_array_equal(port.current_obs(), ref.current_obs())
    rng = np.random.default_rng(0)
    for _ in range(steps):
        a = _actions(port, rng, n)
        for x, y in zip(port.host_step(a), ref.host_step(a)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(port.last_episode_returns,
                                      ref.last_episode_returns)
        np.testing.assert_array_equal(port.last_episode_lengths,
                                      ref.last_episode_lengths)
    if normalize_obs:
        np.testing.assert_array_equal(port._n_mean, ref._n_mean)
        np.testing.assert_array_equal(port._n_m2, ref._n_m2)
        assert port._n_count == ref._n_count
    np.testing.assert_array_equal(port.reset_all(seed=2),
                                  ref.reset_all(seed=2))
    port.close()
    ref.close()


def test_slice_fold_matches_full_batch_fold():
    # the reference's tolerance (tests/test_pipeline_rollout.py:113)
    full = GymVecEnv("CartPole-v1", n_envs=4, seed=0, normalize_obs=True)
    sliced = GymVecEnv("CartPole-v1", n_envs=4, seed=0, normalize_obs=True)
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = rng.integers(0, 2, size=4)
        full.host_step(a)
        sliced.host_step_slice(a[:2], 0, 2)
        sliced.host_step_slice(a[2:], 2, 4)
    c_f, m_f, v_f = full.obs_stats_state()
    c_s, m_s, v_s = sliced.obs_stats_state()
    assert c_f == c_s
    np.testing.assert_allclose(m_f, m_s, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(v_f, v_s, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(full.last_episode_lengths,
                                  sliced.last_episode_lengths)


def test_deferred_fold_merges_in_group_order_and_refreshes_cache():
    a = GymVecEnv("CartPole-v1", n_envs=4, seed=1, normalize_obs=True)
    b = GymVecEnv("CartPole-v1", n_envs=4, seed=1, normalize_obs=True)
    rng = np.random.default_rng(1)
    acts = [rng.integers(0, 2, size=4) for _ in range(6)]
    for env, order in ((a, (0, 2)), (b, (2, 0))):
        env.begin_deferred_fold()
        start = env.obs_stats_state()
        for act in acts:
            for lo in order:  # the groups arrive in another order
                env.host_step_slice(act[lo:lo + 2], lo, lo + 2)
        for x, y in zip(env.obs_stats_state(), start):
            np.testing.assert_array_equal(x, y)  # nothing folded yet
        env.end_deferred_fold()
    for x, y in zip(a.obs_stats_state(), b.obs_stats_state()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.current_obs(), b.current_obs())
    np.testing.assert_array_equal(a.current_obs(),
                                  a._apply_norm(a._raw_obs))


@needs_mujoco
def test_mujoco_qpos_qvel_restore():
    env = envs.make("gym:HalfCheetah-v4", n_envs=1, seed=0)
    a = np.zeros((1, 6), np.float32)
    for _ in range(3):
        env.host_step(a)
    snap = env.env_state_snapshot()
    assert snap["sims"][0]["backend"] == "mujoco"
    o1 = env.host_step(a)[0].copy()
    env.env_state_restore(snap)
    o2 = env.host_step(a)[0].copy()
    np.testing.assert_array_equal(o1, o2)
    env.close()


def test_classic_control_restore_replays_reset_randomness():
    env = envs.make("gym:CartPole-v1", n_envs=1, seed=11)
    for _ in range(3):
        env.host_step(np.zeros(1, np.int64))
    snap = env.env_state_snapshot()
    assert snap["sims"][0]["backend"] == "state"
    o_uninterrupted, _ = env.envs[0].reset()
    env.env_state_restore(snap)
    o_resumed, _ = env.envs[0].reset()
    np.testing.assert_array_equal(o_uninterrupted, o_resumed)
    with pytest.raises(ValueError, match="same n_envs"):
        envs.make("gym:CartPole-v1", n_envs=2).env_state_restore(snap)


def test_fleet_cap_applies_to_gym_only():
    cfg = TRPOConfig(env="gym:CartPole-v1", fleet_n_envs=300,
                     batch_timesteps=600)
    with pytest.raises(ValueError, match="fleet cap"):
        TRPOAgent(cfg.env, cfg, device="cpu")
    wide = cfg.replace(env="native:cartpole")
    agent = TRPOAgent(wide.env, wide, device="cpu")
    assert agent.env.n_envs == 300


@pytest.mark.skipif(importlib.util.find_spec("ale_py") is not None,
                    reason="ale-py present — the pong preset would work")
def test_pong_preset_fails_actionably_without_ale():
    with pytest.raises(RuntimeError) as e:
        TRPOAgent("gym:ALE/Pong-v5", get_preset("pong"), device="cpu")
    msg = str(e.value)
    assert "ALE/Pong-v5" in msg and "ale-py" in msg and "pong-sim" in msg


def test_missing_gymnasium_is_the_reference_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    with pytest.raises(ImportError, match="gymnasium is required"):
        envs.make("gym:CartPole-v1", n_envs=1)


def test_typo_keeps_gymnasiums_own_error():
    with pytest.raises(gymnasium.error.Error):
        envs.make("gym:CartPoel-v1", n_envs=1)


def test_render_frame_needs_render_mode():
    agent = TRPOAgent("gym:CartPole-v1", TRPOConfig(
        env="gym:CartPole-v1", n_envs=2, batch_timesteps=8,
        policy_hidden=(8,)), device="cpu")
    state = agent.init_state(seed=0)
    with pytest.raises(RuntimeError, match="render_mode"):
        agent.evaluate(state, n_steps=3, render=True)
    env = envs.make("gym:CartPole-v1", n_envs=2, render_mode="rgb_array")
    agent = TRPOAgent(env, TRPOConfig(env="gym:CartPole-v1", n_envs=2,
                                      batch_timesteps=8,
                                      policy_hidden=(8,)), device="cpu")
    _, _, frames = agent.evaluate(agent.init_state(seed=0), n_steps=3,
                                  render=True)
    assert len(frames) == 3 and frames[0].ndim == 3


def test_spec_from_env_reads_gymnasium_spaces():
    from trpo_torch.models.policy import BoxSpec, DiscreteSpec, spec_from_env

    assert spec_from_env(gymnasium.make("CartPole-v1")) == ((4,),
                                                             DiscreteSpec(2))
    assert spec_from_env(gymnasium.make("Pendulum-v1")) == ((3,), BoxSpec(1))
    adapter = GymVecEnv("Pendulum-v1", n_envs=1)
    assert spec_from_env(adapter) == ((3,), BoxSpec(1))
