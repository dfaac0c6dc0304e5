"""The port's envs, rollout and agent against trpo_tpu on the CPU, and the
agent's device rule.

Randomness differs between the packages (threefry vs Philox), so the
parity tests hand both the same numbers: env states and actions from
numpy, a trajectory rolled out by trpo_tpu and carried across with
``trpo_torch.convert``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trpo_tpu.agent import TRPOAgent as TpuAgent
from trpo_tpu.config import get_preset as tpu_get_preset
from trpo_tpu.envs.locomotion import ChainState as TpuChainState
from trpo_tpu.envs.locomotion import HalfCheetahSim as TpuHalfCheetah
from trpo_tpu.envs.locomotion import HumanoidSim as TpuHumanoid
from trpo_tpu.ops import flatten_params as tpu_flatten
from trpo_tpu.rollout import device_rollout as tpu_rollout
from trpo_torch import train
from trpo_torch.agent import TRPOAgent, resolve_device
from trpo_torch.config import get_preset
from trpo_torch.convert import (
    policy_params_from_numpy,
    policy_params_to_numpy,
    trajectory_from_numpy,
    vf_state_from_numpy,
)
from trpo_torch.envs.locomotion import (
    ChainState,
    HalfCheetahSim,
    HumanoidSim,
    projection_path,
)
from trpo_torch.ops.flat import flatten_params
from trpo_torch.rollout import device_rollout, init_env_states

ENVS = {"humanoid-sim": (TpuHumanoid, HumanoidSim),
        "halfcheetah-sim": (TpuHalfCheetah, HalfCheetahSim)}


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_projection_data_matches_fresh_reference_draw(name):
    ref = np.asarray(ENVS[name][0]()._w)
    shipped = np.load(projection_path(*ref.shape))
    assert shipped.dtype == np.float32
    np.testing.assert_array_equal(shipped, ref)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_step_parity(name):
    tpu_env, env = ENVS[name][0](max_episode_steps=3), ENVS[name][1](
        max_episode_steps=3)
    N, n = 6, env.n_masses
    rng = np.random.default_rng(0)
    pos = (np.arange(n) + 0.1 * rng.normal(size=(N, n))).astype(np.float32)
    vel = (0.3 * rng.normal(size=(N, n))).astype(np.float32)
    t = np.array([0, 1, 2, 0, 1, 2], np.int32)
    ref_state = TpuChainState(jnp.asarray(pos), jnp.asarray(vel),
                              jnp.asarray(t))
    state = ChainState(torch.from_numpy(pos), torch.from_numpy(vel),
                       torch.from_numpy(t))
    np.testing.assert_allclose(env.observe(state).numpy(),
                               np.asarray(jax.vmap(tpu_env._obs)(ref_state)),
                               rtol=1e-5, atol=1e-5)
    for _ in range(3):
        actions = (1.5 * rng.normal(size=(N, n))).astype(np.float32)
        keys = jax.random.split(jax.random.key(0), N)
        ref = jax.vmap(tpu_env.step)(ref_state, jnp.asarray(actions), keys)
        got = env.step(state, torch.from_numpy(actions))
        ref_state, state = ref[0], got[0]
        for a, b in zip(got[0], ref[0]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        # the projection matmul sums 11-33 terms in another order
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


def test_rollout_auto_reset_semantics():
    env = HalfCheetahSim(max_episode_steps=3)
    agent_cfg = get_preset("halfcheetah-sim").replace(
        solve_audit_every=0, policy_hidden=(8,))
    agent = TRPOAgent(env, agent_cfg, device="cpu")
    params = agent.policy.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    carry = init_env_states(env, 2, g)
    noise = torch.zeros(7, 2, 6)
    carry, traj = device_rollout(env, agent.policy, params, carry, g, 7,
                                 action_noise=noise)
    done = traj.done.numpy()
    assert done[:, 0].tolist() == [False, False, True] * 2 + [False]
    assert not traj.terminated.any()
    assert traj.episode_length[2].tolist() == [3, 3]
    np.testing.assert_allclose(traj.episode_return[2].numpy(),
                               traj.rewards[:3].sum(0).numpy(), rtol=1e-6)
    # next_obs at the boundary is the pre-reset successor, not the reset obs
    assert not torch.allclose(traj.next_obs[2], traj.obs[3])
    torch.testing.assert_close(traj.next_obs[1], traj.obs[2])
    # zero noise: actions are the policy mean
    torch.testing.assert_close(traj.actions, traj.old_dist["mean"])
    assert carry[3].tolist() == [1, 1]


def _small_tpu_cfg():
    return tpu_get_preset("humanoid-sim").replace(
        n_envs=4, batch_timesteps=64, max_pathlength=10,
        policy_hidden=(32, 32), solve_audit_every=0)


def test_process_trajectory_matches_reference():
    tpu_cfg = _small_tpu_cfg()
    tpu_agent = TpuAgent("humanoid-sim", tpu_cfg)
    ref_state = tpu_agent.init_state(seed=0)
    ref_state = ref_state._replace(vf_state=ref_state.vf_state._replace(
        initialized=jnp.asarray(True)))
    _, traj = jax.jit(
        lambda p, c, k: tpu_rollout(tpu_agent.env, tpu_agent.policy, p, c, k,
                                    tpu_agent.n_steps)
    )(ref_state.policy_params, ref_state.env_carry, jax.random.key(5))
    traj_np = _np(traj)
    assert traj_np.done.any()  # truncation boundaries inside the window
    params_np = _np(ref_state.policy_params)
    vf_np = _np(ref_state.vf_state)
    adam = vf_np.opt_state[0]

    cfg = get_preset("humanoid-sim").replace(
        n_envs=4, batch_timesteps=64, max_pathlength=10,
        policy_hidden=(32, 32), solve_audit_every=0)
    agent = TRPOAgent("humanoid-sim", cfg, device="cpu")
    state = agent.init_state(seed=0)._replace(
        policy_params=policy_params_from_numpy(params_np),
        vf_state=vf_state_from_numpy(vf_np.params, adam.mu, adam.nu,
                                     int(adam.count), True),
    )
    assert state.precond is not None and state.precond.age == 0

    ref_new, ref_stats = jax.jit(tpu_agent._process_trajectory)(ref_state,
                                                                traj)
    new, stats = agent._process_trajectory(state,
                                           trajectory_from_numpy(traj_np))

    want = np.asarray(tpu_flatten(ref_new.policy_params)[0], np.float64)
    got = flatten_params(new.policy_params)[0].numpy().astype(np.float64)
    # the whole iteration in f32 on two backends; CG amplifies roundoff
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
    # 50 critic Adam steps compound roundoff: 1e-4 of the weights' scale
    for a, b in zip(jax.tree_util.tree_leaves(
            policy_params_to_numpy(new.vf_state.params)),
            jax.tree_util.tree_leaves(_np(ref_new.vf_state.params))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert new.precond.age == 1
    assert set(stats) <= set(ref_stats)
    for key, value in stats.items():
        ref = np.asarray(ref_stats[key])
        value = value.numpy() if isinstance(value, torch.Tensor) else value
        if ref.dtype == bool:
            assert bool(value) == bool(ref), key
        else:
            np.testing.assert_allclose(float(value), float(ref), rtol=1e-4,
                                       atol=1e-4, err_msg=key)


def test_run_iteration_on_cpu_stays_finite():
    cfg = get_preset("humanoid-sim").replace(
        n_envs=8, batch_timesteps=256, max_pathlength=20,
        policy_hidden=(32, 32), solve_audit_every=0)
    agent = TRPOAgent("humanoid-sim", cfg, device="cpu")
    state = agent.init_state()
    for _ in range(2):
        state, stats = agent.run_iteration(state)
        for key, value in stats.items():
            assert math.isfinite(float(value)), key
        assert float(stats["kl_old_new"]) <= 2 * cfg.max_kl
    assert state.iteration == 2 and state.total_timesteps == 512


def test_agent_without_device_raises_when_cuda_is_missing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_preset("humanoid-sim").replace(solve_audit_every=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TRPOAgent("humanoid-sim", cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--preset", "humanoid-sim", "--solve-audit-every", "0",
                    "--iterations", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_train_cli_on_cpu(capsys):
    assert train.main([
        "--preset", "halfcheetah-sim", "--solve-audit-every", "0",
        "--iterations", "1", "--n-envs", "4", "--batch-timesteps", "64",
        "--policy-hidden", "16,16", "--device", "cpu",
    ]) == 0
    out = capsys.readouterr().out
    assert "iter 1 " in out and "kl_old_new=" in out


def test_unported_env_and_preset_paths_raise():
    # the ladder, the fleet presets, the pixel, recurrent and MoE families,
    # the gym:/native: host envs, the overlapped loop and the serving data
    # plane run now; the gymproc: worker pool and the serving control
    # plane still raise, naming their ROADMAP items
    agent = TRPOAgent("cartpole", get_preset("cartpole").replace(
        train_overlap=1, rollout_chunk=5), device="cpu")
    assert agent._overlap and agent.n_steps == 125
    with pytest.raises(NotImplementedError, match="item 18"):
        TRPOAgent("gymproc:CartPole-v1", get_preset("cartpole"),
                  device="cpu")
    with pytest.raises(NotImplementedError, match="item 18"):
        TRPOAgent("cartpole", get_preset("cartpole").replace(
            env="gymproc:CartPole-v1"), device="cpu")
    # the serving data plane runs now; its control plane still raises
    assert agent.serve_engine().batch_shapes == (1, 8, 64)
    for control in ({"serve_replicas": 2}, {"serve_hosts": ("a",)},
                    {"serve_canary_fraction": 0.25}):
        with pytest.raises(NotImplementedError,
                           match=r"item 17 \(the control plane\)"):
            TRPOAgent("cartpole", get_preset("cartpole").replace(**control),
                      device="cpu")
    pytest.importorskip("mujoco")
    agent = TRPOAgent("gym:HalfCheetah-v4", get_preset("halfcheetah")
                      .replace(n_envs=2), device="cpu")
    assert agent.obs_shape == (17,) and not agent.is_device_env


_LADDER_KEYS = ("solve_cosine", "solve_audited", "solve_fallback",
                "solve_pinned", "cg_budget", "solve_cosine_min",
                "audit_runs", "fallbacks")


@pytest.mark.parametrize("preset, narrow", [
    ("humanoid-sim", dict(n_envs=8, batch_timesteps=256,
                          policy_hidden=(32, 32))),
    ("humanoid-sim-fleet", dict(fleet_n_envs=16, batch_timesteps=112,
                                policy_hidden=(32, 32))),
    ("cartpole", dict(n_envs=8, batch_timesteps=256)),
    ("pendulum", dict(n_envs=8, batch_timesteps=256)),
])
def test_run_iteration_presets_on_cpu(preset, narrow):
    cfg = get_preset(preset).replace(**narrow)
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    state = agent.init_state()
    laddered = state.ladder is not None
    assert laddered == (preset.startswith("humanoid"))
    for i in range(2):
        state, stats = agent.run_iteration(state)
        for key, value in stats.items():
            if key in ("mean_episode_reward", "mean_episode_length") \
                    and int(stats["episodes_in_batch"]) == 0:
                continue  # NaN by contract when no episode ended
            if key == "solve_cosine" and not bool(stats["solve_audited"]):
                continue  # NaN by contract on an unaudited update
            assert math.isfinite(float(value)), key
        assert all((k in stats) == laddered for k in _LADDER_KEYS)
        if laddered:
            # the audit fires on update 1 (step 0) and then every 25th
            assert bool(stats["solve_audited"]) == (i == 0)
            assert int(stats["audit_runs"]) == 1
    if laddered:
        assert state.ladder.step_host == 2 and int(state.ladder.step) == 2


def test_adaptive_damping_rides_the_train_state():
    cfg = get_preset("halfcheetah-sim").replace(
        n_envs=4, batch_timesteps=64, policy_hidden=(16,),
        adaptive_damping=True, cg_damping=0.2)
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    state = agent.init_state()
    assert float(state.cg_damping) == pytest.approx(0.2)
    state, stats = agent.run_iteration(state)
    assert float(stats["cg_damping"]) == pytest.approx(0.2)
    # a clean step shrinks λ by damping_shrink; a failed one grows it
    factor = float(state.cg_damping) / 0.2
    assert factor == pytest.approx(cfg.damping_shrink) or \
        factor == pytest.approx(cfg.damping_grow)
    state, stats = agent.run_iteration(state)
    assert float(stats["cg_damping"]) == pytest.approx(0.2 * factor)


@pytest.mark.slow
@pytest.mark.parametrize("preset", [
    "cartpole", "pendulum", "halfcheetah-sim", "humanoid-sim",
    "cartpole-fleet", "halfcheetah-sim-fleet", "humanoid-sim-fleet"])
def test_presets_run_unchanged_on_cpu(preset):
    cfg = get_preset(preset)
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    state, stats = agent.run_iteration(agent.init_state())
    assert math.isfinite(float(stats["kl_old_new"]))
    assert float(stats["kl_old_new"]) <= 2 * cfg.max_kl


@pytest.mark.slow
def test_cartpole_learns_on_cpu():
    # the reference's own demo through the port's categorical head
    cfg = get_preset("cartpole").replace(seed=0)
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    state = agent.init_state()
    rewards = []
    for _ in range(30):
        state, stats = agent.run_iteration(state)
        rewards.append(float(stats["mean_episode_reward"]))
    assert np.nanmean(rewards[-5:]) > 150.0, rewards
