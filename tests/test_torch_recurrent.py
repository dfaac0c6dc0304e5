"""The port's recurrent family against trpo_tpu on the CPU: the GRU and LSTM
cells, the window replay with resets, the env-axis curvature subsample,
the POMDP critic's ``[obs, state]`` features, ``MaskObservation``, the
rollout's recurrent carry, ``act`` with memory, and one recurrent update.

Params, windows and trajectories are drawn with numpy (or by trpo_tpu)
and carried across with ``trpo_torch.convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trpo_tpu import trpo as tpu_trpo
from trpo_tpu.agent import TRPOAgent as TpuAgent
from trpo_tpu.config import TRPOConfig as TpuConfig
from trpo_tpu.envs import make as tpu_make_env
from trpo_tpu.envs.cartpole import CartPoleState as TpuCartPoleState
from trpo_tpu.models import DiscreteSpec as TpuDiscrete
from trpo_tpu.models import SeqObs as TpuSeqObs
from trpo_tpu.models import make_recurrent_policy as tpu_make_recurrent
from trpo_tpu.models.recurrent import gru_step as tpu_gru_step
from trpo_tpu.models.recurrent import init_gru as tpu_init_gru
from trpo_tpu.models.recurrent import init_lstm as tpu_init_lstm
from trpo_tpu.models.recurrent import lstm_step as tpu_lstm_step
from trpo_tpu.ops import flatten_params as tpu_flatten
from trpo_tpu.rollout import Trajectory as TpuTrajectory
from trpo_torch import envs, trpo
from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig, get_preset
from trpo_torch.convert import (
    policy_params_from_numpy,
    trajectory_from_numpy,
)
from trpo_torch.envs.cartpole import CartPoleState
from trpo_torch.envs.wrappers import MaskObservation
from trpo_torch.models.policy import DiscreteSpec
from trpo_torch.models.recurrent import (
    SeqObs,
    gru_step,
    lstm_step,
    make_recurrent_policy,
)
from trpo_torch.ops.flat import flatten_params, tree_leaves
from trpo_torch.rollout import device_rollout, init_env_states

J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
T = torch.from_numpy
TW, N, OBS = 12, 4, (3,)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_cell_step_matches_reference(cell):
    init, step = {"gru": (tpu_init_gru, tpu_gru_step),
                  "lstm": (tpu_init_lstm, tpu_lstm_step)}[cell]
    port_step = {"gru": gru_step, "lstm": lstm_step}[cell]
    params = _np(init(jax.random.key(0), 5, 8))
    rng = np.random.default_rng(1)
    mult = 1 if cell == "gru" else 2
    h = rng.normal(size=(6, 8 * mult)).astype(np.float32)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    want = np.asarray(step(J(params), jnp.asarray(h), jnp.asarray(x)))
    got = port_step(policy_params_from_numpy(params), T(h), T(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _window(rng, state_size):
    obs = rng.normal(size=(TW, N) + OBS).astype(np.float32)
    reset = np.zeros((TW, N), bool)
    reset[0] = True
    reset[5, 1] = reset[8, 3] = True
    h0 = rng.normal(size=(N, state_size)).astype(np.float32)
    return obs, reset, h0


def _policies(cell, spec=DiscreteSpec(2)):
    ref = tpu_make_recurrent(OBS, TpuDiscrete(spec.n), hidden=(16,),
                             gru_size=8, cell=cell)
    port = make_recurrent_policy(OBS, spec, hidden=(16,), gru_size=8,
                                 cell=cell)
    return ref, port


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_window_replay_with_resets_matches_reference(cell):
    ref, port = _policies(cell)
    assert port.state_size == ref.state_size
    params = _np(ref.init(jax.random.key(2)))
    obs, reset, h0 = _window(np.random.default_rng(3), ref.state_size)
    want = ref.apply(J(params), TpuSeqObs(jnp.asarray(obs),
                                          jnp.asarray(reset),
                                          jnp.asarray(h0)))
    got = port.apply(policy_params_from_numpy(params),
                     SeqObs(T(obs), T(reset), T(h0)))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=1e-5,
                               atol=1e-6)
    # the single-step interface the rollout uses, with the same zeroing
    p = policy_params_from_numpy(params)
    h, steps = T(h0), []
    for t in range(TW):
        h = torch.where(T(reset[t])[:, None], torch.zeros_like(h), h)
        h, d = port.step(p, h, T(obs[t]))
        steps.append(d["logits"])
    np.testing.assert_allclose(torch.stack(steps).numpy(),
                               got["logits"].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fraction", [0.5, 0.75, 0.9])
def test_env_axis_subsample_keeps_reference_indices(fraction):
    rng = np.random.default_rng(4)
    n = 7
    obs = rng.normal(size=(5, n, 2)).astype(np.float32)
    reset = rng.integers(0, 2, size=(5, n)).astype(bool)
    h0 = rng.normal(size=(n, 3)).astype(np.float32)
    actions = rng.integers(0, 2, size=(5, n))
    adv = rng.normal(size=(5, n)).astype(np.float32)
    logits = rng.normal(size=(5, n, 2)).astype(np.float32)
    weight = np.ones((5, n), np.float32)
    want = tpu_trpo._fvp_batch(tpu_trpo.TRPOBatch(
        TpuSeqObs(jnp.asarray(obs), jnp.asarray(reset), jnp.asarray(h0)),
        jnp.asarray(actions), jnp.asarray(adv),
        {"logits": jnp.asarray(logits)}, jnp.asarray(weight)), fraction)
    got = trpo._fvp_batch(trpo.TRPOBatch(
        SeqObs(T(obs), T(reset), T(h0)), T(actions), T(adv),
        {"logits": T(logits)}, T(weight)), fraction)
    for a, b in zip([*got.obs, got.actions, got.advantages,
                     got.old_dist["logits"], got.weight],
                    [*want.obs, want.actions, want.advantages,
                     want.old_dist["logits"], want.weight]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.obs.h0.shape[0] < n


def test_pomdp_critic_features_match_reference():
    cfg = dict(n_envs=N, batch_timesteps=N * TW, policy_hidden=(16,),
               policy_gru=8, policy_cell="lstm")
    ref_agent = TpuAgent("cartpole-po", TpuConfig(env="cartpole-po", **cfg))
    agent = TRPOAgent("cartpole-po", TRPOConfig(env="cartpole-po", **cfg),
                      device="cpu")
    rng = np.random.default_rng(5)
    S = agent.policy.state_size
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa
    traj = dict(obs=f(TW, N, 2), actions=rng.integers(0, 2, (TW, N)),
                rewards=f(TW, N), terminated=np.zeros((TW, N), bool),
                done=np.zeros((TW, N), bool), old_dist={"logits": f(TW, N, 2)},
                next_obs=f(TW, N, 2), episode_return=f(TW, N),
                episode_length=np.ones((TW, N), np.int32),
                reset=np.zeros((TW, N), bool), policy_h0=f(N, S),
                policy_h=f(TW, N, S), policy_h_next=f(TW, N, S))
    want = ref_agent._vf_features(TpuTrajectory(**J(traj)))
    got = agent._vf_features(trajectory_from_numpy(traj))
    assert got[0].shape == (TW * N, 2 + S)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert agent.vf.init(torch.Generator().manual_seed(0)).params[
        "layers"][0]["w"].shape[0] == 2 + S


def test_mask_observation_matches_reference():
    ref_env = tpu_make_env("cartpole-po", max_episode_steps=4)
    env = envs.make("cartpole-po", max_episode_steps=4)
    assert env.obs_shape == ref_env.obs_shape == (2,)
    assert env.max_episode_steps == 4
    rng = np.random.default_rng(6)
    fields = list(rng.uniform(-0.15, 0.15, size=(4, 6)).astype(np.float32))
    fields.append(np.array([0, 1, 2, 3, 0, 1], np.int32))
    ref_state = TpuCartPoleState(*[jnp.asarray(x) for x in fields])
    state = CartPoleState(*[T(x) for x in fields])
    keys = jax.random.split(jax.random.key(0), 6)
    for _ in range(3):
        actions = rng.integers(0, 2, size=6)
        ref = jax.vmap(ref_env.step)(ref_state, jnp.asarray(actions), keys)
        got = env.step(state, T(actions))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
        ref_state, state = ref[0], got[0]
    _, obs = env.reset(5, torch.Generator().manual_seed(0))
    assert obs.shape == (5, 2)
    with pytest.raises(ValueError, match="invalid"):
        MaskObservation(envs.make("cartpole"), (0, 4))


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_rollout_threads_the_state_and_chunks_bit_exactly(cell):
    env = envs.make("cartpole-po", max_episode_steps=5)
    policy = make_recurrent_policy(env.obs_shape, env.action_spec,
                                   hidden=(16,), gru_size=8, cell=cell)
    params = policy.init(torch.Generator().manual_seed(0))

    def roll(chunk):
        g = torch.Generator().manual_seed(1)
        return device_rollout(env, policy, params,
                              init_env_states(env, N, g, policy=policy), g,
                              TW, chunk=chunk)

    carry, traj = roll(None)
    assert len(carry) == 6 and traj.reset[0].all()
    assert torch.count_nonzero(traj.policy_h[0]) == 0
    done = traj.done[:-1, :, None]
    # the state entering step t+1 is step t's output, zeroed after an end
    assert torch.equal(traj.policy_h[1:],
                       torch.where(done, torch.zeros_like(traj.policy_h[1:]),
                                   traj.policy_h_next[:-1]))
    assert torch.equal(traj.reset[1:], traj.done[:-1])
    assert traj.done.any()
    for chunk in (3, 4):
        c2, t2 = roll(chunk)
        for a, b in zip(tree_leaves((carry, traj)), tree_leaves((c2, t2))):
            assert torch.equal(a, b)


def test_act_carries_memory():
    cfg = get_preset("cartpole-po").replace(n_envs=N, batch_timesteps=64,
                                            policy_hidden=(16,),
                                            policy_gru=8)
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    state = agent.init_state()
    obs = torch.tensor([[0.1, -0.2], [0.0, 0.3]])
    a1, d1, h1 = agent.act(state, obs, eval_mode=True)
    a2, d2, h2 = agent.act(state, obs, eval_mode=True, policy_carry=h1)
    h_ref, d_ref = agent.policy.step(state.policy_params, h1, obs)
    assert torch.equal(h2, h_ref) and torch.equal(d2["logits"],
                                                  d_ref["logits"])
    assert not torch.equal(d1["logits"], d2["logits"])
    single = agent.act(state, obs[0], eval_mode=True)
    assert single[2].shape == (8,) and single[0].shape == ()
    mean, n_done = agent.evaluate(state, n_steps=30)
    assert np.isfinite(mean) and n_done > 0


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_recurrent_update_matches_reference(cell):
    ref, port = _policies(cell)
    params = _np(ref.init(jax.random.key(7)))
    rng = np.random.default_rng(8)
    obs, reset, h0 = _window(rng, ref.state_size)
    seq = TpuSeqObs(jnp.asarray(obs), jnp.asarray(reset), jnp.asarray(h0))
    dist = _np(ref.apply(J(params), seq))
    actions = rng.integers(0, 2, size=(TW, N)).astype(np.int32)
    adv = rng.normal(size=(TW, N)).astype(np.float32)
    adv = ((adv - adv.mean()) / adv.std()).astype(np.float32)
    cfg_kw = dict(cg_iters=10, cg_damping=0.1)
    ref_p, ref_s = jax.jit(tpu_trpo.make_trpo_update(ref, TpuConfig(
        **cfg_kw)))(J(params), tpu_trpo.TRPOBatch(
            seq, jnp.asarray(actions), jnp.asarray(adv), J(dist),
            jnp.ones((TW, N))))
    p, s = trpo.make_trpo_update(port, TRPOConfig(**cfg_kw))(
        policy_params_from_numpy(params),
        trpo.TRPOBatch(SeqObs(T(obs), T(reset), T(h0)), T(actions).long(),
                       T(adv), {"logits": T(dist["logits"])},
                       torch.ones(TW, N)))
    want = np.asarray(tpu_flatten(ref_p)[0], np.float64)
    got = flatten_params(p)[0].numpy().astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
    assert bool(s.linesearch_success) == bool(ref_s.linesearch_success)
    for name in ("kl", "surrogate_after", "entropy"):
        np.testing.assert_allclose(float(getattr(s, name)),
                                   float(getattr(ref_s, name)), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_recurrent_refuses_the_bf16_rung_and_head_block():
    cfg = get_preset("cartpole-po").replace(
        n_envs=N, batch_timesteps=64, policy_hidden=(16,), policy_gru=8,
        fvp_dtype="bf16", solve_audit_every=1)
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    with pytest.raises(ValueError, match="apply_cast"):
        agent.run_iteration(agent.init_state())
