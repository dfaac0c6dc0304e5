"""The port's pixel path against trpo_tpu on the CPU: the Nature conv torso,
the conv policy, the Catch env at both of its shapes, the conv GGN
Fisher-vector product and one ``catch`` update.

Params cross with ``trpo_torch.convert`` (conv filters ``HWIO`` →
``OIHW``), so the flat vectors of the two packages order the filters
differently: vectors cross as trees, and results are compared in the
reference's order. The pong-sim tests stay at a few rows (forward and
FVP only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trpo_tpu import trpo as tpu_trpo
from trpo_tpu.config import TRPOConfig as TpuConfig
from trpo_tpu.envs.catch import CatchPixels as TpuCatch
from trpo_tpu.envs.catch import CatchState as TpuCatchState
from trpo_tpu.models import DiscreteSpec as TpuDiscrete
from trpo_tpu.models import apply_atari_torso as tpu_torso
from trpo_tpu.models import init_atari_torso as tpu_init_torso
from trpo_tpu.models import make_policy as tpu_make_policy
from trpo_tpu.ops import flatten_params as tpu_flatten
from trpo_tpu.ops import make_ggn_fvp as tpu_make_ggn_fvp
from trpo_torch import envs, trpo
from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig, get_preset
from trpo_torch.convert import (
    policy_params_from_numpy,
    policy_params_to_numpy,
)
from trpo_torch.envs.catch import CatchState
from trpo_torch.models.conv import apply_atari_torso, torso_features
from trpo_torch.models.policy import DiscreteSpec, make_policy
from trpo_torch.ops.flat import flatten_params
from trpo_torch.ops.fvp import make_ggn_fvp

J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
T = torch.from_numpy
DAMPING = 0.1


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _ref_flat(port_tree):
    """A port params tree as the reference's flat vector."""
    return np.asarray(tpu_flatten(J(policy_params_to_numpy(port_tree)))[0])


def _pixels(rng, shape, dtype):
    if dtype == "uint8":
        return rng.integers(0, 256, size=shape).astype(np.uint8)
    return rng.uniform(0.0, 1.0, size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("rows", [2, 4])
def test_torso_matches_reference(dtype, rows):
    params = _np(tpu_init_torso(jax.random.key(rows), in_channels=4))
    x = _pixels(np.random.default_rng(rows), (rows, 84, 84, 4), dtype)
    want = np.asarray(tpu_torso(J(params), jnp.asarray(x)))
    got = apply_atari_torso(policy_params_from_numpy(params), T(x))
    assert got.shape == want.shape == (rows, torso_features((84, 84, 4)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(40, 40, 1), (84, 84, 4)])
def test_conv_policy_logits_match_reference(shape):
    tpu_policy = tpu_make_policy(shape, TpuDiscrete(3), hidden=(512,))
    params = _np(tpu_policy.init(jax.random.key(1)))
    obs = _pixels(np.random.default_rng(2), (3,) + shape, "uint8")
    want = np.asarray(tpu_policy.apply(J(params), jnp.asarray(obs))["logits"])
    policy = make_policy(shape, DiscreteSpec(3), hidden=(512,))
    got = policy.apply(policy_params_from_numpy(params), T(obs))["logits"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert policy.mlp_spec is None and policy.apply_cast is not None


def test_pong_sim_shape_and_parameter_count():
    env = envs.make("pong-sim")
    assert env.obs_shape == (84, 84, 4) and env.action_spec.n == 3
    policy = make_policy(env.obs_shape, env.action_spec, hidden=(512,))
    n = flatten_params(policy.init(torch.Generator().manual_seed(0)))[0]
    ref = tpu_make_policy((84, 84, 4), TpuDiscrete(3), hidden=(512,))
    n_ref = sum(int(np.prod(x.shape)) for x in
                jax.tree_util.tree_leaves(ref.init(jax.random.key(0))))
    assert n.numel() == n_ref >= 1_000_000
    with pytest.raises(TypeError, match="fixed horizon"):
        envs.make("catch", max_episode_steps=5)


def _catch_states(rng, N, grid, frames):
    ball_row = rng.integers(0, grid - 1, size=N).astype(np.int32)
    ball_col = rng.integers(0, grid, size=N).astype(np.int32)
    paddle = rng.integers(0, grid, size=N).astype(np.int32)
    t = ball_row.copy()
    hist = rng.integers(0, grid, size=(N, frames, 3)).astype(np.int32)
    hist[:, 0] = np.stack([ball_row, ball_col, paddle], axis=1)
    return ball_row, ball_col, paddle, t, hist


@pytest.mark.parametrize("name, kw", [
    ("catch", dict()),
    ("pong-sim", dict(grid=21, cell_px=4, frames=4)),
])
def test_catch_reset_and_step_match_reference(name, kw):
    ref_env, env = TpuCatch(**kw), envs.make(name)
    assert env.obs_shape == ref_env.obs_shape
    N = 7
    # reset: the reference's boards from its own draws, rendered by both
    keys = jax.random.split(jax.random.key(0), N)
    ref_state, ref_obs = jax.vmap(ref_env.reset)(keys)
    state = CatchState(*(T(np.array(x)) for x in ref_state))
    np.testing.assert_array_equal(env.observe(state).numpy(),
                                  np.asarray(ref_obs))
    fresh, obs = env.reset(N, torch.Generator().manual_seed(0))
    assert obs.dtype == torch.uint8 and obs.shape == (N,) + env.obs_shape
    assert int(fresh.ball_row.max()) == 0
    assert torch.all(fresh.paddle_col == env.grid // 2)
    assert torch.equal(fresh.hist, fresh.hist[:, :1].expand_as(fresh.hist))
    # steps from the same states and actions
    rng = np.random.default_rng(1)
    arrays = _catch_states(rng, N, env.grid, env.frames)
    ref_state = TpuCatchState(*(jnp.asarray(a) for a in arrays))
    state = CatchState(*(T(a) for a in arrays))
    for _ in range(env.grid):
        actions = rng.integers(0, 3, size=N)
        ref = jax.vmap(ref_env.step)(ref_state, jnp.asarray(actions), keys)
        got = env.step(state, T(actions))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
        assert not got[4].any()
        for a, b in zip(got[0], ref[0]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        ref_state, state = ref[0], got[0]


def _catch_problem(B=64, seed=0):
    tpu_policy = tpu_make_policy((40, 40, 1), TpuDiscrete(3), hidden=(32,))
    params = _np(tpu_policy.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    obs = _pixels(rng, (B, 40, 40, 1), "uint8")
    return tpu_policy, params, obs, rng


def test_conv_ggn_fvp_matches_reference():
    tpu_policy, params, obs, rng = _catch_problem()
    weight = np.ones(obs.shape[0], np.float32)
    weight[-9:] = 0.0
    flat0, unravel = tpu_flatten(J(params))
    v = rng.normal(size=flat0.shape[0]).astype(np.float32)
    want = tpu_make_ggn_fvp(
        lambda f: tpu_policy.apply(unravel(f), jnp.asarray(obs)),
        tpu_policy.dist.fisher_weight, flat0, jnp.asarray(weight),
        damping=DAMPING)(jnp.asarray(v))
    # v crosses as a tree (the filters' flat order differs)
    policy = make_policy((40, 40, 1), DiscreteSpec(3), hidden=(32,))
    x0, port_unravel = flatten_params(policy_params_from_numpy(params))
    v_port = flatten_params(policy_params_from_numpy(_np(unravel(v))))[0]
    got = make_ggn_fvp(lambda x: policy.apply(port_unravel(x), T(obs)),
                       policy.dist.fisher_weight, x0, T(weight),
                       damping=DAMPING)(v_port)
    assert _rel(_ref_flat(port_unravel(got)), want) < 1e-5


def test_catch_update_matches_reference():
    tpu_policy, params, obs, rng = _catch_problem(B=128, seed=3)
    B = obs.shape[0]
    dist = _np(tpu_policy.apply(J(params), jnp.asarray(obs)))
    actions = rng.integers(0, 3, size=B).astype(np.int32)
    adv = rng.normal(size=B).astype(np.float32)
    adv = ((adv - adv.mean()) / adv.std()).astype(np.float32)
    cfg_kw = dict(cg_iters=10, cg_damping=0.1)
    ref_p, ref_s = jax.jit(tpu_trpo.make_trpo_update(
        tpu_policy, TpuConfig(**cfg_kw)))(
        J(params), tpu_trpo.TRPOBatch(jnp.asarray(obs), jnp.asarray(actions),
                                      jnp.asarray(adv), J(dist),
                                      jnp.ones(B)))
    policy = make_policy((40, 40, 1), DiscreteSpec(3), hidden=(32,))
    p, s = trpo.make_trpo_update(policy, TRPOConfig(**cfg_kw))(
        policy_params_from_numpy(params),
        trpo.TRPOBatch(T(obs), T(actions).long(), T(adv),
                       {"logits": T(dist["logits"])}, torch.ones(B)))
    want = np.asarray(tpu_flatten(ref_p)[0], np.float64)
    assert _rel(_ref_flat(p), want) < 1e-4
    # the residual of this system reaches the 1e-10 exit near iteration 9,
    # where the two backends' f32 roundoff decides which side of it an
    # iterate lands: the counts may differ by one, the solutions do not
    assert abs(int(s.cg_iterations) - int(ref_s.cg_iterations)) <= 1
    assert bool(s.linesearch_success) == bool(ref_s.linesearch_success)
    for name in ("kl", "surrogate_after", "entropy"):
        np.testing.assert_allclose(float(getattr(s, name)),
                                   float(getattr(ref_s, name)), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_pixel_agent_keeps_uint8_and_refuses_the_fused_kernel():
    cfg = get_preset("catch").replace(n_envs=4, batch_timesteps=64,
                                      policy_hidden=(16,), vf_train_steps=2)
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.deterministic
    state = agent.init_state()
    assert state.env_carry[1].dtype == torch.uint8
    new, stats = agent.run_iteration(state)
    assert new.env_carry[1].dtype == torch.uint8
    assert all(torch.isfinite(torch.as_tensor(v, dtype=torch.float64))
               for k, v in stats.items()
               if k not in ("mean_episode_reward", "mean_episode_length"))
    with pytest.raises(ValueError, match="conv/MoE/recurrent"):
        TRPOAgent(cfg.env, cfg.replace(fvp_mode="fused"),
                  device="cpu").run_iteration(agent.init_state())
