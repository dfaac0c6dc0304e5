"""The port's Categorical head, CartPole and Pendulum envs and the
time-chunked rollout against trpo_tpu on the CPU, and one cartpole update.

Randomness differs between the packages, so the tests hand both the same
numbers: env states and actions from numpy, pre-drawn Gumbel noise for the
categorical samples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trpo_tpu import trpo as tpu_trpo
from trpo_tpu.config import TRPOConfig as TpuConfig
from trpo_tpu.distributions import Categorical as TpuCategorical
from trpo_tpu.envs.cartpole import CartPole as TpuCartPole
from trpo_tpu.envs.cartpole import CartPoleState as TpuCartPoleState
from trpo_tpu.envs.pendulum import Pendulum as TpuPendulum
from trpo_tpu.envs.pendulum import PendulumState as TpuPendulumState
from trpo_tpu.models import DiscreteSpec as TpuDiscrete
from trpo_tpu.models import make_policy as tpu_make_policy
from trpo_tpu.ops import flatten_params as tpu_flatten
from trpo_torch import trpo
from trpo_torch.config import TRPOConfig, get_preset
from trpo_torch.convert import policy_params_from_numpy
from trpo_torch.distributions import Categorical
from trpo_torch.envs.cartpole import CartPole, CartPoleState
from trpo_torch.envs.locomotion import HumanoidSim
from trpo_torch.envs.pendulum import Pendulum, PendulumState
from trpo_torch.models.policy import BoxSpec, DiscreteSpec, make_policy
from trpo_torch.ops import _build
from trpo_torch.ops.flat import flatten_params
from trpo_torch.rollout import ChunkedRollout, device_rollout, init_env_states

J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
T = torch.from_numpy
RTOL = 1e-6  # f32 elementwise math on two CPU backends


@pytest.mark.parametrize("fn", ["logp", "kl", "entropy", "fisher_weight",
                                "mode"])
def test_categorical_matches_reference(fn):
    rng = np.random.default_rng(1)
    mk = lambda: {"logits": rng.normal(size=(64, 6)).astype(np.float32)}  # noqa
    old, new = mk(), mk()
    actions = rng.integers(0, 6, size=64)
    args = {"logp": (old, actions), "kl": (old, new), "entropy": (old,),
            "fisher_weight": (old, new), "mode": (old,)}[fn]
    conv_t = [{k: T(v) for k, v in a.items()} if isinstance(a, dict)
              else T(a) for a in args]
    conv_j = [J(a) for a in args]
    got = getattr(Categorical, fn)(*conv_t)
    want = getattr(TpuCategorical, fn)(*conv_j)
    if isinstance(got, dict):
        got, want = got["logits"], want["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)


def test_categorical_sample_is_gumbel_max_of_the_given_noise():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(500, 3)).astype(np.float32)
    noise = rng.gumbel(size=(500, 3)).astype(np.float32)
    got = Categorical.sample({"logits": T(logits)}, noise=T(noise))
    np.testing.assert_array_equal(got.numpy(),
                                  np.argmax(logits + noise, axis=-1))
    # drawn from a generator: the empirical frequencies follow softmax
    p = np.exp([0.0, 1.0, -1.0]) / np.exp([0.0, 1.0, -1.0]).sum()
    draws = Categorical.sample(
        {"logits": torch.tensor([[0.0, 1.0, -1.0]]).expand(40_000, 3)},
        generator=torch.Generator().manual_seed(0))
    freq = np.bincount(draws.numpy(), minlength=3) / 40_000
    np.testing.assert_allclose(freq, p, atol=0.01)


ENVS = {
    "cartpole": (TpuCartPole, TpuCartPoleState, CartPole, CartPoleState),
    "pendulum": (TpuPendulum, TpuPendulumState, Pendulum, PendulumState),
}


def _states(name, rng, N):
    t = np.array([0, 1, 2, 0, 1, 2][:N], np.int32)
    if name == "cartpole":
        vals = rng.uniform(-0.15, 0.15, size=(4, N)).astype(np.float32)
        return list(vals) + [t]
    th = rng.uniform(-np.pi, np.pi, size=N).astype(np.float32)
    thd = rng.uniform(-7.0, 7.0, size=N).astype(np.float32)
    return [th, thd, t]


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_step_parity(name):
    TpuEnv, TpuState, Env, State = ENVS[name]
    tpu_env, env = TpuEnv(max_episode_steps=3), Env(max_episode_steps=3)
    N = 6
    rng = np.random.default_rng(0)
    fields = _states(name, rng, N)
    ref_state = TpuState(*[jnp.asarray(f) for f in fields])
    state = State(*[T(f) for f in fields])
    np.testing.assert_allclose(env.observe(state).numpy(),
                               np.asarray(jax.vmap(tpu_env._obs)(ref_state)),
                               rtol=RTOL, atol=RTOL)
    for _ in range(3):
        if name == "cartpole":
            actions = rng.integers(0, 2, size=N)
        else:
            actions = (2.0 * rng.normal(size=(N, 1))).astype(np.float32)
        keys = jax.random.split(jax.random.key(0), N)
        ref = jax.vmap(tpu_env.step)(ref_state, jnp.asarray(actions), keys)
        got = env.step(state, T(actions))
        ref_state, state = ref[0], got[0]
        for a, b in zip(got[0], ref[0]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=RTOL)
        for a, b in zip(got[1:3], ref[1:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=RTOL)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_reset_matches_reference_ranges(name):
    env = ENVS[name][2]()
    state, obs = env.reset(4096, torch.Generator().manual_seed(0))
    ref_state, ref_obs = jax.vmap(ENVS[name][0]().reset)(
        jax.random.split(jax.random.key(0), 4096))
    assert obs.shape == ref_obs.shape and obs.dtype == torch.float32
    for a, b in zip(state, ref_state):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        # same uniform ranges: bounds and means within sampling error
        np.testing.assert_allclose([a.min(), a.max(), a.mean()],
                                   [b.min(), b.max(), b.mean()],
                                   atol=0.05 * max(1.0, np.abs(b).max()))
    assert not state.t.any()


def test_cartpole_update_matches_reference():
    tpu_policy = tpu_make_policy((4,), TpuDiscrete(2), hidden=(16,))
    params = jax.tree_util.tree_map(np.asarray,
                                    tpu_policy.init(jax.random.key(0)))
    rng = np.random.default_rng(3)
    B = 256
    obs = rng.uniform(-0.2, 0.2, size=(B, 4)).astype(np.float32)
    dist = jax.tree_util.tree_map(
        np.array, tpu_policy.apply(J(params), jnp.asarray(obs)))
    actions = rng.integers(0, 2, size=B).astype(np.int32)
    adv = rng.normal(size=B).astype(np.float32)
    adv = ((adv - adv.mean()) / adv.std()).astype(np.float32)
    cfg_kw = dict(cg_iters=10, cg_damping=0.1)
    ref_p, ref_s = jax.jit(tpu_trpo.make_trpo_update(
        tpu_policy, TpuConfig(**cfg_kw)))(
        J(params), tpu_trpo.TRPOBatch(jnp.asarray(obs), jnp.asarray(actions),
                                      jnp.asarray(adv), J(dist),
                                      jnp.ones(B)))
    policy = make_policy((4,), DiscreteSpec(2), hidden=(16,))
    p, s = trpo.make_trpo_update(policy, TRPOConfig(**cfg_kw))(
        policy_params_from_numpy(params),
        trpo.TRPOBatch(T(obs), T(actions).long(), T(adv),
                       {"logits": T(dist["logits"])}, torch.ones(B)))
    want = np.asarray(tpu_flatten(ref_p)[0], np.float64)
    got = flatten_params(p)[0].numpy().astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
    assert int(s.cg_iterations) == int(ref_s.cg_iterations)
    assert bool(s.linesearch_success) == bool(ref_s.linesearch_success)
    for name in ("kl", "surrogate_after", "entropy"):
        np.testing.assert_allclose(float(getattr(s, name)),
                                   float(getattr(ref_s, name)), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("chunk", [1, 3, 6])
def test_chunked_rollout_is_bit_exact(chunk):
    env = HumanoidSim(max_episode_steps=4)
    policy = make_policy((376,), BoxSpec(17), hidden=(16,))
    params = policy.init(torch.Generator().manual_seed(0))

    def roll(fn):
        g = torch.Generator().manual_seed(1)
        return fn(init_env_states(env, 5, g), g)

    flat = roll(lambda c, g: device_rollout(env, policy, params, c, g, 12))
    chunked = roll(lambda c, g: device_rollout(env, policy, params, c, g, 12,
                                               chunk=chunk))
    driver = roll(lambda c, g: ChunkedRollout(env, policy, chunk)(
        params, c, g, 12))
    for other in (chunked, driver):
        for a, b in zip(jax.tree_util.tree_leaves(flat),
                        jax.tree_util.tree_leaves(other)):
            assert torch.equal(a, b)
    assert flat[1].done.any()  # truncations inside the window
    parts = roll(lambda c, g: list(ChunkedRollout(env, policy, chunk)
                                   .iter_chunks(params, c, g, 12)))
    assert len(parts) == 12 // chunk
    assert all(t.rewards.shape == (chunk, 5) for _, t in parts)
    with pytest.raises(ValueError, match="must divide"):
        roll(lambda c, g: device_rollout(env, policy, params, c, g, 12,
                                         chunk=5))


def test_fleet_preset_chunk_divides_its_window():
    cfg = get_preset("humanoid-sim-fleet")
    assert cfg.resolved_n_envs() == 1024 and cfg.rollout_chunk == 7
    assert -(-cfg.batch_timesteps // 1024) % 7 == 0
    with pytest.raises(ValueError, match="must divide"):
        cfg.replace(fleet_n_envs=1000)
