"""The port's running observation normalization against trpo_tpu on the
CPU: ``update_stats`` and ``normalize`` on the same numpy batches, one
normalized ``_process_trajectory`` on the same statistics and trajectory,
the agent's wiring (rollout, update, ``act``, ``evaluate``) and the
statistics' round trip through a checkpoint.

Tolerances: 1e-6 relative for the statistics and the normalized values
(f32 sums of a few dozen terms in two libraries); 1e-4 relative L2 for
the update, as ``tests/test_torch_agent.py`` holds the unnormalized one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trpo_tpu.agent import TRPOAgent as TpuAgent
from trpo_tpu.config import get_preset as tpu_get_preset
from trpo_tpu.ops import flatten_params as tpu_flatten
from trpo_tpu.rollout import device_rollout as tpu_rollout
from trpo_tpu.utils import normalize as tpu_norm
from trpo_torch.agent import TRPOAgent
from trpo_torch.config import get_preset
from trpo_torch.convert import (
    policy_params_from_numpy,
    trajectory_from_numpy,
    vf_state_from_numpy,
)
from trpo_torch.ops import _build
from trpo_torch.ops.flat import flatten_params
from trpo_torch.utils import normalize as norm
from trpo_torch.utils.checkpoint import Checkpointer

RTOL = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _assert_stats_close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=RTOL)


@pytest.mark.parametrize("shape, chunks", [
    ((5,), [(7,), (64,), (1,), (33,)]),
    ((3,), [(4, 6), (2, 5)]),
])
def test_update_stats_matches_reference(shape, chunks):
    rng = np.random.default_rng(0)
    ref = tpu_norm.init_stats(shape)
    got = norm.init_stats(shape)
    for lead in chunks:
        x = rng.normal(3.0, 2.5, size=lead + shape).astype(np.float32)
        ref = tpu_norm.update_stats(ref, jnp.asarray(x))
        got = norm.update_stats(got, torch.from_numpy(x))
        _assert_stats_close(got, ref)
    assert float(got.count) == sum(int(np.prod(c)) for c in chunks)


def test_normalize_matches_reference_identity_and_clip():
    rng = np.random.default_rng(1)
    x = np.array([[100.0, -50.0], [0.5, 2.0]], np.float32)
    empty = norm.normalize(norm.init_stats((2,)), torch.from_numpy(x))
    np.testing.assert_array_equal(empty.numpy(), x)  # identity, count 0
    batch = rng.normal(size=(64, 2)).astype(np.float32)
    ref = tpu_norm.update_stats(tpu_norm.init_stats((2,)), jnp.asarray(batch))
    got = norm.update_stats(norm.init_stats((2,)), torch.from_numpy(batch))
    for probe in (x, 1e6 * np.ones((1, 2), np.float32)):
        want = np.asarray(tpu_norm.normalize(ref, jnp.asarray(probe)))
        out = norm.normalize(got, torch.from_numpy(probe)).numpy()
        np.testing.assert_allclose(out, want, rtol=RTOL, atol=RTOL)
        assert np.all(np.abs(out) <= 10.0)


def _stats(rng, dim):
    count = np.float32(100.0)
    mean = (0.5 * rng.normal(size=dim)).astype(np.float32)
    m2 = (count * rng.uniform(0.5, 2.0, size=dim)).astype(np.float32)
    return count, mean, m2


def test_process_trajectory_normalized_matches_reference():
    kw = dict(n_envs=4, batch_timesteps=64, max_pathlength=10,
              policy_hidden=(32, 32), solve_audit_every=0,
              normalize_obs=True)
    tpu_agent = TpuAgent("humanoid-sim",
                         tpu_get_preset("humanoid-sim").replace(**kw))
    ref_state = tpu_agent.init_state(seed=0)
    count, mean, m2 = _stats(np.random.default_rng(2), tpu_agent.obs_shape)
    ref_state = ref_state._replace(
        obs_norm=tpu_norm.RunningStats(jnp.asarray(count), jnp.asarray(mean),
                                       jnp.asarray(m2)),
        vf_state=ref_state.vf_state._replace(initialized=jnp.asarray(True)))
    _, traj = jax.jit(
        lambda p, c, k: tpu_rollout(tpu_agent.env, tpu_agent.policy, p, c, k,
                                    tpu_agent.n_steps)
    )(ref_state.policy_params, ref_state.env_carry, jax.random.key(5))
    vf_np = _np(ref_state.vf_state)
    adam = vf_np.opt_state[0]

    agent = TRPOAgent("humanoid-sim",
                      get_preset("humanoid-sim").replace(**kw), device="cpu")
    state = agent.init_state(seed=0)
    state = state._replace(
        policy_params=policy_params_from_numpy(
            _np(ref_state.policy_params)),
        vf_state=vf_state_from_numpy(vf_np.params, adam.mu, adam.nu,
                                     int(adam.count), True),
        obs_norm=norm.RunningStats(torch.tensor(count),
                                   torch.from_numpy(mean),
                                   torch.from_numpy(m2)),
    )
    ref_new, ref_stats = jax.jit(tpu_agent._process_trajectory)(ref_state,
                                                                traj)
    _build.reset_launches()
    new, stats = agent._process_trajectory(state,
                                           trajectory_from_numpy(_np(traj)))
    # the update ran the fused FVP's path on the normalized inputs (its
    # plain version on the CPU), not the GGN fallback
    assert _build.LAUNCHES["fused_fvp_plain"] > 0

    want = np.asarray(tpu_flatten(ref_new.policy_params)[0], np.float64)
    got = flatten_params(new.policy_params)[0].numpy().astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
    _assert_stats_close(new.obs_norm, ref_new.obs_norm)
    np.testing.assert_allclose(float(stats["kl_old_new"]),
                               float(ref_stats["kl_old_new"]), rtol=1e-4,
                               atol=1e-6)


def _agent(**kw):
    cfg = get_preset("pendulum").replace(
        n_envs=4, batch_timesteps=64, cg_iters=4, vf_train_steps=5,
        policy_hidden=(16,), normalize_obs=True, **kw)
    return TRPOAgent("pendulum", cfg, device="cpu")


def test_agent_trains_acts_and_evaluates_with_normalization():
    agent = _agent()
    state = agent.init_state(0)
    assert isinstance(state.obs_norm, norm.RunningStats)
    assert float(state.obs_norm.count) == 0.0
    state, _ = agent.run_iteration(state)
    assert float(state.obs_norm.count) == 64.0
    state, stats = agent.run_iteration(state)
    assert float(state.obs_norm.count) == 128.0
    assert np.isfinite(float(stats["entropy"]))
    obs = torch.tensor([0.3, -0.2, 1.5])
    action, dist = agent.act(state, obs, eval_mode=True)
    want = agent.policy.apply(state.policy_params,
                              norm.normalize(state.obs_norm, obs)[None])
    torch.testing.assert_close(action, want["mean"][0], rtol=0, atol=0)
    mean_ret, _ = agent.evaluate(state, n_steps=16)
    assert np.isfinite(mean_ret)


def test_normed_policy_is_never_taken_for_a_plain_mlp():
    agent = _agent()
    stats = norm.update_stats(norm.init_stats((3,)), torch.randn(8, 3))
    wrapped = agent._normed_policy(stats)
    assert wrapped.mlp_spec is None and agent.policy.mlp_spec is not None
    assert agent._normed_policy(None) is agent.policy


def test_checkpoint_roundtrips_stats(tmp_path):
    agent = _agent()
    state, _ = agent.run_iteration(agent.init_state(0))
    ck = Checkpointer(str(tmp_path / "norm"))
    ck.save(1, state)
    restored = ck.restore(agent.init_state(0))
    for a, b in zip(state.obs_norm, restored.obs_norm):
        assert torch.equal(a, b)
    assert float(restored.obs_norm.count) == 64.0
