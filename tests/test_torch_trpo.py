"""One TRPO update of the port against trpo_tpu's on the CPU, at the
flagship solver settings (head-block preconditioned CG, ¾ curvature
subsample), on the same params and batch.

The reference's ``fvp_mode="auto"`` runs its XLA Gauss-Newton operator
off-TPU; the port's runs the fused operator's plain version on CPU
tensors. Both are the same Fisher, so the accepted step must agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trpo_tpu import trpo as tpu_trpo
from trpo_tpu.config import TRPOConfig as TpuConfig
from trpo_tpu.models import BoxSpec as TpuBox
from trpo_tpu.models import make_policy as tpu_make_policy
from trpo_tpu.ops import flatten_params as tpu_flatten
from trpo_torch import trpo
from trpo_torch.config import TRPOConfig
from trpo_torch.convert import policy_params_from_numpy
from trpo_torch.models.policy import BoxSpec, make_policy
from trpo_torch.ops import _build
from trpo_torch.ops.flat import flatten_params


@pytest.mark.parametrize(
    "n, fraction",
    [(50_048, 0.75), (100, 0.75), (7, 0.9), (1, 0.5), (96, 0.5), (10, 0.3),
     (1000, 5 / 6)],
)
def test_keep_indices_identical(n, fraction):
    got = trpo._fvp_keep_indices(n, fraction)
    np.testing.assert_array_equal(got,
                                  tpu_trpo._fvp_keep_indices(n, fraction))
    if (n, fraction) == (50_048, 0.75):
        assert len(got) == 37_536


def _problem(B=256, obs_dim=11, act_dim=5, hidden=(32, 48), seed=0):
    policy = tpu_make_policy((obs_dim,), TpuBox(act_dim), hidden=hidden)
    params = jax.tree_util.tree_map(np.asarray,
                                    policy.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    params["log_std"] = rng.uniform(-0.6, 0.0, act_dim).astype(np.float32)
    obs = rng.normal(size=(B, obs_dim)).astype(np.float32)
    dist = jax.tree_util.tree_map(
        np.array,
        policy.apply(jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.asarray(obs)))
    actions = (dist["mean"] + np.exp(dist["log_std"])
               * rng.normal(size=(B, act_dim))).astype(np.float32)
    adv = rng.normal(size=B).astype(np.float32)
    adv = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(np.float32)
    return policy, params, obs, actions, adv, dist


@pytest.mark.parametrize(
    "precondition, kl_cap",
    [("head_block", False), (False, False), ("head_block", True)],
)
def test_update_matches_reference_subsampled(precondition, kl_cap):
    policy, params, obs, actions, adv, dist = _problem()
    B = obs.shape[0]
    tpu_cfg = TpuConfig(cg_precondition=precondition, fvp_subsample=0.75,
                        linesearch_kl_cap=kl_cap)
    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    ref_batch = tpu_trpo.TRPOBatch(jnp.asarray(obs), jnp.asarray(actions),
                                   jnp.asarray(adv), J(dist), jnp.ones(B))
    ref_params, ref_stats = jax.jit(
        tpu_trpo.make_trpo_update(policy, tpu_cfg))(J(params), ref_batch)

    port_policy = make_policy((11,), BoxSpec(5), hidden=(32, 48))
    cfg = TRPOConfig(cg_precondition=precondition, fvp_subsample=0.75,
                     linesearch_kl_cap=kl_cap)
    T = torch.from_numpy
    batch = trpo.TRPOBatch(T(obs), T(actions), T(adv),
                           {k: T(v) for k, v in dist.items()}, torch.ones(B))
    _build.reset_launches()
    new_params, stats = trpo.make_trpo_update(port_policy, cfg)(
        policy_params_from_numpy(params), batch)
    # one matvec per CG iteration that took effect, and one for sᵀFs
    assert _build.LAUNCHES["fused_fvp_plain"] == int(stats.cg_iterations) + 1

    x0 = np.asarray(tpu_flatten(J(params))[0], np.float64)
    want = np.asarray(tpu_flatten(ref_params)[0], np.float64)
    got = flatten_params(new_params)[0].numpy().astype(np.float64)
    # CG amplifies the two backends' f32 roundoff (measured here: params
    # ~5e-8, step ~2e-6 relative); held at 1e-4 for both
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
    step_err = np.linalg.norm((got - x0) - (want - x0))
    assert step_err / np.linalg.norm(want - x0) < 1e-4
    assert int(stats.cg_iterations) == int(ref_stats.cg_iterations)
    assert bool(stats.linesearch_success) == bool(
        ref_stats.linesearch_success)
    assert bool(stats.rolled_back) == bool(ref_stats.rolled_back)
    assert int(stats.linesearch_trials) == int(ref_stats.linesearch_trials)
    for name in ("kl", "surrogate_after", "surrogate_before", "entropy"):
        np.testing.assert_allclose(float(getattr(stats, name)),
                                   float(getattr(ref_stats, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(stats.grad_norm),
                               float(ref_stats.grad_norm), rtol=1e-5)
    np.testing.assert_allclose(float(stats.step_norm),
                               float(ref_stats.step_norm), rtol=1e-4)


def test_standardize_advantages_matches_reference():
    rng = np.random.default_rng(4)
    adv = rng.normal(3.0, 2.0, size=64).astype(np.float32)
    w = (rng.uniform(size=64) < 0.8).astype(np.float32)
    want = tpu_trpo.standardize_advantages(jnp.asarray(adv), jnp.asarray(w))
    got = trpo.standardize_advantages(torch.from_numpy(adv),
                                      torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
