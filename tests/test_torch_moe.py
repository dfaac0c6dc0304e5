"""The port's mixture-of-experts family against trpo_tpu on the CPU: the
gated blend, one update, and the family rules of the agent.

Params come from trpo_tpu's init and cross with ``trpo_torch.convert``
(the expert-stacked ``(K, ...)`` leaves keep their layout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trpo_tpu import trpo as tpu_trpo
from trpo_tpu.config import TRPOConfig as TpuConfig
from trpo_tpu.models import BoxSpec as TpuBox
from trpo_tpu.models import DiscreteSpec as TpuDiscrete
from trpo_tpu.models import make_moe_policy as tpu_make_moe
from trpo_tpu.ops import flatten_params as tpu_flatten
from trpo_torch import trpo
from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig, get_preset
from trpo_torch.convert import policy_params_from_numpy
from trpo_torch.models.moe import make_moe_policy
from trpo_torch.models.policy import BoxSpec, DiscreteSpec
from trpo_torch.ops.flat import flatten_params

J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
T = torch.from_numpy


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.mark.parametrize("spec", ["discrete", "box"])
def test_gated_blend_matches_reference(spec):
    ref_spec, port_spec = ((TpuDiscrete(3), DiscreteSpec(3))
                           if spec == "discrete" else (TpuBox(2), BoxSpec(2)))
    ref = tpu_make_moe((5,), ref_spec, hidden=(16, 8), n_experts=4)
    port = make_moe_policy((5,), port_spec, hidden=(16, 8), n_experts=4)
    params = _np(ref.init(jax.random.key(0)))
    obs = np.random.default_rng(1).normal(size=(32, 5)).astype(np.float32)
    want = ref.apply(J(params), jnp.asarray(obs))
    got = port.apply(policy_params_from_numpy(params), T(obs))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
    assert port.mlp_spec is None and port.apply_cast is None
    p = port.init(torch.Generator().manual_seed(0))
    assert p["experts"]["layers"][0]["w"].shape == (4, 5, 16)
    assert [t.shape for t in jax.tree_util.tree_leaves(params)] == \
        [tuple(t.shape) for t in jax.tree_util.tree_leaves(p)]


def test_moe_update_matches_reference():
    ref = tpu_make_moe((4,), TpuDiscrete(2), hidden=(16,), n_experts=4)
    params = _np(ref.init(jax.random.key(2)))
    rng = np.random.default_rng(3)
    B = 256
    obs = rng.uniform(-0.2, 0.2, size=(B, 4)).astype(np.float32)
    dist = _np(ref.apply(J(params), jnp.asarray(obs)))
    actions = rng.integers(0, 2, size=B).astype(np.int32)
    adv = rng.normal(size=B).astype(np.float32)
    adv = ((adv - adv.mean()) / adv.std()).astype(np.float32)
    cfg_kw = dict(cg_iters=10, cg_damping=0.1)
    ref_p, ref_s = jax.jit(tpu_trpo.make_trpo_update(ref, TpuConfig(
        **cfg_kw)))(J(params), tpu_trpo.TRPOBatch(
            jnp.asarray(obs), jnp.asarray(actions), jnp.asarray(adv),
            J(dist), jnp.ones(B)))
    port = make_moe_policy((4,), DiscreteSpec(2), hidden=(16,), n_experts=4)
    p, s = trpo.make_trpo_update(port, TRPOConfig(**cfg_kw))(
        policy_params_from_numpy(params),
        trpo.TRPOBatch(T(obs), T(actions).long(), T(adv),
                       {"logits": T(dist["logits"])}, torch.ones(B)))
    want = np.asarray(tpu_flatten(ref_p)[0], np.float64)
    got = flatten_params(p)[0].numpy().astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
    assert bool(s.linesearch_success) == bool(ref_s.linesearch_success)
    for name in ("kl", "surrogate_after", "entropy"):
        np.testing.assert_allclose(float(getattr(s, name)),
                                   float(getattr(ref_s, name)), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_family_rules():
    base = get_preset("cartpole").replace(n_envs=4, batch_timesteps=64,
                                          policy_hidden=(16,),
                                          vf_train_steps=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        TRPOAgent("cartpole", base.replace(policy_gru=8, policy_experts=4),
                  device="cpu")
    with pytest.raises(ValueError, match="n_experts"):
        TRPOAgent("cartpole", base.replace(policy_experts=1), device="cpu")
    agent = TRPOAgent("cartpole", base.replace(policy_experts=4),
                      device="cpu")
    state, stats = agent.run_iteration(agent.init_state())
    assert state.policy_params["experts"]["layers"][0]["w"].shape[0] == 4
    assert np.isfinite(float(stats["kl_old_new"]))
    with pytest.raises(ValueError, match="apply_cast"):
        bf16 = base.replace(policy_experts=4, fvp_dtype="bf16",
                            solve_audit_every=1)
        TRPOAgent("cartpole", bf16, device="cpu").run_iteration(
            agent.init_state())
