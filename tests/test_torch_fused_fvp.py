"""The port's fused Gauss-Newton FVP (its plain version, which the wrapper
runs for CPU tensors) against trpo_tpu on the CPU.

The JAX side runs ``make_fused_gaussian_mlp_fvp`` through the Pallas
interpreter (``interpret=True``, as ``tests/test_fused_fvp.py`` does; it
needs 128-multiple hidden widths) and the XLA ``make_ggn_fvp``. Relative L2
error < 1e-5, the reference's operator tolerance
(``tests/test_fused_fvp.py:73``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trpo_tpu.models import BoxSpec as TpuBox
from trpo_tpu.models import make_policy as tpu_make_policy
from trpo_tpu.ops import flatten_params as tpu_flatten
from trpo_tpu.ops import make_ggn_fvp as tpu_make_ggn_fvp
from trpo_tpu.ops.fused_fvp import (
    make_fused_gaussian_mlp_fvp as tpu_make_fused,
)
from trpo_torch.config import TRPOConfig
from trpo_torch.convert import policy_params_from_numpy
from trpo_torch.models.policy import BoxSpec, make_policy
from trpo_torch.ops import _build
from trpo_torch.ops.flat import flatten_params
from trpo_torch.ops.fused_fvp import (
    fused_fvp_net_plain,
    fused_fvp_supported,
    make_fused_gaussian_mlp_fvp,
)
from trpo_torch.ops.fvp import make_ggn_fvp
from trpo_torch.trpo import TRPOBatch, make_trpo_update

RTOL = 1e-5
DAMPING = 0.1


def _problem(hidden, activation="tanh", batch=300, obs_dim=11, act_dim=5,
             pad_tail=50, seed=0):
    policy = tpu_make_policy((obs_dim,), TpuBox(act_dim), hidden=hidden,
                             activation=activation)
    params = jax.tree_util.tree_map(np.asarray,
                                    policy.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    params["log_std"] = rng.uniform(-0.5, 0.2, act_dim).astype(np.float32)
    obs = rng.normal(size=(batch, obs_dim)).astype(np.float32)
    weight = np.ones(batch, np.float32)
    if pad_tail:
        weight[-pad_tail:] = 0.0
    flat, _ = tpu_flatten(jax.tree_util.tree_map(jnp.asarray, params))
    v = rng.normal(size=flat.shape[0]).astype(np.float32)
    return policy, params, obs, weight, v


def _port_fused(params, obs, weight, v, activation):
    p = policy_params_from_numpy(params)
    op = make_fused_gaussian_mlp_fvp(
        p["net"], torch.from_numpy(obs), torch.from_numpy(weight),
        p["log_std"], DAMPING, activation=activation)
    return op.flat(torch.from_numpy(v)).numpy()


def _tpu_fused(params, obs, weight, v, activation):
    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    p = J(params)
    _, unravel = tpu_flatten(p)
    op = tpu_make_fused(p["net"], jnp.asarray(obs), jnp.asarray(weight),
                        p["log_std"], DAMPING, activation=activation,
                        compute_dtype=jnp.float32, block_rows=128,
                        interpret=True)
    return np.asarray(tpu_flatten(op(unravel(jnp.asarray(v))))[0])


def _tpu_ggn(policy, params, obs, weight, v):
    flat0, unravel = tpu_flatten(jax.tree_util.tree_map(jnp.asarray, params))

    @jax.jit
    def apply(f0, vv):
        return tpu_make_ggn_fvp(
            lambda f: policy.apply(unravel(f), jnp.asarray(obs)),
            policy.dist.fisher_weight, f0, jnp.asarray(weight),
            damping=DAMPING)(vv)

    return np.asarray(apply(flat0, jnp.asarray(v)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("activation", ["tanh", "relu", "elu"])
def test_plain_matches_reference_pallas_kernel(activation):
    _, params, obs, weight, v = _problem((128, 128), activation)
    got = _port_fused(params, obs, weight, v, activation)
    want = _tpu_fused(params, obs, weight, v, activation)
    assert _rel(got, want) < RTOL


def test_three_hidden_layers_match_reference_pallas_kernel():
    _, params, obs, weight, v = _problem((128, 256, 128), batch=200,
                                         pad_tail=30)
    got = _port_fused(params, obs, weight, v, "tanh")
    want = _tpu_fused(params, obs, weight, v, "tanh")
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize("hidden", [(32, 48), (7,), (50, 30, 20)])
def test_non_128_widths_match_reference_ggn(hidden):
    policy, params, obs, weight, v = _problem(hidden)
    got = _port_fused(params, obs, weight, v, "tanh")
    assert _rel(got, _tpu_ggn(policy, params, obs, weight, v)) < RTOL


def test_port_ggn_matches_reference_ggn():
    policy, params, obs, weight, v = _problem((32, 48))
    port_policy = make_policy((11,), BoxSpec(5), hidden=(32, 48))
    flat0, unravel = flatten_params(policy_params_from_numpy(params))
    obs_t = torch.from_numpy(obs)
    op = make_ggn_fvp(lambda x: port_policy.apply(unravel(x), obs_t),
                      port_policy.dist.fisher_weight, flat0,
                      torch.from_numpy(weight), damping=DAMPING)
    got = op(torch.from_numpy(v)).numpy()
    assert _rel(got, _tpu_ggn(policy, params, obs, weight, v)) < RTOL


def test_zero_weight_rows_contribute_nothing():
    _, params, obs, weight, v = _problem((32, 48), pad_tail=60)
    full = _port_fused(params, obs, weight, v, "tanh")
    garbage = obs.copy()
    garbage[-60:] = 1e3 * np.random.default_rng(9).normal(size=(60, 11))
    np.testing.assert_array_equal(
        _port_fused(params, garbage, weight, v, "tanh"), full)
    cut = _port_fused(params, obs[:-60], weight[:-60], v, "tanh")
    assert _rel(full, cut) < RTOL


def test_tree_contract_and_log_std_closed_form():
    _, params, obs, weight, v = _problem((32, 48))
    p = policy_params_from_numpy(params)
    op = make_fused_gaussian_mlp_fvp(p["net"], torch.from_numpy(obs),
                                     torch.from_numpy(weight), p["log_std"],
                                     DAMPING)
    _, unravel = flatten_params(p)
    out = op(unravel(torch.from_numpy(v)))
    assert set(out) == {"net", "log_std"}
    assert [set(layer) for layer in out["net"]["layers"]] == [{"w", "b"}] * 3
    # Σwₙ = 1 for a batch with real rows: the log-std block is (2 + λ)v_σ
    np.testing.assert_allclose(out["log_std"].numpy(),
                               (2.0 + DAMPING) * v[:5], rtol=1e-6)
    flat = op.flat(torch.from_numpy(v))
    np.testing.assert_array_equal(flatten_params(out)[0].numpy(),
                                  flat.numpy())


def test_eligibility():
    p = policy_params_from_numpy(_problem((32,))[1])
    assert fused_fvp_supported("tanh", p["net"])
    assert not fused_fvp_supported("gelu", p["net"])
    assert not fused_fvp_supported("tanh", {"layers": p["net"]["layers"][:1]})


def _batch(policy, params, n=96, seed=3):
    rng = np.random.default_rng(seed)
    obs = torch.from_numpy(rng.normal(size=(n, 11)).astype(np.float32))
    with torch.no_grad():
        dist = policy.apply(params, obs)
    actions = dist["mean"] + torch.from_numpy(
        rng.normal(size=(n, 5)).astype(np.float32))
    adv = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    return TRPOBatch(obs, actions, adv, dist, torch.ones(n))


def test_explicit_fused_raises_on_ineligible_policy():
    policy = make_policy((11,), BoxSpec(5), hidden=(16,), activation="gelu")
    params = policy.init(torch.Generator().manual_seed(0))
    update = make_trpo_update(policy, TRPOConfig(fvp_mode="fused"))
    with pytest.raises(ValueError, match='fvp_mode="fused" unsupported'):
        update(params, _batch(policy, params))


def test_auto_mode_routes_by_eligibility():
    for activation, fused in (("tanh", True), ("gelu", False)):
        policy = make_policy((11,), BoxSpec(5), hidden=(16,),
                             activation=activation)
        params = policy.init(torch.Generator().manual_seed(0))
        _build.reset_launches()
        _, stats = make_trpo_update(policy, TRPOConfig())(
            params, _batch(policy, params))
        assert bool(torch.isfinite(stats.kl))
        assert (_build.LAUNCHES["fused_fvp_plain"] == 11) == fused
    # a bfloat16 policy, and the ladder's bf16 rung on an f32 one, take
    # K1-bf16 — never silently the GGN, and never the f32 kernel
    for compute_dtype, cfg in (
            (torch.bfloat16, TRPOConfig()),
            (torch.float32, TRPOConfig(fvp_dtype="bf16",
                                       solve_audit_every=1)),
            (torch.bfloat16, TRPOConfig(fvp_mode="fused"))):
        policy = make_policy((11,), BoxSpec(5), hidden=(16,),
                             compute_dtype=compute_dtype)
        params = policy.init(torch.Generator().manual_seed(0))
        _build.reset_launches()
        _, stats = make_trpo_update(policy, cfg)(
            params, _batch(policy, params))
        assert bool(torch.isfinite(stats.kl))
        assert _build.LAUNCHES["fused_fvp_bf16_plain"] == 11
        assert _build.LAUNCHES["fused_fvp_plain"] == 0


# --- the kernel's precision plan, emulated on the CPU ----------------------
# The CUDA kernel computes every product on TF32 tensor cores as 3xTF32:
# hi = x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero,
# as cvt.rna.tf32.f32), lo = x - hi read by the tensor cores as its top 19
# bits (truncated), and a·b ≈ lo_a·hi_b + hi_a·lo_b + hi_a·hi_b.


def _tf32_nearest(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _matmul_3xtf32(a, b):
    ah, bh = _tf32_nearest(a), _tf32_nearest(b)
    al, bl = _tf32_truncated(a - ah), _tf32_truncated(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _matmul_1xtf32(a, b):
    return _tf32_nearest(a) @ _tf32_nearest(b)


def _plain_sweeps(matmul):
    hidden, rows, obs_dim, act_dim = (64, 64), 256, 32, 6
    _, params, obs, weight, v = _problem(hidden, batch=rows, obs_dim=obs_dim,
                                         act_dim=act_dim, pad_tail=40)
    p = policy_params_from_numpy(params)
    op = make_fused_gaussian_mlp_fvp(p["net"], torch.from_numpy(obs),
                                     torch.from_numpy(weight), p["log_std"],
                                     DAMPING)
    return fused_fvp_net_plain(op.obs, op.hs, op.ws, torch.from_numpy(v),
                               op.wn, op.m, DAMPING, "tanh", matmul=matmul)


def test_tf32_rounding_emulation():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    # ties go away from zero; below half an ulp (2^-10) rounds down
    np.testing.assert_array_equal(
        _tf32_nearest(x).numpy(),
        np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                  -(1.0 + 2.0 ** -10), 1.0], np.float32))
    r = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    # 3xTF32 splits carry x to ~2^-21 relative; one TF32 half to ~2^-11
    hi = _tf32_nearest(r)
    assert ((r - hi).abs() / r.abs()).max() <= 2.0 ** -11
    two = hi + _tf32_truncated(r - hi)
    assert ((r - two).abs() / r.abs()).max() <= 2.0 ** -21


def test_3xtf32_products_hold_the_operator_tolerance():
    want = _plain_sweeps(torch.matmul)
    assert _rel(_plain_sweeps(_matmul_3xtf32), want) < RTOL


def test_1xtf32_products_miss_the_operator_tolerance():
    # why the kernel pays for three tensor-core passes per product
    want = _plain_sweeps(torch.matmul)
    assert _rel(_plain_sweeps(_matmul_1xtf32), want) > 10 * RTOL
