"""The port's solver precision ladder against trpo_tpu on the CPU: K1-bf16's
plain version against the reference's Pallas kernel at bf16, the audited
update (f32 and bf16 rungs), the fallback → pin escalation, the adaptive
CG budget, the adaptive damping rule and the ladder's config checks.

Inputs are drawn with numpy and handed to both packages; params and the
``LadderState`` cross through ``trpo_torch.convert``. The reference's
``fvp_mode="auto"`` runs its XLA Gauss-Newton operator off-TPU (over
``apply_cast`` at bf16 on the bf16 rung); the port's runs the fused
operator's plain version (K1 or K1-bf16) on CPU tensors.
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
from trpo_tpu.ops.fused_fvp import (
    make_fused_gaussian_mlp_fvp as tpu_make_fused,
)
from trpo_torch import trpo
from trpo_torch.config import TRPOConfig
from trpo_torch.convert import (
    damping_from_numpy,
    ladder_from_numpy,
    ladder_to_numpy,
    policy_params_from_numpy,
)
from trpo_torch.models.policy import BoxSpec, make_policy
from trpo_torch.ops import _build
from trpo_torch.ops.flat import flatten_params
from trpo_torch.ops.fused_fvp import make_fused_gaussian_mlp_fvp

J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
T = torch.from_numpy


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ---------------------------------------------------------------------------
# K1-bf16's plain version against the reference kernel at bf16
# ---------------------------------------------------------------------------

# measured here: 1.3e-3 to 2.8e-3 relative L2 (the bf16 forward and the
# sums run in another order, so some values land on the other side of a
# bf16 rounding boundary); held at the port's 1e-2
BF16_RTOL = 1e-2


@pytest.mark.parametrize(
    "hidden, activation",
    [((128, 128), "tanh"), ((128, 128), "relu"), ((128, 128), "elu"),
     ((128, 256, 128), "tanh")],
)
def test_bf16_plain_matches_reference_pallas_kernel(hidden, activation):
    obs_dim, act_dim, batch = 11, 5, 200
    policy = tpu_make_policy((obs_dim,), TpuBox(act_dim), hidden=hidden,
                             activation=activation)
    params = jax.tree_util.tree_map(np.asarray,
                                    policy.init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    params["log_std"] = rng.uniform(-0.5, 0.2, act_dim).astype(np.float32)
    obs = rng.normal(size=(batch, obs_dim)).astype(np.float32)
    weight = np.ones(batch, np.float32)
    weight[-30:] = 0.0
    flat, unravel = tpu_flatten(J(params))
    v = rng.normal(size=flat.shape[0]).astype(np.float32)

    op = tpu_make_fused(J(params)["net"], jnp.asarray(obs),
                        jnp.asarray(weight), jnp.asarray(params["log_std"]),
                        0.1, activation=activation,
                        compute_dtype=jnp.bfloat16, block_rows=128,
                        interpret=True)
    want = np.asarray(tpu_flatten(op(unravel(jnp.asarray(v))))[0])
    p = policy_params_from_numpy(params)
    _build.reset_launches()
    got = make_fused_gaussian_mlp_fvp(
        p["net"], T(obs), T(weight), p["log_std"], 0.1,
        activation=activation, compute_dtype=torch.bfloat16,
    ).flat(T(v)).numpy()
    assert _build.LAUNCHES["fused_fvp_bf16_plain"] == 1
    assert _rel(got, want) < BF16_RTOL


def _batch(obs_dim, act_dim, hidden, B, seed=0):
    policy = tpu_make_policy((obs_dim,), TpuBox(act_dim), hidden=hidden)
    params = jax.tree_util.tree_map(np.asarray,
                                    policy.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    params["log_std"] = rng.uniform(-0.6, 0.0, act_dim).astype(np.float32)
    obs = rng.normal(size=(B, obs_dim)).astype(np.float32)
    dist = jax.tree_util.tree_map(
        np.array, policy.apply(J(params), jnp.asarray(obs)))
    actions = (dist["mean"] + np.exp(dist["log_std"])
               * rng.normal(size=(B, act_dim))).astype(np.float32)
    adv = rng.normal(size=B).astype(np.float32)
    adv = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(np.float32)
    return policy, params, (obs, actions, adv, dist)


def _port_batch(data):
    obs, actions, adv, dist = data
    return trpo.TRPOBatch(T(obs), T(actions), T(adv),
                          {k: T(v) for k, v in dist.items()},
                          torch.ones(obs.shape[0]))


def _tpu_batch(data):
    obs, actions, adv, dist = data
    return tpu_trpo.TRPOBatch(jnp.asarray(obs), jnp.asarray(actions),
                              jnp.asarray(adv), J(dist),
                              jnp.ones(obs.shape[0]))


def test_bf16_rung_holds_cosine_floor_humanoid_sim_shape():
    # the port of the reference's acceptance shape test
    # (tests/test_solver_ladder.py:145): 376 -> 256 -> 256 -> 17, 2,048 rows
    _, params, data = _batch(376, 17, (256, 256), 2048)
    policy = make_policy((376,), BoxSpec(17), hidden=(256, 256))
    cfg = TRPOConfig(cg_damping=0.1, fvp_dtype="bf16", solve_audit_every=1,
                     cg_precondition=False)
    _build.reset_launches()
    _, stats = trpo.make_trpo_update(policy, cfg)(
        policy_params_from_numpy(params), _port_batch(data), None, None,
        trpo.init_ladder(cfg))
    assert _build.LAUNCHES["fused_fvp_bf16_plain"] == cfg.cg_iters + 1
    assert bool(stats.solve_audited)
    assert float(stats.solve_cosine) >= cfg.solve_cosine_floor
    assert not bool(stats.solve_fallback)
    assert int(stats.ladder_next.fallbacks) == 0


# ---------------------------------------------------------------------------
# one audited update against the reference
# ---------------------------------------------------------------------------

def _run_both(cfg_kw, n_updates=1, B=256, hidden=(32, 48)):
    """``n_updates`` updates of both packages from the same params, batch
    and ladder (each update restarts from the same params, threading only
    the ladder). Returns the per-update (port, reference) results."""
    tpu_policy, params, data = _batch(11, 5, hidden, B)
    tpu_cfg = TpuConfig(**cfg_kw)
    cfg = TRPOConfig(**cfg_kw)
    ref_update = jax.jit(tpu_trpo.make_trpo_update(tpu_policy, tpu_cfg))
    port_update = trpo.make_trpo_update(
        make_policy((11,), BoxSpec(5), hidden=hidden), cfg)
    ref_ladder = tpu_trpo.init_ladder(tpu_cfg)
    ladder = ladder_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      ref_ladder))
    out = []
    for _ in range(n_updates):
        ref_p, ref_s = ref_update(J(params), _tpu_batch(data), None, None,
                                  ref_ladder)
        p, s = port_update(policy_params_from_numpy(params),
                           _port_batch(data), None, None, ladder)
        out.append((p, s, ref_p, ref_s))
        ref_ladder, ladder = ref_s.ladder_next, s.ladder_next
    return params, out


def _assert_ladder_equal(port, ref, cos_tol=1e-5):
    ref = ref._asdict()
    for name, value in ladder_to_numpy(port).items():
        if name == "cosine_min":
            np.testing.assert_allclose(value, np.asarray(ref[name]),
                                       atol=cos_tol)
        else:
            np.testing.assert_array_equal(value, np.asarray(ref[name]),
                                          err_msg=name)
    assert port.step_host == int(ref["step"])
    assert port.pinned_host == bool(ref["pinned"])


def _assert_flags_equal(s, ref_s):
    for name in ("solve_audited", "solve_fallback", "solve_pinned"):
        assert bool(getattr(s, name)) == bool(getattr(ref_s, name)), name
    assert int(s.cg_budget) == int(ref_s.cg_budget)


@pytest.mark.parametrize("floor", [0.999, 0.5])
def test_audited_update_matches_reference(floor):
    # floor 0.999: the ¾ subsample's cosine falls below it at this small
    # batch (the update falls back); floor 0.5: the cheap solution is used
    params, [(p, s, ref_p, ref_s)] = _run_both(dict(
        fvp_subsample=0.75, solve_audit_every=1, solve_cosine_floor=floor,
        cg_precondition="head_block"))
    want = np.asarray(tpu_flatten(ref_p)[0], np.float64)
    got = flatten_params(p)[0].numpy().astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
    assert bool(s.solve_audited)
    assert abs(float(s.solve_cosine) - float(ref_s.solve_cosine)) < 1e-5
    assert bool(s.solve_fallback) == (floor == 0.999)
    _assert_flags_equal(s, ref_s)
    _assert_ladder_equal(s.ladder_next, ref_s.ladder_next)


@pytest.mark.parametrize("floor", [0.999, 0.9])
def test_audited_bf16_update_matches_reference(floor):
    # floor 0.999: the audit falls back to the full solution, held at 1e-4;
    # floor 0.9: the cheap bf16 solution is used. bf16 rounds at other
    # places in the two packages' operators (measured here: params 2.4e-4
    # relative apart, solution cosines 3.5e-5 apart), so that step is held
    # at 1e-3
    params, [(p, s, ref_p, ref_s)] = _run_both(dict(
        fvp_subsample=0.75, fvp_dtype="bf16", solve_audit_every=1,
        solve_cosine_floor=floor))
    want = np.asarray(tpu_flatten(ref_p)[0], np.float64)
    got = flatten_params(p)[0].numpy().astype(np.float64)
    tol = 1e-4 if floor == 0.999 else 1e-3
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < tol
    assert abs(float(s.solve_cosine) - float(ref_s.solve_cosine)) < 1e-3
    assert bool(s.solve_fallback) == (floor == 0.999)
    _assert_flags_equal(s, ref_s)
    _assert_ladder_equal(s.ladder_next, ref_s.ladder_next, cos_tol=1e-3)


def test_fault_skew_falls_back_then_pins_like_the_reference():
    # flags and counters against the reference; params against the port's
    # own clean f32 update (the reference's version of this test misses its
    # params tolerance on this image — ROADMAP.md Queue 3)
    kw = dict(fvp_dtype="bf16", solve_audit_every=1, solve_fault_skew=4.0,
              solve_fallback_limit=2)
    params, runs = _run_both(kw, n_updates=3)
    tpu_policy, _, data = _batch(11, 5, (32, 48), 256)
    policy = make_policy((11,), BoxSpec(5), hidden=(32, 48))
    clean, _ = trpo.make_trpo_update(policy, TRPOConfig())(
        policy_params_from_numpy(params), _port_batch(data))
    clean = flatten_params(clean)[0].numpy()
    for i, (p, s, _, ref_s) in enumerate(runs):
        _assert_flags_equal(s, ref_s)
        _assert_ladder_equal(s.ladder_next, ref_s.ladder_next, cos_tol=1e-3)
        if i < 2:
            assert bool(s.solve_fallback)
            assert float(s.solve_cosine) < 0.999
        else:
            assert bool(s.solve_pinned) and not bool(s.solve_audited)
        # a fallback or pinned step uses the clean full solution
        np.testing.assert_allclose(flatten_params(p)[0].numpy(), clean,
                                   rtol=1e-5, atol=1e-6)
    assert runs[1][1].ladder_next.pinned_host
    assert int(runs[2][1].ladder_next.fallbacks) == 2


# ---------------------------------------------------------------------------
# the adaptive CG budget and the adaptive damping
# ---------------------------------------------------------------------------

def test_adaptive_budget_converges_to_exit_point_like_the_reference():
    kw = dict(cg_iters=20, cg_budget_adaptive=True, cg_budget_floor=2,
              cg_residual_rtol=1e-2)
    _, runs = _run_both(kw, n_updates=5)
    budgets, exits = [], []
    for p, s, ref_p, ref_s in runs:
        _assert_flags_equal(s, ref_s)
        _assert_ladder_equal(s.ladder_next, ref_s.ladder_next)
        assert int(s.cg_iterations) == int(ref_s.cg_iterations)
        budgets.append(int(s.cg_budget))
        exits.append(int(s.cg_iterations))
        assert 2 <= int(s.ladder_next.cg_budget) <= 20
    assert budgets[-1] == exits[-1] + 1, (budgets, exits)
    assert budgets[-1] == budgets[-2]


def test_adaptive_budget_grows_back_to_ceiling_like_the_reference():
    tpu_policy, params, data = _batch(11, 5, (32, 48), 256)
    kw = dict(cg_iters=8, cg_budget_adaptive=True, cg_budget_floor=2,
              cg_residual_rtol=1e-9)
    tpu_cfg, cfg = TpuConfig(**kw), TRPOConfig(**kw)
    ref_update = jax.jit(tpu_trpo.make_trpo_update(tpu_policy, tpu_cfg))
    update = trpo.make_trpo_update(
        make_policy((11,), BoxSpec(5), hidden=(32, 48)), cfg)
    ref_ladder = tpu_trpo.init_ladder(tpu_cfg)._replace(
        cg_budget=jnp.asarray(2, jnp.int32))
    ladder = ladder_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      ref_ladder))
    seen, ref_seen = [], []
    for _ in range(5):
        _, s = update(policy_params_from_numpy(params), _port_batch(data),
                      None, None, ladder)
        _, ref_s = ref_update(J(params), _tpu_batch(data), None, None,
                              ref_ladder)
        seen.append(int(s.cg_budget))
        ref_seen.append(int(ref_s.cg_budget))
        ladder, ref_ladder = s.ladder_next, ref_s.ladder_next
    assert seen == ref_seen == [2, 4, 6, 8, 8]


@pytest.mark.parametrize(
    "damping, success, rollback",
    [(0.1, True, False), (0.1, False, False), (0.1, True, True),
     (9.0, False, True), (1.05e-3, True, False)],
)
def test_next_damping_matches_reference(damping, success, rollback):
    kw = dict(adaptive_damping=True)
    want = tpu_trpo._next_damping(TpuConfig(**kw), jnp.float32(damping),
                                  jnp.asarray(success), jnp.asarray(rollback))
    got = trpo._next_damping(TRPOConfig(**kw), damping_from_numpy(damping),
                             torch.tensor(success), torch.tensor(rollback))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7)


def test_adaptive_damping_update_matches_reference():
    tpu_policy, params, data = _batch(11, 5, (32, 48), 256)
    kw = dict(adaptive_damping=True, cg_damping=0.3)
    ref_p, ref_s = jax.jit(tpu_trpo.make_trpo_update(
        tpu_policy, TpuConfig(**kw)))(J(params), _tpu_batch(data),
                                      jnp.float32(0.3))
    p, s = trpo.make_trpo_update(
        make_policy((11,), BoxSpec(5), hidden=(32, 48)), TRPOConfig(**kw))(
        policy_params_from_numpy(params), _port_batch(data),
        damping_from_numpy(0.3))
    np.testing.assert_allclose(float(s.damping_next),
                               float(ref_s.damping_next), rtol=1e-7)
    want = np.asarray(tpu_flatten(ref_p)[0], np.float64)
    got = flatten_params(p)[0].numpy().astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "kw, match",
    [({"fvp_dtype": "bf16"}, "solve_audit_every"),
     ({"solve_cosine_floor": 0.0}, "solve_cosine_floor"),
     ({"solve_fallback_limit": 0}, "solve_fallback_limit"),
     ({"solve_fault_skew": -1.0}, "solve_fault_skew"),
     ({"cg_budget_adaptive": True, "cg_budget_floor": 50}, "cg_budget_floor"),
     ({"cg_budget_adaptive": True, "cg_residual_tol": 0.0}, "residual rule"),
     ({"adaptive_damping": True, "damping_grow": 1.0}, "damping_grow"),
     ({"adaptive_damping": True, "damping_min": 0.0}, "damping_min"),
     ({"rollout_chunk": 3, "n_envs": 8, "batch_timesteps": 64},
      "must divide")],
)
def test_config_rejects_what_the_reference_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        TpuConfig(**kw)
    with pytest.raises(ValueError, match=match):
        TRPOConfig(**kw)


def test_ladder_helpers_agree_with_the_reference():
    for kw in ({}, {"fvp_subsample": 0.5},
               {"fvp_subsample": 0.5, "solve_audit_every": 5},
               {"cg_budget_adaptive": True},
               {"fvp_dtype": "bf16", "solve_audit_every": 2}):
        assert trpo.ladder_enabled(TRPOConfig(**kw)) == \
            tpu_trpo.ladder_enabled(TpuConfig(**kw)), kw
        assert trpo.ladder_stateful(TRPOConfig(**kw)) == \
            tpu_trpo.ladder_stateful(TpuConfig(**kw)), kw
    cfg = TRPOConfig(cg_budget_adaptive=True, cg_budget_ceiling=7)
    _assert_ladder_equal(trpo.init_ladder(cfg),
                         tpu_trpo.init_ladder(TpuConfig(
                             cg_budget_adaptive=True, cg_budget_ceiling=7)))
