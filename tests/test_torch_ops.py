"""trpo_torch numeric core against trpo_tpu on the CPU: the flat order, the
diagonal Gaussian, the MLP, the presets, CG, the line search, the
head-block preconditioner and the critic's Adam fit — plus the rules that
the port imports nothing of JAX and raises on paths it has not ported.

Inputs are drawn with numpy and handed to both packages; params cross
through ``trpo_torch.convert``.
"""

import dataclasses
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from trpo_tpu import config as tpu_config
from trpo_tpu.distributions import DiagGaussian as TpuGaussian
from trpo_tpu.models import BoxSpec as TpuBox
from trpo_tpu.models import make_policy as tpu_make_policy
from trpo_tpu.models.mlp import apply_mlp as tpu_apply_mlp
from trpo_tpu.ops.cg import conjugate_gradient as tpu_cg
from trpo_tpu.ops.linesearch import backtracking_linesearch as tpu_ls
from trpo_tpu.ops import precond as tpu_precond
from trpo_tpu.vf import create_value_function as tpu_create_vf
from trpo_torch import config as port_config
from trpo_torch.convert import (
    policy_params_from_numpy,
    policy_params_to_numpy,
    vf_state_from_numpy,
)
from trpo_torch.distributions import DiagGaussian
from trpo_torch.models.mlp import apply_mlp
from trpo_torch.ops import cg as cg_module
from trpo_torch.ops.cg import conjugate_gradient
from trpo_torch.ops.flat import flatten_params
from trpo_torch.ops.linesearch import backtracking_linesearch
from trpo_torch.ops import precond
from trpo_torch.vf import create_value_function

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 elementwise math and small matmuls on two CPU backends: the
# reference's own per-op tolerance for distribution math
RTOL = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tpu_params(hidden=(32, 48), obs_dim=11, act_dim=5, seed=0):
    policy = tpu_make_policy((obs_dim,), TpuBox(act_dim), hidden=hidden)
    return _np(policy.init(jax.random.key(seed)))


def test_flat_order_matches_ravel_pytree():
    params_np = _tpu_params()
    params_np["log_std"] = np.linspace(-1, 1, 5).astype(np.float32)
    ref_flat, _ = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, params_np))
    flat, unravel = flatten_params(policy_params_from_numpy(params_np))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref_flat))
    back = policy_params_to_numpy(unravel(flat))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params_np)):
        np.testing.assert_array_equal(a, b)


def _dist_pair(rng, B=64, A=5):
    mk = lambda: {"mean": rng.normal(size=(B, A)).astype(np.float32),
                  "log_std": rng.uniform(-1, 0.5, (B, A)).astype(np.float32)}
    return mk(), mk()


@pytest.mark.parametrize("fn", ["logp", "kl", "entropy", "fisher_weight"])
def test_diag_gaussian_matches_reference(fn):
    rng = np.random.default_rng(1)
    old, new = _dist_pair(rng)
    actions = rng.normal(size=(64, 5)).astype(np.float32)
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    args = {"logp": ((old, actions),), "kl": ((old, new),),
            "entropy": ((old,),), "fisher_weight": ((old, new),)}[fn][0]
    conv_t = [t(a) if isinstance(a, dict) else torch.from_numpy(a)
              for a in args]
    conv_j = [j(a) if isinstance(a, dict) else jnp.asarray(a) for a in args]
    got = getattr(DiagGaussian, fn)(*conv_t)
    want = getattr(TpuGaussian, fn)(*conv_j)
    if isinstance(got, dict):
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=RTOL, atol=RTOL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=RTOL)


def test_sample_uses_given_noise():
    rng = np.random.default_rng(2)
    d, _ = _dist_pair(rng)
    noise = rng.normal(size=(64, 5)).astype(np.float32)
    got = DiagGaussian.sample({k: torch.from_numpy(v) for k, v in d.items()},
                              noise=torch.from_numpy(noise))
    want = d["mean"] + np.exp(d["log_std"]) * noise
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("activation", ["tanh", "relu", "elu", "gelu"])
def test_apply_mlp_matches_reference(activation):
    params_np = _tpu_params(hidden=(32, 48))["net"]
    x = np.random.default_rng(3).normal(size=(40, 11)).astype(np.float32)
    want = tpu_apply_mlp(jax.tree_util.tree_map(jnp.asarray, params_np),
                         jnp.asarray(x), activation)
    got = apply_mlp(policy_params_from_numpy(params_np), torch.from_numpy(x),
                    activation)
    # matmul sums in another order on the two CPU backends: compare at the
    # f32 matmul scale (absolute, the outputs are O(0.01))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-6)


def test_presets_match_reference_training_fields():
    port_fields = {f.name for f in dataclasses.fields(port_config.TRPOConfig)}
    assert set(port_config.PRESETS) == set(tpu_config.PRESETS)
    for name, cfg in port_config.PRESETS.items():
        ref = tpu_config.PRESETS[name]
        for field in port_fields:
            assert getattr(cfg, field) == getattr(ref, field), (name, field)


@pytest.mark.parametrize(
    "override",
    [
        {"env": "gymproc:CartPole-v1"},
        {"mesh_shape": (2,)},
        "capture",
        "fleet",
    ],
)
def test_unported_paths_raise(override):
    if override == "capture":
        # request capture runs now (item 18.5): nothing refuses it, and
        # the refusal helper it had is gone
        import inspect

        from trpo_torch.serve import PolicyServer, Router

        assert not hasattr(port_config, "refuse_unported")
        for cls in (PolicyServer, Router):
            assert "capture" in inspect.signature(cls).parameters
        importlib.import_module("trpo_torch.obs.capture")
        return
    if override == "fleet":
        # the fleet orchestrator and the promotion controller run now
        # (item 18.6): the package imports and exposes the reference's
        # surface, and so does the compat module
        fleet = importlib.import_module("trpo_torch.fleet")
        tpu_fleet = importlib.import_module("trpo_tpu.fleet")
        assert fleet.__all__ == tpu_fleet.__all__
        assert all(hasattr(fleet, name) for name in fleet.__all__)
        compat = importlib.import_module("trpo_torch.compat")
        assert compat.__all__ == importlib.import_module(
            "trpo_tpu.compat").__all__
        return
    cfg = port_config.TRPOConfig(**override)
    if "env" in override:
        # the gymproc: worker pool runs now (item 18.3): nothing refuses
        # it, its fields match the reference's, and the env builds a pool
        # that steps
        assert not hasattr(port_config, "check_ported")
        ref = tpu_config.TRPOConfig(**override)
        for name in ("env_step_timeout", "max_worker_restarts",
                     "min_env_workers", "worker_backoff", "inject_faults"):
            assert getattr(cfg, name) == getattr(ref, name), name
        pytest.importorskip("gymnasium")
        from trpo_torch import envs

        pool = envs.make(cfg.env, n_envs=2, seed=0, n_workers=1)
        try:
            assert pool.host_step(np.zeros(2, np.int64))[0].shape == (2, 4)
        finally:
            pool.close()
        return
    # every mesh runs now (items 16.1 and 16.2): the refusal helper is
    # gone; a valid mesh passes the agent's validation and asks for its
    # ranks (a RuntimeError naming torchrun, before any process group),
    # and an invalid one raises the reference's ValueError
    from trpo_torch.agent import TRPOAgent

    assert not hasattr(port_config, "check_ported")
    for kw, error, match in (
            ({"mesh_shape": (2,)}, RuntimeError, "torchrun"),
            ({"mesh_shape": (2, 2), "mesh_axes": ("data", "seq"),
              "batch_timesteps": 256}, RuntimeError, "torchrun"),
            ({"mesh_shape": (2, 2), "mesh_axes": ("data", "model")},
             RuntimeError, "torchrun"),
            ({"mesh_shape": (2, 2), "mesh_axes": ("data", "expert")},
             ValueError, "needs an MoE policy"),
            ({"mesh_shape": (2,), "env": "gym:CartPole-v1"},
             RuntimeError, "torchrun")):
        port_cfg = port_config.TRPOConfig(**kw)
        with pytest.raises(error, match=match):
            TRPOAgent(port_cfg.env, port_cfg, device="cpu")
        if error is ValueError:   # the reference's own error
            from trpo_tpu.agent import TRPOAgent as TpuAgent

            with pytest.raises(error, match=match):
                TpuAgent("cartpole", tpu_config.TRPOConfig(**kw))
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize(
    "override",
    [
        {"serve_replicas": 2},
        {"serve_replicas": 2, "serve_max_replicas": 3},
        {"serve_min_replicas": 2, "serve_replicas": 2,
         "serve_max_replicas": 4},
        {"serve_hosts": ("a", "b")},
        {"serve_replica_cmd": "python serve.py"},
        {"serve_canary_fraction": 0.5},
        {"serve_reward_window": 4},
    ],
)
def test_control_plane_fields_are_ported(override):
    # the serving control plane runs now: nothing refuses its fields, and
    # the port's config validates them as the reference's does
    cfg = port_config.TRPOConfig(**override)
    assert not hasattr(port_config, "check_ported")
    ref = tpu_config.TRPOConfig(**override)
    for name in override:
        assert getattr(cfg, name) == getattr(ref, name)
    bad = {"serve_replicas": 0, "serve_max_replicas": 1,
           "serve_min_replicas": 0, "serve_hosts": (),
           "serve_replica_cmd": " ", "serve_canary_fraction": 1.5,
           "serve_reward_window": -1}
    for name in override:
        wrong = {**override, name: bad[name]}
        for cls in (tpu_config.TRPOConfig, port_config.TRPOConfig):
            with pytest.raises(ValueError):
                cls(**wrong)


@pytest.mark.parametrize(
    "preset, override",
    [
        # Queue 1 item 15: the overlapped actor/learner loop
        (None, {"train_overlap": 1, "rollout_chunk": 1}),
        ("humanoid-sim-fleet", {"train_overlap": 1}),
    ],
)
def test_overlap_paths_are_ported(preset, override):
    cfg = (port_config.TRPOConfig(**override) if preset is None
           else port_config.get_preset(preset).replace(**override))
    assert cfg.train_overlap == 1
    assert not hasattr(port_config, "check_ported")


@pytest.mark.parametrize(
    "override",
    [
        {"fvp_subsample": 0.75, "solve_audit_every": 25},
        {"fvp_dtype": "bf16", "solve_audit_every": 25},
        {"cg_budget_adaptive": True},
        {"adaptive_damping": True},
        {"rollout_chunk": 2, "n_envs": 8, "batch_timesteps": 64},
        {"compute_dtype": "bfloat16"},
        {"normalize_obs": True},
        {"policy_experts": 4},
        {"env": "pong-sim"},
        {"env": "catch"},
        {"policy_gru": 8},
        {"env": "cartpole-po", "policy_gru": 64, "policy_cell": "lstm"},
        # Queue 1 items 13 and 3
        {"env": "native:cartpole"},
        {"cg_precondition": True},
        {"env": "fake"},
        {"env": "gym:Humanoid-v4"},
        {"env": "chain"},
        {"cg_precondition": "jacobi"},
        {"fvp_mode": "jvp_grad"},
    ],
)
def test_ladder_and_fleet_paths_are_ported(override):
    cfg = port_config.TRPOConfig(**override)
    assert all(getattr(cfg, k) == v for k, v in override.items())
    assert not hasattr(port_config, "check_ported")


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, n)).astype(np.float32)
    return (q @ q.T / n + np.diag(np.logspace(-2, 1, n))).astype(np.float32)


@pytest.mark.parametrize("precondition", [False, True])
@pytest.mark.parametrize("rtol", [0.0, 1e-2])
def test_cg_matches_reference(precondition, rtol):
    A = _spd(30, 4)
    b = np.random.default_rng(5).normal(size=30).astype(np.float32)
    d_inv = (1.0 / np.diag(A)).astype(np.float32)
    ref = tpu_cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), cg_iters=10,
                 M_inv=(lambda r: jnp.asarray(d_inv) * r)
                 if precondition else None,
                 residual_rtol=rtol)
    got = conjugate_gradient(lambda v: torch.from_numpy(A) @ v,
                             torch.from_numpy(b), cg_iters=10,
                             M_inv=(lambda r: torch.from_numpy(d_inv) * r)
                             if precondition else None,
                             residual_rtol=rtol)
    assert int(got.iterations) == int(ref.iterations)
    # the same recurrence in f32 on two backends; 10 iterations amplify
    # matvec roundoff, so compare relative to the solution's size
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(ref.x)).max())


def _masked_cg(f_Ax, b, cg_iters, residual_tol, M_inv=None, max_iters=None):
    """The CG loop as it was before the early exit: always ``cg_iters``
    (or ``max_iters`` under a tensor budget) iterations, converged ones
    masked. The oracle the early exit must equal bit for bit."""
    budget = isinstance(cg_iters, torch.Tensor)
    n_loop = int(max_iters) if budget else int(cg_iters)
    x, r = torch.zeros_like(b), b
    rdotr = torch.dot(b, b)
    z = b if M_inv is None else M_inv(b)
    p, rdotz = z, rdotr if M_inv is None else torch.dot(b, z)
    stop = torch.clamp(0.0 * rdotr, min=residual_tol)
    iterations = torch.zeros((), dtype=torch.int32)
    for i in range(n_loop):
        active = rdotr > stop
        if budget:
            active = active & (cg_iters > i)
        w = f_Ax(p)
        alpha = rdotz / torch.dot(p, w)
        x_new, r_new = x + alpha * p, r - alpha * w
        z = r_new if M_inv is None else M_inv(r_new)
        rdotr_new = torch.dot(r_new, r_new)
        rdotz_new = rdotr_new if M_inv is None else torch.dot(r_new, z)
        p_new = z + (rdotz_new / rdotz) * p
        x, r, p = (torch.where(active, a, b_) for a, b_ in
                   ((x_new, x), (r_new, r), (p_new, p)))
        rdotz = torch.where(active, rdotz_new, rdotz)
        rdotr = torch.where(active, rdotr_new, rdotr)
        iterations = iterations + active.to(torch.int32)
    return x, rdotr, iterations


def _five_cluster_system():
    """An SPD system with five distinct eigenvalues: CG solves it in five
    iterations, then the residual sits at roundoff."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.normal(size=(30, 30)))
    eig = np.repeat([0.5, 1.0, 2.0, 4.0, 8.0], 6)
    A = (q * eig) @ q.T
    b = rng.normal(size=30)
    return A.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("precondition", [False, True])
def test_cg_early_exit_calls_the_operator_as_the_reference(precondition):
    A, b = _five_cluster_system()
    tol = 1e-6
    # a scalar preconditioner keeps the five clusters (Jacobi would not)
    d_inv = np.full(30, 0.5, np.float32)
    ref = tpu_cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), cg_iters=10,
                 residual_tol=tol,
                 M_inv=(lambda r: jnp.asarray(d_inv) * r)
                 if precondition else None)
    calls = []

    def f_Ax(v):
        calls.append(1)
        return torch.from_numpy(A) @ v

    M_inv = ((lambda r: torch.from_numpy(d_inv) * r) if precondition
             else None)
    got = conjugate_gradient(f_Ax, torch.from_numpy(b), cg_iters=10,
                             residual_tol=tol, M_inv=M_inv)
    assert int(ref.iterations) == 5
    # the reference's while_loop runs its body once per iteration
    assert len(calls) == int(got.iterations) == int(ref.iterations) < 10
    x, rr, it = _masked_cg(lambda v: torch.from_numpy(A) @ v,
                           torch.from_numpy(b), 10, tol, M_inv)
    assert torch.equal(got.x, x) and torch.equal(got.residual_norm_sq, rr)
    assert torch.equal(got.iterations, it)


@pytest.mark.parametrize("check_every", [0, 1, 2, 3])
@pytest.mark.parametrize("budget", [None, 3, 7])
def test_cg_early_exit_is_bitwise_the_masked_loop(monkeypatch, check_every,
                                                   budget):
    monkeypatch.setattr(cg_module, "CHECK_EVERY", check_every)
    A, b = _five_cluster_system()
    calls = []

    def f_Ax(v):
        calls.append(1)
        return torch.from_numpy(A) @ v

    iters = 10 if budget is None else torch.tensor(budget, dtype=torch.int32)
    got = conjugate_gradient(f_Ax, torch.from_numpy(b), cg_iters=iters,
                             residual_tol=1e-6, max_iters=10)
    x, rr, it = _masked_cg(lambda v: torch.from_numpy(A) @ v,
                           torch.from_numpy(b), iters, 1e-6, max_iters=10)
    assert torch.equal(got.x, x) and torch.equal(got.residual_norm_sq, rr)
    assert torch.equal(got.iterations, it)
    # a tensor budget is read once and bounds the loop; past convergence
    # at most check_every - 1 calls remain (all of them with no reading)
    n_loop = 10 if budget is None else budget
    if check_every == 0:
        assert len(calls) == n_loop
    else:
        assert int(it) <= len(calls) <= min(n_loop,
                                            int(it) + check_every - 1)
    # a rule that cannot fire is never read: the full count, as the
    # bench's forced solves need
    calls.clear()
    conjugate_gradient(f_Ax, torch.from_numpy(b), cg_iters=10,
                       residual_tol=0.0)
    assert len(calls) == 10


# (step along c, sign of the expected rate, KL cap, trials) for a loss
# |x - c|² from 0 and the cap |x|² ≤ 100·kl_cap (|c|² = 16.3): a rate of
# the wrong sign passes no trial; with the right one the half step passes
# at once, and the 4c step overshoots to 1/4 (1/8 under the cap)
LS_CASES = [
    pytest.param(4.0, -1.0, None, 10, id="None"),
    pytest.param(4.0, -1.0, 0.05, 10, id="0.05"),
    pytest.param(0.5, 1.0, None, 1, id="first-None"),
    pytest.param(0.5, 1.0, 0.05, 1, id="first-0.05"),
    pytest.param(4.0, 1.0, None, 3, id="planted-None"),
    pytest.param(4.0, 1.0, 0.05, 4, id="planted-0.05"),
]


def _ls_problem(scale, sign):
    rng = np.random.default_rng(6)
    c = rng.normal(size=8).astype(np.float32)
    step = (scale * c).astype(np.float32)
    return c, np.zeros(8, np.float32), step, float(sign * 2.0
                                                    * np.dot(c, step))


@pytest.mark.parametrize("scale,sign,kl_cap,trials", LS_CASES)
def test_linesearch_matches_reference(scale, sign, kl_cap, trials):
    c, x0, step, rate = _ls_problem(scale, sign)

    def loss_j(x):
        return jnp.sum((x - jnp.asarray(c)) ** 2), {"x": x}

    def loss_t(x):
        return torch.sum((x - torch.from_numpy(c)) ** 2), {"x": x}

    cons_j = cons_t = None
    if kl_cap is not None:
        cons_j = lambda x, aux: jnp.sum(aux["x"] ** 2) <= kl_cap * 100
        cons_t = lambda x, aux: torch.sum(aux["x"] ** 2) <= kl_cap * 100
    ref = tpu_ls(loss_j, jnp.asarray(x0), jnp.asarray(step),
                 jnp.float32(rate), has_aux=True, constraint_fn=cons_j)
    got = backtracking_linesearch(loss_t, torch.from_numpy(x0),
                                  torch.from_numpy(step),
                                  torch.tensor(rate), has_aux=True,
                                  constraint_fn=cons_t)
    assert bool(got.success) == bool(ref.success) == (trials < 10)
    assert int(got.trials) == int(ref.trials) == trials
    assert float(got.step_fraction) == float(ref.step_fraction)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=RTOL)
    np.testing.assert_allclose(got.aux["x"].numpy(), np.asarray(ref.aux["x"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(got.loss), float(ref.loss), rtol=RTOL)


def _latched_linesearch(loss_fn, x, fullstep, rate, max_backtracks,
                        accept_ratio, factor, constraint_fn, f0, aux0):
    """Every trial evaluated and the first acceptance latched by
    ``torch.where``: the result the early exit must equal bit for bit."""
    accepted = torch.zeros((), dtype=torch.bool)
    trials = torch.zeros((), dtype=torch.int32)
    x_acc, f_acc, aux_acc = x, f0, aux0
    frac_acc = torch.zeros((), dtype=torch.float32)
    for k in range(max_backtracks):
        frac = torch.tensor(factor, dtype=torch.float32) ** float(k)
        xnew = x + frac.to(x.dtype) * fullstep
        newfval, aux = loss_fn(xnew)
        actual = f0 - newfval
        ok = (actual / (rate * frac) > accept_ratio) & (actual > 0.0)
        if constraint_fn is not None:
            ok = ok & constraint_fn(xnew, aux)
        take = ok & ~accepted
        trials = trials + (~accepted).to(torch.int32)
        x_acc = torch.where(take, xnew, x_acc)
        f_acc = torch.where(take, newfval, f_acc)
        frac_acc = torch.where(take, frac, frac_acc)
        aux_acc = {"x": torch.where(take, aux["x"], aux_acc["x"])}
        accepted = accepted | ok
    return x_acc, accepted, frac_acc, f_acc, aux_acc, trials


@pytest.mark.parametrize("factor", [0.5, 0.7])
@pytest.mark.parametrize("scale,sign,kl_cap,trials", LS_CASES)
def test_linesearch_early_exit_is_bitwise_the_latch(scale, sign, kl_cap,
                                                    trials, factor):
    """The loss runs exactly ``trials`` times (``max_backtracks`` with no
    acceptance, returning ``x``, ``f0`` and ``aux0``), and every field is
    bitwise the all-trials latch's, for a factor that is not a power of
    two too."""
    c, x0, step, rate = _ls_problem(scale, sign)
    ct, x, fullstep = (torch.from_numpy(v) for v in (c, x0, step))
    calls = []

    def loss(v):
        calls.append(1)
        return torch.sum((v - ct) ** 2), {"x": v}

    cons = None
    if kl_cap is not None:
        cons = lambda v, aux: torch.sum(aux["x"] ** 2) <= kl_cap * 100
    f0, aux0 = loss(x)
    calls.clear()
    rate_t = torch.tensor(rate)
    got = backtracking_linesearch(loss, x, fullstep, rate_t,
                                  backtrack_factor=factor,
                                  constraint_fn=cons, has_aux=True, f0=f0,
                                  aux0=aux0)
    evals = len(calls)
    assert evals == int(got.trials)
    if factor == 0.5:
        assert evals == trials
    want = _latched_linesearch(loss, x, fullstep, rate_t, 10, 0.1, factor,
                               cons, f0, aux0)
    for a, b in zip((got.x, got.success, got.step_fraction, got.loss,
                     got.aux["x"], got.trials),
                    (want[0], want[1], want[2], want[3], want[4]["x"],
                     want[5])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    if not bool(got.success):
        assert evals == 10
        assert torch.equal(got.x, x) and torch.equal(got.loss, f0)
        assert got.aux is aux0


def test_head_block_preconditioner_matches_reference():
    params_np = _tpu_params(hidden=(16, 24), obs_dim=7, act_dim=3)
    params_np["log_std"] = np.asarray([-0.3, 0.1, 0.2], np.float32)
    rng = np.random.default_rng(7)
    obs = rng.normal(size=(90, 7)).astype(np.float32)
    weight = np.ones(90, np.float32)
    weight[-10:] = 0.0
    r_np = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), params_np)

    def torso_j(net, o):
        h = o
        for layer in net["layers"][:-1]:
            h = jnp.tanh(h @ layer["w"] + layer["b"])
        return h

    def torso_t(net, o):
        h = o
        for layer in net["layers"][:-1]:
            h = torch.tanh(h @ layer["w"] + layer["b"])
        return h

    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    S_ref = tpu_precond.gaussian_head_gram(torso_j, J(params_np["net"]),
                                           jnp.asarray(obs),
                                           jnp.asarray(weight))
    M_ref = tpu_precond.apply_gaussian_head_block_inv(
        *tpu_precond.head_gram_eigh(S_ref), jnp.asarray(weight),
        jnp.asarray(params_np["log_std"]), 0.1)(J(r_np))
    params = policy_params_from_numpy(params_np)
    S = precond.gaussian_head_gram(torso_t, params["net"],
                                   torch.from_numpy(obs),
                                   torch.from_numpy(weight))
    np.testing.assert_allclose(S.numpy(), np.asarray(S_ref), rtol=1e-5,
                               atol=1e-6)
    M = precond.apply_gaussian_head_block_inv(
        *precond.head_gram_eigh(S), torch.from_numpy(weight),
        params["log_std"], 0.1)(policy_params_from_numpy(r_np))
    # eigh on two backends: the map U diag U^T is basis-independent, but
    # the small eigenvalues' f32 error is amplified by 1/(s·m + λ)
    for a, b in zip(jax.tree_util.tree_leaves(policy_params_to_numpy(M)),
                    jax.tree_util.tree_leaves(_np(M_ref))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_critic_adam_fit_matches_optax():
    rng = np.random.default_rng(8)
    obs = rng.normal(size=(128, 6)).astype(np.float32)
    targets = rng.normal(size=128).astype(np.float32)
    weight = np.ones(128, np.float32)
    ref_vf = tpu_create_vf(6, hidden=(16, 16), train_steps=7)
    ref_state = ref_vf.init(jax.random.key(0))
    adam = ref_state.opt_state[0]
    state = vf_state_from_numpy(_np(ref_state.params), _np(adam.mu),
                                _np(adam.nu), int(adam.count), False)
    ref_new, ref_loss = ref_vf.fit(ref_state, jnp.asarray(obs),
                                   jnp.asarray(targets), jnp.asarray(weight))
    vf = create_value_function(6, hidden=(16, 16), train_steps=7)
    new, loss = vf.fit(state, torch.from_numpy(obs),
                       torch.from_numpy(targets), torch.from_numpy(weight))
    assert new.initialized and new.opt_state.count == 7
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    # seven Adam steps: each step's update is O(lr) and its f32 roundoff
    # compounds, so compare at 1e-5 of the weights' scale
    for a, b in zip(jax.tree_util.tree_leaves(policy_params_to_numpy(
            new.params)), jax.tree_util.tree_leaves(_np(ref_new.params))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    zero = vf.predict(state, torch.from_numpy(obs))
    assert torch.count_nonzero(zero) == 0  # uninitialized → zeros


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import trpo_torch\n"
        "for m in pkgutil.walk_packages(trpo_torch.__path__, 'trpo_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('trpo_torch.serve.server', 'trpo_torch.serve.session',\n"
        "          'trpo_torch.serve.__main__', 'trpo_torch.utils.httpd'):\n"
        "    assert m in sys.modules, m\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'optax', 'flax', 'trpo_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean', len([k for k in sys.modules\n"
        "                    if k.startswith('trpo_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")
