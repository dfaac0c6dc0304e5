"""The rest of the solver and numeric surface against trpo_tpu on the CPU
(``tests/test_fvp.py``, ``tests/test_precond.py``, ``tests/test_returns.py``,
``tests/test_flat.py``): the jvp-of-grad FVP and the dense Fisher, the
Hutchinson/Jacobi preconditioner (with the reference's own probes passed
across), a Jacobi-preconditioned and a ``jvp_grad`` update, ``discount``
and ``gae_advantages``, the flat-parameter helpers, the nearest-rank
quantile, and the ``fake`` and ``chain`` device envs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from trpo_tpu import trpo as tpu_trpo
from trpo_tpu.config import TRPOConfig as TpuConfig
from trpo_tpu.envs.fake import FakeEnv as TpuFake
from trpo_tpu.envs.locomotion import ChainLocomotion as TpuChain
from trpo_tpu.models import BoxSpec as TpuBox
from trpo_tpu.models import make_policy as tpu_make_policy
from trpo_tpu.ops import flat as tpu_flat
from trpo_tpu.ops import fvp as tpu_fvp
from trpo_tpu.ops import precond as tpu_precond
from trpo_tpu.ops import returns as tpu_returns
from trpo_tpu.ops.flat import flatten_params as tpu_flatten
from trpo_tpu.utils.metrics import quantile_nearest_rank as tpu_quantile
from trpo_torch import envs, trpo
from trpo_torch.config import TRPOConfig
from trpo_torch.convert import policy_params_from_numpy
from trpo_torch.distributions import DiagGaussian, make_distribution
from trpo_torch.models.policy import BoxSpec, make_policy
from trpo_torch.ops import _build, flat, fvp, precond, returns
from trpo_torch.ops.flat import flatten_params
from trpo_torch.utils.metrics import quantile_nearest_rank

J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
T = torch.from_numpy


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _problem(B=96, obs_dim=5, act_dim=3, hidden=(16,), seed=0):
    ref = tpu_make_policy((obs_dim,), TpuBox(act_dim), hidden=hidden)
    params = _np(ref.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    params["log_std"] = rng.uniform(-0.5, 0.0, act_dim).astype(np.float32)
    obs = rng.normal(size=(B, obs_dim)).astype(np.float32)
    port = make_policy((obs_dim,), BoxSpec(act_dim), hidden=hidden)
    return ref, params, obs, port


def _kl_fns(ref, params, obs, port):
    """``kl(flat)`` of both packages: KL(stop_grad(π_θ) ‖ π_flat)."""
    flat0_r, unravel_r = tpu_flatten(J(params))
    anchor_r = ref.apply(J(params), jnp.asarray(obs))
    kl_r = lambda x: jnp.mean(ref.dist.kl(anchor_r,  # noqa: E731
                                          ref.apply(unravel_r(x),
                                                    jnp.asarray(obs))))
    pp = policy_params_from_numpy(params)
    flat0, unravel = flatten_params(pp)
    with torch.no_grad():
        anchor = port.apply(pp, T(obs))
    kl_p = lambda x: DiagGaussian.kl(anchor,  # noqa: E731
                                     port.apply(unravel(x), T(obs))).mean()
    return (kl_r, flat0_r), (kl_p, flat0)


def test_make_fvp_matches_reference_and_the_ggn():
    ref, params, obs, port = _problem()
    (kl_r, x_r), (kl_p, x_p) = _kl_fns(ref, params, obs, port)
    v = np.random.default_rng(1).normal(size=x_p.shape[0]).astype(np.float32)
    want = np.asarray(tpu_fvp.make_fvp(kl_r, x_r, damping=0.1)(
        jnp.asarray(v)))
    got = fvp.make_fvp(kl_p, x_p, damping=0.1)(T(v))
    # the reference's tolerance (tests/test_fvp.py:59)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    pp = policy_params_from_numpy(params)
    _, unravel = flatten_params(pp)
    ggn = fvp.make_ggn_fvp(lambda x: port.apply(unravel(x), T(obs)),
                           DiagGaussian.fisher_weight, x_p,
                           torch.ones(obs.shape[0]), damping=0.1)(T(v))
    np.testing.assert_allclose(got.numpy(), ggn.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_tree_fvp_and_dense_fisher_agree():
    ref, params, obs, port = _problem(B=32, hidden=(6,))
    (kl_r, x_r), (kl_p, x_p) = _kl_fns(ref, params, obs, port)
    F = fvp.materialize_fisher(kl_p, x_p)
    F_ref = np.asarray(tpu_fvp.materialize_fisher(kl_r, x_r))
    np.testing.assert_allclose(F.numpy(), F_ref, rtol=1e-4, atol=1e-5)
    v = torch.randn(x_p.shape[0], generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(fvp.make_fvp(kl_p, x_p)(v).numpy(),
                               (F @ v).numpy(), rtol=1e-4, atol=1e-5)
    pp = policy_params_from_numpy(params)
    _, unravel = flatten_params(pp)
    obs_t = T(obs)
    with torch.no_grad():
        anchor = port.apply(pp, obs_t)
    tree_op = fvp.make_tree_fvp(
        lambda p: DiagGaussian.kl(anchor, port.apply(p, obs_t)).mean(), pp,
        damping=0.05)
    got = flatten_params(tree_op(unravel(v)))[0]
    np.testing.assert_allclose(got.numpy(), (F @ v + 0.05 * v).numpy(),
                               rtol=1e-4, atol=1e-5)


def _ref_probes(like, n):
    """The reference's Jacobi probes for a flat vector (its fixed key)."""
    key = jax.random.key(0)
    return [np.asarray(tpu_precond._rademacher_like(
        jax.random.fold_in(key, i), like)) for i in range(n)]


def test_hutchinson_matches_reference_with_its_probes():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(20, 20)).astype(np.float32)
    A = (q @ q.T / 20 + np.diag(np.logspace(-2, 1, 20))).astype(np.float32)
    like = np.zeros(20, np.float32)
    probes = _ref_probes(jnp.asarray(like), 6)
    want = np.asarray(tpu_precond.hutchinson_diag(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(like), 6,
        jax.random.key(0)))
    got = precond.hutchinson_diag(lambda v: T(A) @ v, T(like), 6,
                                  probes=probes)
    # the reference's tolerances (tests/test_precond.py:117,141)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want_inv = np.asarray(tpu_precond.hutchinson_diag_inv(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(like), 6,
        jax.random.key(0), floor=0.1))
    got_inv = precond.hutchinson_diag_inv(lambda v: T(A) @ v, T(like), 6,
                                          0.1, probes=probes)
    np.testing.assert_allclose(got_inv.numpy(), want_inv, rtol=1e-5)
    # a diagonal operator is exact with one probe of the port's own draws
    d = torch.linspace(0.5, 3.0, 20)
    np.testing.assert_allclose(
        precond.hutchinson_diag(lambda v: d * v, torch.zeros(20), 1).numpy(),
        d.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="n_probes"):
        precond.hutchinson_diag(lambda v: v, torch.zeros(3), 0)


def _batch_problem():
    ref, params, obs, port = _problem(B=128, obs_dim=7, act_dim=3,
                                      hidden=(16, 16), seed=2)
    rng = np.random.default_rng(2)
    dist = _np(ref.apply(J(params), jnp.asarray(obs)))
    actions = (dist["mean"] + np.exp(dist["log_std"])
               * rng.normal(size=dist["mean"].shape)).astype(np.float32)
    adv = rng.normal(size=obs.shape[0]).astype(np.float32)
    adv = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(np.float32)
    B = obs.shape[0]
    ref_batch = tpu_trpo.TRPOBatch(jnp.asarray(obs), jnp.asarray(actions),
                                   jnp.asarray(adv), J(dist), jnp.ones(B))
    batch = trpo.TRPOBatch(T(obs), T(actions), T(adv),
                           {k: T(v) for k, v in dist.items()}, torch.ones(B))
    return ref, params, port, ref_batch, batch


def _assert_update_close(ref_params, ref_stats, new_params, stats, params):
    x0 = np.asarray(tpu_flatten(J(params))[0], np.float64)
    want = np.asarray(tpu_flatten(ref_params)[0], np.float64)
    got = flatten_params(new_params)[0].numpy().astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
    assert np.linalg.norm((got - x0) - (want - x0)) / np.linalg.norm(
        want - x0) < 1e-4
    assert int(stats.cg_iterations) == int(ref_stats.cg_iterations)
    np.testing.assert_allclose(float(stats.kl), float(ref_stats.kl),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("precondition", ["jacobi", True])
def test_jacobi_update_matches_reference(precondition):
    ref, params, port, ref_batch, batch = _batch_problem()
    tpu_cfg = TpuConfig(cg_precondition=precondition, cg_precond_probes=4)
    ref_params, ref_stats = jax.jit(
        tpu_trpo.make_trpo_update(ref, tpu_cfg))(J(params), ref_batch)
    n = tpu_flatten(J(params))[0].shape[0]
    probes = _ref_probes(jnp.zeros(n, jnp.float32), 4)
    cfg = TRPOConfig(cg_precondition=precondition, cg_precond_probes=4)
    _build.reset_launches()
    new_params, stats = trpo.make_trpo_update(port, cfg,
                                              jacobi_probes=probes)(
        policy_params_from_numpy(params), batch)
    # the probes run the CG operator (the fused kernel's plain version
    # here): Σ(cg_iterations + 1) + cg_precond_probes
    assert _build.LAUNCHES["fused_fvp_plain"] == \
        int(stats.cg_iterations) + 1 + 4
    _assert_update_close(ref_params, ref_stats, new_params, stats, params)
    # the port's own fixed-seed probes reproduce run to run
    a = trpo.make_trpo_update(port, cfg)(policy_params_from_numpy(params),
                                         batch)[0]
    b = trpo.make_trpo_update(port, cfg)(policy_params_from_numpy(params),
                                         batch)[0]
    assert torch.equal(flatten_params(a)[0], flatten_params(b)[0])


def test_jvp_grad_update_matches_reference_and_launches_no_kernel():
    ref, params, port, ref_batch, batch = _batch_problem()
    tpu_cfg = TpuConfig(fvp_mode="jvp_grad")
    ref_params, ref_stats = jax.jit(
        tpu_trpo.make_trpo_update(ref, tpu_cfg))(J(params), ref_batch)
    _build.reset_launches()
    new_params, stats = trpo.make_trpo_update(
        port, TRPOConfig(fvp_mode="jvp_grad"))(
        policy_params_from_numpy(params), batch)
    assert _build.LAUNCHES["fused_fvp_plain"] == 0
    _assert_update_close(ref_params, ref_stats, new_params, stats, params)


def test_discount_matches_lfilter_and_reference():
    rng = np.random.default_rng(0)
    for shape in ((37,), (23, 5)):
        x = rng.normal(size=shape).astype(np.float32)
        want = scipy.signal.lfilter([1], [1, -0.97], x[::-1], axis=0)[::-1]
        got = returns.discount(T(x.copy()), 0.97)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(tpu_returns.discount(jnp.asarray(x),
                                                         0.97)),
            rtol=2e-5, atol=2e-5)
    ints = returns.discount(torch.arange(4), 0.5)
    assert ints.dtype == torch.float32


@pytest.mark.parametrize("with_terminated", [False, True])
def test_gae_advantages_matches_reference(with_terminated):
    rng = np.random.default_rng(1)
    Tn, N = 29, 6
    r = rng.normal(size=(Tn, N)).astype(np.float32)
    v = rng.normal(size=(Tn, N)).astype(np.float32)
    last = rng.normal(size=N).astype(np.float32)
    done = rng.uniform(size=(Tn, N)) < 0.1
    term = done & (rng.uniform(size=(Tn, N)) < 0.5)
    kw = {"terminated": term} if with_terminated else {}
    want = tpu_returns.gae_advantages(
        jnp.asarray(r), jnp.asarray(v), jnp.asarray(done),
        jnp.asarray(last), 0.99, 0.95,
        **{k: jnp.asarray(x) for k, x in kw.items()})
    got = returns.gae_advantages(T(r), T(v), T(done), T(last), 0.99, 0.95,
                                 **{k: T(x) for k, x in kw.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


def test_flat_helpers_match_reference():
    ref, params, obs, port = _problem(hidden=(8, 4))
    pp = policy_params_from_numpy(params)
    assert flat.numel(pp) == tpu_flat.numel(J(params))
    assert flat.var_shapes(pp) == [tuple(s) for s in
                                   tpu_flat.var_shapes(J(params))]
    fn_r = lambda p: jnp.sum(ref.apply(p, jnp.asarray(obs))["mean"] ** 2)
    fn_p = lambda p: torch.sum(port.apply(p, T(obs))["mean"] ** 2)
    np.testing.assert_allclose(
        flat.flat_grad(fn_p, pp).numpy(),
        np.asarray(tpu_flat.flat_grad(fn_r, J(params))), rtol=1e-5,
        atol=1e-6)


@pytest.mark.parametrize("vals, q", [([], 0.5), ([3.0], 0.99),
                                     ([5, 1, 4, 2, 3], 0.5),
                                     (list(range(100)), 0.99),
                                     ([2.5, 0.5, 1.5], 1.0)])
def test_quantile_nearest_rank_matches_reference(vals, q):
    assert quantile_nearest_rank(vals, q) == tpu_quantile(vals, q)


def test_make_distribution_names():
    assert make_distribution("diag_gaussian") is DiagGaussian
    with pytest.raises(KeyError, match="unknown distribution"):
        make_distribution("beta")


def test_fake_env_matches_reference():
    port = envs.make("fake", chain_len=4, reward_scale=2.0)
    ref = TpuFake(chain_len=4, reward_scale=2.0)
    state, obs = port.reset(3)
    rs, ro = ref.reset(jax.random.key(0))
    np.testing.assert_array_equal(obs[0].numpy(), np.asarray(ro))
    actions = [np.array([1, 0, 1]), np.array([1, 1, 0]), np.array([0, 1, 1]),
               np.array([1, 1, 1])]
    for a in actions:
        state, obs, rew, term, trunc = port.step(state, T(a))
        rs, ro, rr, rt, _ = ref.step(rs, jnp.asarray(a[0]),
                                     jax.random.key(0))
        np.testing.assert_array_equal(obs[0].numpy(), np.asarray(ro))
        assert float(rew[0]) == float(rr) and bool(term[0]) == bool(rt)
        assert not trunc.any()
    assert term.all()


@pytest.mark.parametrize("n_masses, obs_dim", [(4, 9), (3, 5)])
def test_chain_at_other_widths_matches_reference(n_masses, obs_dim):
    ref = TpuChain(n_masses=n_masses, obs_dim=obs_dim, max_episode_steps=7)
    port = envs.make("chain", max_episode_steps=7, n_masses=n_masses,
                     obs_dim=obs_dim, projection=np.asarray(ref._w))
    assert port.obs_shape == (obs_dim,) and port.action_spec.dim == n_masses
    state, _ = port.reset(1, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    from trpo_tpu.envs.locomotion import ChainState as TpuChainState
    rs = TpuChainState(jnp.asarray(state.pos[0].numpy()),
                       jnp.asarray(state.vel[0].numpy()),
                       jnp.asarray(0, jnp.int32))
    for _ in range(7):
        a = rng.uniform(-1.5, 1.5, size=n_masses).astype(np.float32)
        state, obs, rew, _, trunc = port.step(state, T(a[None]))
        rs, ro, rr, _, rtr = ref.step(rs, jnp.asarray(a), jax.random.key(0))
        np.testing.assert_allclose(obs[0].numpy(), np.asarray(ro),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(rew[0]), float(rr), rtol=1e-5,
                                   atol=1e-6)
    assert bool(trunc[0]) and bool(rtr)
    # without a projection the port draws its own at this width
    own = envs.make("chain", n_masses=n_masses, obs_dim=obs_dim)
    assert own._w.shape == (obs_dim, 2 * n_masses - 1)
    np.testing.assert_allclose(own._w.norm(dim=1).numpy(), 1.0, rtol=1e-5)


def test_head_block_inverse_entry_point_matches_reference():
    ref, params, obs, port = _problem(B=40, obs_dim=6, act_dim=2,
                                      hidden=(5, 7), seed=4)
    w = np.ones(obs.shape[0], np.float32)
    r = np.random.default_rng(0).normal(
        size=tpu_flatten(J(params))[0].shape[0]).astype(np.float32)

    def torso_ref(net, o):
        h = o
        for layer in net["layers"][:-1]:
            h = jnp.tanh(h @ layer["w"] + layer["b"])
        return h

    def torso_port(net, o):
        h = o
        for layer in net["layers"][:-1]:
            h = torch.tanh(h @ layer["w"] + layer["b"])
        return h

    _, unravel_r = tpu_flatten(J(params))
    want = tpu_precond.make_gaussian_head_block_inv(
        torso_ref, J(params)["net"], jnp.asarray(obs), jnp.asarray(w),
        jnp.asarray(params["log_std"]), 0.1, unravel=unravel_r)(
        jnp.asarray(r))
    pp = policy_params_from_numpy(params)
    _, unravel = flatten_params(pp)
    tree_inv = precond.make_gaussian_head_block_inv(
        torso_port, pp["net"], T(obs), T(w), pp["log_std"], 0.1)
    got = flatten_params(tree_inv(unravel(T(r))))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_init_carry_is_init_env_states_in_the_reference_order():
    from trpo_torch.rollout import init_carry, init_env_states

    env = envs.make("pendulum")
    a = init_carry(env, torch.Generator().manual_seed(3), 5)
    b = init_env_states(env, 5, torch.Generator().manual_seed(3))
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
