"""The port's compat surface (``trpo_torch/compat.py``) held against the
reference's (``trpo_tpu/compat.py``), on the CPU, on the same numpy
inputs: ``discount`` to 2e-5 (the scan's tolerance); the host CG to
1e-5 and the line search to the same accepted step; ``flatgrad``,
``GetFlat`` and ``SetFromFlat`` to 1e-6 in the reference's flat order;
``slice_2d`` exactly; ``explained_variance`` to 1e-6 with NaN on constant
targets; ``rollout`` the same paths on a scripted env; ``VF`` carried
across predicting to 1e-5 and fitting once to 1e-4. The samplers use
different generators, so ``cat_sample`` is held to its frequencies and
to its reproducibility, never to the reference's stream.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trpo_torch import compat
from trpo_torch.convert import compat_vf_from_numpy, policy_params_from_numpy
from trpo_tpu import compat as ref

CPU = "cpu"


@pytest.mark.parametrize("shape,gamma", [((7,), 0.95), ((1,), 0.5),
                                         ((64,), 0.99), ((9, 3), 0.9),
                                         ((5,), 0.0), ((300,), 1.0)])
def test_discount_matches_the_reference(shape, gamma):
    x = np.random.default_rng(len(shape) + int(gamma * 100)).normal(
        size=shape).astype(np.float32)
    got = compat.discount(x, gamma, device=CPU)
    want = ref.discount(x, gamma)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # a tensor stays on its device (the CPU here: the plain scan)
    t = compat.discount(torch.from_numpy(x), gamma)
    np.testing.assert_allclose(t, want, rtol=2e-5, atol=2e-5)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, n))
    return m @ m.T + n * np.eye(n), rng.normal(size=n)


@pytest.mark.parametrize("n,iters,seed", [(12, 50, 0), (8, 10, 3),
                                          (30, 5, 1), (3, 10, 2)])
def test_conjugate_gradient_matches_the_reference(n, iters, seed):
    a, b = _spd(n, seed)
    got = compat.conjugate_gradient(lambda v: a @ v, b, cg_iters=iters)
    want = ref.conjugate_gradient(lambda v: a @ v, b, cg_iters=iters)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    # a closure answering in tensors is read the same
    got_t = compat.conjugate_gradient(
        lambda v: torch.from_numpy(a @ v), b, cg_iters=iters)
    np.testing.assert_allclose(got_t, want, rtol=1e-5, atol=1e-12)


_LS_CASES = {
    "quadratic": ([2.0], [-2.0], 4.0),
    "overshoot": ([1.0], [-8.0], 2.0),
    "zero_expected": ([1.0], [-1.0], 0.0),
    "failure": ([0.0], [1.0], 1.0),
    "two_dims": ([1.0, -3.0], [-4.0, 9.0], 3.0),
}


@pytest.mark.parametrize("case", sorted(_LS_CASES))
def test_linesearch_accepts_the_same_step(case):
    x0, step, rate = _LS_CASES[case]
    seen = {"port": [], "ref": []}

    def f(who):
        def fn(x):
            seen[who].append(np.asarray(x).copy())
            return float(np.sum(np.asarray(x) ** 2))
        return fn

    got = compat.linesearch(f("port"), np.asarray(x0), np.asarray(step),
                            rate)
    want = ref.linesearch(f("ref"), np.asarray(x0), np.asarray(step), rate)
    np.testing.assert_array_equal(got, want)
    # the same probes, so the same fraction accepted
    assert len(seen["port"]) == len(seen["ref"])
    for a, b in zip(seen["port"], seen["ref"]):
        np.testing.assert_array_equal(a, b)


def _policy_params():
    """The reference's policy params (Gaussian MLP) and the same numbers
    as torch tensors, via the converter."""
    from trpo_tpu.models import BoxSpec, make_policy

    policy = make_policy((5,), BoxSpec(3), hidden=(16, 8))
    params = policy.init(jax.random.key(0))
    params["log_std"] = params["log_std"] + 0.1
    port = policy_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           params))
    return policy, params, port


def test_flat_helpers_match_the_reference_order():
    policy, params, port = _policy_params()
    want = ref.GetFlat(params)()
    got = compat.GetFlat(port)()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert compat.numel(port) == ref.numel(params) == want.size
    assert compat.var_shape(port["net"]["layers"][0]["w"]) == \
        ref.var_shape(params["net"]["layers"][0]["w"])
    # SetFromFlat: a new tree, leaf for leaf the reference's, template kept
    theta = np.random.default_rng(0).normal(size=want.size).astype(
        np.float32)
    got_tree = compat.SetFromFlat(port)(theta)
    want_tree = ref.SetFromFlat(params)(theta)
    for a, b in zip(jax.tree_util.tree_leaves(want_tree),
                    [got_tree["log_std"]] + [
                        leaf for layer in got_tree["net"]["layers"]
                        for leaf in (layer["b"], layer["w"])]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    np.testing.assert_allclose(compat.GetFlat(port)(), want, rtol=1e-6)
    with pytest.raises(ValueError, match="expected flat vector"):
        compat.SetFromFlat(port)(np.zeros(5, np.float32))


def test_flatgrad_matches_the_reference():
    from trpo_torch.models import BoxSpec as PortBox
    from trpo_torch.models import make_policy as port_make_policy

    policy, params, port = _policy_params()
    port_policy = port_make_policy((5,), PortBox(3), hidden=(16, 8))
    obs = np.random.default_rng(1).normal(size=(11, 5)).astype(np.float32)
    target = np.random.default_rng(2).normal(size=(11, 3)).astype(
        np.float32)

    def ref_loss(p):
        d = policy.apply(p, jnp.asarray(obs))
        return jnp.sum((d["mean"] - target) ** 2 * jnp.exp(d["log_std"]))

    def port_loss(p):
        d = port_policy.apply(p, torch.from_numpy(obs))
        return torch.sum((d["mean"] - torch.from_numpy(target)) ** 2
                         * torch.exp(d["log_std"]))

    got = compat.flatgrad(port_loss, port)
    want = np.asarray(ref.flatgrad(ref_loss, params))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_slice_2d_and_explained_variance_match_the_reference():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    i0, i1 = [0, 1, 2, 2], [3, 0, 2, 0]
    np.testing.assert_array_equal(
        compat.slice_2d(x, i0, i1, device=CPU).numpy(),
        np.asarray(ref.slice_2d(x, i0, i1)))
    rng = np.random.default_rng(4)
    y = rng.normal(size=50).astype(np.float32)
    yhat = y + 0.3 * rng.normal(size=50).astype(np.float32)
    for a, b in ((yhat, y), (y, y), (np.full(50, y.mean()), y)):
        got = compat.explained_variance(a, b, device=CPU)
        assert isinstance(got, float)
        assert got == pytest.approx(ref.explained_variance(a, b), abs=1e-6)
    assert np.isnan(compat.explained_variance(np.zeros(4), np.ones(4),
                                              device=CPU))
    assert np.isnan(ref.explained_variance(np.zeros(4), np.ones(4)))


class _ScriptedEnv:
    """A deterministic classic-gym env: obs counts steps, an episode ends
    after ``lengths[i]`` steps (the i-th episode)."""

    def __init__(self, lengths):
        self.lengths, self.episode, self.t = list(lengths), -1, 0

    def reset(self):
        self.episode += 1
        self.t = 0
        return np.asarray([self.episode, 0.0], np.float32)

    def step(self, action):
        self.t += 1
        done = self.t >= self.lengths[self.episode % len(self.lengths)]
        return (np.asarray([self.episode, self.t], np.float32),
                float(action) + 0.5 * self.t, done, {})


class _ScriptedAgent:
    def act(self, ob):
        a = int(ob[1]) % 2
        return a, np.asarray([0.25 + 0.5 * a, 0.75 - 0.5 * a], np.float32)


@pytest.mark.parametrize("lengths,max_len,n", [([3, 5, 2], 10, 9),
                                               ([50], 4, 8),
                                               ([6, 1], 4, 11)])
def test_rollout_packs_the_same_paths(lengths, max_len, n):
    """The same paths as the reference's collector, an episode cut at
    ``max_pathlength`` (truncation) packed like any other."""
    got = compat.rollout(_ScriptedEnv(lengths), _ScriptedAgent(), max_len, n)
    want = ref.rollout(_ScriptedEnv(lengths), _ScriptedAgent(), max_len, n)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    if lengths == [50]:
        assert all(len(p["rewards"]) == max_len for p in got)


def _vf_paths():
    rng = np.random.RandomState(0)

    def path(n):
        p = {"obs": rng.randn(n, 4).astype(np.float32),
             "action_dists": rng.rand(n, 2).astype(np.float32),
             "rewards": rng.randn(n).astype(np.float32)}
        p["returns"] = ref.discount(p["rewards"], 0.95)
        return p
    return [path(30), path(17)]


def test_vf_carried_across_predicts_and_fits_like_the_reference():
    paths = _vf_paths()
    vf_ref = ref.VF(seed=3)
    vf_ref.fit(paths)   # Adam state past its first 50 steps
    params, opt_state = vf_ref.net
    adam = opt_state[0]
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    vf = compat_vf_from_numpy(compat.VF(device=CPU), as_np(params),
                              as_np(adam.mu), as_np(adam.nu),
                              int(adam.count))
    assert isinstance(vf, torch.nn.Module)
    for p in paths:
        got = vf.predict(p)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, vf_ref.predict(p), atol=1e-5)
    vf.fit(paths)
    vf_ref.fit(paths)
    for p in paths:
        np.testing.assert_allclose(vf.predict(p), vf_ref.predict(p),
                                   atol=1e-4)


def test_vf_predicts_zeros_before_fit_and_draws_no_global_rng():
    paths = _vf_paths()
    vf = compat.VF(device=CPU)
    np.testing.assert_array_equal(vf.predict(paths[0]),
                                  np.zeros(30, np.float32))
    torch.manual_seed(5)
    before = torch.rand(1)
    torch.manual_seed(5)
    vf.fit(paths)
    assert torch.equal(torch.rand(1), before)
    assert vf._features(paths[1]).shape == (17, 4 + 2 + 1)


def test_cat_sample_frequencies_and_reproducibility():
    prob = np.tile(np.asarray([[0.7, 0.2, 0.1]], np.float32), (6000, 1))
    g = compat.seed_everything(0, device=CPU)
    assert isinstance(g, torch.Generator)
    s = compat.cat_sample(prob, generator=g)
    assert s.shape == (6000,) and s.dtype == np.int32
    freq = np.bincount(s, minlength=3) / len(s)
    np.testing.assert_allclose(freq, [0.7, 0.2, 0.1], atol=0.025)
    np.testing.assert_array_equal(
        compat.cat_sample(np.asarray([[1.0, 0.0], [0.0, 1.0]]),
                          generator=g), [0, 1])
    a, b = (compat.cat_sample(
        prob[:50], generator=torch.Generator().manual_seed(9))
        for _ in range(2))
    np.testing.assert_array_equal(a, b)
    # the generator-less call draws from the module's stream
    compat.seed_everything(7, device=CPU)
    c = compat.cat_sample(prob[:50], device=CPU)
    compat.seed_everything(7, device=CPU)
    np.testing.assert_array_equal(compat.cat_sample(prob[:50], device=CPU),
                                  c)


def test_dict2_and_no_import_time_seeding():
    d = compat.dict2(a=1, b="x")
    assert d.a == 1 and d["b"] == "x" and dict(ref.dict2(a=1, b="x")) == d
    code = ("import torch; s = torch.initial_seed(); "
            "import trpo_torch.compat as c; "
            "assert c._stream is None and torch.initial_seed() == s")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
