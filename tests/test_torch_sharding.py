"""The port's data parallelism (``trpo_torch.parallel.sharded``) on a gloo
group of two CPU processes, held against ``trpo_tpu.parallel`` on its
8-device CPU mesh: the same inputs, drawn from a numpy seed, through the
reference's sharded FVPs, update and CG solve and through the port's, at
the reference's own tolerances (``tests/test_sharding.py``).

One group serves the whole file (``torch_mesh_worker.Group`` from a
module-scoped fixture): every case is a job it runs once, while this
process computes the reference's results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_worker import Group, outputs
from trpo_tpu.config import TRPOConfig as TpuConfig
from trpo_tpu.models import BoxSpec as TpuBox
from trpo_tpu.models import DiscreteSpec as TpuDiscrete
from trpo_tpu.models import make_policy as tpu_make_policy
from trpo_tpu.ops import conjugate_gradient as tpu_cg
from trpo_tpu.ops import flatten_params as tpu_flatten
from trpo_tpu.parallel import make_mesh as tpu_make_mesh
from trpo_tpu.parallel import make_sharded_fvp as tpu_sharded_fvp
from trpo_tpu.parallel import make_sharded_ggn_fvp as tpu_sharded_ggn
from trpo_tpu.parallel import make_sharded_update as tpu_sharded_update
from trpo_tpu.parallel import shard_batch as tpu_shard_batch
from trpo_tpu.trpo import TRPOBatch as TpuBatch
from trpo_torch import trpo
from trpo_torch.config import TRPOConfig
from trpo_torch.models.policy import BoxSpec, DiscreteSpec, make_policy
from trpo_torch.ops.fused_fvp import make_fused_gaussian_mlp_fvp
from trpo_torch.parallel import make_mesh, pad_batch

WORLD = 2
CAT = {"obs_dim": 4, "act": ["discrete", 3], "hidden": [16]}
GAUSS = {"obs_dim": 11, "act": ["box", 5], "hidden": [32, 48]}


def _problem(spec, n, seed=0, pad_tail=0):
    """Params (flat), obs, actions, advantages, old dist and weights from
    the reference's policy; the last ``pad_tail`` rows weigh 0."""
    kind, k = spec["act"]
    policy = tpu_make_policy((spec["obs_dim"],),
                             TpuDiscrete(k) if kind == "discrete"
                             else TpuBox(k), hidden=tuple(spec["hidden"]))
    params = policy.init(jax.random.key(seed))
    rng = np.random.default_rng(seed + 1)
    obs = rng.normal(size=(n, spec["obs_dim"])).astype(np.float32)
    dist = {key: np.asarray(v) for key, v in
            policy.apply(params, jnp.asarray(obs)).items()}
    if kind == "discrete":
        actions = rng.integers(0, k, n).astype(np.int64)
    else:
        actions = (dist["mean"] + np.exp(dist["log_std"])
                   * rng.normal(size=(n, k))).astype(np.float32)
    adv = rng.normal(size=n).astype(np.float32)
    adv = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(np.float32)
    weight = np.ones(n, np.float32)
    if pad_tail:
        weight[-pad_tail:] = 0.0
    flat = np.asarray(tpu_flatten(params)[0], np.float32)
    arrays = dict(flat=flat, obs=obs, actions=actions, adv=adv,
                  weight=weight, **{"d_" + key: v for key, v in dist.items()})
    return policy, params, arrays


def _tpu_batch(a):
    J = jnp.asarray
    return TpuBatch(J(a["obs"]), J(a["actions"]), J(a["adv"]),
                    {k[2:]: J(v) for k, v in a.items() if k.startswith("d_")},
                    J(a["weight"]))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


CASES = {}   # job name -> (fn, args, inputs, reference thunk)
REFS = {}    # job name -> the reference's result


def _case(name, fn, args, arrays, ref=None):
    CASES[name] = (fn, args, arrays, ref)


def _build_cases():
    mesh = tpu_make_mesh()
    v_key = jax.random.key(9)
    for kind, maker in (("jvp", tpu_sharded_fvp), ("ggn", tpu_sharded_ggn)):
        for n in (256, 250):
            policy, params, a = _problem(CAT, n)
            cfg = TpuConfig(cg_damping=0.1)
            v = np.asarray(jax.random.normal(v_key, a["flat"].shape),
                           np.float32)
            ref = (lambda maker=maker, policy=policy, cfg=cfg, params=params,
                    a=a, v=v: np.asarray(maker(policy, cfg, mesh)(
                        params, tpu_shard_batch(mesh, _tpu_batch(a)),
                        jnp.asarray(v))))
            _case(f"fvp_{kind}_{n}", "sharded_fvp",
                  {"kind": kind, "policy": CAT, "damping": 0.1},
                  dict(a, v=v), ref)
    # the fused operator: the reference's sharded GGN and the port's
    # single-rank fused operator on the full batch are both its oracle
    policy, params, a = _problem(GAUSS, 320, pad_tail=40)
    v = np.asarray(jax.random.normal(v_key, a["flat"].shape), np.float32)
    _case("fvp_fused_320", "sharded_fvp",
          {"kind": "fused", "policy": GAUSS, "damping": 0.1}, dict(a, v=v),
          lambda policy=policy, params=params, a=a, v=v: np.asarray(
              tpu_sharded_ggn(policy, TpuConfig(cg_damping=0.1), mesh)(
                  params, tpu_shard_batch(mesh, _tpu_batch(a)),
                  jnp.asarray(v))))
    # update and solve (tests/test_sharding.py's setup: 240 rows)
    policy, params, a = _problem(CAT, 240)

    def update_ref():
        p_ref, s_ref = tpu_sharded_update(policy, TpuConfig(), mesh)(
            params, tpu_shard_batch(mesh, _tpu_batch(a)))
        return (np.asarray(tpu_flatten(p_ref)[0]), float(s_ref.kl),
                bool(s_ref.linesearch_success))

    _case("update", "sharded_update", {"policy": CAT}, a, update_ref)
    b = np.asarray(jax.random.normal(jax.random.key(4), a["flat"].shape),
                   np.float32)
    _case("solve", "sharded_solve", {"policy": CAT}, dict(a, b=b),
          lambda: np.asarray(tpu_cg(
              lambda vv: tpu_sharded_fvp(policy, TpuConfig(), mesh)(
                  params, tpu_shard_batch(mesh, _tpu_batch(a)), vv),
              jnp.asarray(b)).x))
    # actions 30 standard deviations out: the search backtracks, and the
    # ranks must leave it at the same trial
    g_policy, g_params, g = _problem(GAUSS, 240, seed=3)
    noise = np.random.default_rng(5).normal(size=g["actions"].shape)
    g["actions"] = (g["d_mean"] + 30.0 * np.exp(g["d_log_std"])
                    * noise).astype(np.float32)

    def planted_ref():
        p_ref, s_ref = tpu_sharded_update(g_policy, TpuConfig(), mesh)(
            g_params, tpu_shard_batch(mesh, _tpu_batch(g)))
        return (np.asarray(tpu_flatten(p_ref)[0]),
                int(s_ref.linesearch_trials), float(s_ref.step_fraction))

    _case("planted_search", "counted_update", {"policy": GAUSS}, g,
          planted_ref)
    _case("fused_mode", "sharded_update",
          {"policy": CAT, "cfg": {"fvp_mode": "fused"}}, a)
    _case("subsample", "sharded_update",
          {"policy": CAT, "cfg": {"fvp_subsample": 0.75,
                                  "cg_precondition": False}}, a)
    _case("mesh_validate", "mesh_validate", {}, {})
    _case("diverge", "diverge", {}, {})   # last: it leaves a group broken


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    if not CASES:
        _build_cases()
    work = tmp_path_factory.mktemp("sharding")
    ranks = Group(work, [{"name": n, "fn": fn, "args": args}
                         for n, (fn, args, _, _) in CASES.items()],
                  WORLD, {n: c[2] for n, c in CASES.items()})
    REFS.update({n: c[3]() for n, c in CASES.items() if c[3] is not None})
    return work, ranks.wait()


def _out(group, name):
    work, _ = group
    return outputs(work, name, WORLD)


@pytest.mark.parametrize("name", ["fvp_jvp_256", "fvp_jvp_250",
                                  "fvp_ggn_256", "fvp_ggn_250"])
def test_sharded_fvp_matches_reference(group, name):
    outs = _out(group, name)
    for o in outs:   # every rank holds the reduced product
        np.testing.assert_allclose(o["hv"], REFS[name], rtol=2e-4,
                                   atol=1e-5)
    np.testing.assert_array_equal(outs[0]["hv"], outs[1]["hv"])


def test_sharded_fused_fvp_matches_ggn_and_single_rank(group):
    outs = _out(group, "fvp_fused_320")
    a, ref_ggn = CASES["fvp_fused_320"][2], REFS["fvp_fused_320"]
    policy = make_policy((11,), BoxSpec(5), hidden=(32, 48))
    from trpo_torch.ops.flat import flatten_params

    _, unravel = flatten_params(policy.init(torch.Generator().manual_seed(0)))
    params = unravel(torch.from_numpy(a["flat"]))
    single = make_fused_gaussian_mlp_fvp(
        params["net"], torch.from_numpy(a["obs"]),
        torch.from_numpy(a["weight"]), params["log_std"], 0.1)
    want = single.flat(torch.from_numpy(a["v"])).numpy()
    for o in outs:
        assert _rel(o["hv"], ref_ggn) < 1e-5
        assert _rel(o["hv"], want) < 1e-5


def test_sharded_update_matches_reference(group):
    outs = _out(group, "update")
    flat_ref, kl_ref, ok_ref = REFS["update"]
    for o in outs:
        np.testing.assert_allclose(o["flat"], flat_ref, rtol=1e-4, atol=1e-5)
        assert abs(float(o["kl"]) - kl_ref) < 1e-5
        assert bool(o["success"]) == ok_ref


def test_two_rank_update_agrees_bitwise_across_ranks(group):
    # the port's counterpart of tests/test_multihost.py: both controllers
    # hold the same KL to the bit, and the same params
    outs = _out(group, "update")
    assert str(outs[0]["kl_hex"]) == str(outs[1]["kl_hex"])
    np.testing.assert_array_equal(outs[0]["flat"], outs[1]["flat"])


def test_planted_backtrack_leaves_every_rank_at_the_same_trial(group):
    """Each rank reads its own accept predicate, made of all-reduced
    values: both evaluate the reference's trials and no more, and hold
    the same params to the bit."""
    outs = _out(group, "planted_search")
    flat_ref, trials_ref, frac_ref = REFS["planted_search"]
    assert trials_ref > 1
    for o in outs:
        assert int(o["evals"]) == int(o["trials"]) == trials_ref
        assert float(o["fraction"]) == frac_ref
        np.testing.assert_allclose(o["flat"], flat_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(outs[0]["flat"], outs[1]["flat"])


def test_sharded_cg_solve_matches_reference(group):
    for o in _out(group, "solve"):
        np.testing.assert_allclose(o["x"], REFS["solve"], rtol=5e-3,
                                   atol=1e-4)


def test_fused_mode_on_a_mesh_raises_the_reference_error(group):
    for o in _out(group, "fused_mode"):
        assert 'fvp_mode="fused" is unavailable' in str(o["error"])


def test_subsampled_update_on_two_ranks_equals_one_rank(group):
    a = CASES["subsample"][2]
    policy = make_policy((4,), DiscreteSpec(3), hidden=(16,))
    from trpo_torch.ops.flat import flatten_params

    _, unravel = flatten_params(policy.init(torch.Generator().manual_seed(0)))
    T = torch.from_numpy
    batch = trpo.TRPOBatch(T(a["obs"]), T(a["actions"]), T(a["adv"]),
                           {"logits": T(a["d_logits"])}, T(a["weight"]))
    cfg = TRPOConfig(fvp_subsample=0.75, cg_precondition=False)
    new, stats = trpo.make_trpo_update(policy, cfg)(unravel(T(a["flat"])),
                                                    batch)
    want = flatten_params(new)[0].numpy()
    outs = _out(group, "subsample")
    for o in outs:
        np.testing.assert_allclose(o["flat"], want, rtol=1e-4, atol=1e-5)
        assert abs(float(o["kl"]) - float(stats.kl)) < 1e-6
    # the ranks' curvature rows together are the one-rank keep set
    np.testing.assert_array_equal(
        np.concatenate([o["keep"] for o in outs]),
        trpo._fvp_keep_indices(240, 0.75))


def test_make_mesh_validates_on_a_group(group):
    o = _out(group, "mesh_validate")[1]
    assert "needs 4 devices, have 2" in str(o["oversubscribed"])
    assert "covers 1 of 2" in str(o["smaller"])
    assert o["shape"].tolist() == [1, 2] and o["coord"].tolist() == [0, 1]


def test_pad_batch_weights_zero():
    _, _, a = _problem(CAT, 10)
    T = torch.from_numpy
    batch = trpo.TRPOBatch(T(a["obs"]), T(a["actions"]), T(a["adv"]),
                           {"logits": T(a["d_logits"])}, T(a["weight"]))
    padded = pad_batch(batch, 8)
    assert padded.weight.shape[0] == 16 and padded.obs.shape[0] == 16
    assert float(padded.weight.sum()) == 10.0


def test_make_mesh_without_a_launcher_names_torchrun():
    with pytest.raises(ValueError, match="rank mismatch"):
        make_mesh((2, 2), ("data",), device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh((2,), ("data",), device="cpu")
    assert not torch.distributed.is_initialized()


def test_a_rank_that_diverges_raises_instead_of_hanging(group):
    # every collective of the mesh tests has a timeout: a rank left alone
    # in a collective raises once it expires
    o = _out(group, "diverge")[0]
    assert str(o["error"]) and float(o["seconds"]) < 30.0
