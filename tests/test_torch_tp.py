"""The port's parameter sharding (``trpo_torch.parallel.tp``, the tree
update ``trpo.make_tree_trpo_update``, the agent on a ``"model"`` or
``"expert"`` axis, host envs on a mesh) on gloo groups of CPU processes.

The reference gets its sharded update from GSPMD, and its own parity tests
for it do not run on this image (``tests/test_tree_update.py``,
``tests/test_moe.py``, ``tests/test_recurrent.py``): the port writes the
Megatron collectives itself, so each case holds its sharded update to the
reference's SINGLE-DEVICE update on the same seeded numpy inputs, at the
reference's tolerances (params rtol 2e-4 / atol 2e-5, KL rtol 1e-3), and
its agent runs to the port's one-rank run (the mesh tolerance, rtol 1e-4 /
atol 1e-5). One group of four ranks serves the file
(``torch_mesh_worker.Group``); the 2×2×2 ``data,seq,model`` case has a
group of eight of its own.
"""

import io

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
from trpo_tpu.models.moe import make_moe_policy as tpu_make_moe
from trpo_tpu.ops import conjugate_gradient as tpu_cg
from trpo_tpu.ops import flatten_params as tpu_flatten
from trpo_tpu.ops.treemath import tree_vdot as tpu_tree_vdot
from trpo_tpu.parallel import make_mesh as tpu_make_mesh
from trpo_tpu.parallel import policy_param_shardings as tpu_shardings
from trpo_tpu.trpo import TRPOBatch as TpuBatch
from trpo_tpu.trpo import make_trpo_update as tpu_update
from trpo_torch import trpo
from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig
from trpo_torch.models.moe import make_moe_policy
from trpo_torch.models.policy import BoxSpec, DiscreteSpec, make_policy
from trpo_torch.models.recurrent import make_recurrent_policy
from trpo_torch.ops.flat import flatten_params
from trpo_torch.ops.linesearch import backtracking_linesearch
from trpo_torch.ops.treemath import tree_norm, tree_vdot
from trpo_torch.parallel.tp import policy_param_shardings
from trpo_torch.utils.checkpoint import Checkpointer
from trpo_torch.utils.metrics import StatsLogger

WORLD = 4
TP = dict(shape=[2, 2], axes=["data", "model"])
EP = dict(shape=[2, 2], axes=["data", "expert"])
CAT = {"obs_dim": 6, "act": ["discrete", 3], "hidden": [32, 32]}
GAUSS = {"obs_dim": 6, "act": ["box", 2], "hidden": [32, 32]}
GAUSS3 = {"obs_dim": 6, "act": ["box", 3], "hidden": [32, 32]}
MOE = {"obs_dim": 6, "act": ["discrete", 2], "hidden": [16], "experts": 4}
UPDATE_CFG = {"cg_iters": 8}
# updates held to the reference's single-device update
REF_CASES = {"update_cat": CAT, "update_gauss": GAUSS, "update_expert": MOE}
# solver paths held to the port's one-rank update (their probes and
# preconditioners are the port's own draws, not the reference's)
SOLVER_CASES = {
    "jacobi": (GAUSS, {"cg_iters": 8, "cg_precondition": "jacobi"}),
    # a whole head (3 outputs), and one split by its output columns
    "head_block": (GAUSS3, {"cg_iters": 8,
                            "cg_precondition": "head_block"}),
    "head_block_split": (GAUSS, {"cg_iters": 8,
                                 "cg_precondition": "head_block"}),
    "jvp_grad": (CAT, {"cg_iters": 8, "fvp_mode": "jvp_grad"}),
}
# agent runs: (config, iterations, seed)
AGENT_CASES = {
    "agent_model": (dict(env="cartpole", n_envs=8, batch_timesteps=256,
                         policy_hidden=(32, 32), vf_train_steps=10,
                         mesh_shape=(2, 2), mesh_axes=("data", "model")),
                    1, 11),
    "agent_expert": (dict(env="cartpole", n_envs=8, batch_timesteps=128,
                          cg_iters=3, vf_train_steps=3, policy_hidden=(16,),
                          policy_experts=2, mesh_shape=(2, 2),
                          mesh_axes=("data", "expert")), 1, 0),
    "agent_gru": (dict(env="cartpole-po", n_envs=8, batch_timesteps=64,
                       cg_iters=3, vf_train_steps=3, policy_hidden=(8,),
                       policy_gru=8, mesh_shape=(2, 2),
                       mesh_axes=("data", "model")), 1, 3),
    # a torso ending row-parallel: the gates' input projection takes its
    # block of the whole features
    "agent_lstm": (dict(env="cartpole-po", n_envs=8, batch_timesteps=64,
                        cg_iters=3, vf_train_steps=3, policy_hidden=(16, 8),
                        policy_gru=8, policy_cell="lstm", mesh_shape=(2, 2),
                        mesh_axes=("data", "model")), 1, 3),
    # a host env on two data ranks (each also split over "model"), with
    # the observation statistics folded over both ranks' rows
    "agent_host": (dict(env="native:pendulum", n_envs=8, batch_timesteps=64,
                        cg_iters=3, vf_train_steps=3, policy_hidden=(16, 16),
                        normalize_obs=True, mesh_shape=(2, 2),
                        mesh_axes=("data", "model")), 2, 0),
}
CKPT = dict(env="cartpole", n_envs=8, batch_timesteps=128, cg_iters=3,
            vf_train_steps=3, policy_hidden=(32, 32))
# learn on four data ranks of a worker pool: the async host driver, two
# pipeline groups a rank, the statistics folded over every rank's rows;
# then one rank's worker killed
HOST_LEARN = dict(env="gymproc:Pendulum-v1", n_envs=8, batch_timesteps=64,
                  cg_iters=3, vf_train_steps=3, policy_hidden=(16, 16),
                  normalize_obs=True, host_pipeline_groups=8,
                  host_async_pipeline=True, worker_backoff=0.0,
                  mesh_shape=(4,), mesh_axes=("data",))


def _tpu_policy(spec):
    kind, k = spec["act"]
    act = TpuDiscrete(k) if kind == "discrete" else TpuBox(k)
    if spec.get("experts"):
        return tpu_make_moe((spec["obs_dim"],), act,
                            hidden=tuple(spec["hidden"]),
                            n_experts=spec["experts"])
    return tpu_make_policy((spec["obs_dim"],), act,
                           hidden=tuple(spec["hidden"]))


def _port_policy(spec):
    kind, k = spec["act"]
    act = DiscreteSpec(k) if kind == "discrete" else BoxSpec(k)
    if spec.get("experts"):
        return make_moe_policy((spec["obs_dim"],), act,
                               hidden=tuple(spec["hidden"]),
                               n_experts=spec["experts"])
    return make_policy((spec["obs_dim"],), act, hidden=tuple(spec["hidden"]))


def _problem(spec, n=256, seed=0, reference=True):
    """Params (flat, ravel order; drawn by the port's init, which the two
    packages share the layout of), obs, actions, advantages and the old
    dist from the reference's policy (the port's with
    ``reference=False``) on numpy draws."""
    kind, k = spec["act"]
    rng = np.random.default_rng(seed + 1)
    obs = rng.normal(size=(n, spec["obs_dim"])).astype(np.float32)
    params = _port_policy(spec).init(torch.Generator().manual_seed(seed))
    flat = flatten_params(params)[0].numpy()
    if reference:
        policy = _tpu_policy(spec)
        params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                        params)
        dist = {key: np.asarray(v) for key, v in jax.jit(policy.apply)(
            params, jnp.asarray(obs)).items()}
    else:
        policy = _port_policy(spec)
        with torch.no_grad():
            dist = {key: v.numpy() for key, v in policy.apply(
                params, torch.from_numpy(obs)).items()}
    if kind == "discrete":
        actions = rng.integers(0, k, n).astype(np.int64)
    else:
        actions = (dist["mean"] + np.exp(dist["log_std"])
                   * rng.normal(size=(n, k))).astype(np.float32)
    adv = rng.normal(size=n).astype(np.float32)
    adv = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(np.float32)
    inp = {"flat": flat, "obs": obs,
           "actions": actions, "adv": adv,
           "weight": np.ones(n, np.float32)}
    inp.update({"d_" + key: v for key, v in dist.items()})
    return policy, params, inp


def _port_batch(inp):
    T = lambda k: torch.from_numpy(np.asarray(inp[k]))  # noqa: E731
    return trpo.TRPOBatch(T("obs"), T("actions"), T("adv"),
                          {k[2:]: T(k) for k in inp if k.startswith("d_")},
                          T("weight"))


def _port_one_rank(spec, cfg, inp):
    policy = _port_policy(spec)
    _, unravel = flatten_params(policy.init(torch.Generator().manual_seed(0)))
    params = unravel(torch.from_numpy(inp["flat"]).clone())
    new, stats = trpo.make_trpo_update(policy, TRPOConfig(**cfg),
                                       allow_fused=False)(
        params, _port_batch(inp))
    return flatten_params(new)[0].numpy(), stats


def _reference(policy, params, inp, cfg):
    batch = TpuBatch(jnp.asarray(inp["obs"]), jnp.asarray(inp["actions"]),
                     jnp.asarray(inp["adv"]),
                     {k[2:]: jnp.asarray(v) for k, v in inp.items()
                      if k.startswith("d_")}, jnp.asarray(inp["weight"]))
    new, stats = jax.jit(tpu_update(policy, TpuConfig(**cfg)))(params, batch)
    return np.asarray(tpu_flatten(new)[0]), stats


def _one_rank_agent(cfg, n, seed):
    cfg = {k: v for k, v in cfg.items() if k not in ("mesh_shape",
                                                     "mesh_axes")}
    agent = TRPOAgent(cfg["env"], TRPOConfig(**cfg), device="cpu")
    return agent.run_iterations(agent.init_state(seed), n)


def _one_rank_learn(cfg, n):
    cfg = {k: v for k, v in cfg.items() if k not in ("mesh_shape",
                                                     "mesh_axes")}
    agent = TRPOAgent(cfg["env"], TRPOConfig(**cfg), device="cpu")
    try:
        return agent.learn(n_iterations=n,
                           logger=StatsLogger(stream=io.StringIO()))
    finally:
        agent.env.close()


def _jobs(work):
    jobs = [{"name": name, "fn": "tp_update",
             "args": dict(TP, axis="model", policy=REF_CASES[name],
                          cfg=UPDATE_CFG)}
            for name in ("update_cat", "update_gauss")]
    jobs.append({"name": "update_expert", "fn": "tp_update",
                 "args": dict(EP, axis="expert", policy=MOE,
                              cfg=UPDATE_CFG)})
    jobs += [{"name": name, "fn": "tp_update",
              "args": dict(TP, axis="model", policy=spec, cfg=cfg)}
             for name, (spec, cfg) in SOLVER_CASES.items()]
    jobs.append({"name": "cg", "fn": "tp_cg",
                 "args": dict(TP, iters=24)})
    jobs += [{"name": name, "fn": "agent_iterations",
              "args": {"cfg": cfg, "n": n, "seed": seed}}
             for name, (cfg, n, seed) in AGENT_CASES.items()]
    jobs.append({"name": "unshardable", "fn": "agent_iterations",
                 "args": {"cfg": dict(CKPT, policy_hidden=(10, 10),
                                      mesh_shape=(1, 4),
                                      mesh_axes=("data", "model")),
                          "n": 1}})
    jobs.append({"name": "ckpt_save", "fn": "agent_iterations",
                 "args": {"cfg": dict(CKPT, mesh_shape=(2, 2),
                                      mesh_axes=("data", "model")),
                          "n": 1, "ckpt": str(work / "tp_ck")}})
    jobs.append({"name": "peer_desync", "fn": "peer_desync",
                 "args": {"cfg": AGENT_CASES["agent_host"][0], "n": 1,
                          "part_ranks": [1]}})
    jobs.append({"name": "host_learn", "fn": "host_learn",
                 "args": {"cfg": HOST_LEARN, "n": 2, "more": 2,
                          "fault_rank": 1}})
    jobs.append({"name": "ckpt_restore", "fn": "agent_iterations",
                 "args": {"cfg": dict(CKPT, mesh_shape=(2, 2),
                                      mesh_axes=("data", "model")),
                          "n": 1, "restore": str(work / "one_ck")}})
    return jobs


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    # a one-rank checkpoint for the data×model restore, written first
    one_agent = TRPOAgent("cartpole", TRPOConfig(**CKPT), device="cpu")
    one_state, _ = one_agent.run_iterations(one_agent.init_state(5), 1)
    Checkpointer(str(work / "one_ck")).save(1, one_state)
    problems = {name: _problem(spec, seed=i, reference=name in REF_CASES)
                for i, (name, spec) in enumerate(
                    (*REF_CASES.items(),
                     *((n, s) for n, (s, _) in SOLVER_CASES.items())))}
    rng = np.random.default_rng(7)
    a = rng.normal(size=(38, 38)).astype(np.float32)
    cg_in = {"A": (a @ a.T / 38 + np.eye(38)).astype(np.float32),
             "b": rng.normal(size=38).astype(np.float32)}
    inputs = {name: p[2] for name, p in problems.items()}
    inputs["cg"] = cg_in
    ranks = Group(work, _jobs(work), WORLD, inputs)
    ref = {}
    for name, (policy, params, inp) in problems.items():
        if name in SOLVER_CASES:
            spec, cfg = SOLVER_CASES[name]
            ref[name] = _port_one_rank(spec, cfg, inp)
        else:
            ref[name] = _reference(policy, params, inp, UPDATE_CFG)
            ref[name + "_port"] = _port_one_rank(REF_CASES[name], UPDATE_CFG,
                                                 inp)
    for name, (cfg, n, seed) in AGENT_CASES.items():
        ref[name] = _one_rank_agent(cfg, n, seed)
    ref["host_learn"] = _one_rank_learn(HOST_LEARN, 2)
    ref["one_state"] = one_state
    ref["cg_in"] = cg_in
    log = ranks.wait()
    return work, ref, log


def _flat(params):
    return flatten_params(params)[0].numpy()


def test_tree_vdot_matches_flat_dot():
    t1 = {"a": torch.arange(6.0).reshape(2, 3),
          "b": torch.tensor([1.0, -2.0], dtype=torch.bfloat16)}
    t2 = {"a": torch.ones(2, 3), "b": torch.tensor([0.5, 4.0])}
    flat = lambda t: torch.cat([t["a"].reshape(-1),  # noqa: E731
                                t["b"].float()])
    got = tree_vdot(t1, t2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(flat(t1) @ flat(t2)))
    ref = tpu_tree_vdot({k: jnp.asarray(v.float().numpy())
                         for k, v in t1.items()},
                        {k: jnp.asarray(v.numpy()) for k, v in t2.items()})
    np.testing.assert_allclose(float(got), float(ref))
    np.testing.assert_allclose(float(tree_norm(t2)),
                               float(torch.linalg.vector_norm(flat(t2))))


@pytest.mark.parametrize("name", ["tree_f32", "tree_zeros_like",
                                  "tree_scale", "tree_sub",
                                  "tree_add_scaled"])
def test_tree_helpers_match_the_reference(name):
    import trpo_tpu.ops.treemath as ref_tm
    import trpo_torch.ops.treemath as port_tm

    rng = np.random.default_rng(3)
    a = {"w": rng.normal(size=(3, 4)).astype(np.float32),
         "b": [rng.normal(size=5).astype(np.float32)]}
    b = jax.tree_util.tree_map(lambda x: x * 2.0 - 1.0, a)
    args = {"tree_f32": (a,), "tree_zeros_like": (a,),
            "tree_scale": (0.5, a), "tree_sub": (a, b),
            "tree_add_scaled": (a, -0.25, b)}[name]
    to_port = lambda x: (jax.tree_util.tree_map(torch.from_numpy, x)  # noqa
                         if isinstance(x, dict) else x)
    to_ref = lambda x: (jax.tree_util.tree_map(jnp.asarray, x)  # noqa
                        if isinstance(x, dict) else x)
    got = getattr(port_tm, name)(*map(to_port, args))
    want = getattr(ref_tm, name)(*map(to_ref, args))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_tree_cg_matches_flat_cg(group):
    work, ref, _ = group
    A, b = ref["cg_in"]["A"], ref["cg_in"]["b"]
    want = np.asarray(tpu_cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                             cg_iters=24).x)
    for o in outputs(work, "cg", WORLD):
        np.testing.assert_allclose(o["x"], want, rtol=1e-4, atol=1e-5)
        # the inner product counts the replicated entries once
        np.testing.assert_allclose(float(o["dot"]), float(b @ b), rtol=1e-6)


def _tpu_specs(params, mesh, axis):
    """The reference's shardings as this package's split dims."""
    def dim(s):
        spec = tuple(s.spec)
        return spec.index(axis) if axis in spec else None
    return jax.tree_util.tree_map(dim, tpu_shardings(params, mesh, axis))


@pytest.mark.parametrize("family", ["mlp", "mlp_wide_head", "gru", "lstm",
                                    "moe"])
def test_shardings_match_the_reference(family):
    axis = "expert" if family == "moe" else "model"
    mesh = tpu_make_mesh((2, 4), ("data", axis))
    if family in ("gru", "lstm"):
        policy = make_recurrent_policy((6,), DiscreteSpec(2), hidden=(32, 16),
                                       gru_size=8, cell=family)
    elif family == "moe":
        policy = _port_policy({**MOE, "experts": 8})
    else:
        out = 4 if family == "mlp_wide_head" else 17
        policy = make_policy((12,), BoxSpec(out), hidden=(32, 32))
    # the port's init: both packages share the params' layout
    params = policy.init(torch.Generator().manual_seed(0))
    want = _tpu_specs(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), params), mesh, axis)

    class _Mesh:
        shape = {axis: 4}

    got = policy_param_shardings(params, _Mesh(), axis)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda x: x, want))
    assert jax.tree_util.tree_leaves(got, is_leaf=lambda x: x is None) == \
        jax.tree_util.tree_leaves(want, is_leaf=lambda x: x is None)
    if family.startswith("mlp"):
        layers = got["net"]["layers"]
        assert (layers[0]["w"], layers[0]["b"]) == (1, 0)   # column
        assert (layers[1]["w"], layers[1]["b"]) == (0, None)  # row
        # 17 does not divide the axis: the head stays whole; 4 does
        assert layers[2]["w"] == (1 if family == "mlp_wide_head" else None)
        assert got["log_std"] is None


@pytest.mark.parametrize("name", ["update_cat", "update_gauss",
                                  "update_expert"])
def test_sharded_update_matches_single_device(group, name):
    work, ref, _ = group
    want, s_ref = ref[name]
    port_one, s_port = ref[name + "_port"]
    outs = outputs(work, name, WORLD)
    for o in outs:
        np.testing.assert_allclose(o["flat"], want, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(float(o["kl"]), float(s_ref.kl),
                                   rtol=1e-3, atol=1e-6)
        assert bool(o["success"]) == bool(s_ref.linesearch_success)
        np.testing.assert_allclose(float(o["step_fraction"]),
                                   float(s_ref.step_fraction))
        np.testing.assert_allclose(o["flat"], port_one, rtol=1e-4, atol=1e-5)
        # grad and step norms count the replicated leaves once
        np.testing.assert_allclose(float(o["grad_norm"]),
                                   float(s_port.grad_norm), rtol=1e-4)
        np.testing.assert_allclose(float(o["step_norm"]),
                                   float(s_port.step_norm), rtol=1e-4)
        # the leaves stayed split: each rank holds less than the whole
        assert o["local_flat"].size < o["flat"].size
    # ranks of one model coordinate agree to the bit; the two blocks differ
    np.testing.assert_array_equal(outs[0]["flat"], outs[2]["flat"])
    assert not np.array_equal(outs[0]["local_flat"], outs[1]["local_flat"])
    if name == "update_expert":   # 2 of the 4 experts on each rank
        assert int(outs[0]["first_shape"][0]) == 2


@pytest.mark.parametrize("name", sorted(SOLVER_CASES))
def test_sharded_solver_paths_match_one_rank(group, name):
    work, ref, _ = group
    want, s_one = ref[name]
    for o in outputs(work, name, WORLD):
        np.testing.assert_allclose(o["flat"], want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(o["kl"]), float(s_one.kl),
                                   rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("name", sorted(AGENT_CASES))
def test_agent_on_a_parameter_axis_matches_one_rank(group, name):
    work, ref, _ = group
    s1, st1 = ref[name]
    want = _flat(s1.policy_params)
    for o in outputs(work, name, WORLD):
        np.testing.assert_allclose(o["flat"], want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(o["kl"], st1["kl_old_new"].numpy(),
                                   rtol=1e-3, atol=1e-6)
        np.testing.assert_array_equal(o["episodes"],
                                      st1["episodes_in_batch"].numpy())
        assert int(o["total_timesteps"]) == s1.total_timesteps
        assert o["init_local_flat"].size < want.size
    if name == "agent_host":
        # the host envs' statistics folded every rank's rows
        assert s1.obs_norm is not None


def test_host_env_mesh_learns_as_one_rank_and_outlives_one_ranks_fault(
        group):
    work, ref, _ = group
    one = ref["host_learn"]
    outs = outputs(work, "host_learn", WORLD)
    n_envs, steps = HOST_LEARN["n_envs"], HOST_LEARN["batch_timesteps"] // 8
    for o in outs:
        # the async driver with two pipeline groups a rank, against one
        # rank's eight groups: the statistics merged in its group order
        np.testing.assert_allclose(o["flat"], _flat(one.policy_params),
                                   rtol=1e-4, atol=1e-5)
        assert int(o["iteration"]) == one.iteration == 2
        np.testing.assert_array_equal(o["obs_norm_count"],
                                      one.obs_norm.count.numpy())
        np.testing.assert_allclose(o["obs_norm_mean"],
                                   one.obs_norm.mean.numpy(), rtol=1e-6)
        np.testing.assert_allclose(o["obs_norm_m2"], one.obs_norm.m2.numpy(),
                                   rtol=1e-6)
        # rank 1's worker restarted: every rank went on folding at the
        # same points (the reset rows are normalized, not folded), so the
        # statistics and the params stay one across the ranks
        assert int(o["fault_iteration"]) == 4
        assert float(o["fault_obs_norm_count"]) == n_envs * (1 + 4 * steps)
        for key in ("fault_flat", "fault_obs_norm_mean",
                    "fault_obs_norm_m2"):
            np.testing.assert_array_equal(o[key], outs[0][key])
    assert [int(o["restarts"]) for o in outs] == [0, 1, 0, 0]


def test_host_env_model_peers_that_part_are_refused(group):
    work, _, _ = group
    # rank 1 alone moved: every rank raises at the window's end, none is
    # left in a collective
    for o in outputs(work, "peer_desync", WORLD):
        assert "no longer agree" in str(o["error"])


def test_unshardable_policy_is_refused(group):
    work, _, _ = group
    for o in outputs(work, "unshardable", WORLD):
        assert "shards nothing" in str(o["error"])
        assert "hidden=(10, 10)" in str(o["error"])


def test_model_sharded_checkpoint_restores_both_ways(group):
    work, ref, _ = group
    saved = outputs(work, "ckpt_save", WORLD)
    # data×model → one rank: the file is what a one-rank run writes
    agent = TRPOAgent("cartpole", TRPOConfig(**CKPT), device="cpu")
    state = Checkpointer(str(work / "tp_ck")).restore(agent.init_state(0))
    np.testing.assert_array_equal(_flat(state.policy_params),
                                  saved[0]["flat"])
    for o in saved:
        assert "param_layout=agent.param_layout" in str(o["no_layout_error"])
        assert bool(o["restored_local_equal"])
        np.testing.assert_array_equal(o["restored_flat"], o["flat"])
    # one rank → data×model: every rank re-shards the whole params
    want = _flat(ref["one_state"].policy_params)
    restored = outputs(work, "ckpt_restore", WORLD)
    for o in restored:
        np.testing.assert_array_equal(o["flat"], want)
        assert o["local_flat"].size < want.size
    assert not np.array_equal(restored[0]["local_flat"],
                              restored[1]["local_flat"])


def test_linesearch_preserves_bf16_dtype():
    x = torch.ones(8, dtype=torch.bfloat16)
    step = -torch.ones(8, dtype=torch.bfloat16)
    res = backtracking_linesearch(lambda v: torch.sum(v.float() ** 2), x,
                                  step, torch.tensor(16.0))
    assert res.x.dtype == torch.bfloat16
    assert bool(res.success)


SEQ_TP = dict(env="cartpole", n_envs=8, batch_timesteps=256,
              policy_hidden=(32, 32), vf_train_steps=10, mesh_shape=(2, 2, 2),
              mesh_axes=("data", "seq", "model"))


@pytest.mark.slow   # eight processes: ≈ 10 s on its own
def test_data_seq_model_mesh_stays_sharded_and_matches_one_rank(tmp_path):
    ranks = Group(tmp_path, [{"name": "dsm", "fn": "agent_iterations",
                              "args": {"cfg": SEQ_TP, "n": 1, "seed": 11}}],
                  8)
    s1, st1 = _one_rank_agent(SEQ_TP, 1, 11)
    ranks.wait()
    want = _flat(s1.policy_params)
    outs = outputs(tmp_path, "dsm", 8)
    for o in outs:
        np.testing.assert_allclose(o["flat"], want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(o["kl"], st1["kl_old_new"].numpy(),
                                   rtol=1e-3, atol=1e-6)
        assert o["init_local_flat"].size < want.size
