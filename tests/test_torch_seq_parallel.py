"""The port's sequence parallelism (``trpo_torch.parallel.seq``) on a gloo
group of four CPU processes, held against ``trpo_tpu.parallel.seq`` on
its 8-device CPU mesh at the reference's tolerances
(``tests/test_seq_parallel.py``): the returns and GAE with the time axis
split over a ``"seq"`` axis of 4, and over a ``("data", "seq")`` mesh of
2 × 2. On CPU tensors the plain scan stands in for K2; each rank runs it
twice per scan.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from torch_mesh_worker import Group, outputs
from trpo_tpu.parallel.seq import seq_sharded_gae as tpu_seq_gae
from trpo_tpu.parallel.seq import seq_sharded_returns as tpu_seq_returns

WORLD = 4


def _traj(T=64, N=4, seed=0, p_done=0.1):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    dones = (rng.random((T, N)) < p_done).astype(np.float32)
    return rewards, dones


def _gae_inputs(T=64, N=4, seed=1):
    rng = np.random.default_rng(seed)
    rewards, dones = _traj(T, N, seed=seed)
    return dict(rewards=rewards, dones=dones,
                terminated=(dones * (rng.random((T, N)) < 0.7)).astype(
                    np.float32),
                values=rng.normal(size=(T, N)).astype(np.float32),
                next_values=rng.normal(size=(T, N)).astype(np.float32))


SEQ = {"shape": [4], "axes": ["seq"]}
DATA_SEQ = {"shape": [2, 2], "axes": ["data", "seq"], "batch_axis": "data"}
CASES = {
    "returns": ("returns", SEQ, 0.97, dict(zip(("rewards", "dones"),
                                              _traj(64, 4)))),
    "returns_long": ("returns", SEQ, 0.999,
                     {"rewards": np.ones((512, 2), np.float32),
                      "dones": np.zeros((512, 2), np.float32)}),
    "gae": ("gae", SEQ, 0.99, _gae_inputs()),
    "returns_2d": ("returns", DATA_SEQ, 0.95,
                   dict(zip(("rewards", "dones"), _traj(32, 8, seed=2)))),
    "gae_2d": ("gae", DATA_SEQ, 0.99, _gae_inputs(32, 8, seed=3)),
}
LAM = 0.95


def _ref_mesh(layout):
    devs = np.asarray(jax.devices()[:8])
    if layout is SEQ:
        return Mesh(devs, ("seq",)), None
    return Mesh(devs.reshape(2, 4), ("data", "seq")), "data"


def _reference(name):
    what, layout, gamma, a = CASES[name]
    mesh, batch_axis = _ref_mesh(layout)
    if what == "returns":
        return {"y": np.asarray(tpu_seq_returns(
            mesh, a["rewards"], a["dones"], gamma, batch_axis=batch_axis))}
    adv, tgt = tpu_seq_gae(mesh, a["rewards"], a["values"], a["next_values"],
                           a["terminated"], a["dones"], gamma, LAM,
                           batch_axis=batch_axis)
    return {"adv": np.asarray(adv), "vtarg": np.asarray(tgt)}


# the agent on a 2 x 2 ("data", "seq") mesh: envs split over data, each
# data group's GAE split over seq (8 steps, 2 blocks)
AGENT = dict(env="cartpole", n_envs=8, batch_timesteps=64, gamma=0.99,
             lam=0.97, cg_iters=4, vf_train_steps=5, policy_hidden=(16,))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import TRPOConfig

    work = tmp_path_factory.mktemp("seq")
    jobs = [{"name": n, "fn": "seq_scan",
             "args": dict(layout, what=what, gamma=gamma, lam=LAM)}
            for n, (what, layout, gamma, _) in CASES.items()]
    jobs.append({"name": "agent_2x2", "fn": "agent_iterations", "args": {
        "cfg": dict(AGENT, mesh_shape=(2, 2), mesh_axes=("data", "seq")),
        "n": 2, "seed": 5}})
    ranks = Group(work, jobs, WORLD, {n: c[3] for n, c in CASES.items()})
    refs = {n: _reference(n) for n in CASES}
    agent = TRPOAgent("cartpole", TRPOConfig(**AGENT), device="cpu")
    refs["agent_2x2"] = agent.run_iterations(agent.init_state(5), 2)
    ranks.wait()
    return work, refs


@pytest.mark.parametrize("name", ["returns", "gae", "returns_2d", "gae_2d"])
def test_seq_sharded_scan_matches_reference(group, name):
    work, refs = group
    outs = outputs(work, name, WORLD)
    for o in outs:   # every rank gets the global result back
        for key, want in refs[name].items():
            np.testing.assert_allclose(o[key], want, atol=1e-4)
        # two scans a rank: the block with its coefficient product, then
        # the rescan with the carry folded in
        assert int(o["scans"]) == 2


def test_seq_sharded_returns_no_dones_long_horizon(group):
    work, refs = group
    for o in outputs(work, "returns_long", WORLD):
        np.testing.assert_allclose(o["y"], refs["returns_long"]["y"],
                                   rtol=1e-5)
        # the first entry saw the far end of the sequence
        assert float(o["y"][0, 0]) > 100.0


def test_agent_on_a_data_by_seq_mesh_matches_one_rank(group):
    from trpo_torch.ops.flat import flatten_params

    work, refs = group
    state, stats = refs["agent_2x2"]
    want = flatten_params(state.policy_params)[0].numpy()
    for o in outputs(work, "agent_2x2", WORLD):
        np.testing.assert_allclose(o["flat"], want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(o["kl"], stats["kl_old_new"].numpy(),
                                   atol=1e-5)
        assert int(o["total_timesteps"]) == state.total_timesteps
