"""The port's agent on a mesh (``cfg.mesh_shape``), one gloo process per
rank on the CPU: a mesh run must equal the one-rank run (placement changes
execution, not math: ``tests/test_agent_mesh.py``, at its tolerances), on
``("data",)`` and on ``("data", "seq")`` — the case the reference xfails
on jax drift runs here. Also the reference's validation errors, the
parameter axes and host envs on a mesh that pass them and ask for their
ranks (``tests/test_torch_tp.py`` runs them), the composed kitchen-sink
runs through a
checkpoint, a mesh checkpoint restored on one rank, ``Population(mesh)``,
and the train CLI under ``torch.distributed.run`` (rank 0 alone writes
rows; a SIGTERM to rank 1 stops both ranks with the requeue code).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from torch_mesh_worker import REPO, Group, outputs
from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig
from trpo_torch.ops.flat import flatten_params
from trpo_torch.population import Population
from trpo_torch.utils.checkpoint import Checkpointer

WORLD = 2


def cfg_with(**kw):
    base = dict(env="cartpole", n_envs=8, batch_timesteps=256, gamma=0.99,
                lam=0.97, vf_train_steps=10)
    base.update(kw)
    return base


COMPOSED = dict(env="pendulum", n_envs=8, batch_timesteps=64, cg_iters=3,
                vf_train_steps=3, policy_hidden=(16,), normalize_obs=True,
                mesh_shape=(1, 2), mesh_axes=("data", "seq"))
ADAPTIVE = dict(env="cartpole", n_envs=8, batch_timesteps=128, cg_iters=3,
                vf_train_steps=3, policy_hidden=(16,), normalize_obs=True,
                adaptive_damping=True, fvp_subsample=0.5, mesh_shape=(2,))
POP = dict(env="cartpole", n_envs=4, batch_timesteps=64, cg_iters=3,
           vf_train_steps=3, policy_hidden=(16,))
# a recurrent policy replays its window as (T, N) columns: the curvature
# subsample thins the env axis, by global column ids on a mesh
RECURRENT = dict(env="cartpole-po", n_envs=8, batch_timesteps=128,
                 cg_iters=3, vf_train_steps=3, policy_hidden=(8,),
                 policy_gru=8, fvp_subsample=0.5, mesh_shape=(2,))


def _jobs(work):
    return [
        {"name": "data", "fn": "agent_iterations",
         "args": {"cfg": cfg_with(mesh_shape=(2,)), "n": 1, "seed": 11}},
        {"name": "data_seq", "fn": "agent_iterations",
         "args": {"cfg": cfg_with(mesh_shape=(1, 2),
                                  mesh_axes=("data", "seq")),
                  "n": 1, "seed": 11}},
        {"name": "composed", "fn": "agent_iterations",
         "args": {"cfg": COMPOSED, "n": 2, "more": 2,
                  "ckpt": str(work / "composed")}},
        {"name": "adaptive", "fn": "agent_iterations",
         "args": {"cfg": ADAPTIVE, "n": 3, "more": 2,
                  "ckpt": str(work / "adaptive")}},
        {"name": "recurrent", "fn": "agent_iterations",
         "args": {"cfg": RECURRENT, "n": 2, "seed": 3}},
        {"name": "population", "fn": "population",
         "args": {"cfg": POP, "seeds": [0, 1, 2, 3]}},
        {"name": "population_bad", "fn": "population",
         "args": {"cfg": POP, "seeds": [0, 1, 2]}},
    ]


def _one_rank(cfg: dict, n: int, seed: int):
    """The same config without a mesh, in this process."""
    cfg = {k: v for k, v in cfg.items() if k not in ("mesh_shape",
                                                      "mesh_axes")}
    agent = TRPOAgent(cfg["env"], TRPOConfig(**cfg), device="cpu")
    return agent, agent.run_iterations(agent.init_state(seed), n)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    work = tmp_path_factory.mktemp("agent_mesh")
    ranks = Group(work, _jobs(work), WORLD)
    one = {name: _one_rank(cfg_with(), 1, 11) for name in ("data",)}
    one["adaptive"] = _one_rank(ADAPTIVE, 3, 0)
    one["recurrent"] = _one_rank(RECURRENT, 2, 3)
    pop_agent = TRPOAgent("cartpole", TRPOConfig(**POP), device="cpu")
    pop = Population(pop_agent, [0, 1, 2, 3])
    one["population"] = (pop, pop.run_iteration())
    ranks.wait()
    return work, one


def _flat(params):
    return flatten_params(params)[0].numpy()


@pytest.mark.parametrize("name", ["data", "data_seq"])
def test_mesh_iteration_matches_one_rank(group, name):
    work, one = group
    _, (s1, st1) = one["data"]
    outs = outputs(work, name, WORLD)
    for o in outs:
        np.testing.assert_allclose(o["flat"], _flat(s1.policy_params),
                                   rtol=1e-4, atol=1e-5)
        assert abs(float(o["kl"][0]) - float(st1["kl_old_new"][0])) < 1e-5
        assert int(o["episodes"][0]) == int(st1["episodes_in_batch"][0])
        assert int(o["total_timesteps"]) == s1.total_timesteps
    # the ranks agree to the bit
    np.testing.assert_array_equal(outs[0]["flat"], outs[1]["flat"])
    carry = np.concatenate([o["carry_obs"] for o in outs])
    if name == "data":   # the carry is split over the data axis
        assert outs[0]["carry_obs"].shape[0] == 4
        np.testing.assert_allclose(carry, s1.env_carry[1].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_everything_composed(group):
    """data×seq mesh + obs normalization + checkpoint/resume through the
    mesh checkpointer, continuing bit-close."""
    work, _ = group
    for o in outputs(work, "composed", WORLD):
        assert np.all(np.isfinite(o["entropy"]))
        assert float(o["obs_norm_count"]) == 128.0
        np.testing.assert_allclose(o["entropy_cont"], o["entropy_resumed"],
                                   rtol=1e-5)
        assert int(o["iteration_resumed"]) == 4


def test_everything_composed_adaptive(group):
    """mesh + adaptive damping + curvature subsampling + obs normalization:
    the λ scalar and the statistics survive the checkpoint and keep
    adapting, and the run equals the one-rank run."""
    work, one = group
    _, (s1, st1) = one["adaptive"]
    for o in outputs(work, "adaptive", WORLD):
        assert np.all(np.isfinite(o["entropy"]))
        lam = float(o["cg_damping"])
        assert 1e-3 <= lam <= 10.0 and o["kl"].shape == (3,)
        assert float(o["restored_damping"]) == lam
        assert float(o["damping_resumed"]) != lam
        np.testing.assert_allclose(o["flat"], _flat(s1.policy_params),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(lam, float(s1.cg_damping), rtol=1e-5)


def test_recurrent_mesh_run_matches_one_rank(group):
    work, one = group
    _, (s1, st1) = one["recurrent"]
    for o in outputs(work, "recurrent", WORLD):
        np.testing.assert_allclose(o["flat"], _flat(s1.policy_params),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(o["kl"], st1["kl_old_new"].numpy(),
                                   atol=1e-5)


def test_mesh_checkpoint_restores_on_one_rank(group):
    work, _ = group
    outs = outputs(work, "adaptive", WORLD)
    cfg = {k: v for k, v in ADAPTIVE.items() if k != "mesh_shape"}
    agent = TRPOAgent("cartpole", TRPOConfig(**cfg), device="cpu")
    ck = Checkpointer(str(work / "adaptive"))
    assert ck.latest_step() == 3
    state = ck.restore(agent.init_state(0))
    np.testing.assert_array_equal(_flat(state.policy_params), outs[0]["flat"])
    # the carry was gathered: rank 0's envs, then rank 1's
    np.testing.assert_array_equal(
        state.env_carry[1].numpy(),
        np.concatenate([o["carry_obs"] for o in outs]))
    state, stats = agent.run_iteration(state)
    assert state.iteration == 4 and np.isfinite(float(stats["entropy"]))


def test_population_on_a_mesh_equals_the_meshless_population(group):
    work, one = group
    pop, stats = one["population"]
    outs = outputs(work, "population", WORLD)
    for r, o in enumerate(outs):
        # every rank holds every member's stats
        np.testing.assert_array_equal(
            o["reward"], stats["mean_episode_reward"].numpy())
        assert int(o["best"]) == pop.best_member(stats)
        for i in (2 * r, 2 * r + 1):
            np.testing.assert_array_equal(
                o[f"member{i}"], _flat(pop.member_state(i).policy_params))


def test_population_validates_divisibility(group):
    work, _ = group
    for o in outputs(work, "population_bad", WORLD):
        assert "must divide evenly over the data=2 mesh axis" in str(
            o["error"])


@pytest.mark.parametrize("kw, error, match", [
    (cfg_with(n_envs=6, mesh_shape=(4,)), ValueError, "divide evenly"),
    (cfg_with(batch_timesteps=56, mesh_shape=(4, 2),
              mesh_axes=("data", "seq")), ValueError, "seq"),
    (cfg_with(mesh_shape=(2, 4), mesh_axes=("seq", "data")), ValueError,
     "batch/env axis"),
    # parameter axes and host envs on a mesh run now: a valid config passes
    # the validation and asks for its ranks (UnlaunchedMeshError, a
    # RuntimeError naming torchrun); an invalid one raises the reference's
    # ValueError
    (cfg_with(mesh_shape=(2, 2), mesh_axes=("data", "model")),
     RuntimeError, "torchrun"),
    (cfg_with(mesh_shape=(2, 2), mesh_axes=("data", "expert")),
     ValueError, "needs an MoE policy"),
    (cfg_with(mesh_shape=(2, 2, 2), mesh_axes=("data", "model", "expert")),
     ValueError, "do not compose"),
    (cfg_with(env="native:cartpole", mesh_shape=(2,)), RuntimeError,
     "torchrun"),
    (cfg_with(env="gym:CartPole-v1", mesh_shape=(2,)), RuntimeError,
     "torchrun"),
])
def test_mesh_validation_errors(kw, error, match):
    # each is raised before any process group exists
    with pytest.raises(error, match=match):
        TRPOAgent(kw["env"], TRPOConfig(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in kw.items()}), device="cpu")
    assert not torch.distributed.is_initialized()


def _cli(argv, env=None, **kw):
    return subprocess.run([sys.executable] + argv, cwd=REPO,
                          capture_output=True, text=True,
                          env=dict(os.environ, **(env or {})), **kw)


TINY = ["-m", "trpo_torch.train", "--preset", "cartpole", "--device", "cpu",
        "--batch-timesteps", "256", "--cg-iters", "3"]


@pytest.mark.slow
def test_train_cli_on_two_ranks(tmp_path):
    rows = tmp_path / "rows.jsonl"
    p = _cli(["-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", "2"] + TINY + [
        "--iterations", "2", "--mesh-shape", "2", "--log-jsonl", str(rows)],
        timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    lines = [json.loads(x) for x in rows.read_text().splitlines()]
    assert [r["iteration"] for r in lines] == [1, 2]   # rank 0 alone
    assert p.stdout.count("iter 2 ") == 1
    assert lines[-1]["timesteps_total"] == 512


def test_train_cli_mesh_without_a_launcher_exits_2():
    p = _cli(TINY + ["--iterations", "1", "--mesh-shape", "2"], timeout=120)
    assert p.returncode == 2 and "torchrun" in p.stderr


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_sigterm_to_one_rank_stops_every_rank(tmp_path):
    rows, ck = tmp_path / "rows.jsonl", tmp_path / "ck"
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable] + TINY + [
            "--iterations", "200", "--mesh-shape", "2", "--log-jsonl",
            str(rows), "--checkpoint-dir", str(ck), "--checkpoint-every",
            "100"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                            WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=port)) for r in range(2)]
    try:
        deadline = time.time() + 120
        while time.time() < deadline and (
                not rows.exists() or len(rows.read_text().splitlines()) < 2):
            assert all(p.poll() is None for p in procs)
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [75, 75], outs
    n = len(rows.read_text().splitlines())
    assert 2 <= n < 200
    # the final checkpoint is the last logged iteration, on both ranks
    assert Checkpointer(str(ck)).latest_step() == n
