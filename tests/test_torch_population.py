"""The port's ``Population`` on the CPU, case by case against the
reference's ``tests/test_population.py``, and the GAE-λ axis held against
``trpo_tpu``:

- members differ after one iteration, and member *i* is bitwise equal to
  a solo run of seed *i* (the reference pins rtol 1e-4 / atol 1e-5: its
  members run under ``vmap`` on the XLA GGN, the port's in lockstep on
  the agent's own iteration);
- ``run_iterations(n)`` equals n ``run_iteration`` calls;
- recurrent members and adaptive damping run;
- a member's λ equal to ``cfg.lam`` is the plain run bit for bit, another
  λ changes it, and one update at that λ matches the reference's within
  the per-family update tolerance (1e-4, PERF.md §2);
- ``member_scores``/``best_member`` equal the reference's on the same
  numpy stats;
- the inputs the reference refuses are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trpo_tpu.agent import TRPOAgent as TpuAgent
from trpo_tpu.config import TRPOConfig as TpuConfig
from trpo_tpu.ops import flatten_params as tpu_flatten
from trpo_tpu.population import Population as TpuPopulation
from trpo_tpu.rollout import device_rollout as tpu_rollout
from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig
from trpo_torch.convert import (
    policy_params_from_numpy,
    trajectory_from_numpy,
    vf_state_from_numpy,
)
from trpo_torch.ops.flat import flatten_params
from trpo_torch.population import Population

from test_torch_checkpoint import assert_equal, assert_state_equal

# the reference's population agent (tests/test_population.py:_agent)
BASE = dict(env="cartpole", n_envs=4, batch_timesteps=64, cg_iters=4,
            vf_train_steps=5, policy_hidden=(16,))
UPDATE_TOL = 1e-4


def _agent(**kw):
    base = {**BASE, **kw}
    return TRPOAgent(base["env"], TRPOConfig(**base), device="cpu")


def _flat(state):
    return flatten_params(state.policy_params)[0]


def test_population_runs_and_members_differ():
    pop = Population(_agent(), seeds=[0, 1, 2, 3])
    assert pop.size == 4
    stats = pop.run_iteration()
    assert stats["entropy"].shape == (4,)
    assert pop.member_state(0).iteration == 1
    assert not torch.allclose(_flat(pop.member_state(0)),
                              _flat(pop.member_state(1)))


def test_population_member_is_bitwise_a_solo_run():
    agent = _agent()
    pop = Population(agent, seeds=[3, 5])
    pop.run(2)
    solo = agent.init_state(5)
    for _ in range(2):
        solo, _ = agent.run_iteration(solo)
    assert_state_equal(pop.member_state(1), solo)


def test_population_run_iterations_equals_stepping():
    pop_a = Population(_agent(), seeds=[2, 7])
    pop_b = Population(_agent(), seeds=[2, 7])
    fused = pop_a.run_iterations(3)
    steps = [pop_b.run_iteration() for _ in range(3)]
    assert fused["entropy"].shape == (2, 3)
    for k in fused:
        for j in range(3):
            assert_equal(fused[k][:, j], steps[j][k])
    for i in range(2):
        assert_state_equal(pop_a.member_state(i), pop_b.member_state(i))
    with pytest.raises(ValueError, match=">= 1"):
        pop_a.run_iterations(0)


def test_population_of_recurrent_agents():
    pop = Population(_agent(env="cartpole-po", policy_gru=8),
                     seeds=[0, 1, 2, 3])
    pop.run_iteration()
    stats = pop.run_iteration()
    assert stats["entropy"].shape == (4,)
    assert torch.isfinite(stats["entropy"]).all()
    assert not torch.allclose(_flat(pop.member_state(0)),
                              _flat(pop.member_state(1)))


def test_population_with_adaptive_damping():
    agent = _agent(cg_iters=3, vf_train_steps=3, adaptive_damping=True)
    pop = Population(agent, seeds=[0, 1, 2])
    stats = pop.run_iteration()
    assert stats["cg_damping"].shape == (3,)
    for i in range(3):
        lam = float(pop.member_state(i).cg_damping)
        assert agent.cfg.damping_min <= lam <= agent.cfg.damping_max


def test_population_lam_axis():
    agent = _agent()
    plain = Population(agent, seeds=[0, 1])
    swept = Population(agent, seeds=[0, 1], lam=[agent.cfg.lam, 0.5])
    s_plain = plain.run_iterations(3)
    s_swept = swept.run_iterations(3)
    # member 0 carries cfg.lam: the same run, bit for bit
    assert_state_equal(plain.member_state(0), swept.member_state(0))
    assert_equal(s_plain["kl_old_new"][0], s_swept["kl_old_new"][0])
    # member 1 carries another λ: another run
    assert not torch.allclose(s_plain["surrogate_loss"][1],
                              s_swept["surrogate_loss"][1])


@pytest.mark.parametrize("lam", [0.5, 0.95])
def test_member_lam_update_matches_reference(lam):
    cfg = dict(BASE, env="humanoid-sim", policy_hidden=(32, 32),
               max_pathlength=10, solve_audit_every=0,
               cg_precondition=False)
    tpu_agent = TpuAgent("humanoid-sim", TpuConfig(**cfg))
    ref_state = tpu_agent.init_state(seed=0)
    ref_state = ref_state._replace(vf_state=ref_state.vf_state._replace(
        initialized=jnp.asarray(True)))
    _, traj = jax.jit(lambda p, c, k: tpu_rollout(
        tpu_agent.env, tpu_agent.policy, p, c, k, tpu_agent.n_steps))(
        ref_state.policy_params, ref_state.env_carry, jax.random.key(5))
    traj_np = jax.tree_util.tree_map(np.asarray, traj)
    ref_adv = tpu_agent._advantages(ref_state.vf_state, traj,
                                    lam=jnp.float32(lam))[0]
    ref_new, ref_stats = jax.jit(
        lambda s, t: tpu_agent._process_trajectory(s, t, lam=lam))(
        ref_state, traj)

    agent = TRPOAgent("humanoid-sim", TRPOConfig(**cfg), device="cpu")
    vf = jax.tree_util.tree_map(np.asarray, ref_state.vf_state)
    adam = vf.opt_state[0]
    state = agent.init_state(seed=0)._replace(
        policy_params=policy_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, ref_state.policy_params)),
        vf_state=vf_state_from_numpy(vf.params, adam.mu, adam.nu,
                                     int(adam.count), True))
    window = trajectory_from_numpy(traj_np)
    adv = agent._advantages(state.vf_state, window, lam=lam)[0]
    new, stats = agent._process_trajectory(state, window, lam=lam)

    np.testing.assert_allclose(adv.numpy(), np.asarray(ref_adv),
                               rtol=UPDATE_TOL, atol=UPDATE_TOL)
    want = np.asarray(tpu_flatten(ref_new.policy_params)[0], np.float64)
    got = _flat(new).numpy().astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < UPDATE_TOL
    for key in ("kl_old_new", "surrogate_loss", "surrogate_before"):
        np.testing.assert_allclose(float(stats[key]),
                                   float(ref_stats[key]), rtol=UPDATE_TOL,
                                   atol=UPDATE_TOL, err_msg=key)


NAN = np.nan
SCORE_CASES = [
    # per-iteration stats, a NaN batch among them
    {"mean_episode_reward": [NAN, 10.0, 5.0]},
    # (member, n): a trailing NaN does not disqualify a member
    {"mean_episode_reward": [[50.0, 1.0], [0.0, 30.0], [99.0, NAN]]},
    # a member with no finite entry scores worst
    {"mean_episode_reward": [[NAN, NAN], [NAN, 2.0]]},
    # episode-weighted across the chunk
    {"mean_episode_reward": [[10.0, 40.0], [30.0, NAN], [20.0, 25.0]],
     "episodes_in_batch": [[3, 1], [2, 0], [1, 1]]},
    # a member that finished no episode at all
    {"mean_episode_reward": [[NAN, NAN], [1.0, 2.0]],
     "episodes_in_batch": [[0, 0], [1, 1]]},
]


@pytest.mark.parametrize("case", range(len(SCORE_CASES)))
def test_member_scores_match_reference(case):
    stats = {k: np.asarray(v, np.float32 if k == "mean_episode_reward"
                           else np.int32)
             for k, v in SCORE_CASES[case].items()}
    ref = TpuPopulation.__new__(TpuPopulation)
    pop = Population.__new__(Population)  # only the scoring is exercised
    want = np.asarray(TpuPopulation.member_scores(
        ref, {k: jnp.asarray(v) for k, v in stats.items()}))
    got = pop.member_scores({k: torch.as_tensor(v)
                             for k, v in stats.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    assert pop.best_member(stats) == TpuPopulation.best_member(
        ref, {k: jnp.asarray(v) for k, v in stats.items()})


class _FakeMesh:
    """The mesh attributes Population reads before any collective."""

    def __init__(self, n):
        self.shape = {"data": n}


def _on_a_mesh(agent):
    """``agent`` as an agent on a data×model mesh looks to Population."""
    agent.mesh = _FakeMesh(2)
    return agent


@pytest.mark.parametrize("make, kw, error, match", [
    (lambda: _agent(), dict(seeds=[]), ValueError, "at least one seed"),
    (lambda: _agent(), dict(seeds=[0, 1], lam=[0.9]), ValueError,
     "parallel to seeds"),
    # Population(mesh) runs now (item 16.1: tests/test_torch_agent_mesh.py
    # steps one over two ranks); what it refuses is the reference's:
    # members that do not divide over the mesh, and an agent that is on a
    # mesh itself (its population axis is the one to shard)
    (lambda: _agent(), dict(seeds=[0, 1, 2], mesh=_FakeMesh(2)),
     ValueError, "must divide evenly over the data=2 mesh axis"),
    (lambda: _agent(n_envs=8, batch_timesteps=128, rollout_chunk=4,
                    train_overlap=1), dict(seeds=[0, 1]), ValueError,
     "train_overlap"),
    (lambda: TRPOAgent("native:cartpole", TRPOConfig(
        env="native:cartpole", n_envs=2, batch_timesteps=16), device="cpu"),
     dict(seeds=[0]), ValueError, "device env"),
    (lambda: _on_a_mesh(_agent()), dict(seeds=[0, 1]), ValueError,
     "meshless agent"),
])
def test_population_validates_inputs(make, kw, error, match):
    with pytest.raises(error, match=match):
        Population(make(), **kw)
