"""The port's overlapped actor/learner loop (``cfg.train_overlap``) on the
CPU, case by case against the reference's ``tests/test_overlap.py``, and one
stale learner step held against ``trpo_tpu``:

- the staged update (solve → finish) composes bitwise to the fused one;
- ``is_weight`` of ones is the plain surrogate bit for bit, and the weight
  is exactly 1 where the behavior and current policies are one;
- the first overlapped iteration (the fill window) equals the serial
  iteration on every ``TrainState`` leaf, and the threaded run equals its
  schedule stepped on one thread, however the threads interleave;
- a stale learner step on one window and two param sets agrees with the
  reference's within the per-family update tolerance (1e-4, PERF.md §2),
  with and without observation normalization;
- invalid overlap configs fail at construction; ``learn`` checkpoints
  the refreshed carry and generator, and the CLI resumes.

Windows cross from the reference as numpy through ``trpo_torch.convert``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trpo_tpu.agent import TRPOAgent as TpuAgent
from trpo_tpu.config import TRPOConfig as TpuConfig
from trpo_tpu.ops import flatten_params as tpu_flatten
from trpo_tpu.rollout import device_rollout as tpu_rollout
from trpo_tpu.utils.normalize import RunningStats as TpuStats
from trpo_torch import train
from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig
from trpo_torch.convert import (
    policy_params_from_numpy,
    trajectory_from_numpy,
    vf_state_from_numpy,
)
from trpo_torch.ops.flat import flatten_params, tree_map
from trpo_torch.rollout import device_rollout
from trpo_torch.trpo import (
    make_staged_trpo_update,
    make_trpo_update,
    surrogate_and_dist,
)
from trpo_torch.utils.checkpoint import Checkpointer
from trpo_torch.utils.normalize import RunningStats
from trpo_torch.utils.timers import PhaseTimer

from test_torch_checkpoint import assert_equal, assert_state_equal

# the reference's small overlap agent (tests/test_overlap.py:_agent_pair),
# at the issue's widths: cartpole, 8 envs, 128 steps in chunks of 4
BASE = dict(env="cartpole", n_envs=8, batch_timesteps=128, rollout_chunk=4,
            cg_iters=3, vf_train_steps=3, policy_hidden=(16,),
            vf_hidden=(16,), normalize_obs=True, seed=0)
# one update of one family on two backends (PERF.md §2)
UPDATE_TOL = 1e-4


def _agent_pair(**kw):
    """(serial agent, overlapped agent) over configs that differ only in
    ``train_overlap``."""
    base = {**BASE, **kw}
    env = base.pop("env")
    return (TRPOAgent(env, TRPOConfig(**base), device="cpu"),
            TRPOAgent(env, TRPOConfig(**base, train_overlap=1),
                      device="cpu"))


def _window(agent, state):
    """One window of ``state``'s policy and its serial batch."""
    _, traj = device_rollout(agent.env,
                             agent._normed_policy(state.obs_norm),
                             state.policy_params, state.env_carry,
                             state.rng, agent.n_steps)
    return traj


# ---------------------------------------------------------------------------
# the staged update and the importance weight
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", [{}, {"env": "cartpole-po",
                                         "policy_gru": 8}])
def test_staged_update_matches_fused(family):
    agent, _ = _agent_pair(**family)
    state = agent.init_state()
    batch, _ = agent._batch_phase(state, _window(agent, state),
                                  state.obs_norm)
    update = make_trpo_update(agent.policy, agent.cfg)
    solve, finish = make_staged_trpo_update(agent.policy, agent.cfg)
    want_params, want = update(state.policy_params, batch)
    pack = solve(state.policy_params, batch)
    got_params, got = finish(state.policy_params, batch, pack)
    assert_equal(flatten_params(want_params)[0],
                 flatten_params(got_params)[0])
    for name in ("kl", "surrogate_after", "entropy", "step_norm",
                 "cg_iterations"):
        assert_equal(getattr(want, name), getattr(got, name))


def test_is_weight_ones_is_plain_surrogate():
    agent, _ = _agent_pair()
    state = agent.init_state()
    batch, _ = agent._batch_phase(state, _window(agent, state),
                                  state.obs_norm)
    params = tree_map(lambda t: t + 0.01, state.policy_params)
    plain, _ = surrogate_and_dist(agent.policy, params, batch)
    ones = batch._replace(is_weight=torch.ones_like(batch.advantages))
    weighted, _ = surrogate_and_dist(agent.policy, params, ones)
    assert_equal(plain, weighted)


def test_is_weight_is_one_when_behavior_is_current():
    # a window whose behavior distributions are the current params' on the
    # same rows: the stale batch's weight exp(logp_anchor − logp_behavior)
    # is exactly 1, and its anchor is the behavior distribution
    agent, _ = _agent_pair(normalize_obs=False)
    state = agent.init_state()
    traj = _window(agent, state)
    T, N = traj.rewards.shape
    with torch.no_grad():
        dist = agent.policy.apply(state.policy_params,
                                  traj.obs.reshape(T * N, -1))
    traj = traj._replace(old_dist={k: v.reshape(T, N, *v.shape[1:])
                                   for k, v in dist.items()})
    batch, _ = agent._batch_phase(state, traj, None, stale=True)
    assert_equal(batch.is_weight, torch.ones(T * N))
    for k in dist:
        assert_equal(batch.old_dist[k], dist[k])


# ---------------------------------------------------------------------------
# the overlap driver
# ---------------------------------------------------------------------------


def _first_iteration_bitwise(**kw):
    sync, over = _agent_pair(**kw)
    s_sync, st_sync = sync.run_iterations(sync.init_state(), 1)
    s_over, st_over = over.run_iterations(over.init_state(), 1)
    assert_state_equal(s_sync, s_over)
    assert set(st_sync) == set(st_over)
    for k in st_sync:
        assert_equal(st_sync[k], st_over[k])


def test_overlap_first_iteration_bitwise_equal_to_serial():
    _first_iteration_bitwise()


@pytest.mark.slow
def test_overlap_first_iteration_bitwise_equal_to_serial_recurrent():
    _first_iteration_bitwise(env="cartpole-po", policy_gru=8)


def test_overlap_three_iterations_kl_bound_and_accounting():
    _, over = _agent_pair()
    s0 = over.init_state()
    rng0, carry0 = s0.rng.get_state(), s0.env_carry
    s, rows = over.run_iterations(s0, 3)
    kl = rows["kl_old_new"]
    assert kl.shape == (3,)
    # backtracking accepts kl <= 1.5 max_kl around the current params
    assert torch.all(kl <= 1.5 * over.cfg.max_kl), kl
    assert torch.isfinite(rows["entropy"]).all()
    batch = over.n_steps * over.n_envs
    assert s.iteration == 3 and s.total_timesteps == 3 * batch
    # each window folded into the statistics exactly once
    assert float(s.obs_norm.count) == 3 * batch
    assert not torch.equal(s.rng.get_state(), rng0)
    assert not torch.equal(s.env_carry[1], carry0[1])


def _schedule_by_hand(agent, state, n):
    """The overlap's schedule on one thread: window k+1 collected with the
    params and statistics update k starts from, before that update."""
    timer = PhaseTimer()
    roll = state.obs_norm
    carry, window = agent._overlap_collect(state.policy_params, roll,
                                           state.env_carry, state.rng, timer)
    for k in range(n):
        next_window = next_roll = None
        if k + 1 < n:
            next_roll = state.obs_norm
            carry, next_window = agent._overlap_collect(
                state.policy_params, next_roll, carry, state.rng, timer)
        state, _, _ = agent._overlap_learner_step(state, window, roll, k > 0,
                                                  timer)
        state = state._replace(env_carry=carry)
        window, roll = next_window, next_roll
    return state


def test_overlap_threads_equal_the_schedule_on_one_thread():
    # the learner thread shares nothing mutable with the collecting one
    # (only the collector draws from the generator), so however the two
    # interleave, the run equals its schedule stepped on one thread
    _, over = _agent_pair()
    want = _schedule_by_hand(over, over.init_state(), 3)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(2):
            got, _ = over.run_iterations(over.init_state(), 3)
            assert_state_equal(want, got)
    finally:
        sys.setswitchinterval(interval)


def _tpu_state(agent, params_np, obs_norm):
    """``agent``'s seed-0 state with ``params_np`` and an initialized
    critic (its values enter the advantages)."""
    st = agent.init_state(seed=0)
    return st._replace(
        policy_params=jax.tree_util.tree_map(jnp.asarray, params_np),
        vf_state=st.vf_state._replace(initialized=jnp.asarray(True)),
        obs_norm=obs_norm)


def _stats_np(rng, n, mean=0.0):
    """Running statistics over ``n`` random cartpole observations."""
    x = (mean + rng.normal(size=(n, 4))).astype(np.float32)
    m = x.mean(0)
    return (np.float32(n), m, ((x - m) ** 2).sum(0).astype(np.float32))


@pytest.mark.parametrize("normalize_obs", [False, True])
def test_stale_learner_step_matches_reference(normalize_obs):
    cfg = dict(BASE, normalize_obs=normalize_obs, train_overlap=1)
    env = cfg.pop("env")
    tpu_agent = TpuAgent(env, TpuConfig(**cfg))
    agent = TRPOAgent(env, TRPOConfig(**cfg), device="cpu")
    rng = np.random.default_rng(0)

    # behavior θ_b and current θ_c; roll stats one window older than the
    # current ones
    behave = jax.tree_util.tree_map(
        np.asarray, tpu_agent.policy.init(jax.random.key(0)))
    current = jax.tree_util.tree_map(
        lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
        behave)
    roll_np = cur_np = None
    if normalize_obs:
        roll_np = _stats_np(rng, 64)
        cur_np = _stats_np(rng, 192, mean=0.1)
    tpu_roll = None if roll_np is None else TpuStats(
        *map(jnp.asarray, roll_np))
    tpu_cur = None if cur_np is None else TpuStats(*map(jnp.asarray, cur_np))

    ref_state = _tpu_state(tpu_agent, current, tpu_cur)
    _, traj = jax.jit(lambda p, c, k: tpu_rollout(
        tpu_agent.env, tpu_agent._normed_policy(tpu_roll), p, c, k,
        tpu_agent.n_steps))(behave, ref_state.env_carry, jax.random.key(5))
    traj_np = jax.tree_util.tree_map(np.asarray, traj)
    assert traj_np.done.any()
    ref_batch, _ = tpu_agent._overlap_adv_fns[True](ref_state, traj_np,
                                                     tpu_roll)
    ref_new, ref_row = tpu_agent._overlap_learner_step(
        ref_state, traj_np, tpu_roll, True, None, None)

    vf = jax.tree_util.tree_map(np.asarray, ref_state.vf_state)
    adam = vf.opt_state[0]
    to_stats = lambda s: None if s is None else RunningStats(  # noqa: E731
        *(torch.as_tensor(np.asarray(x)) for x in s))
    state = agent.init_state(seed=0)._replace(
        policy_params=policy_params_from_numpy(current),
        vf_state=vf_state_from_numpy(vf.params, adam.mu, adam.nu,
                                     int(adam.count), True),
        obs_norm=to_stats(cur_np))
    window = trajectory_from_numpy(traj_np)
    batch, _ = agent._batch_phase(state, window, to_stats(roll_np),
                                  stale=True)
    new, _, row = agent._overlap_learner_step(
        state, window, to_stats(roll_np), True, PhaseTimer())

    np.testing.assert_allclose(batch.is_weight.numpy(),
                               np.asarray(ref_batch.is_weight),
                               rtol=UPDATE_TOL, atol=UPDATE_TOL)
    assert not np.allclose(batch.is_weight.numpy(), 1.0)  # θ_b ≠ θ_c
    want = np.asarray(tpu_flatten(ref_new.policy_params)[0], np.float64)
    got = flatten_params(new.policy_params)[0].numpy().astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < UPDATE_TOL
    for key in ("kl_old_new", "surrogate_loss", "surrogate_before"):
        np.testing.assert_allclose(row[key], float(ref_row[key]),
                                   rtol=UPDATE_TOL, atol=UPDATE_TOL,
                                   err_msg=key)
    if normalize_obs:
        for a, b in zip(new.obs_norm, ref_new.obs_norm):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# construction-time validation
# ---------------------------------------------------------------------------

OK = dict(n_envs=8, batch_timesteps=128, rollout_chunk=4)


@pytest.mark.parametrize("kw, match", [
    (dict(OK, train_overlap=2), "train_overlap must be 0"),
    (dict(train_overlap=1), "set rollout_chunk"),
    (dict(OK, train_overlap=1, host_async_pipeline=True),
     "host_async_pipeline"),
    (dict(OK, train_overlap=1, fuse_iterations=2), "fuse_iterations"),
    (dict(OK, train_overlap=1, mesh_shape=(2,)), "mesh"),
    (dict(OK, train_overlap=1, recover_on_nan="restore"), "recover_on_nan"),
])
def test_overlap_config_rejections(kw, match):
    with pytest.raises(ValueError, match=match):
        TRPOConfig(**kw)


def test_overlap_rejects_host_env():
    pytest.importorskip("gymnasium")
    cfg = TRPOConfig(train_overlap=1, rollout_chunk=4, n_envs=2,
                     batch_timesteps=16, vf_train_steps=2, cg_iters=2)
    with pytest.raises(ValueError, match="device env"):
        TRPOAgent("gym:CartPole-v1", cfg, device="cpu")


# ---------------------------------------------------------------------------
# learn and the CLI
# ---------------------------------------------------------------------------


def test_learn_overlap_checkpoints_the_refreshed_chains(tmp_path):
    _, over = _agent_pair(checkpoint_every=1)
    ck = Checkpointer(str(tmp_path / "ck"))
    seen = {}

    def callback(state, row):
        seen[state.iteration] = (tree_map(torch.clone, state.env_carry),
                                 state.rng.get_state())

    s0 = over.init_state()
    final = over.learn(n_iterations=3, state=s0, checkpointer=ck,
                       callback=callback)
    assert final.iteration == 3 and sorted(seen) == [1, 2, 3]
    # step 1 was saved after its join: the carry and the generator are
    # already past window 2, the one in flight
    restored = ck.restore(over.init_state(), step=1)
    carry, rng_state = seen[1]
    for a, b in zip(restored.env_carry, carry):
        assert_equal(a, b)
    assert_equal(restored.rng.get_state(), rng_state)
    assert not torch.equal(rng_state, seen[2][1])
    # the resume runs from a fresh fill window
    resumed = over.learn(n_iterations=2, state=restored)
    assert resumed.iteration == 3
    assert resumed.total_timesteps == 3 * over.n_steps * over.n_envs


def test_train_cli_overlap_checkpoint_and_resume(tmp_path, capsys):
    base = ["--preset", "cartpole", "--overlap", "--rollout-chunk", "4",
            "--n-envs", "8", "--batch-timesteps", "128", "--cg-iters", "3",
            "--policy-hidden", "16", "--normalize-obs", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ck"),
            "--checkpoint-every", "2"]
    assert train.main(base + ["--iterations", "3"]) == 0
    out = capsys.readouterr().out
    assert "iter 3 " in out and "done: 3 iterations" in out
    assert train.main(base + ["--iterations", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "done: 4 iterations" in out
    cfg = train.build_config(train.parse_args(base))
    assert cfg.train_overlap == 1
