"""The port's host rollouts against the reference's
(``tests/test_pipeline_rollout.py``, ``tests/test_host_inference.py``):
``host_rollout`` under a mode policy with converted params on the native
envs, the pipelined rollout against the serial one, the packed act against
the unpacked, a recurrent policy's carry, and the deferred fold under
threads. The two packages sample from different RNG families, so only
mode (deterministic) rollouts are compared across them.
"""

import time

import jax
import numpy as np
import pytest
import torch

from trpo_tpu.envs.native import NativeVecEnv as TpuNative
from trpo_tpu.models import BoxSpec as TpuBox
from trpo_tpu.models import DiscreteSpec as TpuDiscrete
from trpo_tpu.models import make_policy as tpu_make_policy
from trpo_tpu.models import make_recurrent_policy as tpu_make_recurrent
from trpo_tpu.rollout import host_rollout as tpu_host_rollout
from trpo_torch.convert import policy_params_from_numpy
from trpo_torch.envs.native import NativeVecEnv
from trpo_torch.models.policy import BoxSpec, DiscreteSpec, make_policy
from trpo_torch.models.recurrent import make_recurrent_policy
from trpo_torch.rollout import (
    host_rollout,
    make_host_act_fn,
    pipelined_host_rollout,
)
from trpo_torch.utils.timers import PhaseTimer

T_STEPS, N_ENVS = 40, 6


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _policies(kind, recurrent=False):
    obs, port_spec, ref_spec = {
        "cartpole": ((4,), DiscreteSpec(2), TpuDiscrete(2)),
        "pendulum": ((3,), BoxSpec(1), TpuBox(1)),
    }[kind]
    if recurrent:
        ref = tpu_make_recurrent(obs, ref_spec, hidden=(16,), gru_size=8)
        port = make_recurrent_policy(obs, port_spec, hidden=(16,),
                                     gru_size=8)
    else:
        ref = tpu_make_policy(obs, ref_spec, hidden=(16, 16))
        port = make_policy(obs, port_spec, hidden=(16, 16))
    ref_params = ref.init(jax.random.key(3))
    return ref, ref_params, port, policy_params_from_numpy(_np(ref_params))


def _np_traj(traj):
    return traj._replace(
        old_dist={k: v.numpy() for k, v in traj.old_dist.items()},
        **{f: getattr(traj, f).numpy() for f in (
            "obs", "next_obs", "rewards", "terminated", "done",
            "episode_return", "episode_length", "actions")})


def _assert_traj(got, want, rtol=0.0, atol=0.0):
    env_fields = ("obs", "next_obs", "rewards", "terminated", "done",
                  "episode_return", "episode_length", "actions")
    for f in env_fields:
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        if rtol or atol:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f)
    for k, v in got.old_dist.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want.old_dist[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind, rtol, atol", [
    ("cartpole", 0.0, 0.0),      # discrete: the env stream is bitwise
    ("pendulum", 1e-4, 1e-6),    # the reference's pipelined tolerance
])
def test_host_rollout_matches_reference_under_mode_policy(kind, rtol, atol):
    ref, ref_params, port, params = _policies(kind)
    want = tpu_host_rollout(
        TpuNative(kind, n_envs=N_ENVS, seed=2, max_episode_steps=25), ref,
        ref_params, jax.random.key(0), T_STEPS, deterministic=True)
    got = host_rollout(
        NativeVecEnv(kind, n_envs=N_ENVS, seed=2, max_episode_steps=25),
        port, params, torch.Generator(), T_STEPS, deterministic=True)
    assert got.done.any()
    _assert_traj(got, want, rtol, atol)
    assert got.obs.dtype == torch.float32
    assert got.actions.dtype == (torch.int64 if kind == "cartpole"
                                 else torch.float32)


@pytest.mark.parametrize("n_groups", [2, 3])
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("kind, rtol, atol", [
    ("cartpole", 0.0, 0.0),
    # a continuous mode action is the MLP's mean, and torch's GEMM rounds a
    # row differently at another batch width (a group's), so pendulum is
    # held at the reference's pipelined tolerance; its dist leaves carry
    # the same caveat in the reference (tests/test_pipeline_rollout.py:50)
    ("pendulum", 1e-4, 1e-6),
])
def test_pipelined_equals_serial_under_mode_policy(kind, rtol, atol,
                                                   n_groups, staged):
    _, _, port, params = _policies(kind)
    serial = host_rollout(
        NativeVecEnv(kind, n_envs=7, seed=4, max_episode_steps=15), port,
        params, torch.Generator(), T_STEPS, deterministic=True)
    piped = pipelined_host_rollout(
        NativeVecEnv(kind, n_envs=7, seed=4, max_episode_steps=15), port,
        params, torch.Generator(), T_STEPS, n_groups=n_groups,
        deterministic=True, stage_to_device=staged)
    assert serial.done.any()
    _assert_traj(piped, _np_traj(serial), rtol, atol)


def test_packed_act_equals_unpacked():
    for kind in ("cartpole", "pendulum"):
        _, _, port, params = _policies(kind)
        obs = NativeVecEnv(kind, n_envs=9, seed=1).current_obs()
        for det in (False, True):
            outs = []
            for pack in (True, False):
                act = make_host_act_fn(port, deterministic=det, pack=pack)
                outs.append(act(params, obs, torch.Generator()
                                .manual_seed(5)))
            (a1, d1), (a2, d2) = outs
            assert a1.dtype == a2.dtype and np.array_equal(a1, a2)
            for k in d1:
                assert np.array_equal(d1[k], d2[k]), k


def test_sampled_pipelined_rollout_reproduces_under_threads():
    # per-group generators derived at window start: a fixed seed gives
    # the same trajectory and statistics whatever the interleaving
    _, _, port, params = _policies("pendulum")
    runs = []
    for _ in range(2):
        env = NativeVecEnv("pendulum", n_envs=8, seed=6,
                           normalize_obs=True)
        gen = torch.Generator().manual_seed(11)
        trajs = [pipelined_host_rollout(env, port, params, gen, 12,
                                        n_groups=4) for _ in range(2)]
        runs.append((trajs, env.obs_stats_state(), gen.get_state()))
    (t1, s1, g1), (t2, s2, g2) = runs
    for a, b in zip(t1, t2):
        assert torch.equal(a.obs, b.obs) and torch.equal(a.actions,
                                                         b.actions)
        assert torch.equal(a.old_dist["mean"], b.old_dist["mean"])
    for x, y in zip(s1, s2):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(g1, g2)
    # deferred mode: the window's observations were normalized under the
    # statistics of its start (one fold per window, not per step)
    assert float(s1[0]) == 8 * (1 + 2 * 12)


def test_pipelined_refuses_recurrent_and_bad_groups():
    _, _, rec, rparams = _policies("cartpole", recurrent=True)
    env = NativeVecEnv("cartpole", n_envs=4)
    with pytest.raises(NotImplementedError, match="recurrent"):
        pipelined_host_rollout(env, rec, rparams, torch.Generator(), 4)
    _, _, ff, params = _policies("cartpole")
    with pytest.raises(ValueError, match="n_groups"):
        pipelined_host_rollout(env, ff, params, torch.Generator(), 4,
                               n_groups=5)


def test_recurrent_host_rollout_matches_reference():
    ref, ref_params, port, params = _policies("cartpole", recurrent=True)
    env_r = TpuNative("cartpole", n_envs=N_ENVS, seed=8,
                      max_episode_steps=12)
    env_p = NativeVecEnv("cartpole", n_envs=N_ENVS, seed=8,
                         max_episode_steps=12)
    state_r = state_p = None
    for _ in range(2):  # the carry crosses a window boundary
        want, state_r = tpu_host_rollout(
            env_r, ref, ref_params, jax.random.key(0), 20,
            policy_state=state_r, deterministic=True)
        got, state_p = host_rollout(env_p, port, params, torch.Generator(),
                                    20, policy_state=state_p,
                                    deterministic=True)
        _assert_traj(got, want)
        np.testing.assert_array_equal(got.reset.numpy(),
                                      np.asarray(want.reset))
        for f in ("policy_h0", "policy_h", "policy_h_next"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
        np.testing.assert_array_equal(state_p[1].numpy(),
                                      np.asarray(state_r[1]))
    # memory is zeroed after an episode end
    done = got.done.numpy()
    h_next = got.policy_h.numpy()[1:]
    assert done[:-1].any()
    assert not np.abs(h_next[done[:-1]]).any()


def test_group_spans_are_recorded_from_the_worker_threads():
    _, _, port, params = _policies("cartpole")
    timer = PhaseTimer()
    with timer.phase("rollout"):
        pipelined_host_rollout(NativeVecEnv("cartpole", n_envs=6), port,
                               params, torch.Generator(), 5, n_groups=3,
                               timer=timer)
    summary = timer.summary()
    for g in range(3):
        assert summary[f"rollout/group{g}"]["calls"] == 1
    assert summary["rollout"]["calls"] == 1


def test_pipelined_groups_overlap_blocking_env_steps():
    # a step that blocks outside the GIL (time.sleep here, MuJoCo or the
    # C++ stepper in use) overlaps across groups: 4 groups of one env take
    # well under the serial time
    gymnasium = pytest.importorskip("gymnasium")
    from trpo_torch.envs.gym_adapter import GymVecEnv

    if "TrpoTorchSleep-v0" not in gymnasium.registry:
        gymnasium.register(id="TrpoTorchSleep-v0",
                           entry_point="trpo_torch.envs.sleep_env:SleepEnv",
                           kwargs={"sleep_ms": 20.0})
    policy = make_policy((4,), DiscreteSpec(2), hidden=(8,))
    params = policy.init(torch.Generator().manual_seed(0))

    def wall(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    env = GymVecEnv("TrpoTorchSleep-v0", n_envs=4, seed=0)
    serial = wall(lambda: host_rollout(env, policy, params,
                                       torch.Generator(), 10))
    piped = wall(lambda: pipelined_host_rollout(
        env, policy, params, torch.Generator(), 10, n_groups=4))
    assert serial > 0.75  # 10 steps × 4 envs × 20 ms, one after another
    assert piped < 0.6 * serial
