"""The port's ``gymproc:`` worker pool (``trpo_torch/envs/proc_env.py``)
against the reference's (``tests/test_proc_env.py``).

The reference's ``ProcVecEnv`` is bit-identical to its in-process
``GymVecEnv`` by contract, so the port's pool is held, bit for bit
(tolerance 0), against the reference's ``GymVecEnv``: same seeds, same
actions, the same steps, auto-resets, episode counters and normalization
statistics, at 1, 2 and 4 workers. Spawning the reference's own pool would
add JAX-importing workers to every case.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip("gymnasium")

from trpo_tpu.envs.gym_adapter import GymVecEnv as TpuGymVecEnv  # noqa: E402
from trpo_torch import envs  # noqa: E402
from trpo_torch.agent import TRPOAgent  # noqa: E402
from trpo_torch.config import TRPOConfig  # noqa: E402
from trpo_torch.envs.gym_adapter import GymVecEnv  # noqa: E402
from trpo_torch.envs.proc_env import ProcVecEnv  # noqa: E402

ENV = "CartPole-v1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _actions(env, rng):
    spec = env.action_spec
    if hasattr(spec, "n"):
        return rng.integers(0, spec.n, size=env.n_envs)
    # beyond the Box on purpose: both adapters clip
    return rng.uniform(-2.5, 2.5, size=(env.n_envs, spec.dim)).astype(
        np.float32)


def _assert_steps_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("env_id, workers, steps", [
    (ENV, 1, 200), (ENV, 2, 200), (ENV, 4, 200),
    ("Pendulum-v1", 4, 230),  # crosses the 200-step truncation
])
@pytest.mark.parametrize("normalize_obs", [False, True])
def test_bit_identical_to_reference_gym_vec_env(env_id, workers, steps,
                                                normalize_obs):
    ref = TpuGymVecEnv(env_id, n_envs=8, seed=7, normalize_obs=normalize_obs)
    pool = ProcVecEnv(env_id, n_envs=8, seed=7, n_workers=workers,
                      normalize_obs=normalize_obs)
    try:
        assert pool.obs_shape == ref.obs_shape
        np.testing.assert_array_equal(pool.current_obs(), ref.current_obs())
        rng = np.random.default_rng(0)
        resets = 0
        for _ in range(steps):
            a = _actions(pool, rng)
            got, want = pool.host_step(a), ref.host_step(a)
            _assert_steps_equal(got, want)
            resets += int(np.logical_or(got[2], got[3]).sum())
        assert resets > 0  # the auto-reset path ran
        np.testing.assert_array_equal(pool.last_episode_returns,
                                      ref.last_episode_returns)
        np.testing.assert_array_equal(pool.last_episode_lengths,
                                      ref.last_episode_lengths)
        if normalize_obs:
            for x, y in zip(pool.obs_stats_state(), ref.obs_stats_state()):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        np.testing.assert_array_equal(pool.reset_all(seed=42),
                                      ref.reset_all(seed=42))
    finally:
        pool.close()
        ref.close()


def test_reproducible_across_pool_shapes():
    traces = []
    for w in (1, 2, 4):
        pool = ProcVecEnv(ENV, n_envs=4, seed=11, n_workers=w)
        rng = np.random.default_rng(3)
        try:
            traces.append([pool.host_step(_actions(pool, rng))
                           for _ in range(15)])
        finally:
            pool.close()
    for other in traces[1:]:
        for a, b in zip(traces[0], other):
            _assert_steps_equal(a, b)


def test_host_step_slice_on_worker_boundaries_and_split_refusal():
    ref = TpuGymVecEnv(ENV, n_envs=4, seed=3)
    pool = ProcVecEnv(ENV, n_envs=4, seed=3, n_workers=2)
    try:
        rng = np.random.default_rng(0)
        for _ in range(10):
            a = rng.integers(0, 2, size=4)
            full = ref.host_step(a)
            lo, hi = pool.host_step_slice(a[:2], 0, 2), \
                pool.host_step_slice(a[2:], 2, 4)
            for x, l_, h in zip(full, lo, hi):
                np.testing.assert_array_equal(
                    np.asarray(x), np.concatenate([np.atleast_1d(l_),
                                                   np.atleast_1d(h)]))
        with pytest.raises(ValueError, match="splits worker"):
            pool.host_step_slice(np.zeros(2, np.int64), 1, 3)
        # nothing was sent: the protocol is intact
        _assert_steps_equal(pool.host_step(np.zeros(4, np.int64)),
                            ref.host_step(np.zeros(4, np.int64)))
    finally:
        pool.close()
        ref.close()


def test_snapshots_interchangeable_with_gym_vec_env(tmp_path):
    pool = ProcVecEnv(ENV, n_envs=2, seed=9, n_workers=2)
    port = GymVecEnv(ENV, n_envs=2, seed=1009)
    ref = TpuGymVecEnv(ENV, n_envs=2, seed=2009)
    try:
        for _ in range(7):
            pool.host_step(np.ones(2, np.int64))
        snap = pool.env_state_snapshot()
        # the reference's schema, key for key
        assert set(snap) == set(ref.env_state_snapshot())
        port.env_state_restore(snap)
        ref.env_state_restore(snap)
        acts = np.zeros(2, np.int64)
        a, b, c = pool.host_step(acts), port.host_step(acts), \
            ref.host_step(acts)
        _assert_steps_equal(a, b)
        _assert_steps_equal(a, c)
        # the other way, through the checkpoint's pickle-free sidecar
        from trpo_torch.utils.checkpoint import (
            _flatten_snapshot,
            _unflatten_snapshot,
        )

        nesting, arrays = _flatten_snapshot(port.env_state_snapshot())
        np.savez(tmp_path / "s.npz", **arrays)
        back = _unflatten_snapshot(nesting, np.load(tmp_path / "s.npz"))
        pool2 = ProcVecEnv(ENV, n_envs=2, seed=77, n_workers=1)
        try:
            pool2.env_state_restore(back)
            _assert_steps_equal(pool2.host_step(acts), port.host_step(acts))
        finally:
            pool2.close()
    finally:
        pool.close()
        port.close()
        ref.close()


def test_make_routes_gymproc_and_the_agent_builds_a_supervised_pool():
    pool = envs.make(f"gymproc:{ENV}", n_envs=2, seed=0, n_workers=1)
    try:
        assert isinstance(pool, ProcVecEnv) and pool.obs_shape == (4,)
        assert pool.host_step(np.zeros(2, np.int64))[0].shape == (2, 4)
    finally:
        pool.close()
    assert "gymproc:" in envs.HOST_PREFIXES
    with pytest.raises(KeyError, match="gymproc:<EnvId>"):
        envs.make("no-such-env")


@pytest.mark.parametrize("env", [f"gym:{ENV}", f"gymproc:{ENV}"])
def test_fleet_cap_applies_to_gym_and_gymproc(env):
    # the reference caps both families (trpo_tpu/agent.py:136-157)
    cfg = TRPOConfig(env=env, fleet_n_envs=300, batch_timesteps=600)
    with pytest.raises(ValueError, match="gym:/gymproc:"):
        TRPOAgent(cfg.env, cfg, device="cpu")


def test_worker_error_surfaces_and_does_not_desync():
    pool = ProcVecEnv(ENV, n_envs=4, seed=0, n_workers=2)
    ref = ProcVecEnv(ENV, n_envs=4, seed=0, n_workers=2)
    try:
        # worker 0 cannot step these; worker 1 steps, and its reply must
        # be drained before the error is raised
        bad = np.asarray(["x", "y", 0, 1], dtype=object)
        with pytest.raises(RuntimeError, match="worker 0"):
            pool.host_step(bad)
        np.testing.assert_array_equal(pool.reset_all(seed=99),
                                      ref.reset_all(seed=99))
        assert pool.host_step(np.zeros(4, np.int64))[0].shape == (4, 4)
    finally:
        pool.close()
        ref.close()


def test_pipelined_host_rollout_over_the_supervised_pool():
    from trpo_torch.models.policy import DiscreteSpec, make_policy
    from trpo_torch.resilience import SupervisedEnv
    from trpo_torch.rollout import host_rollout, pipelined_host_rollout

    policy = make_policy((4,), DiscreteSpec(2), hidden=(16,))
    params = policy.init(torch.Generator().manual_seed(0))
    serial_env = GymVecEnv(ENV, n_envs=4, seed=7)
    pool = SupervisedEnv(ProcVecEnv(ENV, n_envs=4, seed=7, n_workers=2))
    try:
        # a mode policy: categorical actions are exact at any batch width
        serial = host_rollout(serial_env, policy, params, torch.Generator(),
                              25, deterministic=True)
        piped = pipelined_host_rollout(pool, policy, params,
                                       torch.Generator(), 25, n_groups=2,
                                       deterministic=True)
        assert serial.done.any()
        for name in ("obs", "actions", "rewards", "terminated", "done",
                     "next_obs", "episode_return", "episode_length"):
            assert torch.equal(getattr(serial, name), getattr(piped, name)), \
                name
    finally:
        serial_env.close()
        pool.close()


def test_missing_gymnasium_refuses_before_any_worker(monkeypatch):
    import importlib.util

    import trpo_torch.envs.proc_env as proc_env

    real = importlib.util.find_spec
    monkeypatch.setattr(
        proc_env.importlib.util, "find_spec",
        lambda name, *a: None if name == "gymnasium" else real(name, *a))
    spawned = []
    monkeypatch.setattr(ProcVecEnv, "_spawn_worker",
                        lambda self, w: spawned.append(w))
    # the reference's pool surfaces a worker's missing gymnasium as
    # RuntimeError; the port raises the same type, in the parent
    with pytest.raises(RuntimeError, match="gymnasium"):
        ProcVecEnv(ENV, n_envs=2)
    assert spawned == []


def test_worker_import_chain_is_torch_free_and_start_cost():
    # a worker imports this chain (and gymnasium) and nothing of torch
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, trpo_torch.envs.proc_env, trpo_torch.envs.gym_state; "
         "print('torch' in sys.modules)"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "False", out.stderr
    t0 = time.perf_counter()
    pool = ProcVecEnv(ENV, n_envs=4, seed=0, n_workers=4)
    start_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        pool.restart_worker(1)
        restart_s = time.perf_counter() - t0
    finally:
        pool.close()
    print(f"pool start (4 workers) {start_s:.2f} s, one restart "
          f"{restart_s:.2f} s")
    # importing torch alone takes ~2.3 s on this machine's CPU
    assert restart_s < 30.0


def test_concurrent_worker_starts_hide_and_restore_main(monkeypatch):
    # a trpo_torch.* main is hidden while a worker starts; two pools
    # restarting workers from two threads must each start with it hidden
    # (a child that saw it would import a module that does not exist and
    # never answer its handshake) and leave it restored
    import importlib.machinery
    import multiprocessing.context
    import threading

    main_mod = sys.modules["__main__"]
    fake = importlib.machinery.ModuleSpec("trpo_torch._no_such_main", None)
    monkeypatch.setattr(main_mod, "__spec__", fake)
    # widen the window between hiding the main and the child reading it,
    # so that two starts overlap
    start = multiprocessing.context.SpawnProcess.start

    def slow_start(self):
        time.sleep(0.1)
        start(self)

    monkeypatch.setattr(multiprocessing.context.SpawnProcess, "start",
                        slow_start)
    pools = [ProcVecEnv(ENV, n_envs=2, seed=s, n_workers=2) for s in (0, 9)]
    errors = []

    def restart(pool):
        try:
            for _ in range(3):
                for w in range(2):
                    pool.restart_worker(w)
        except Exception as e:  # collected and asserted below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=restart, args=(p,))
                   for p in pools]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert main_mod.__spec__ is fake
        for pool in pools:
            obs, *_ = pool.host_step([0, 1])
            assert np.asarray(obs).shape == (2, 4)
    finally:
        for pool in pools:
            pool.close()


def test_worker_pool_overlap_wallclock():
    # time.sleep releases the core, so W=4 workers finish a fixed step
    # budget in well under the serial time (the reference's bound, 1.8x of
    # the ideal 4x)
    def steps_ms(workers):
        pool = ProcVecEnv("trpo_torch.envs.sleep_env:SleepEnv", n_envs=8,
                          seed=0, n_workers=workers, sleep_ms=3.0)
        try:
            acts = [0] * 8
            for _ in range(3):
                pool.host_step(acts)
            t0 = time.perf_counter()
            for _ in range(25):
                pool.host_step(acts)
            return (time.perf_counter() - t0) / 25 * 1e3
        finally:
            pool.close()

    serial, pooled = steps_ms(1), steps_ms(4)
    assert serial / pooled > 1.8, (serial, pooled)
