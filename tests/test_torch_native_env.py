"""The port's native (C++) host envs against the reference's
(``tests/test_native_env.py``): the same library source, the port's own
build under ``build/``, bitwise-equal steps on the same action arrays,
the port's device envs as the physics oracle, snapshot/restore, and the
host obs-norm fold.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from trpo_tpu.envs import native as tpu_native
from trpo_torch import envs
from trpo_torch.envs import native, native_build
from trpo_torch.envs.cartpole import CartPole, CartPoleState
from trpo_torch.envs.pendulum import Pendulum, PendulumState

REPO = native_build.SOURCE.parents[1]


def _actions(kind, rng, n):
    if kind == "cartpole":
        return rng.integers(0, 2, size=n).astype(np.int32)
    return rng.uniform(-3, 3, size=n).astype(np.float32)


@pytest.mark.parametrize("kind", ["cartpole", "pendulum"])
@pytest.mark.parametrize("normalize_obs", [False, True])
def test_port_steps_equal_reference_bitwise(kind, normalize_obs):
    # 300 steps cross auto-resets (cartpole terminates, pendulum truncates
    # at a short horizon): obs, final_obs, rewards, flags and the episode
    # counters must agree bit for bit, and so must the f64 statistics
    n, horizon = 6, 40
    port = native.NativeVecEnv(kind, n_envs=n, seed=3,
                               max_episode_steps=horizon,
                               normalize_obs=normalize_obs)
    ref = tpu_native.NativeVecEnv(kind, n_envs=n, seed=3,
                                  max_episode_steps=horizon,
                                  normalize_obs=normalize_obs)
    np.testing.assert_array_equal(port.current_obs(), ref.current_obs())
    rng = np.random.default_rng(0)
    ended = 0
    for _ in range(300):
        a = _actions(kind, rng, n)
        for x, y in zip(port.host_step(a), ref.host_step(a)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(port.last_episode_returns,
                                      ref.last_episode_returns)
        np.testing.assert_array_equal(port.last_episode_lengths,
                                      ref.last_episode_lengths)
        ended += int(port._running_lengths.tolist().count(0))
    assert ended > 0  # auto-resets happened
    np.testing.assert_array_equal(port._rng, ref._rng)
    if normalize_obs:
        for x, y in zip(port.obs_stats_state(), ref.obs_stats_state()):
            np.testing.assert_array_equal(x, y)
        assert port._n_mean.dtype == np.float64
        np.testing.assert_array_equal(port._n_m2, ref._n_m2)


def test_group_slices_equal_full_steps():
    full = native.NativeVecEnv("pendulum", n_envs=7, seed=1)
    grouped = native.NativeVecEnv("pendulum", n_envs=7, seed=1)
    rng = np.random.default_rng(2)
    for _ in range(20):
        a = _actions("pendulum", rng, 7)
        want = full.host_step(a)
        parts = [grouped.host_step_slice(a[lo:hi], lo, hi)
                 for lo, hi in ((0, 3), (3, 7))]
        for i, x in enumerate(want):
            np.testing.assert_array_equal(
                x, np.concatenate([p[i] for p in parts]))


def test_cartpole_matches_port_device_env():
    # the reference's tolerances (tests/test_native_env.py:83)
    n = 64
    rng = np.random.default_rng(0)
    env = native.NativeVecEnv("cartpole", n_envs=n,
                              max_episode_steps=10 ** 9)
    states = rng.uniform(-0.04, 0.04, size=(n, 4)).astype(np.float32)
    env._state[:] = states
    env._t[:] = 0
    actions = rng.integers(0, 2, size=n).astype(np.int32)
    _, rewards, term, _, final_obs = env.host_step(actions)
    dev = CartPole(max_episode_steps=10 ** 9)
    s = torch.from_numpy(states)
    st = CartPoleState(s[:, 0], s[:, 1], s[:, 2], s[:, 3],
                       torch.zeros(n, dtype=torch.int32))
    _, obs, r, dterm, _ = dev.step(st, torch.from_numpy(actions))
    np.testing.assert_allclose(final_obs, obs.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(term, dterm.numpy())
    np.testing.assert_array_equal(rewards, r.numpy())


def test_pendulum_matches_port_device_env():
    # the reference's tolerances (tests/test_native_env.py:113)
    n = 64
    rng = np.random.default_rng(1)
    env = native.NativeVecEnv("pendulum", n_envs=n,
                              max_episode_steps=10 ** 9)
    th = rng.uniform(-np.pi, np.pi, size=n).astype(np.float32)
    thd = rng.uniform(-1, 1, size=n).astype(np.float32)
    env._state[:, 0], env._state[:, 1] = th, thd
    env._t[:] = 0
    actions = rng.uniform(-3, 3, size=n).astype(np.float32)
    _, rewards, term, _, final_obs = env.host_step(actions)
    dev = Pendulum(max_episode_steps=10 ** 9)
    st = PendulumState(torch.from_numpy(th), torch.from_numpy(thd),
                       torch.zeros(n, dtype=torch.int32))
    _, obs, r, _, _ = dev.step(st, torch.from_numpy(actions)[:, None])
    np.testing.assert_allclose(final_obs, obs.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rewards, r.numpy(), rtol=1e-4, atol=1e-5)
    assert not term.any()


def test_default_horizons_come_from_port_device_envs():
    assert native.NativeVecEnv("cartpole", 2).max_episode_steps == \
        CartPole().max_episode_steps
    assert native.NativeVecEnv("pendulum", 2).max_episode_steps == \
        Pendulum().max_episode_steps


@pytest.mark.parametrize("normalize_obs", [False, True])
def test_snapshot_restore_mid_episode_is_exact(normalize_obs):
    # the statistics ride TrainState (as f32), not the snapshot: a resumed
    # adapter gets the snapshot and the f32 statistics, and must then step
    # exactly as the adapter it was taken from does under them
    env = native.NativeVecEnv("cartpole", n_envs=5, seed=4,
                              normalize_obs=normalize_obs)
    rng = np.random.default_rng(5)
    for _ in range(17):
        env.host_step(_actions("cartpole", rng, 5))
    snap = env.env_state_snapshot()
    stats = env.obs_stats_state()
    other = native.NativeVecEnv("cartpole", n_envs=5, seed=99,
                                normalize_obs=normalize_obs)
    other.env_state_restore(snap)
    if normalize_obs:
        env.set_obs_stats_state(stats)
        other.set_obs_stats_state(stats)
    np.testing.assert_array_equal(other.current_obs(), env.current_obs())
    for _ in range(30):
        a = _actions("cartpole", rng, 5)
        for x, y in zip(other.host_step(a), env.host_step(a)):
            np.testing.assert_array_equal(x, y)


def test_restore_refuses_another_width_and_kind():
    snap = native.NativeVecEnv("cartpole", n_envs=4).env_state_snapshot()
    with pytest.raises(ValueError, match="same n_envs"):
        native.NativeVecEnv("cartpole", n_envs=8).env_state_restore(snap)
    with pytest.raises(ValueError, match="native env"):
        native.NativeVecEnv("pendulum", n_envs=4).env_state_restore(snap)


def test_library_builds_under_build_and_never_under_native(tmp_path,
                                                           monkeypatch):
    # the build writes only under its root: a copy of the source in a
    # directory of its own stays alone there, and the shared inputs in
    # native/ are untouched (native/ itself is not listed: the reference's
    # own builds, run by other tests, write there)
    inputs = {name: (REPO / "native" / name).read_bytes()
              for name in ("vec_env.cpp", "Makefile")}
    src_dir = tmp_path / "native"
    src_dir.mkdir()
    src = src_dir / "vec_env.cpp"
    src.write_bytes(inputs["vec_env.cpp"])
    monkeypatch.setattr(native_build, "SOURCE", src)
    lib = native_build.build(root=tmp_path / "out")
    assert lib.is_file() and (tmp_path / "out") in lib.parents
    assert native_build.build(root=tmp_path / "out") == lib  # cached
    assert [p.name for p in src_dir.iterdir()] == ["vec_env.cpp"]
    monkeypatch.undo()
    default = native_build.build()
    assert (REPO / "build" / "trpo_torch_native") in default.parents
    assert {name: (REPO / "native" / name).read_bytes()
            for name in inputs} == inputs
    assert native_build.compiler_info()["version"]


def test_port_and_reference_builds_step_alike(tmp_path):
    # the port's compile and the reference's recipe (native/Makefile, same
    # flags, run on copies of its inputs) give bitwise-equal steps here
    import ctypes
    import subprocess

    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    for name in ("vec_env.cpp", "Makefile"):
        shutil.copy2(REPO / "native" / name, ref_dir / name)
    subprocess.run(["make", "-s", "libtrpo_native.so"], cwd=ref_dir,
                   check=True, capture_output=True, text=True)
    ref_lib = ctypes.CDLL(str(ref_dir / "libtrpo_native.so"))
    port_lib = ctypes.CDLL(str(native_build.build(root=tmp_path / "port")))
    n = 16
    outs = []
    for lib in (ref_lib, port_lib):
        f = lib.trpo_native_pendulum_step
        state = np.random.default_rng(0).uniform(
            -3, 3, size=(n, 2)).astype(np.float32)
        t = np.zeros(n, np.int32)
        rng = np.arange(1, n + 1, dtype=np.uint64)
        a = np.linspace(-3, 3, n).astype(np.float32)
        bufs = [np.empty((n, 3), np.float32), np.empty((n, 3), np.float32),
                np.empty(n, np.float32), np.empty(n, np.uint8),
                np.empty(n, np.uint8)]
        ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        f.argtypes = None
        f(ptr(state), ptr(t), ptr(rng), ptr(a), ctypes.c_int32(n),
          ctypes.c_int32(200), *map(ptr, bufs))
        outs.append([state] + bufs)
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)


def test_failed_compile_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="exited") as e:
        native_build.build(root=tmp_path / "out")
    assert "error" in str(e.value)


def test_make_resolves_native_and_refuses_unknown_kinds():
    env = envs.make("native:pendulum", n_envs=3, max_episode_steps=9)
    assert (env.n_envs, env.max_episode_steps, env.obs_shape) == (3, 9, (3,))
    assert not envs.is_device_env(env)
    assert envs.is_device_env(envs.make("cartpole"))
    with pytest.raises(KeyError):
        envs.make("native:walker")
    # the gymproc: worker pool is ported (item 18.3): with gymnasium it
    # builds a pool that steps, without it it refuses naming gymnasium
    if importlib.util.find_spec("gymnasium") is None:
        with pytest.raises(RuntimeError, match="gymnasium"):
            envs.make("gymproc:CartPole-v1")
        return
    pool = envs.make("gymproc:CartPole-v1", n_envs=2, n_workers=1)
    try:
        assert not envs.is_device_env(pool)
        assert pool.host_step(np.zeros(2, np.int64))[0].shape == (2, 4)
    finally:
        pool.close()


def test_no_toolchain_is_a_clear_error(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_build.build()


def test_a_cxx_without_openmp_is_passed_over(tmp_path, monkeypatch):
    # a machine may set CXX to a compiler whose OpenMP runtime is missing:
    # the next candidate that builds the OpenMP probe is used
    fake = tmp_path / "broken-cxx"
    fake.write_text("#!/bin/sh\necho 'cannot read spec file libgomp.spec' "
                    ">&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setitem(os.environ, "CXX", str(fake))
    assert native_build._cxx() == shutil.which("g++")
    monkeypatch.setattr(native_build, "_candidates", lambda: (str(fake),))
    with pytest.raises(RuntimeError, match="libgomp.spec"):
        native_build._cxx()
