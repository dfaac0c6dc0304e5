"""ctypes bindings of the batched C++ env stepper (counterpart:
``trpo_tpu/envs/native.py``).

:class:`NativeVecEnv` steps N CartPole or Pendulum envs in
``native/vec_env.cpp`` (OpenMP over the envs, auto-reset inside) behind
the host-env interface of ``envs/gym_adapter.GymVecEnv``, so the host
rollouts and the agent drive both the same way. The ABI is the
reference's: flat numpy arrays that the C++ steps in place. ctypes
releases the GIL around each call, so group threads step their slices at
the same time. The library is the port's own build
(``envs/native_build.py``, under ``build/``).

The default horizons come from the port's device ``CartPole`` and
``Pendulum``, so a native env and its device twin truncate alike.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from trpo_torch.envs.episode_stats import EpisodeStatsMixin
from trpo_torch.envs.native_build import build
from trpo_torch.envs.obs_norm import ObsNormMixin
from trpo_torch.models.policy import BoxSpec, DiscreteSpec

__all__ = ["NativeVecEnv", "load_library", "native_available"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def load_library() -> ctypes.CDLL:
    """Build (when needed) and load the library, with its argument types
    declared. A success is cached; a failure raises ``RuntimeError`` with
    the compiler's output and is retried on the next call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except OSError as e:
            raise RuntimeError(
                f"native env library unavailable (load failed): {e}") from e
        lib.trpo_native_seed.argtypes = [_u64p, ctypes.c_int32,
                                         ctypes.c_uint64]
        for prefix, act_p in (("cartpole", _i32p), ("pendulum", _f32p)):
            reset = getattr(lib, f"trpo_native_{prefix}_reset")
            reset.argtypes = [_f32p, _i32p, _u64p, ctypes.c_int32]
            step = getattr(lib, f"trpo_native_{prefix}_step")
            step.argtypes = [_f32p, _i32p, _u64p, act_p, ctypes.c_int32,
                             ctypes.c_int32, _f32p, _f32p, _f32p, _u8p,
                             _u8p]
        _lib = lib
        return lib


def native_available() -> bool:
    """True when the library builds and loads here."""
    try:
        load_library()
        return True
    except RuntimeError:
        return False


def _default_horizon(kind: str) -> int:
    from trpo_torch.envs.cartpole import CartPole
    from trpo_torch.envs.pendulum import Pendulum

    return (CartPole if kind == "cartpole" else Pendulum)().max_episode_steps


_KINDS = {
    # kind -> (state width, obs dim, discrete actions)
    "cartpole": (4, 4, True),
    "pendulum": (2, 3, False),
}


class NativeVecEnv(EpisodeStatsMixin, ObsNormMixin):
    """N batched native envs behind the ``GymVecEnv`` host interface."""

    def __init__(self, kind: str = "cartpole", n_envs: int = 8,
                 seed: int = 0, max_episode_steps: Optional[int] = None,
                 normalize_obs: bool = False, env_offset: int = 0):
        """``env_offset``: these envs are ``[env_offset, env_offset +
        n_envs)`` of a wider fleet (a data rank's slice on a mesh): their
        RNG streams are that fleet's, which the C++ seeds by global env
        index, so the slice starts where the one-rank run's envs do."""
        if kind not in _KINDS:
            raise KeyError(
                f"unknown native env {kind!r}; have {sorted(_KINDS)}")
        if n_envs < 1:
            raise ValueError(f"n_envs must be >= 1, got {n_envs}")
        self._lib = load_library()
        state_w, obs_dim, discrete = _KINDS[kind]
        self.kind = kind
        self.n_envs = n_envs
        self.max_episode_steps = (_default_horizon(kind)
                                  if max_episode_steps is None
                                  else max_episode_steps)
        self.obs_shape = (obs_dim,)
        self.action_spec = DiscreteSpec(2) if discrete else BoxSpec(1)
        self._discrete = discrete
        self._state = np.zeros((n_envs, state_w), np.float32)
        self._t = np.zeros(n_envs, np.int32)
        self.env_offset = env_offset
        self._rng = self._seeded(seed)
        self._reset = getattr(self._lib, f"trpo_native_{kind}_reset")
        self._step = getattr(self._lib, f"trpo_native_{kind}_step")
        self._reset(self._state, self._t, self._rng, n_envs)
        self._init_obs_norm(self.obs_shape, normalize_obs)
        self._obs = self._fold_and_normalize(self._observe())
        self._init_episode_stats(n_envs)

    def _seeded(self, seed: int) -> np.ndarray:
        """The RNG streams of envs ``[env_offset, env_offset + n_envs)``
        of a fleet seeded with ``seed``."""
        n = self.env_offset + self.n_envs
        rng = np.zeros(n, np.uint64)
        self._lib.trpo_native_seed(rng, n, np.uint64(seed))
        return np.ascontiguousarray(rng[self.env_offset:])

    def _observe(self) -> np.ndarray:
        if self.kind == "cartpole":
            return self._state.copy()
        theta, theta_dot = self._state[:, 0], self._state[:, 1]
        return np.stack([np.cos(theta), np.sin(theta), theta_dot],
                        axis=1).astype(np.float32)

    def host_step(self, actions: np.ndarray):
        """Step every env (auto-reset inside). Returns ``(next_obs,
        rewards, terminated, truncated, final_obs)``; ``final_obs`` is the
        observation before the reset."""
        return self.host_step_slice(actions, 0, self.n_envs)

    def host_step_slice(self, actions: np.ndarray, lo: int, hi: int):
        """Step envs ``[lo, hi)`` only: row slices of the state, counter
        and RNG arrays are contiguous views the C++ steps in place."""
        m = hi - lo
        acts = np.ascontiguousarray(
            np.asarray(actions).reshape(m),
            np.int32 if self._discrete else np.float32)
        next_obs = np.empty((m, self.obs_shape[0]), np.float32)
        final_obs = np.empty_like(next_obs)
        rewards = np.empty(m, np.float32)
        terminated = np.empty(m, np.uint8)
        truncated = np.empty(m, np.uint8)
        self._step(self._state[lo:hi], self._t[lo:hi], self._rng[lo:hi],
                   acts, np.int32(m), np.int32(self.max_episode_steps),
                   next_obs, final_obs, rewards, terminated, truncated)
        terminated = terminated.astype(bool)
        truncated = truncated.astype(bool)
        self._update_episode_stats_slice(
            rewards, np.logical_or(terminated, truncated), lo, hi)
        next_obs, final_obs = self._fold_and_normalize_slice(
            next_obs, lo, hi, extra=final_obs)
        self._obs[lo:hi] = next_obs
        return next_obs, rewards, terminated, truncated, final_obs

    def reset_all(self, seed=None) -> np.ndarray:
        """Hard-reset every env (``seed`` reseeds the per-env streams);
        returns a copy of the new observations."""
        if seed is not None:
            self._rng[:] = self._seeded(seed)
        self._reset(self._state, self._t, self._rng, self.n_envs)
        self._obs = self._fold_and_normalize(self._observe())
        self._running_returns[:] = 0.0
        self._running_lengths[:] = 0
        return self._obs.copy()

    def current_obs(self) -> np.ndarray:
        """A copy: group stepping updates the cache in place."""
        return self._obs.copy()

    def close(self):
        pass

    def env_state_snapshot(self) -> dict:
        """The whole simulator state (state, step counters, per-env RNG
        streams, episode counters, observation cache): a restore resumes
        bitwise."""
        snap = {
            "kind": self.kind,
            "state": self._state.copy(),
            "t": self._t.copy(),
            "rng": self._rng.copy(),
            "obs": self._obs.copy(),
            **self._episode_stats_snapshot(),
        }
        if self.has_obs_norm:
            snap["raw_obs"] = self._raw_obs.copy()
        return snap

    def env_state_restore(self, snap: dict) -> None:
        if snap.get("kind") != self.kind:
            raise ValueError(
                f"snapshot is for native env {snap.get('kind')!r}, this "
                f"adapter is {self.kind!r}")
        state = np.asarray(snap["state"])
        if state.shape[0] != self.n_envs:
            raise ValueError(
                f"snapshot holds {state.shape[0]} envs, this adapter has "
                f"{self.n_envs} — resume with the same n_envs (fleet "
                "presets pin the width via fleet_n_envs)")
        if state.shape != self._state.shape:
            raise ValueError(
                f"snapshot state layout {state.shape} does not match this "
                f"{self.kind!r} adapter's {self._state.shape}")
        if self.has_obs_norm and "raw_obs" not in snap:
            raise ValueError(
                "snapshot was taken without normalize_obs; resume with the "
                "same normalize_obs setting")
        self._state[:] = state
        self._t[:] = snap["t"]
        self._rng[:] = snap["rng"]
        self._obs = np.asarray(snap["obs"]).copy()
        if self.has_obs_norm:
            self._raw_obs = np.asarray(snap["raw_obs"]).copy()
        self._episode_stats_restore(snap)
