"""N gymnasium envs on the host behind one batched interface (counterpart:
``trpo_tpu/envs/gym_adapter.py``).

:class:`GymVecEnv` steps its envs one by one on the host, clips
continuous actions to the action Box, auto-resets finished envs and
returns the true pre-reset successor (``final_obs``) beside the
post-reset observation, so a truncated step bootstraps through the
critic. Episode counters (``envs/episode_stats.EpisodeStatsMixin``) and
the shared running observation normalization
(``envs/obs_norm.ObsNormMixin``) are those of ``envs/native.py``.

gymnasium is imported inside the constructor. Without it, or without an
id's simulator backend (``ale-py`` for ``ALE/*``, ``mujoco`` for the
MuJoCo ids), construction raises the reference's actionable error; the
port never carries on with another env instead. The card's machine has
neither gymnasium nor MuJoCo, so there the ``gym:`` family fails this
way.
"""

from __future__ import annotations

import numpy as np

from trpo_torch.envs.episode_stats import EpisodeStatsMixin
from trpo_torch.envs.gym_state import restore_one, snapshot_one
from trpo_torch.envs.obs_norm import ObsNormMixin
from trpo_torch.models.policy import BoxSpec, DiscreteSpec

__all__ = ["GymVecEnv"]


class GymVecEnv(EpisodeStatsMixin, ObsNormMixin):
    """N synchronous gymnasium envs with explicit pre-reset final obs."""

    def __init__(self, env_id: str, n_envs: int = 8, seed: int = 0,
                 normalize_obs: bool = False, env_offset: int = 0,
                 **kwargs):
        """``env_offset``: these envs are ``[env_offset, env_offset +
        n_envs)`` of a wider fleet (a data rank's slice on a mesh), so env
        ``i`` is seeded as that fleet's env ``env_offset + i``."""
        try:
            import gymnasium
        except ImportError as e:
            raise ImportError(
                "gymnasium is required for gym:* envs; use the device envs "
                "('cartpole', 'pendulum') or the native: envs otherwise"
            ) from e
        self.env_id = env_id
        self.n_envs = n_envs
        self.env_offset = env_offset
        seed = seed + env_offset
        self.envs = []
        try:
            for _ in range(n_envs):
                self.envs.append(gymnasium.make(env_id, **kwargs))
        except Exception as e:
            for env in self.envs:
                try:
                    env.close()
                except Exception:
                    pass
            # only a missing backend is re-diagnosed; a typo'd id or a bad
            # kwarg keeps gymnasium's own error
            err_mod = getattr(gymnasium, "error", None)
            dep_types = tuple(
                t for t in (ImportError,
                            getattr(err_mod, "DependencyNotInstalled", None),
                            getattr(err_mod, "NamespaceNotFound", None))
                if isinstance(t, type))
            if not isinstance(e, dep_types):
                raise
            raise RuntimeError(
                f"could not construct gym env {env_id!r}: {e}\n"
                "The id's simulator backend is likely not installed "
                "(ALE/* needs the 'ale-py' package; MuJoCo ids need "
                "'mujoco'). Install it, or use a device stand-in: "
                "'pong-sim' (84x84x4 pixel rung) for ALE/Pong, "
                "'humanoid-sim'/'halfcheetah-sim' for the MuJoCo rungs."
            ) from e
        single = self.envs[0]
        self.obs_shape = tuple(single.observation_space.shape)
        space = single.action_space
        if hasattr(space, "n"):
            self.action_spec = DiscreteSpec(int(space.n))
            self._continuous = False
        else:
            self.action_spec = BoxSpec(int(space.shape[0]))
            self._continuous = True
            self._act_low = np.asarray(space.low, np.float32)
            self._act_high = np.asarray(space.high, np.float32)
        self._init_obs_norm(self.obs_shape, normalize_obs)
        self._obs = self._fold_and_normalize(np.stack(
            [env.reset(seed=seed + i)[0] for i, env in enumerate(self.envs)]))
        self._init_episode_stats(n_envs)

    def host_step(self, actions: np.ndarray):
        """Step every env; auto-reset finished ones. Returns ``(next_obs,
        rewards, terminated, truncated, final_obs)``."""
        return self.host_step_slice(actions, 0, self.n_envs)

    def host_step_slice(self, actions: np.ndarray, lo: int, hi: int):
        """Step envs ``[lo, hi)`` only (group stepping)."""
        m = hi - lo
        next_obs = np.empty((m,) + self._obs.shape[1:], self._obs.dtype)
        final_obs = np.empty_like(next_obs)
        rewards = np.zeros(m, np.float32)
        terminated = np.zeros(m, bool)
        truncated = np.zeros(m, bool)
        for j, env in enumerate(self.envs[lo:hi]):
            a = actions[j]
            if self._continuous:
                a = np.clip(a, self._act_low, self._act_high)
            obs_j, r, term, trunc, _ = env.step(a)
            rewards[j] = r
            terminated[j] = term
            truncated[j] = trunc
            final_obs[j] = obs_j
            if term or trunc:
                obs_j, _ = env.reset()
            next_obs[j] = obs_j
        self._update_episode_stats_slice(
            rewards, np.logical_or(terminated, truncated), lo, hi)
        next_obs, final_obs = self._fold_and_normalize_slice(
            next_obs, lo, hi, extra=final_obs)
        self._obs[lo:hi] = next_obs
        return next_obs, rewards, terminated, truncated, final_obs

    def reset_all(self, seed=None) -> np.ndarray:
        """Hard-reset every env (``seed`` reseeds env ``i`` with
        ``seed + env_offset + i``); returns a copy of the new
        observations."""
        if seed is not None:
            seed = seed + self.env_offset
        self._obs = self._fold_and_normalize(np.stack(
            [env.reset(seed=None if seed is None else seed + i)[0]
             for i, env in enumerate(self.envs)]))
        self._running_returns[:] = 0.0
        self._running_lengths[:] = 0
        return self._obs.copy()

    def current_obs(self) -> np.ndarray:
        """A copy: group stepping updates the cache in place."""
        return self._obs.copy()

    def env_state_snapshot(self) -> dict:
        """Episode counters, the observation cache, and each env's
        simulator state where its backend exposes it (``gym_state``)."""
        snap = {
            "env_id": self.env_id,
            "sims": [snapshot_one(env) for env in self.envs],
            "obs": self._obs.copy(),
            **self._episode_stats_snapshot(),
        }
        if self.has_obs_norm:
            snap["raw_obs"] = self._raw_obs.copy()
        return snap

    def env_state_restore(self, snap: dict) -> None:
        if snap.get("env_id") != self.env_id:
            raise ValueError(
                f"snapshot is for {snap.get('env_id')!r}, this adapter is "
                f"{self.env_id!r}")
        if len(snap["sims"]) != self.n_envs:
            raise ValueError(
                f"snapshot holds {len(snap['sims'])} envs, this adapter has "
                f"{self.n_envs} — resume with the same n_envs")
        if self.has_obs_norm and "raw_obs" not in snap:
            raise ValueError(
                "snapshot was taken without normalize_obs; resume with the "
                "same normalize_obs setting")
        reset_obs = {}
        for i, (env, sim) in enumerate(zip(self.envs, snap["sims"])):
            raw = restore_one(env, sim)
            if raw is not None:  # opaque backend: the episode restarts
                reset_obs[i] = raw
        self._obs = np.asarray(snap["obs"]).copy()
        if self.has_obs_norm:
            self._raw_obs = np.asarray(snap["raw_obs"]).copy()
        self._episode_stats_restore(snap)
        for i, raw in reset_obs.items():
            if self.has_obs_norm:
                self._raw_obs[i] = raw
                with self._norm_lock:
                    self._obs[i] = self._apply_norm(raw)
            else:
                self._obs[i] = raw
            self._running_returns[i] = 0.0
            self._running_lengths[i] = 0

    def render_frame(self) -> np.ndarray:
        """An RGB frame of env 0; needs ``render_mode="rgb_array"`` at
        construction."""
        frame = self.envs[0].render()
        if frame is None:
            raise RuntimeError(
                "rendering returned None — construct the adapter with "
                "GymVecEnv(env_id, render_mode='rgb_array') (or pass "
                "render_mode through envs.make('gym:<Id>', "
                "render_mode='rgb_array'))")
        return np.asarray(frame)

    def close(self):
        for env in self.envs:
            env.close()
