"""On-device rollout collection (counterpart: ``trpo_tpu/rollout.py``,
the device path).

A Python loop over time of a batched env+policy step with auto-reset,
producing fixed ``(T, N, ...)`` tensors: episodes pack contiguously with
explicit ``terminated``/``done`` flags, ``next_obs`` is taken before the
reset (so a truncated step bootstraps through the critic), and the running
episode return and length ride the carry across iterations.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from trpo_torch.models.policy import Policy
from trpo_torch.ops.flat import tree_map

__all__ = ["Trajectory", "device_rollout", "init_env_states"]


class Trajectory(NamedTuple):
    """Fixed-shape ``(T, N, ...)`` rollout tensors (time-major)."""
    obs: torch.Tensor             # (T, N, obs_dim) — s_t
    actions: torch.Tensor         # (T, N, A)
    rewards: torch.Tensor         # (T, N)
    terminated: torch.Tensor      # (T, N) bool — terminal state at t
    done: torch.Tensor            # (T, N) bool — terminated OR truncated
    old_dist: Any                 # {"mean", "log_std"}, each (T, N, A)
    next_obs: torch.Tensor        # (T, N, obs_dim) — s_{t+1} BEFORE reset
    episode_return: torch.Tensor  # (T, N) running return, valid where done
    episode_length: torch.Tensor  # (T, N) running length, valid where done


def init_env_states(env, n_envs: int, generator: torch.Generator):
    """``(states, obs, episode_return, episode_length)`` for ``n_envs``
    fresh envs — the rollout carry."""
    states, obs = env.reset(n_envs, generator)
    return (
        states,
        obs,
        torch.zeros(n_envs, device=obs.device),
        torch.zeros(n_envs, dtype=torch.int32, device=obs.device),
    )


def device_rollout(env, policy: Policy, params, carry, generator,
                   n_steps: int, action_noise: Optional[torch.Tensor] = None):
    """Collect ``n_steps × N`` transitions; returns ``(new_carry,
    Trajectory)``. ``action_noise`` (T, N, A) passes pre-drawn standard
    normals for the action samples; otherwise they and the reset
    perturbations come from ``generator``."""
    states, obs, ep_ret, ep_len = carry
    n = obs.shape[0]
    steps = []
    with torch.no_grad():
        for t in range(n_steps):
            dist = policy.apply(params, obs)
            actions = policy.dist.sample(
                dist,
                noise=None if action_noise is None else action_noise[t],
                generator=generator,
            )
            new_states, next_obs, rewards, terminated, truncated = env.step(
                states, actions
            )
            done = terminated | truncated
            ep_ret = ep_ret + rewards
            ep_len = ep_len + 1
            steps.append((obs, actions, rewards, terminated, done,
                          dist["mean"], dist["log_std"], next_obs, ep_ret,
                          ep_len))
            reset_states, reset_obs = env.reset(n, generator)
            sel = lambda a, b: torch.where(  # noqa: E731
                done.reshape((-1,) + (1,) * (a.ndim - 1)), a, b
            )
            states = tree_map(sel, reset_states, new_states)
            obs = sel(reset_obs, next_obs)
            ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
            ep_len = torch.where(done, torch.zeros_like(ep_len), ep_len)
    cols = [torch.stack(c) for c in zip(*steps)]
    traj = Trajectory(
        obs=cols[0], actions=cols[1], rewards=cols[2], terminated=cols[3],
        done=cols[4], old_dist={"mean": cols[5], "log_std": cols[6]},
        next_obs=cols[7], episode_return=cols[8], episode_length=cols[9],
    )
    return (states, obs, ep_ret, ep_len), traj
