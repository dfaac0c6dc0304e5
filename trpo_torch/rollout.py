"""On-device rollout collection (counterpart: ``trpo_tpu/rollout.py``,
the device path).

A Python loop over time of a batched env+policy step with auto-reset,
producing fixed ``(T, N, ...)`` tensors: episodes pack contiguously with
explicit ``terminated``/``done`` flags, ``next_obs`` is taken before the
reset (so a truncated step bootstraps through the critic), and the running
episode return and length ride the carry across iterations.

Time-chunked rollouts (``cfg.rollout_chunk``): :func:`device_rollout`
with ``chunk`` and :class:`ChunkedRollout` run the same step body over
``n_steps // chunk`` chunks with the carry threaded through each chunk
boundary, so they are bit-exact against the unchunked rollout: the same
noise in the same step order through the same ops. ``ChunkedRollout``
also streams the chunks one at a time (:meth:`ChunkedRollout.iter_chunks`),
so a consumer holds one ``(chunk, N, ...)`` emission at a time.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from trpo_torch.models.policy import Policy
from trpo_torch.ops.flat import tree_map

__all__ = ["ChunkedRollout", "Trajectory", "device_rollout",
           "init_env_states"]


class Trajectory(NamedTuple):
    """Fixed-shape ``(T, N, ...)`` rollout tensors (time-major)."""
    obs: torch.Tensor             # (T, N, obs_dim) — s_t
    actions: torch.Tensor         # (T, N, A) float, or (T, N) int64
    rewards: torch.Tensor         # (T, N)
    terminated: torch.Tensor      # (T, N) bool — terminal state at t
    done: torch.Tensor            # (T, N) bool — terminated OR truncated
    old_dist: Any                 # dist params dict, each (T, N, ...)
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


def _rollout_steps(env, policy: Policy, params, carry, generator,
                   n_steps: int, action_noise: Optional[torch.Tensor],
                   deterministic: bool = False):
    """``n_steps`` env+policy steps from ``carry``; returns ``(new_carry,
    Trajectory)`` of ``(n_steps, N, ...)`` tensors. ``deterministic``
    takes the distribution's mode instead of a sample."""
    states, obs, ep_ret, ep_len = carry
    n = obs.shape[0]
    steps = []
    with torch.no_grad():
        for t in range(n_steps):
            dist = policy.apply(params, obs)
            if deterministic:
                actions = policy.dist.mode(dist)
            else:
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
            steps.append((obs, actions, rewards, terminated, done, dist,
                          next_obs, ep_ret, ep_len))
            reset_states, reset_obs = env.reset(n, generator)
            sel = lambda a, b: torch.where(  # noqa: E731
                done.reshape((-1,) + (1,) * (a.ndim - 1)), a, b
            )
            states = tree_map(sel, reset_states, new_states)
            obs = sel(reset_obs, next_obs)
            ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
            ep_len = torch.where(done, torch.zeros_like(ep_len), ep_len)
    cols = list(zip(*steps))
    stack = lambda xs: torch.stack(list(xs))  # noqa: E731
    traj = Trajectory(
        obs=stack(cols[0]), actions=stack(cols[1]), rewards=stack(cols[2]),
        terminated=stack(cols[3]), done=stack(cols[4]),
        old_dist={k: stack(d[k] for d in cols[5]) for k in cols[5][0]},
        next_obs=stack(cols[6]), episode_return=stack(cols[7]),
        episode_length=stack(cols[8]),
    )
    return (states, obs, ep_ret, ep_len), traj


def _concat(parts):
    """Trajectories of consecutive chunks joined along time."""
    if len(parts) == 1:
        return parts[0]
    return tree_map(lambda *xs: torch.cat(xs, dim=0), *parts)


def device_rollout(env, policy: Policy, params, carry, generator,
                   n_steps: int, action_noise: Optional[torch.Tensor] = None,
                   chunk: Optional[int] = None, deterministic: bool = False):
    """Collect ``n_steps × N`` transitions; returns ``(new_carry,
    Trajectory)``. ``action_noise`` (T, N, ...) passes pre-drawn noise for
    the action samples (standard normals for the Gaussian, standard Gumbel
    draws for the categorical); otherwise they and the reset perturbations
    come from ``generator``. ``chunk`` (a divisor of ``n_steps``) runs the
    rollout in time-chunks, bit-exact against ``chunk=None``.
    ``deterministic`` acts with the distribution's mode (greedy
    evaluation); resets still draw from ``generator``."""
    if chunk is None or chunk == n_steps:
        return _rollout_steps(env, policy, params, carry, generator, n_steps,
                              action_noise, deterministic)
    return ChunkedRollout(env, policy, chunk)(params, carry, generator,
                                              n_steps, action_noise,
                                              deterministic)


class ChunkedRollout:
    """A rollout driven chunk by chunk: ``n_steps // chunk`` calls of the
    step body over ``chunk`` steps each, the carry threaded across."""

    def __init__(self, env, policy: Policy, chunk: int):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.env, self.policy, self.chunk = env, policy, chunk

    def iter_chunks(self, params, carry, generator, n_steps: int,
                    action_noise: Optional[torch.Tensor] = None,
                    deterministic: bool = False):
        """Yield ``(carry_after, Trajectory_chunk)`` per chunk, each
        trajectory ``(chunk, N, ...)``; the last carry is the rollout's."""
        c = self.chunk
        if n_steps < 1 or n_steps % c:
            raise ValueError(
                f"rollout chunk ({c}) must divide the steps per rollout "
                f"({n_steps}) — pad batch_timesteps or pick a divisor"
            )
        for i in range(n_steps // c):
            noise = (None if action_noise is None
                     else action_noise[i * c:(i + 1) * c])
            carry, traj = _rollout_steps(self.env, self.policy, params, carry,
                                         generator, c, noise, deterministic)
            yield carry, traj

    def __call__(self, params, carry, generator, n_steps: int,
                 action_noise: Optional[torch.Tensor] = None,
                 deterministic: bool = False):
        """The whole ``(T, N, ...)`` trajectory, assembled from the
        chunks; returns ``(new_carry, Trajectory)``."""
        parts = []
        for carry, traj in self.iter_chunks(params, carry, generator,
                                            n_steps, action_noise,
                                            deterministic):
            parts.append(traj)
        return carry, _concat(parts)
