"""On-device rollout collection (counterpart: ``trpo_tpu/rollout.py``,
the device path).

A Python loop over time of a batched env+policy step with auto-reset,
producing fixed ``(T, N, ...)`` tensors: episodes pack contiguously with
explicit ``terminated``/``done`` flags, ``next_obs`` is taken before the
reset (so a truncated step bootstraps through the critic), and the running
episode return and length ride the carry across iterations.

Observations keep the env's dtype: pixel frames stay uint8 in the
trajectory (a 2,048-step window of 84×84×4 frames is 58 MB as uint8, four
times that as f32) and are cast only inside the policy's and the critic's
forward.

A recurrent policy (one with ``step``, ``models/recurrent.py``) adds its
state ``h`` and a ``prev_done`` flag to the carry: ``h`` threads through
the steps and is zeroed after an episode ends, and the trajectory gains
what the update needs to replay the window — ``reset`` (the state was
zeroed before step ``t``), ``policy_h0`` (the state entering the window)
— and what the critic reads, ``policy_h``/``policy_h_next`` (the state
before and after consuming ``obs[t]``).

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
    obs: torch.Tensor             # (T, N, *obs_shape) — s_t
    actions: torch.Tensor         # (T, N, A) float, or (T, N) int64
    rewards: torch.Tensor         # (T, N)
    terminated: torch.Tensor      # (T, N) bool — terminal state at t
    done: torch.Tensor            # (T, N) bool — terminated OR truncated
    old_dist: Any                 # dist params dict, each (T, N, ...)
    next_obs: torch.Tensor        # (T, N, *obs_shape) — s_{t+1} BEFORE reset
    episode_return: torch.Tensor  # (T, N) running return, valid where done
    episode_length: torch.Tensor  # (T, N) running length, valid where done
    # recurrent policies only (None otherwise)
    reset: Any = None          # (T, N) bool — state zeroed before step t
    policy_h0: Any = None      # (N, S) — state entering the window
    policy_h: Any = None       # (T, N, S) — state entering step t
    policy_h_next: Any = None  # (T, N, S) — state after obs[t] (pre-reset)


def _recurrent(policy) -> bool:
    return hasattr(policy, "step")


def init_env_states(env, n_envs: int, generator: torch.Generator,
                    policy=None):
    """The rollout carry of ``n_envs`` fresh envs: ``(states, obs,
    episode_return, episode_length)``, and for a recurrent ``policy`` its
    zero state and a ``prev_done`` flag (True: the first step starts a
    fresh memory)."""
    states, obs = env.reset(n_envs, generator)
    dev = obs.device
    carry = (
        states,
        obs,
        torch.zeros(n_envs, device=dev),
        torch.zeros(n_envs, dtype=torch.int32, device=dev),
    )
    if policy is not None and _recurrent(policy):
        carry += (policy.initial_state(n_envs, device=dev),
                  torch.ones(n_envs, dtype=torch.bool, device=dev))
    return carry


def _rollout_steps(env, policy: Policy, params, carry, generator,
                   n_steps: int, action_noise: Optional[torch.Tensor],
                   deterministic: bool = False):
    """``n_steps`` env+policy steps from ``carry``; returns ``(new_carry,
    Trajectory)`` of ``(n_steps, N, ...)`` tensors. ``deterministic``
    takes the distribution's mode instead of a sample."""
    recurrent = _recurrent(policy)
    states, obs, ep_ret, ep_len = carry[:4]
    h = prev_done = h_new = None
    if recurrent:
        h0 = h = carry[4]
        prev_done = carry[5]
    n = obs.shape[0]
    steps = []
    with torch.no_grad():
        for t in range(n_steps):
            if recurrent:
                h_new, dist = policy.step(params, h, obs)
            else:
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
                          next_obs, ep_ret, ep_len, prev_done, h, h_new))
            reset_states, reset_obs = env.reset(n, generator)
            sel = lambda a, b: torch.where(  # noqa: E731
                done.reshape((-1,) + (1,) * (a.ndim - 1)), a, b
            )
            states = tree_map(sel, reset_states, new_states)
            obs = sel(reset_obs, next_obs)
            ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
            ep_len = torch.where(done, torch.zeros_like(ep_len), ep_len)
            if recurrent:
                h = torch.where(done[:, None], torch.zeros_like(h_new),
                                h_new)
                prev_done = done
    cols = list(zip(*steps))
    stack = lambda xs: torch.stack(list(xs))  # noqa: E731
    traj = Trajectory(
        obs=stack(cols[0]), actions=stack(cols[1]), rewards=stack(cols[2]),
        terminated=stack(cols[3]), done=stack(cols[4]),
        old_dist={k: stack(d[k] for d in cols[5]) for k in cols[5][0]},
        next_obs=stack(cols[6]), episode_return=stack(cols[7]),
        episode_length=stack(cols[8]),
    )
    new_carry = (states, obs, ep_ret, ep_len)
    if recurrent:
        traj = traj._replace(reset=stack(cols[9]), policy_h0=h0,
                             policy_h=stack(cols[10]),
                             policy_h_next=stack(cols[11]))
        new_carry += (h, prev_done)
    return new_carry, traj


def _concat(parts):
    """Trajectories of consecutive chunks joined along time; the window's
    ``policy_h0`` is the first chunk's."""
    if len(parts) == 1:
        return parts[0]
    h0 = parts[0].policy_h0
    joined = tree_map(lambda *xs: torch.cat(xs, dim=0),
                      *[p._replace(policy_h0=None) for p in parts])
    return joined._replace(policy_h0=h0)


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
