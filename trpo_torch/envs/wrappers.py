"""Device-env wrappers (counterpart: ``trpo_tpu/envs/wrappers.py``).

:class:`MaskObservation` keeps a subset of a 1-D observation's entries: the
standard way to make a fully observable task a POMDP (CartPole with its
velocities hidden needs a policy with memory, ``models/recurrent.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["MaskObservation"]


class MaskObservation:
    """Keep only ``indices`` of a batched 1-D observation; the dynamics are
    untouched. Wraps any port device env (``reset``/``step``/``obs_shape``
    /``action_spec``)."""

    def __init__(self, env, indices: Sequence[int]):
        if len(env.obs_shape) != 1:
            raise ValueError(
                f"MaskObservation needs 1-D observations, got {env.obs_shape}"
            )
        dim = env.obs_shape[0]
        bad = [i for i in indices if not 0 <= i < dim]
        if bad or not indices:
            raise ValueError(
                f"indices {list(indices)} invalid for obs dim {dim}"
            )
        self.env = env
        self.indices = torch.as_tensor(tuple(indices), dtype=torch.long,
                                       device=env.device)
        self.obs_shape: Tuple[int, ...] = (len(indices),)
        self.action_spec = env.action_spec

    def __getattr__(self, name):  # delegate e.g. max_episode_steps, device
        return getattr(self.env, name)

    def reset(self, n_envs: int, generator=None):
        state, obs = self.env.reset(n_envs, generator)
        return state, obs[:, self.indices]

    def step(self, state, action):
        state, obs, reward, terminated, truncated = self.env.step(state,
                                                                  action)
        return state, obs[:, self.indices], reward, terminated, truncated
