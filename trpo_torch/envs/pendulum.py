"""Batched Pendulum swing-up on the device (counterpart:
``trpo_tpu/envs/pendulum.py``).

State (θ, θ̇), observation (cos θ, sin θ, θ̇), torque clipped to ±2, cost
``θ² + 0.1·θ̇² + 0.001·u²``. Every state field is an ``(N,)`` tensor.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from trpo_torch.models.policy import BoxSpec

__all__ = ["Pendulum", "PendulumState"]


class PendulumState(NamedTuple):
    theta: torch.Tensor      # (N,)
    theta_dot: torch.Tensor  # (N,)
    t: torch.Tensor          # (N,) int32


def _angle_normalize(x):
    return ((x + math.pi) % (2 * math.pi)) - math.pi


class Pendulum:
    obs_shape = (3,)
    action_spec = BoxSpec(1)

    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    l = 1.0  # noqa: E741

    def __init__(self, max_episode_steps: int = 200,
                 device: Optional[torch.device] = None):
        self.max_episode_steps = max_episode_steps
        self.device = torch.device(device if device is not None else "cpu")

    def reset(self, n_envs: int, generator: Optional[torch.Generator] = None):
        """θ uniform in [-π, π), θ̇ uniform in [-1, 1)."""
        u = torch.rand(2, n_envs, generator=generator, device=self.device)
        state = PendulumState(
            -math.pi + 2 * math.pi * u[0], -1.0 + 2.0 * u[1],
            torch.zeros(n_envs, dtype=torch.int32, device=self.device))
        return state, self.observe(state)

    def observe(self, s: PendulumState) -> torch.Tensor:
        return torch.stack(
            [torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=1)

    def step(self, state: PendulumState, action: torch.Tensor):
        """Returns ``(state, obs, reward, terminated, truncated)``."""
        u = torch.clamp(action.reshape(-1), -self.max_torque,
                        self.max_torque)
        th = _angle_normalize(state.theta)
        cost = th ** 2 + 0.1 * state.theta_dot ** 2 + 0.001 * u ** 2

        new_theta_dot = state.theta_dot + (
            3.0 * self.g / (2.0 * self.l) * torch.sin(state.theta)
            + 3.0 / (self.m * self.l ** 2) * u
        ) * self.dt
        new_theta_dot = torch.clamp(new_theta_dot, -self.max_speed,
                                    self.max_speed)
        new_theta = state.theta + new_theta_dot * self.dt
        t = state.t + 1

        new_state = PendulumState(new_theta, new_theta_dot, t)
        terminated = torch.zeros_like(t, dtype=torch.bool)
        truncated = t >= self.max_episode_steps
        return new_state, self.observe(new_state), -cost, terminated, \
            truncated
