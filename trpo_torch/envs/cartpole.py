"""Batched CartPole on the device (counterpart:
``trpo_tpu/envs/cartpole.py``).

The classic cart-pole balancing task (Barto, Sutton & Anderson 1983) with
gym's constants and termination bounds, Euler-integrated. The state is
batched over envs: every field is an ``(N,)`` tensor. Episodes cap at 500
steps by default (the v1 convention).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from trpo_torch.models.policy import DiscreteSpec

__all__ = ["CartPole", "CartPoleState"]


class CartPoleState(NamedTuple):
    x: torch.Tensor          # (N,) cart position
    x_dot: torch.Tensor
    theta: torch.Tensor      # pole angle (rad)
    theta_dot: torch.Tensor
    t: torch.Tensor          # (N,) int32 step index within the episode


class CartPole:
    obs_shape = (4,)
    action_spec = DiscreteSpec(2)

    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    length = 0.5            # half the pole length
    force_mag = 10.0
    tau = 0.02              # integration timestep
    x_threshold = 2.4
    theta_threshold = 12 * 2 * math.pi / 360

    def __init__(self, max_episode_steps: int = 500,
                 device: Optional[torch.device] = None):
        self.max_episode_steps = max_episode_steps
        self.device = torch.device(device if device is not None else "cpu")

    def reset(self, n_envs: int, generator: Optional[torch.Generator] = None):
        """``n_envs`` fresh states, each value uniform in [-0.05, 0.05)."""
        u = torch.rand(4, n_envs, generator=generator, device=self.device)
        vals = -0.05 + 0.1 * u
        state = CartPoleState(vals[0], vals[1], vals[2], vals[3],
                              torch.zeros(n_envs, dtype=torch.int32,
                                          device=self.device))
        return state, self.observe(state)

    def observe(self, s: CartPoleState) -> torch.Tensor:
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=1)

    def step(self, state: CartPoleState, action: torch.Tensor):
        """One Euler step for actions in {0, 1}. Returns ``(state, obs,
        reward, terminated, truncated)``."""
        force = torch.where(action.reshape(-1) == 1, self.force_mag,
                            -self.force_mag)
        cos_t, sin_t = torch.cos(state.theta), torch.sin(state.theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length

        temp = (
            force + polemass_length * state.theta_dot ** 2 * sin_t
        ) / total_mass
        theta_acc = (self.gravity * sin_t - cos_t * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * cos_t ** 2
                           / total_mass)
        )
        x_acc = temp - polemass_length * theta_acc * cos_t / total_mass

        x = state.x + self.tau * state.x_dot
        x_dot = state.x_dot + self.tau * x_acc
        theta = state.theta + self.tau * state.theta_dot
        theta_dot = state.theta_dot + self.tau * theta_acc
        t = state.t + 1

        new_state = CartPoleState(x, x_dot, theta, theta_dot, t)
        terminated = (torch.abs(x) > self.x_threshold) | (
            torch.abs(theta) > self.theta_threshold)
        truncated = (t >= self.max_episode_steps) & ~terminated
        reward = torch.ones_like(x)
        return new_state, self.observe(new_state), reward, terminated, \
            truncated
