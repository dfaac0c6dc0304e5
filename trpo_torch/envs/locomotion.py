"""Batched continuous-control locomotion envs (counterpart:
``trpo_tpu/envs/locomotion.py``).

A damped mass-spring chain driven by per-mass forces, rewarded for forward
velocity minus a control cost, at the HalfCheetah (17 obs / 6 act) and
Humanoid (376 obs / 17 act) widths. The state is batched over envs:
``pos``/``vel`` are ``(N, n)`` tensors, ``t`` is ``(N,)``.

The observation is ``[spring extensions, velocities] @ Wᵀ`` with a fixed
row-normalized projection ``W`` that the reference draws from
``jax.random.key(7)``. Torch cannot regenerate that draw, so the port ships
it as package data (``envs/data/projection_<obs>x<base>.npy``), drawn once
from the reference; a test holds the files against a fresh draw.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from trpo_torch.models.policy import BoxSpec

__all__ = ["ChainLocomotion", "ChainState", "HalfCheetahSim", "HumanoidSim",
           "projection_path"]

_DATA = Path(__file__).resolve().parent / "data"


def projection_path(obs_dim: int, base_dim: int) -> Path:
    return _DATA / f"projection_{obs_dim}x{base_dim}.npy"


class ChainState(NamedTuple):
    pos: torch.Tensor  # (N, n) absolute mass positions
    vel: torch.Tensor  # (N, n) velocities
    t: torch.Tensor    # (N,) int32 step counter


class ChainLocomotion:
    """N coupled masses on a line; action = per-mass force in [-1, 1].

    Semi-implicit Euler: ``acc = -k·(L q) - c·v + gear·clip(a)``,
    ``v' = v + dt·acc``, ``q' = q + dt·v'``. Reward = mean forward velocity
    − ctrl_cost·mean(a²). No termination; episodes truncate at
    ``max_episode_steps``."""

    spring_k = 4.0
    damping = 1.0
    gear = 2.0
    dt = 0.05
    ctrl_cost = 0.1

    def __init__(self, n_masses: int = 6, obs_dim: int = 17,
                 max_episode_steps: int = 500,
                 device: Optional[torch.device] = None):
        if n_masses < 2:
            raise ValueError("need at least 2 masses for a chain")
        self.n_masses = n_masses
        self.obs_dim = obs_dim
        self.max_episode_steps = max_episode_steps
        self.obs_shape = (obs_dim,)
        self.action_spec = BoxSpec(n_masses)
        path = projection_path(obs_dim, 2 * n_masses - 1)
        if not path.exists():
            raise NotImplementedError(
                f"no shipped observation projection for obs_dim={obs_dim}, "
                f"n_masses={n_masses} ({path.name}); the port ships the "
                "halfcheetah-sim and humanoid-sim projections"
            )
        self.device = torch.device(device if device is not None else "cpu")
        self._w = torch.from_numpy(np.load(path)).to(self.device)

    def reset(self, n_envs: int, generator: Optional[torch.Generator] = None):
        """``n_envs`` fresh chains near rest, perturbed by draws from
        ``generator``."""
        n = self.n_masses
        noise = torch.randn(2, n_envs, n, generator=generator,
                            device=self.device)
        pos = torch.arange(n, dtype=torch.float32, device=self.device) \
            + 0.05 * noise[0]
        vel = 0.05 * noise[1]
        t = torch.zeros(n_envs, dtype=torch.int32, device=self.device)
        state = ChainState(pos, vel, t)
        return state, self.observe(state)

    def observe(self, s: ChainState) -> torch.Tensor:
        ext = torch.diff(s.pos, dim=1) - 1.0
        base = torch.cat([ext, s.vel], dim=1)
        return base @ self._w.T

    def step(self, state: ChainState, action: torch.Tensor):
        """Returns ``(state, obs, reward, terminated, truncated)``."""
        N = state.pos.shape[0]
        a = torch.clamp(action.reshape(N, self.n_masses), -1.0, 1.0)
        ext = torch.diff(state.pos, dim=1) - 1.0
        zero = torch.zeros_like(ext[:, :1])
        f_spring = self.spring_k * (
            torch.cat([ext, zero], dim=1) - torch.cat([zero, ext], dim=1)
        )
        acc = f_spring - self.damping * state.vel + self.gear * a
        vel = state.vel + self.dt * acc
        pos = state.pos + self.dt * vel
        t = state.t + 1
        new_state = ChainState(pos, vel, t)
        reward = vel.mean(dim=1) - self.ctrl_cost * (a * a).mean(dim=1)
        terminated = torch.zeros(N, dtype=torch.bool, device=self.device)
        truncated = t >= self.max_episode_steps
        return new_state, self.observe(new_state), reward, terminated, \
            truncated


class HalfCheetahSim(ChainLocomotion):
    """HalfCheetah-shaped rung: 17-dim obs, 6-dim actions."""

    def __init__(self, max_episode_steps: int = 500, device=None):
        super().__init__(n_masses=6, obs_dim=17,
                         max_episode_steps=max_episode_steps, device=device)


class HumanoidSim(ChainLocomotion):
    """Humanoid-shaped rung: 376-dim obs, 17-dim actions."""

    def __init__(self, max_episode_steps: int = 500, device=None):
        super().__init__(n_masses=17, obs_dim=376,
                         max_episode_steps=max_episode_steps, device=device)
