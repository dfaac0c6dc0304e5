"""A scripted chain env for tests (counterpart: ``trpo_tpu/envs/fake.py``).

The observation is a one-hot of the position, the reward is
``position · reward_scale`` when action 1 is taken (else 0), the position
advances one cell a step (capped at the last), and the episode terminates
after ``chain_len`` steps. Nothing is random, so a rollout's returns and
advantages can be worked out by hand. Batched like the port's other
device envs: every state field is an ``(N,)`` tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trpo_torch.models.policy import DiscreteSpec

__all__ = ["FakeEnv", "FakeState"]


class FakeState(NamedTuple):
    pos: torch.Tensor  # (N,) int32
    t: torch.Tensor    # (N,) int32


class FakeEnv:
    def __init__(self, chain_len: int = 5, reward_scale: float = 1.0,
                 device: Optional[torch.device] = None):
        self.chain_len = chain_len
        self.reward_scale = reward_scale
        self.obs_shape = (chain_len,)
        self.action_spec = DiscreteSpec(2)
        self.max_episode_steps = chain_len
        self.device = torch.device(device if device is not None else "cpu")

    def reset(self, n_envs: int, generator: Optional[torch.Generator] = None):
        zero = torch.zeros(n_envs, dtype=torch.int32, device=self.device)
        state = FakeState(pos=zero, t=zero.clone())
        return state, self.observe(state)

    def observe(self, s: FakeState) -> torch.Tensor:
        return torch.nn.functional.one_hot(
            s.pos.long(), self.chain_len).float()

    def step(self, state: FakeState, action: torch.Tensor):
        """Returns ``(state, obs, reward, terminated, truncated)``."""
        action = action.reshape(-1)
        reward = torch.where(action == 1,
                             state.pos.float() * self.reward_scale,
                             torch.zeros_like(state.pos, dtype=torch.float32))
        pos = torch.clamp(state.pos + 1, max=self.chain_len - 1)
        t = state.t + 1
        new_state = FakeState(pos=pos, t=t)
        terminated = t >= self.chain_len
        truncated = torch.zeros_like(terminated)
        return new_state, self.observe(new_state), reward, terminated, \
            truncated
