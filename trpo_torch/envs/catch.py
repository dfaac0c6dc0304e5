"""Catch rendered as pixels on the device (counterpart:
``trpo_tpu/envs/catch.py``).

The pixel control microbenchmark: a ball falls one row per step, a paddle
on the bottom row moves left, stays or moves right, and the episode ends
when the ball reaches the bottom row with reward +1 if the paddle is under
it, −1 otherwise. Boards render as uint8 images, ``frames`` of them
stacked as channels (newest first): ``CatchPixels(grid=21, cell_px=4,
frames=4)`` is the Nature-DQN input shape, 84×84×4 (the ``"pong-sim"``
registry name).

The state is batched over envs: every field has a leading ``(N,)`` axis.
Resets draw the ball's column from the generator they are given.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trpo_torch.models.policy import DiscreteSpec

__all__ = ["CatchPixels", "CatchState"]


class CatchState(NamedTuple):
    ball_row: torch.Tensor    # (N,) int32, 0 = top
    ball_col: torch.Tensor    # (N,) int32
    paddle_col: torch.Tensor  # (N,) int32, on the bottom row
    t: torch.Tensor           # (N,) int32 step counter
    hist: torch.Tensor        # (N, frames, 3) int32 [ball_row, ball_col,
    #                           paddle_col] of the last `frames` boards,
    #                           newest first


class CatchPixels:
    """``grid×grid`` Catch rendered at ``cell_px`` px/cell, observations
    ``(H, W, frames)`` uint8. Actions: 0 = left, 1 = stay, 2 = right. The
    horizon is fixed (``grid − 1`` steps)."""

    def __init__(self, grid: int = 10, cell_px: int = 4, frames: int = 1,
                 device: Optional[torch.device] = None):
        if frames < 1:
            raise ValueError(f"frames must be >= 1, got {frames}")
        self.grid = grid
        self.cell_px = cell_px
        self.frames = frames
        side = grid * cell_px
        self.obs_shape = (side, side, frames)
        self.action_spec = DiscreteSpec(3)
        self.device = torch.device(device if device is not None else "cpu")

    def reset(self, n_envs: int, generator: Optional[torch.Generator] = None):
        """``n_envs`` fresh boards: the ball on the top row in a uniform
        column, the paddle centred, the history the first board
        repeated."""
        i32 = dict(dtype=torch.int32, device=self.device)
        col = torch.randint(0, self.grid, (n_envs,), generator=generator,
                            device=self.device).to(torch.int32)
        ball_row = torch.zeros(n_envs, **i32)
        paddle = torch.full((n_envs,), self.grid // 2, **i32)
        frame = torch.stack([ball_row, col, paddle], dim=1)
        state = CatchState(ball_row, col, paddle, torch.zeros(n_envs, **i32),
                           frame[:, None, :].repeat(1, self.frames, 1))
        return state, self.observe(state)

    def observe(self, s: CatchState) -> torch.Tensor:
        """The stacked frames, ``(N, H, W, frames)`` uint8."""
        rows = torch.arange(self.grid, dtype=torch.int32, device=self.device)
        hist = s.hist[..., None]                       # (N, F, 3, 1)
        on = lambda k: rows == hist[:, :, k]           # noqa: E731 (N, F, g)
        ball = on(0)[..., :, None] & on(1)[..., None, :]
        paddle = ((rows == self.grid - 1)[:, None]
                  & on(2)[..., None, :])
        cells = ball | paddle                          # (N, F, g, g)
        px = self.cell_px
        img = cells.repeat_interleave(px, dim=2).repeat_interleave(px, dim=3)
        return (img.to(torch.uint8) * 255).permute(0, 2, 3, 1).contiguous()

    def step(self, state: CatchState, action: torch.Tensor):
        """One step for actions in {0, 1, 2}. Returns ``(state, obs,
        reward, terminated, truncated)``."""
        move = action.reshape(-1).to(torch.int32) - 1
        paddle = torch.clamp(state.paddle_col + move, 0, self.grid - 1)
        ball_row = state.ball_row + 1
        frame = torch.stack([ball_row, state.ball_col, paddle], dim=1)
        hist = torch.cat([frame[:, None, :], state.hist[:, :-1]], dim=1)
        new_state = CatchState(ball_row, state.ball_col, paddle,
                               state.t + 1, hist)
        at_bottom = ball_row >= self.grid - 1
        caught = at_bottom & (paddle == state.ball_col)
        one = torch.ones_like(ball_row, dtype=torch.float32)
        reward = torch.where(at_bottom, torch.where(caught, one, -one),
                             torch.zeros_like(one))
        truncated = torch.zeros_like(at_bottom)
        return new_state, self.observe(new_state), reward, at_bottom, \
            truncated
