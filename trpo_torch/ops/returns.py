"""Discounted returns and GAE over ``(T, N)`` tensors (counterpart:
``trpo_tpu/ops/returns.py``).

Both reduce to the reverse affine scan of ``ops/reverse_scan.py``, with the
discount zeroed across episode boundaries so nothing leaks between
episodes packed into one fixed-length tensor.
"""

from __future__ import annotations

import torch

from trpo_torch.ops.reverse_scan import reverse_affine_scan

__all__ = ["discounted_returns_segmented", "gae_from_next_values"]


def discounted_returns_segmented(rewards: torch.Tensor, dones: torch.Tensor,
                                 gamma: float) -> torch.Tensor:
    """Per-step discounted return; ``dones`` marks the last step of an
    episode and cuts the discount there."""
    rewards = rewards.float()
    gammas = gamma * (1.0 - dones.float())
    return reverse_affine_scan(gammas, rewards)


def gae_from_next_values(
    rewards: torch.Tensor,
    values: torch.Tensor,
    next_values: torch.Tensor,
    terminated: torch.Tensor,
    done: torch.Tensor,
    gamma: float,
    lam: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """GAE(λ) with explicit successor values and split terminated/done
    masks: ``terminated`` drops the bootstrap ``γ·V(s')``; ``done`` (every
    episode end, truncations included) cuts the λ-accumulation, so a
    truncated step still bootstraps through ``next_values``.

    Returns ``(advantages, value_targets)``, both shaped like ``rewards``."""
    terminated = terminated.to(rewards.dtype)
    done = done.to(rewards.dtype)
    deltas = rewards + gamma * (1.0 - terminated) * next_values - values
    adv = reverse_affine_scan(
        (gamma * lam * (1.0 - done)).contiguous(), deltas.contiguous()
    )
    return adv, adv + values
