"""Discounted returns and GAE over ``(T, N)`` tensors (counterpart:
``trpo_tpu/ops/returns.py``).

All reduce to the reverse affine scan of ``ops/reverse_scan.py`` (the K2
kernel on a CUDA tensor, its plain version on a CPU tensor), with the
discount zeroed across episode boundaries so nothing leaks between
episodes packed into one fixed-length tensor. Trailing axes beyond
``(T, N)`` are folded into N for the scan.
"""

from __future__ import annotations

import torch

from trpo_torch.ops.reverse_scan import reverse_affine_scan

__all__ = ["discount", "discounted_returns_segmented", "gae_advantages",
           "gae_from_next_values"]


def _scan(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reverse affine scan over axis 0 of a ``(T, ...)`` tensor."""
    shape = x.shape
    y = reverse_affine_scan(coeffs.reshape(shape[0], -1).contiguous(),
                            x.reshape(shape[0], -1).contiguous())
    return y.reshape(shape)


def discount(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """``y_t = Σ_k γ^k x_{t+k}`` along axis 0: the reference's
    ``scipy.signal.lfilter([1], [1, -γ], x[::-1])[::-1]``, as a scan."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.float()
    return discounted_returns_segmented(x, torch.zeros_like(x), gamma)


def discounted_returns_segmented(rewards: torch.Tensor, dones: torch.Tensor,
                                 gamma: float) -> torch.Tensor:
    """Per-step discounted return; ``dones`` marks the last step of an
    episode and cuts the discount there."""
    rewards = rewards.float()
    gammas = gamma * (1.0 - dones.float())
    return _scan(gammas, rewards)


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


def gae_advantages(rewards: torch.Tensor, values: torch.Tensor,
                   dones: torch.Tensor, last_values: torch.Tensor,
                   gamma: float, lam: float,
                   terminated: torch.Tensor = None):
    """GAE(λ) over ``(T, N)`` tensors with successor values taken from
    ``values`` shifted one step and ``last_values`` (``(N,)``) after step
    ``T − 1``. ``terminated`` defaults to ``dones`` (every boundary
    terminal). Returns ``(advantages, value_targets)``."""
    dones = dones.to(rewards.dtype)
    if terminated is None:
        terminated = dones
    next_values = torch.cat([values[1:], last_values[None]], dim=0)
    return gae_from_next_values(rewards, values, next_values, terminated,
                                dones, gamma, lam)
