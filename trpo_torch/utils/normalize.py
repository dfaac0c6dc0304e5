"""Running observation normalization (counterpart:
``trpo_tpu/utils/normalize.py``).

``RunningStats`` is a NamedTuple of device tensors, so it rides
``TrainState.obs_norm`` and is checkpointed with the rest of the state.
``update_stats`` folds a batch in with Chan et al.'s parallel merge in f32;
``normalize`` is ``(obs − mean) / std`` clipped to ±``clip``, and the
identity while no data has been folded in. ``update_stats(..., group=g)``
folds in the batch of every rank of ``g`` (its count, mean and squared
deviations all-reduced), so every rank keeps the same statistics.

The agent normalizes the rollout and the update's replay with the
statistics as of the start of an iteration (so the acting distribution and
``old_dist`` come from identical inputs), then folds the iteration's raw
observations in for the next one.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from trpo_torch.ops.allreduce import all_sum

__all__ = ["RunningStats", "init_stats", "normalize", "update_stats"]


class RunningStats(NamedTuple):
    count: torch.Tensor  # f32 scalar: total weight folded in so far
    mean: torch.Tensor   # (*shape,)
    m2: torch.Tensor     # (*shape,): sum of squared deviations


def init_stats(shape: Tuple[int, ...], device=None) -> RunningStats:
    return RunningStats(
        count=torch.zeros((), device=device),
        mean=torch.zeros(shape, device=device),
        m2=torch.zeros(shape, device=device),
    )


def update_stats(stats: RunningStats, obs: torch.Tensor,
                 group=None) -> RunningStats:
    """Fold a batch (leading axes = batch) into ``stats`` in one pass; the
    batch of every rank of ``group`` when one is given."""
    batch_axes = tuple(range(obs.ndim - stats.mean.ndim))
    obs = obs.float()
    n = 1
    for a in batch_axes:
        n *= obs.shape[a]
    n_b = torch.tensor(float(n), device=obs.device)
    if group is None:
        mean_b = obs.mean(dim=batch_axes)
        m2_b = ((obs - mean_b) ** 2).sum(dim=batch_axes)
    else:
        n_b = all_sum(n_b, group)
        mean_b = all_sum(obs.sum(dim=batch_axes), group) / n_b
        m2_b = all_sum(((obs - mean_b) ** 2).sum(dim=batch_axes), group)

    delta = mean_b - stats.mean
    tot = stats.count + n_b
    new_mean = stats.mean + delta * (n_b / tot)
    new_m2 = stats.m2 + m2_b + delta ** 2 * (stats.count * n_b / tot)
    return RunningStats(count=tot, mean=new_mean, m2=new_m2)


def normalize(stats: RunningStats, obs: torch.Tensor,
              clip: float = 10.0) -> torch.Tensor:
    """``(obs − mean) / std`` clipped to ±``clip``; ``obs`` unchanged
    while ``count == 0``."""
    var = stats.m2 / torch.clamp(stats.count, min=1.0)
    std = torch.sqrt(var + 1e-8)
    out = torch.clamp((obs - stats.mean) / std, -clip, clip)
    return torch.where(stats.count > 0.0, out, obs)
