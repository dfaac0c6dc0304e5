"""Run-cumulative solver counters that ride ``TrainState.metrics``
(counterpart: ``trpo_tpu/obs/device_metrics.py``).

Five int64 scalars on the agent's device, added to inside every update
from the update's own stats: CG iterations executed, updates whose CG
exited before the budget it solved under, line-search trials, KL
rollbacks and nonfinite-guard trips. They are merged into each stats row
(:func:`metrics_stats`), so they reach the host through the one stats
transfer per chunk that every other stat takes: no extra transfer, and
no host read on the iteration path. Checkpoints carry them; a checkpoint
written without them restores with all five at 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "DeviceMetrics",
    "METRIC_KEYS",
    "init_device_metrics",
    "accumulate_update",
    "metrics_stats",
]


class DeviceMetrics(NamedTuple):
    """Run-cumulative solver counters (int64 device scalars)."""

    cg_iters_total: torch.Tensor          # CG iterations executed
    cg_early_exit_total: torch.Tensor     # updates whose CG exited early
    linesearch_trials_total: torch.Tensor  # backtracking trials evaluated
    rollback_total: torch.Tensor          # KL rollbacks fired
    nan_guard_total: torch.Tensor         # updates with a nonfinite trip


METRIC_KEYS = DeviceMetrics._fields


def init_device_metrics(device) -> DeviceMetrics:
    return DeviceMetrics(*(torch.zeros((), dtype=torch.int64, device=device)
                           for _ in METRIC_KEYS))


def accumulate_update(metrics: DeviceMetrics, trpo_stats) -> DeviceMetrics:
    """Fold one update's ``TRPOStats`` into the counters. Early exit means
    ``cg_iterations < cg_budget``: the budget this update actually solved
    under (the adaptive ladder's when it shrank the cap), so it never
    counts a small cap as an early exit."""
    def i64(x):
        return torch.as_tensor(x, device=metrics.cg_iters_total.device
                               ).to(torch.int64)

    return DeviceMetrics(
        cg_iters_total=metrics.cg_iters_total
        + i64(trpo_stats.cg_iterations),
        cg_early_exit_total=metrics.cg_early_exit_total
        + i64(torch.as_tensor(trpo_stats.cg_iterations)
              < torch.as_tensor(trpo_stats.cg_budget)),
        linesearch_trials_total=metrics.linesearch_trials_total
        + i64(trpo_stats.linesearch_trials),
        rollback_total=metrics.rollback_total + i64(trpo_stats.rolled_back),
        nan_guard_total=metrics.nan_guard_total + i64(trpo_stats.nan_guard),
    )


def metrics_stats(metrics: DeviceMetrics) -> dict:
    """The counters as stats entries, merged into every row."""
    return dict(zip(METRIC_KEYS, metrics))
