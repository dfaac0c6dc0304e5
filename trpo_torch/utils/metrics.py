"""Training metrics (counterpart: ``trpo_tpu/utils/metrics.py``)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["explained_variance"]


def explained_variance(ypred: torch.Tensor, y: torch.Tensor,
                       weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``1 − Var(y − ŷ)/Var(y)`` over weighted samples; NaN when
    ``Var(y) = 0``."""
    ypred = ypred.float().reshape(-1)
    y = y.float().reshape(-1)
    weight = torch.ones_like(y) if weight is None else \
        weight.float().reshape(-1)
    wsum = torch.clamp(weight.sum(), min=1.0)

    def wvar(v):
        m = torch.sum(v * weight) / wsum
        return torch.sum((v - m) ** 2 * weight) / wsum

    return 1.0 - wvar(y - ypred) / wvar(y)
