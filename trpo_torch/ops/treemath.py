"""Tree helpers for the solve (counterpart: ``trpo_tpu/ops/treemath.py``).

The port's solve runs on flat f32 vectors, where the reference's vector
helpers are single tensor ops; what remains is the device-side select
over a tree (the line search's accepted ``aux``, the rollback's final
dist).
"""

from __future__ import annotations

import torch

from trpo_torch.ops.flat import tree_map

__all__ = ["tree_where"]


def tree_where(cond: torch.Tensor, a, b):
    """Leafwise ``torch.where`` with a scalar boolean tensor predicate —
    the device-side select that replaces ``lax.cond``/``while_loop`` exits
    without a host sync."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)
