"""Tree helpers (counterpart: ``trpo_tpu/ops/treemath.py``).

The reference's pytree arithmetic over params trees: casts, the axpy
steps, and an f32-accumulated inner product. The port's solve runs on
flat f32 vectors (the concatenation of a rank's leaves, with the inner
product of ``parallel/tp.py`` on a parameter axis), so these serve tree
callers and tests; ``tree_where`` is the device-side select over a tree
(the line search's accepted ``aux``, the rollback's final dist).
"""

from __future__ import annotations

import torch

from trpo_torch.ops.flat import tree_leaves, tree_map

__all__ = [
    "tree_add_scaled",
    "tree_f32",
    "tree_norm",
    "tree_scale",
    "tree_sub",
    "tree_vdot",
    "tree_where",
    "tree_zeros_like",
]


def tree_f32(t):
    """Every leaf cast to float32."""
    return tree_map(lambda x: x.float(), t)


def tree_zeros_like(t):
    return tree_map(torch.zeros_like, t)


def tree_scale(alpha, t):
    """``alpha · t`` leafwise."""
    return tree_map(lambda x: alpha * x, t)


def tree_sub(a, b):
    """``a − b`` leafwise."""
    return tree_map(lambda x, y: x - y, a, b)


def tree_add_scaled(x, alpha, y):
    """``x + alpha · y`` leafwise (CG's axpy step)."""
    return tree_map(lambda a, b: a + alpha * b, x, y)


def tree_vdot(a, b) -> torch.Tensor:
    """Σ over leaves of ⟨a_leaf, b_leaf⟩, each leaf's product and the sum
    in f32 whatever the leaves' dtype (as the reference's)."""
    total = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(a)[0].device)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        total = total + torch.dot(x.float().reshape(-1), y.float().reshape(-1))
    return total


def tree_norm(t) -> torch.Tensor:
    return torch.sqrt(tree_vdot(t, t))


def tree_where(cond: torch.Tensor, a, b):
    """Leafwise ``torch.where`` with a scalar boolean tensor predicate —
    the device-side select that replaces ``lax.cond``/``while_loop`` exits
    without a host sync."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)
