"""Gauss-Newton Fisher-vector products (counterpart: ``trpo_tpu/ops/fvp.py``).

``F·v = Jᵀ (M · (J v)) + λv`` with ``J`` the Jacobian of the dist params
with respect to the optimization variable and ``M`` the dist-space KL
Hessian (``dist.fisher_weight``), written as ``torch.func.jvp`` →
``fisher_weight`` → ``torch.func.vjp``. It is the operator for any policy
the fused kernel (``ops/fused_fvp.py``) does not cover, and that kernel's
independent oracle.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.func

from trpo_torch.ops.flat import tree_map

__all__ = ["make_ggn_fvp"]


def make_ggn_fvp(
    apply_fn: Callable[[Any], Any],
    fisher_weight: Callable[[Any, Any], Any],
    x0: torch.Tensor,
    weight: torch.Tensor,
    damping: float = 0.0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``v ↦ (F + λI)v`` at ``x0``.

    ``apply_fn(x) -> dist params`` closes over the batch obs; ``weight`` is
    the per-sample weight column (normalized to a weighted mean here). The
    primal forward and the pullback are built once; each call runs one
    tangent forward and one pullback."""
    x0 = x0.detach()
    d0, pullback = torch.func.vjp(apply_fn, x0)
    d0 = tree_map(torch.Tensor.detach, d0)
    w_norm = weight / torch.clamp(weight.sum(), min=1.0)

    def fvp(v: torch.Tensor) -> torch.Tensor:
        _, d = torch.func.jvp(apply_fn, (x0,), (v,))
        m = fisher_weight(d0, d)
        m = tree_map(lambda t: t.float() * w_norm.unsqueeze(-1), m)
        (hv,) = pullback(m)
        return hv.float() + damping * v

    return fvp
