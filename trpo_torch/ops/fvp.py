"""Fisher-vector products (counterpart: ``trpo_tpu/ops/fvp.py``).

:func:`make_ggn_fvp`: ``F·v = Jᵀ (M · (J v)) + λv`` with ``J`` the Jacobian
of the dist params with respect to the optimization variable and ``M`` the
dist-space KL Hessian (``dist.fisher_weight``), written as
``torch.func.jvp`` → ``fisher_weight`` → ``torch.func.vjp``. It is the
operator for any policy the fused kernel (``ops/fused_fvp.py``) does not
cover, and that kernel's independent oracle.

:func:`make_fvp` (``fvp_mode="jvp_grad"``) and :func:`make_tree_fvp`: the
same Fisher as the Hessian of ``KL(stop_grad(π_θ) ‖ π_x)`` at ``x = θ``,
applied as ``torch.func.jvp`` over ``torch.func.grad`` of that KL (forward
over reverse), on a flat vector or on a params tree.
:func:`materialize_fisher` is the dense Hessian, for tests on tiny nets.
Every operator's output is f32, with the damping added in f32. With a
``group`` (data parallelism, ``parallel/sharded.py``) the product is this
rank's share of the global mean, summed over the group before the damping
is added.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.func

from trpo_torch.ops.allreduce import all_sum, weight_total
from trpo_torch.ops.flat import tree_map

__all__ = ["make_fvp", "make_ggn_fvp", "make_tree_fvp", "materialize_fisher"]


def make_fvp(kl_fn: Callable[[torch.Tensor], torch.Tensor],
             flat_params: torch.Tensor,
             damping=0.0, group=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """``v ↦ (F + λI)v`` at ``flat_params``, where ``kl_fn(flat)`` is the
    mean KL(stop_grad(π_θ) ‖ π_flat) over the batch (its Hessian at θ is
    the Fisher); with ``group``, this rank's share of that mean."""
    grad_kl = torch.func.grad(kl_fn)
    x0 = flat_params.detach()

    def fvp(v: torch.Tensor) -> torch.Tensor:
        _, hv = torch.func.jvp(grad_kl, (x0,), (v,))
        return all_sum(hv.float(), group) + damping * v

    return fvp


def make_tree_fvp(kl_fn: Callable[[Any], torch.Tensor], params: Any,
                  damping=0.0) -> Callable[[Any], Any]:
    """:func:`make_fvp` on a params tree: ``v`` has ``params``'s
    structure."""
    grad_kl = torch.func.grad(kl_fn)
    p0 = tree_map(torch.Tensor.detach, params)

    def fvp(v: Any) -> Any:
        _, hv = torch.func.jvp(grad_kl, (p0,), (v,))
        return tree_map(lambda h, t: h.float() + damping * t, hv, v)

    return fvp


def materialize_fisher(kl_fn: Callable[[torch.Tensor], torch.Tensor],
                       flat_params: torch.Tensor) -> torch.Tensor:
    """The dense Fisher (the Hessian of ``kl_fn``); O(P²), for tests."""
    return torch.func.hessian(kl_fn)(flat_params.detach())


def _rows(w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The row weight ``w`` shaped to broadcast over ``t``'s trailing axes
    (``(B, K)``, ``(T, N, K)``, a sequence's ``(B, T, V)``)."""
    return w.reshape(w.shape + (1,) * (t.ndim - w.ndim))


def make_ggn_fvp(
    apply_fn: Callable[[Any], Any],
    fisher_weight: Callable[[Any, Any], Any],
    x0: torch.Tensor,
    weight: torch.Tensor,
    damping: float = 0.0,
    group=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``v ↦ (F + λI)v`` at ``x0``.

    ``apply_fn(x) -> dist params`` closes over the batch obs; ``weight`` is
    the per-sample weight column (normalized to a weighted mean here, over
    every rank of ``group``), broadcast over each dist param's trailing
    axes. The primal forward and the pullback are built
    once; each call runs one tangent forward and one pullback."""
    x0 = x0.detach()
    d0, pullback = torch.func.vjp(apply_fn, x0)
    d0 = tree_map(torch.Tensor.detach, d0)
    w_norm = weight / weight_total(weight, group)

    def fvp(v: torch.Tensor) -> torch.Tensor:
        _, d = torch.func.jvp(apply_fn, (x0,), (v,))
        m = fisher_weight(d0, d)
        m = tree_map(lambda t: t.float() * _rows(w_norm, t), m)
        (hv,) = pullback(m)
        return all_sum(hv.float(), group) + damping * v

    return fvp
