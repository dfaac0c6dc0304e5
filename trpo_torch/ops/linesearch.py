"""Backtracking line search with a device-side accept predicate
(counterpart: ``trpo_tpu/ops/linesearch.py``).

The reference's ``lax.while_loop`` stops at the first accepted trial. Here
every trial runs and the first acceptance is latched by ``torch.where``, so
no trial waits on the host; ``trials`` counts the trials the reference
would have evaluated. Acceptance is the reference's: ``actual_improve > 0``
and ``actual_improve / (expected_improve_rate · frac) > accept_ratio``, and
the original point comes back when nothing is accepted. Each trial is a
``trpo/linesearch/trial`` span (``utils/timers.span``), so a profiled
update counts every evaluation, the ones after the acceptance included.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from trpo_torch.ops.treemath import tree_where
from trpo_torch.utils.timers import span

__all__ = ["LinesearchResult", "backtracking_linesearch"]


class LinesearchResult(NamedTuple):
    x: torch.Tensor               # accepted point (== input x on failure)
    success: torch.Tensor         # bool: some trial was accepted
    step_fraction: torch.Tensor   # accepted 0.5**k (0.0 on failure)
    loss: torch.Tensor            # loss at the returned point
    aux: Any = None               # loss_fn's aux at the returned point
    trials: Any = 0               # int32: trials up to the first acceptance


def backtracking_linesearch(
    loss_fn: Callable[[torch.Tensor], Any],
    x: torch.Tensor,
    fullstep: torch.Tensor,
    expected_improve_rate: torch.Tensor,
    max_backtracks: int = 10,
    accept_ratio: float = 0.1,
    backtrack_factor: float = 0.5,
    constraint_fn: Optional[Callable[..., torch.Tensor]] = None,
    has_aux: bool = False,
    f0: Optional[torch.Tensor] = None,
    aux0: Any = None,
) -> LinesearchResult:
    """Search along ``fullstep`` from ``x`` minimizing ``loss_fn``.

    ``has_aux``: ``loss_fn`` returns ``(loss, aux)`` and the accepted
    trial's aux comes back (``constraint_fn(x, aux)`` then reads it).
    ``f0``/``aux0``: the known loss (and aux) at ``x``, which skips the
    search's own evaluation of it."""
    if f0 is not None:
        if has_aux and aux0 is None:
            raise ValueError("f0 with has_aux=True also needs aux0")
        fval, aux_x = f0, aux0
    elif has_aux:
        fval, aux_x = loss_fn(x)
    else:
        fval, aux_x = loss_fn(x), None

    device = x.device
    accepted = torch.zeros((), dtype=torch.bool, device=device)
    trials = torch.zeros((), dtype=torch.int32, device=device)
    x_acc, f_acc, aux_acc = x, fval, aux_x
    frac_acc = torch.zeros((), dtype=torch.float32, device=device)
    for k in range(max_backtracks):
        with span("trpo/linesearch/trial"):
            frac = torch.tensor(
                backtrack_factor, dtype=torch.float32, device=device
            ) ** float(k)
            xnew = x + frac.to(x.dtype) * fullstep
            if has_aux:
                newfval, aux = loss_fn(xnew)
            else:
                newfval, aux = loss_fn(xnew), None
            actual_improve = fval - newfval
            ratio = actual_improve / (expected_improve_rate * frac)
            ok = (ratio > accept_ratio) & (actual_improve > 0.0)
            if constraint_fn is not None:
                ok = ok & (constraint_fn(xnew, aux) if has_aux
                           else constraint_fn(xnew))
            take = ok & ~accepted
            trials = trials + (~accepted).to(torch.int32)
            x_acc = torch.where(take, xnew, x_acc)
            f_acc = torch.where(take, newfval, f_acc)
            frac_acc = torch.where(take, frac, frac_acc)
            if has_aux:
                aux_acc = tree_where(take, aux, aux_acc)
            accepted = accepted | ok
    return LinesearchResult(
        x=x_acc,
        success=accepted,
        step_fraction=frac_acc,
        loss=f_acc,
        aux=aux_acc if has_aux else None,
        trials=trials,
    )
