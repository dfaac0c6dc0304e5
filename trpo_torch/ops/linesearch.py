"""Backtracking line search with an early exit
(counterpart: ``trpo_tpu/ops/linesearch.py``).

Trial k steps to ``x + frac_k · fullstep`` with ``frac_k =
backtrack_factor ** k`` (f32 on ``x``'s device, as the reference), and
the host reads that trial's accept predicate once (``ls.accept``,
``utils/timers.host_read``): the first accepted trial comes back as it
was computed, and the next trial runs only if it was rejected. So the
search evaluates exactly ``trials`` candidates, as the reference's
``lax.while_loop`` does, and waits on the device once per trial and
nowhere else: the step fraction's base is filled on the device, not
copied from the host. A latch over every trial (a ``torch.where`` on
the point, loss, aux and fraction, with no read) would cost
``max_backtracks`` evaluations whatever the acceptance, nine wasted
when the first trial is taken, as it usually is.

Acceptance is the reference's: ``actual_improve > 0`` and
``actual_improve / (expected_improve_rate · frac) > accept_ratio``, and
``constraint_fn`` on the trial's own aux when given; the original point,
loss and aux come back when nothing is accepted. On a mesh every term
of the predicate is all-reduced, so every rank reads the same answer,
leaves at the same trial and keeps its collectives matched. Each trial
is a ``trpo/linesearch/trial`` span (``utils/timers.span``), so a
profiled update counts the evaluations.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from trpo_torch.utils.timers import host_read, span

__all__ = ["LinesearchResult", "backtracking_linesearch"]


class LinesearchResult(NamedTuple):
    x: torch.Tensor               # accepted point (== input x on failure)
    success: torch.Tensor         # bool: some trial was accepted
    step_fraction: torch.Tensor   # accepted 0.5**k (0.0 on failure)
    loss: torch.Tensor            # loss at the returned point
    aux: Any = None               # loss_fn's aux at the returned point
    trials: Any = 0               # int32: trials evaluated


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
    base = torch.full((), backtrack_factor, dtype=torch.float32,
                      device=device)

    def result(x_out, ok, frac, loss, aux, trials):
        return LinesearchResult(
            x=x_out,
            success=torch.full((), ok, dtype=torch.bool, device=device),
            step_fraction=frac,
            loss=loss,
            aux=aux if has_aux else None,
            trials=torch.full((), trials, dtype=torch.int32, device=device),
        )

    for k in range(max_backtracks):
        with span("trpo/linesearch/trial"):
            frac = base ** float(k)
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
            if host_read(ok, "ls.accept"):
                return result(xnew, True, frac, newfval, aux, k + 1)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return result(x, False, zero, fval, aux_x, max_backtracks)
