"""Conjugate gradient with an early exit (counterpart: ``trpo_tpu/ops/cg.py``).

The reference's ``lax.while_loop`` exits once ``rᵀr`` falls under the
threshold, so it calls the operator once per iteration it runs. Here the
loop body keeps the exit as a device-side mask (once converged, ``x``,
``r`` and ``p`` are kept by ``torch.where`` and the iteration count stops
growing), and the host reads that mask every :data:`CHECK_EVERY`
iterations (one sync each) and leaves the loop once no further iteration
would take effect. Every value is computed by the same ops in the same
order as the reference's loop body, and an iteration that the mask
rejects changes nothing, so the result is bitwise that of the masked loop
run to the end; only the operator calls after convergence are saved (at
most ``CHECK_EVERY - 1`` of them remain). With ``CHECK_EVERY = 1`` the
operator runs exactly once per iteration that takes effect, as in the
reference.

A rule that cannot fire (``residual_tol`` and ``residual_rtol`` both 0,
as in ``trpo_torch/bench.py``'s forced-iteration solves) is never read:
that loop runs its full count with no sync.

``cg_iters`` may be a device int tensor, the ladder's adaptive iteration
budget (``cfg.cg_budget_adaptive``): it is read once per solve (one sync)
and bounds the loop, so iterations past the budget cost nothing either.

Everything this module owns — ``x``, ``r``, ``p``, the dot products and
the residual test — is f32. ``dot`` replaces ``torch.dot`` where the
vectors are this rank's blocks of a sharded one (``parallel/tp.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

__all__ = ["CGResult", "conjugate_gradient"]

# How often the host reads the exit mask: 1 = every iteration (no wasted
# operator call), k = every k-th (at most k - 1 wasted calls, 1/k of the
# syncs), 0 = never (the masked loop runs its full count). PERF.md has the
# card's numbers for 0, 1 and 2.
CHECK_EVERY = 1


class CGResult(NamedTuple):
    x: torch.Tensor                 # approximate solution of A x = b
    residual_norm_sq: torch.Tensor  # rᵀr at exit
    iterations: torch.Tensor        # int32: iterations that took effect


def conjugate_gradient(
    f_Ax: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    cg_iters: Union[int, torch.Tensor] = 10,
    residual_tol: float = 1e-10,
    M_inv: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    residual_rtol: float = 0.0,
    max_iters: Optional[int] = None,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.dot,
) -> CGResult:
    """Solve ``A x = b`` for SPD ``A`` given the matvec ``f_Ax``: x₀ = 0,
    r₀ = b, exit when ``rᵀr ≤ max(residual_tol, residual_rtol²·bᵀb)``.
    ``M_inv`` (a callable ``r ↦ M⁻¹r``) makes it preconditioned CG; the exit
    test stays on the true residual ``rᵀr``. A tensor ``cg_iters`` needs
    ``max_iters``, the bound of the loop (the budget's ceiling)."""
    if isinstance(cg_iters, torch.Tensor):
        if max_iters is None:
            raise ValueError("a tensor cg_iters needs max_iters")
        n_loop = max(0, min(int(max_iters), int(cg_iters.item())))
    else:
        n_loop = int(cg_iters)
    every = CHECK_EVERY
    if residual_tol <= 0.0 and residual_rtol <= 0.0:
        every = 0  # the rule cannot fire: nothing to read
    b = b.float()
    x = torch.zeros_like(b)
    r = b
    rdotr = dot(b, b)
    z = b if M_inv is None else M_inv(b).float()
    p = z
    rdotz = rdotr if M_inv is None else dot(b, z)
    stop = torch.clamp(
        float(residual_rtol) ** 2 * rdotr, min=float(residual_tol)
    )
    iterations = torch.zeros((), dtype=torch.int32, device=b.device)
    for i in range(n_loop):
        active = rdotr > stop
        if every and i % every == 0 and not bool(active):
            break  # converged: no later iteration takes effect
        w = f_Ax(p).float()
        alpha = rdotz / dot(p, w)
        x_new = x + alpha * p
        r_new = r - alpha * w
        z = r_new if M_inv is None else M_inv(r_new).float()
        rdotr_new = dot(r_new, r_new)
        rdotz_new = rdotr_new if M_inv is None else dot(r_new, z)
        mu = rdotz_new / rdotz
        p_new = z + mu * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rdotz = torch.where(active, rdotz_new, rdotz)
        rdotr = torch.where(active, rdotr_new, rdotr)
        iterations = iterations + active.to(torch.int32)
    return CGResult(x=x, residual_norm_sq=rdotr, iterations=iterations)
