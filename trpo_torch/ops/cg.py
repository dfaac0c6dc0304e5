"""Conjugate gradient with a device-side early exit (counterpart:
``trpo_tpu/ops/cg.py``).

The reference's ``lax.while_loop`` exits once ``rᵀr`` falls under the
threshold. Here the loop always runs ``cg_iters`` times and the exit is a
mask: once converged, ``x``, ``r`` and ``p`` are kept by ``torch.where``
and the iteration count stops growing. Every selected value is computed by
the same ops in the same order as the reference's loop body, and no
iteration waits on the host (no ``.item()``), so the solve can later be
captured as a CUDA graph. The price is that the operator still runs on the
iterations after convergence.

``cg_iters`` may be a device int tensor, the ladder's adaptive iteration
budget (``cfg.cg_budget_adaptive``): the budget joins the mask
(``i < budget``) and the loop runs ``max_iters`` times. So the adaptive
budget changes the solution and the iteration count as in the reference,
but saves no matvecs yet: the operator still runs up to the ceiling.

Everything this module owns — ``x``, ``r``, ``p``, the dot products and
the residual test — is f32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

__all__ = ["CGResult", "conjugate_gradient"]


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
) -> CGResult:
    """Solve ``A x = b`` for SPD ``A`` given the matvec ``f_Ax``: x₀ = 0,
    r₀ = b, exit when ``rᵀr ≤ max(residual_tol, residual_rtol²·bᵀb)``.
    ``M_inv`` (a callable ``r ↦ M⁻¹r``) makes it preconditioned CG; the exit
    test stays on the true residual ``rᵀr``. A tensor ``cg_iters`` needs
    ``max_iters``, the host bound of the loop (the budget's ceiling)."""
    if isinstance(cg_iters, torch.Tensor):
        if max_iters is None:
            raise ValueError("a tensor cg_iters needs max_iters")
        n_loop = int(max_iters)
    else:
        n_loop = int(cg_iters)
    b = b.float()
    x = torch.zeros_like(b)
    r = b
    rdotr = torch.dot(b, b)
    z = b if M_inv is None else M_inv(b).float()
    p = z
    rdotz = rdotr if M_inv is None else torch.dot(b, z)
    stop = torch.clamp(
        float(residual_rtol) ** 2 * rdotr, min=float(residual_tol)
    )
    iterations = torch.zeros((), dtype=torch.int32, device=b.device)
    for i in range(n_loop):
        active = rdotr > stop
        if isinstance(cg_iters, torch.Tensor):
            active = active & (cg_iters > i)
        w = f_Ax(p).float()
        alpha = rdotz / torch.dot(p, w)
        x_new = x + alpha * p
        r_new = r - alpha * w
        z = r_new if M_inv is None else M_inv(r_new).float()
        rdotr_new = torch.dot(r_new, r_new)
        rdotz_new = rdotr_new if M_inv is None else torch.dot(r_new, z)
        mu = rdotz_new / rdotz
        p_new = z + mu * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rdotz = torch.where(active, rdotz_new, rdotz)
        rdotr = torch.where(active, rdotr_new, rdotr)
        iterations = iterations + active.to(torch.int32)
    return CGResult(x=x, residual_norm_sq=rdotr, iterations=iterations)
