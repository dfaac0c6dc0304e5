"""The plain reference of a TRPO policy update (Schulman et al. 2015), in
f32 PyTorch with autograd only. It imports nothing of the program and
takes nothing the program made: the benchmark hands it the same named
weights and batches it hands the program, and it works out everything
else again.

One update, on a batch ``(obs, actions, advantages)`` with unit row
weights, from parameters ``θ``, as the configuration's ``trpo`` block
states it:

1. ``π_old`` is ``θ``'s own distribution on the batch (or the stale one
   the batch states it was drawn from); the surrogate is
   ``L(x) = -mean(exp(log π_x(a|s) - log π_old(a|s)) · A)`` and ``g =
   ∇L(θ)``.
2. The curvature rows: every row, or, with ``fvp_subsample = f``, the
   rows ``i`` with ``i mod k ≠ k - 1`` for ``k = floor(1/(1-f))`` when
   ``f > 1/2`` (every ``ceil(1/f)``-th row otherwise). A pinned solver
   ladder solves on every row.
3. ``F v`` is the Hessian of ``mean KL(π_old ‖ π_x)`` at ``x = θ`` applied
   to ``v`` (double backward; at ``θ`` it equals the Gauss-Newton
   ``JᵀMJ``), plus ``λ v``.
4. ``cg_precondition = "head_block"``: the head's ``(W, b)`` block of
   ``(F + λI)⁻¹`` is solved exactly per action dimension ``j`` as
   ``(S·m_j + λI)⁻¹``, with ``S = mean(h̃ h̃ᵀ)`` over the subsample rows,
   ``h̃ = [h, 1]`` the head's input, and ``m = exp(-2 log σ)``; the
   log-std block is ``1/(2 + λ)``; the torso's is the identity. ``S`` is
   computed afresh every ``precond_refresh_every`` updates, starting with
   the first, and held in between.
5. Preconditioned conjugate gradient from 0 on ``F s = -g``, at most
   ``cg_iters`` iterations, leaving once ``rᵀr ≤ cg_residual_tol``.
6. ``s`` is scaled to ``sqrt(2 δ / sᵀFs) · s`` (``δ = max_kl``), then a
   backtracking line search over fractions ``1/2^k``, ``k <
   linesearch_backtracks``, takes the first with a positive improvement
   above ``linesearch_accept_ratio`` of the expected one; none keeps
   ``θ``. A mean KL above ``kl_rollback_factor · δ`` rolls back to ``θ``.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch


def keep_rows(n: int, fraction: Optional[float]) -> torch.Tensor:
    """The curvature subsample's row indices (step 2)."""
    idx = torch.arange(n)
    if fraction is None or fraction >= 1.0:
        return idx
    if fraction <= 0.5:
        return idx[::max(math.ceil(1.0 / fraction), 2)]
    k = max(math.floor(1.0 / (1.0 - fraction)), 2)
    keep = idx[idx % k != k - 1]
    return keep if len(keep) < n or n == 1 else idx[:-1]


class _Flat:
    """A flat f32 vector over the named leaves, in sorted-name order."""

    def __init__(self, named: dict):
        self.names = sorted(named)
        self.shapes = [tuple(named[k].shape) for k in self.names]
        self.sizes = [math.prod(s) for s in self.shapes]

    def flat(self, named: dict) -> torch.Tensor:
        return torch.cat([named[k].reshape(-1).float() for k in self.names])

    def named(self, x: torch.Tensor) -> dict:
        out, off = {}, 0
        for k, s, n in zip(self.names, self.shapes, self.sizes):
            out[k] = x[off:off + n].view(s)
            off += n
        return out


def _head_block_inverse(family, config, sp: _Flat, S: torch.Tensor,
                        log_std: torch.Tensor, lam: float,
                        head: tuple) -> Callable:
    """``r ↦ M⁻¹ r`` of step 4 for the held ``S`` and the current
    ``log σ``."""
    m = torch.exp(-2.0 * log_std)
    eye = torch.eye(S.shape[0], device=S.device)
    blocks = S[None] * m[:, None, None] + lam * eye[None]  # (A, H+1, H+1)
    w_name, b_name = head

    def apply(r: torch.Tensor) -> torch.Tensor:
        rn = {k: v.clone() for k, v in sp.named(r).items()}
        X = torch.cat([rn[w_name], rn[b_name][None, :]], dim=0)  # (H+1, A)
        Y = torch.linalg.solve(blocks, X.T.unsqueeze(-1)).squeeze(-1).T
        rn[w_name], rn[b_name] = Y[:-1], Y[-1]
        rn["log_std"] = rn["log_std"] / (2.0 + lam)
        return sp.flat(rn)

    return apply


def _cg(fvp: Callable, b: torch.Tensor, iters: int, tol: float,
        M_inv: Optional[Callable]) -> torch.Tensor:
    x = torch.zeros_like(b)
    r = b.clone()
    z = r if M_inv is None else M_inv(r)
    p = z.clone()
    rz = torch.dot(r, z)
    for _ in range(iters):
        if float(torch.dot(r, r)) <= tol:
            break
        Ap = fvp(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r if M_inv is None else M_inv(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def run_updates(family, config, params: dict, batches: List[tuple],
                n_updates: int, pinned: bool = False,
                half_batch: bool = False) -> List[dict]:
    """``n_updates`` chained updates from ``params`` on ``batches`` (update
    ``t`` takes ``batches[t % len(batches)]``: ``(obs, actions, adv)``, or
    ``(obs, actions, adv, old)`` with ``old`` the distribution the batch
    was drawn from, a stale ``π_old`` in place of ``θ``'s own). Each
    entry: the surrogate before and after, the mean KL to ``π_old``,
    ``‖g‖``, the gradient's norm per leaf, the accepted step fraction (0
    when none was), whether the KL rolled the step back, and the
    parameters after the update (named, detached). ``half_batch`` keeps
    only the first half of every batch's rows (a planted fault, for
    calibrating the limits)."""
    trpo = config["trpo"]
    lam = float(trpo["cg_damping"])
    max_kl = float(trpo["max_kl"])
    sp = _Flat(params)
    x = sp.flat(params).detach()
    head = family.head_names(params) if trpo["cg_precondition"] else None
    if trpo["cg_precondition"] not in (False, None, "head_block"):
        raise ValueError(f"no reference for cg_precondition="
                         f"{trpo['cg_precondition']!r}")
    S = None
    out = []
    for t in range(n_updates):
        obs, actions, adv, *stale = batches[t % len(batches)]
        d_old = stale[0] if stale else None
        if half_batch:
            half = obs.shape[0] // 2
            obs, actions, adv = obs[:half], actions[:half], adv[:half]
            if d_old is not None:
                d_old = {k: v[:half] for k, v in d_old.items()}
        n = obs.shape[0]
        with torch.no_grad():
            if d_old is None:
                d_old = family.forward(config, sp.named(x), obs)
            logp_old = family.logp(d_old, actions)

        def surrogate(xx):
            d = family.forward(config, sp.named(xx), obs)
            ratio = torch.exp(family.logp(d, actions) - logp_old)
            return -(ratio * adv).mean(), d

        x0 = x.clone().requires_grad_(True)
        surr0, _ = surrogate(x0)
        (g,) = torch.autograd.grad(surr0, x0)
        surr0 = surr0.detach()

        sub = keep_rows(n, trpo.get("fvp_subsample")).to(obs.device)
        rows = torch.arange(n, device=obs.device) if pinned else sub
        obs_f = obs[rows]
        with torch.no_grad():
            d_fix = family.forward(config, sp.named(x), obs_f)

        def fvp(v):
            xx = x.clone().requires_grad_(True)
            kl = family.kl(d_fix, family.forward(config, sp.named(xx),
                                                 obs_f)).mean()
            (gk,) = torch.autograd.grad(kl, xx, create_graph=True)
            (hv,) = torch.autograd.grad(torch.dot(gk, v), xx)
            return hv + lam * v

        M_inv = None
        if head is not None:
            if t % int(trpo["precond_refresh_every"]) == 0:
                with torch.no_grad():
                    h = family.features(config, sp.named(x), obs[sub])
                    h1 = torch.cat([h, torch.ones_like(h[:, :1])], dim=1)
                    S = h1.T @ h1 / h1.shape[0]
            M_inv = _head_block_inverse(family, config, sp, S,
                                        sp.named(x)["log_std"], lam, head)

        neg_g = -g
        s = _cg(fvp, neg_g, int(trpo["cg_iters"]),
                float(trpo["cg_residual_tol"]), M_inv)
        shs = 0.5 * torch.dot(s, fvp(s))
        scale = torch.sqrt(torch.clamp(shs, min=1e-12) / max_kl)
        fullstep = s / scale
        expected = torch.dot(neg_g, s) / scale

        with torch.no_grad():
            x_new, d_new, frac_new = x, None, 0.0
            for k in range(int(trpo["linesearch_backtracks"])):
                frac = 0.5 ** k
                x_try = x + frac * fullstep
                f_try, d_try = surrogate(x_try)
                improve = surr0 - f_try
                if (improve > 0 and improve / (expected * frac)
                        > float(trpo["linesearch_accept_ratio"])):
                    x_new, d_new, frac_new = x_try, d_try, frac
                    break
            if d_new is None:
                d_new = family.forward(config, sp.named(x), obs)
            kl_new = family.kl(d_old, d_new).mean()
            rolled_back = bool(
                kl_new > float(trpo["kl_rollback_factor"]) * max_kl)
            if rolled_back:
                x_new = x
                d_new = family.forward(config, sp.named(x), obs)
                kl_new = family.kl(d_old, d_new).mean()
            ratio = torch.exp(family.logp(d_new, actions) - logp_old)
            surr_after = -(ratio * adv).mean()
        g_named = sp.named(g)
        out.append({
            "surrogate_before": float(surr0),
            "surrogate_after": float(surr_after),
            "kl": float(kl_new),
            "step_fraction": frac_new,
            "rolled_back": rolled_back,
            "grad_norm": float(torch.linalg.vector_norm(g)),
            "grad_leaf_norms": {k: float(torch.linalg.vector_norm(v))
                                for k, v in g_named.items()},
            "params": {k: v.detach().clone()
                       for k, v in sp.named(x_new).items()},
        })
        x = x_new.detach()
    return out
