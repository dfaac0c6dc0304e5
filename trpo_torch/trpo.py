"""The TRPO natural-gradient update (counterpart: ``trpo_tpu/trpo.py``).

``make_trpo_update`` returns ``(params, batch) -> (params, stats)``:
policy gradient → conjugate-gradient solve of ``F·s = −g`` over
Fisher-vector products → step scaling ``√(2δ/sᵀFs)`` → backtracking line
search → KL rollback. It works in the flat-vector domain in
``ravel_pytree`` order (``ops/flat.py``), so iterates and step norms
compare one-for-one with the reference.

As in the reference, nothing in the update waits on the host: the CG exit
and the line-search acceptance are device-side predicates
(``ops/cg.py``, ``ops/linesearch.py``), and the head-block refresh cadence
is a Python counter.

The Fisher operator under ``fvp_mode="auto"`` or ``"fused"`` is the fused
kernel (``ops/fused_fvp.py``) for a plain-MLP diagonal-Gaussian policy. An
ineligible policy under ``"auto"`` gets the ``torch.func`` Gauss-Newton
operator (``ops/fvp.make_ggn_fvp``) — a choice made when the operator is
selected, before anything is built — and under ``"fused"`` raises.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from trpo_torch.config import TRPOConfig, check_ported
from trpo_torch.models.mlp import ACTIVATIONS
from trpo_torch.models.policy import Policy
from trpo_torch.ops.cg import conjugate_gradient
from trpo_torch.ops.flat import flatten_params, tree_map
from trpo_torch.ops.fused_fvp import (
    fused_fvp_supported,
    make_fused_gaussian_mlp_fvp,
)
from trpo_torch.ops.fvp import make_ggn_fvp
from trpo_torch.ops.linesearch import backtracking_linesearch
from trpo_torch.ops.precond import (
    PrecondState,
    apply_gaussian_head_block_inv,
    gaussian_head_gram,
    head_gram_eigh,
)
from trpo_torch.ops.treemath import tree_where

__all__ = [
    "SolvePack",
    "TRPOBatch",
    "TRPOStats",
    "make_trpo_update",
    "standardize_advantages",
    "surrogate_and_dist",
]


class TRPOBatch(NamedTuple):
    """One update's experience, leading axis ``(B,)`` = flattened
    (time, env)."""
    obs: torch.Tensor         # (B, obs_dim)
    actions: torch.Tensor     # (B, A)
    advantages: torch.Tensor  # (B,) — already standardized
    old_dist: Any             # {"mean": (B, A), "log_std": (B, A)}
    weight: torch.Tensor      # (B,) — 1.0 real step, 0.0 padding


class TRPOStats(NamedTuple):
    surrogate_before: torch.Tensor
    surrogate_after: torch.Tensor
    kl: torch.Tensor                 # KL(π_old ‖ π_new) after the update
    entropy: torch.Tensor
    grad_norm: torch.Tensor
    step_norm: torch.Tensor
    cg_iterations: torch.Tensor
    cg_residual: torch.Tensor
    linesearch_success: torch.Tensor
    step_fraction: torch.Tensor
    rolled_back: torch.Tensor
    damping: float
    linesearch_trials: torch.Tensor
    nan_guard: torch.Tensor
    cg_budget: int
    precond_next: Any = None  # PrecondState for the next update, or None


class SolvePack(NamedTuple):
    """Everything crossing the solve → line-search seam."""
    fullstep: torch.Tensor
    expected_improve_rate: torch.Tensor
    surr_before: torch.Tensor
    dist0: Any
    logp_old: torch.Tensor
    grad_norm: torch.Tensor
    cg_iterations: torch.Tensor
    cg_residual: torch.Tensor
    damping: float
    precond_next: Any


def _wmean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)


def surrogate_and_dist(policy: Policy, params, batch: TRPOBatch,
                       logp_old=None) -> Tuple[torch.Tensor, Any]:
    """``(surrogate, dist_params)`` from one forward: the surrogate is
    ``-E[π(a|s)/π_old(a|s) · A]`` as a log-prob difference."""
    if logp_old is None:
        logp_old = policy.dist.logp(batch.old_dist, batch.actions)
    dist_params = policy.apply(params, batch.obs)
    logp = policy.dist.logp(dist_params, batch.actions)
    ratio = torch.exp(logp - logp_old)
    surr = -_wmean(ratio * batch.advantages, batch.weight)
    return surr, dist_params


def _fvp_keep_indices(n: int, fraction: float) -> np.ndarray:
    """Sample indices realizing ``fraction`` of ``n`` — the reference's
    exact set (``trpo_tpu/trpo.py:_fvp_keep_indices``): ``fraction ≤ ½``
    keeps every ``ceil(1/f)``-th sample; ``fraction > ½`` drops every
    ``floor(1/(1-f))``-th; a fraction < 1 always subsamples, except that
    n == 1 keeps its one sample."""
    if fraction <= 0.5:
        stride = max(int(math.ceil(1.0 / fraction)), 2)
        return np.arange(0, n, stride)
    k = max(int(math.floor(1.0 / (1.0 - fraction))), 2)
    idx = np.arange(n)
    keep = idx[(idx % k) != (k - 1)]
    if len(keep) == n and n > 1:
        keep = idx[:-1]
    return keep


def _fvp_batch(batch: TRPOBatch, fraction: Optional[float]) -> TRPOBatch:
    """The deterministic curvature subsample the FVPs run on; gradient,
    line search and rollback stay full-batch."""
    if fraction is None or fraction == 1.0:
        return batch
    keep = torch.as_tensor(
        _fvp_keep_indices(batch.weight.shape[0], fraction),
        device=batch.weight.device,
    )
    return tree_map(lambda x: x[keep], batch)


def _maybe_fused_fvp(policy: Policy, cfg: TRPOConfig, params0,
                     fb: TRPOBatch, damping: float):
    """The fused kernel's flat operator when the policy qualifies, else
    None (``"auto"``); an explicit ``"fused"`` raises instead of falling
    back."""
    explicit = cfg.fvp_mode == "fused"
    if cfg.fvp_mode not in ("auto", "fused"):
        return None

    def bail(reason):
        if explicit:
            raise ValueError(f'fvp_mode="fused" unsupported here: {reason}')
        return None

    spec = policy.mlp_spec
    if spec is None:
        return bail("policy has no plain-MLP spec")
    if getattr(policy.dist, "name", None) != "diag_gaussian":
        return bail("the fused FVP covers the diagonal-Gaussian head only")
    if not (isinstance(params0, dict) and set(params0) == {"net", "log_std"}):
        return bail("unexpected params structure")
    if spec["compute_dtype"] != torch.float32:
        return bail("the fused FVP kernel computes in float32 only")
    if not fused_fvp_supported(spec["activation"], params0["net"]):
        return bail(
            f"activation {spec['activation']!r} / torso shape not "
            "kernel-eligible"
        )
    return make_fused_gaussian_mlp_fvp(
        params0["net"], fb.obs, fb.weight, params0["log_std"], damping,
        activation=spec["activation"],
    ).flat


def _head_block_inv(policy: Policy, cfg: TRPOConfig, params0, fb: TRPOBatch,
                    damping: float, to_params, precond):
    """Flat ``r ↦ M⁻¹r`` for the head-block preconditioner, and the
    ``PrecondState`` for the next update (None without a state)."""
    spec = policy.mlp_spec
    if (
        spec is None
        or getattr(policy.dist, "name", None) != "diag_gaussian"
        or not (isinstance(params0, dict)
                and set(params0) == {"net", "log_std"})
    ):
        raise ValueError(
            'cg_precondition="head_block" needs the plain-MLP '
            "diagonal-Gaussian policy"
        )
    act = ACTIVATIONS[spec["activation"]]

    def torso_apply(net, obs):
        h = obs.reshape(obs.shape[0], -1)
        for layer in net["layers"][:-1]:
            h = act(h @ layer["w"] + layer["b"])
        return h

    def fresh():
        with torch.no_grad():
            S = gaussian_head_gram(torso_apply, params0["net"], fb.obs,
                                   fb.weight)
            return head_gram_eigh(S)

    precond_next = None
    if precond is None:
        s_eig, U = fresh()
    else:
        if precond.age % max(int(cfg.precond_refresh_every), 1) == 0:
            s_eig, U = fresh()
        else:
            s_eig, U = precond.s_eig, precond.u
        precond_next = PrecondState(u=U, s_eig=s_eig, age=precond.age + 1)
    tree_M = apply_gaussian_head_block_inv(
        s_eig, U, fb.weight, params0["log_std"], damping
    )
    return (lambda r: flatten_params(tree_M(to_params(r)))[0]), precond_next


def _solve_stage(policy: Policy, cfg: TRPOConfig, to_params: Callable,
                 x0: torch.Tensor, batch: TRPOBatch,
                 precond: Optional[PrecondState] = None) -> SolvePack:
    """Gradient and surrogate in one pass → damped-Fisher operator → CG
    solve → KL-radius step scaling."""
    x0 = x0.detach()
    with torch.no_grad():
        logp_old = policy.dist.logp(batch.old_dist, batch.actions)
    xg = x0.clone().requires_grad_(True)
    with torch.enable_grad():
        surr_before, dist0 = surrogate_and_dist(
            policy, to_params(xg), batch, logp_old
        )
        (g,) = torch.autograd.grad(surr_before, xg)
    surr_before = surr_before.detach()
    dist0 = tree_map(torch.Tensor.detach, dist0)
    grad_norm = torch.linalg.vector_norm(g)
    neg_g = -1.0 * g

    damping = float(cfg.cg_damping)
    fb = _fvp_batch(batch, cfg.fvp_subsample)
    params0 = to_params(x0)
    fvp = _maybe_fused_fvp(policy, cfg, params0, fb, damping)
    if fvp is None:
        fvp = make_ggn_fvp(
            lambda x: policy.apply(to_params(x), fb.obs),
            policy.dist.fisher_weight, x0, fb.weight, damping=damping,
        )

    M_inv, precond_next = None, None
    if cfg.cg_precondition == "head_block":
        M_inv, precond_next = _head_block_inv(
            policy, cfg, params0, fb, damping, to_params, precond
        )

    with torch.no_grad():
        cg = conjugate_gradient(
            fvp, neg_g, cg_iters=cfg.cg_iters,
            residual_tol=cfg.cg_residual_tol, M_inv=M_inv,
            residual_rtol=cfg.cg_residual_rtol,
        )
        stepdir = cg.x
        shs = 0.5 * torch.dot(stepdir, fvp(stepdir))
        shs = torch.clamp(shs, min=1e-12)
        lm = torch.sqrt(shs / cfg.max_kl)
        fullstep = (1.0 / lm) * stepdir
        expected_improve_rate = torch.dot(neg_g, stepdir) / lm
    return SolvePack(
        fullstep=fullstep,
        expected_improve_rate=expected_improve_rate,
        surr_before=surr_before,
        dist0=dist0,
        logp_old=logp_old,
        grad_norm=grad_norm,
        cg_iterations=cg.iterations,
        cg_residual=cg.residual_norm_sq,
        damping=damping,
        precond_next=precond_next,
    )


def _finish_stage(policy: Policy, cfg: TRPOConfig, to_params: Callable,
                  x0: torch.Tensor, batch: TRPOBatch,
                  pack: SolvePack) -> Tuple[Any, TRPOStats]:
    """Backtracking line search along the scaled step → KL rollback →
    final params and stats."""
    x0 = x0.detach()
    logp_old = pack.logp_old

    def surr_with_dist(x):
        return surrogate_and_dist(policy, to_params(x), batch, logp_old)

    ls_constraint = None
    if cfg.linesearch_kl_cap:
        kl_cap = cfg.kl_rollback_factor * cfg.max_kl
        ls_constraint = lambda x, dist: (  # noqa: E731
            _wmean(policy.dist.kl(batch.old_dist, dist), batch.weight)
            <= kl_cap
        )
    with torch.no_grad():
        ls = backtracking_linesearch(
            surr_with_dist,
            x0,
            pack.fullstep,
            pack.expected_improve_rate,
            max_backtracks=cfg.linesearch_backtracks,
            accept_ratio=cfg.linesearch_accept_ratio,
            constraint_fn=ls_constraint,
            has_aux=True,
            f0=pack.surr_before,
            aux0=pack.dist0,
        )
        dist_ls = ls.aux
        kl_after = _wmean(policy.dist.kl(batch.old_dist, dist_ls),
                          batch.weight)
        rollback = kl_after > cfg.kl_rollback_factor * cfg.max_kl
        x_new = torch.where(rollback, x0, ls.x)
        final_dist = tree_where(rollback, pack.dist0, dist_ls)
        logp_new = policy.dist.logp(final_dist, batch.actions)
        ratio_new = torch.exp(logp_new - logp_old)
        surr_after = -_wmean(ratio_new * batch.advantages, batch.weight)
        entropy = _wmean(policy.dist.entropy(final_dist), batch.weight)
        nan_guard = ~(
            torch.isfinite(pack.grad_norm)
            & torch.isfinite(surr_after)
            & torch.isfinite(entropy)
        )
        stats = TRPOStats(
            surrogate_before=pack.surr_before,
            surrogate_after=surr_after,
            kl=_wmean(policy.dist.kl(batch.old_dist, final_dist),
                      batch.weight),
            entropy=entropy,
            grad_norm=pack.grad_norm,
            step_norm=torch.linalg.vector_norm(x_new - x0),
            cg_iterations=pack.cg_iterations,
            cg_residual=pack.cg_residual,
            linesearch_success=ls.success,
            step_fraction=ls.step_fraction,
            rolled_back=rollback,
            damping=pack.damping,
            linesearch_trials=ls.trials,
            nan_guard=nan_guard,
            cg_budget=cfg.cg_iters,
            precond_next=pack.precond_next,
        )
    return to_params(x_new), stats


def make_trpo_update(policy: Policy, cfg: TRPOConfig):
    """The update in the flat-vector domain: ``update(params, batch,
    precond=None) -> (new_params, stats)``. ``precond`` (a
    ``PrecondState``) arms the amortized head-block refresh; without it the
    factors are recomputed every update."""
    check_ported(cfg)

    def update(params, batch: TRPOBatch,
               precond: Optional[PrecondState] = None):
        flat0, unravel = flatten_params(params)
        flat0 = flat0.float().detach()
        pack = _solve_stage(policy, cfg, unravel, flat0, batch, precond)
        return _finish_stage(policy, cfg, unravel, flat0, batch, pack)

    return update


def standardize_advantages(adv: torch.Tensor,
                           weight: torch.Tensor) -> torch.Tensor:
    """Zero-mean unit-variance advantages over real (unpadded) steps."""
    mean = _wmean(adv, weight)
    var = _wmean((adv - mean) ** 2, weight)
    return (adv - mean) / (torch.sqrt(var) + 1e-8) * weight
