"""The TRPO natural-gradient update (counterpart: ``trpo_tpu/trpo.py``).

``make_trpo_update`` returns ``update(params, batch, damping=None,
precond=None, ladder=None) -> (params, stats)`` (the reference's argument
order): policy gradient → conjugate-gradient solve of ``F·s = −g`` over
Fisher-vector products → step scaling ``√(2δ/sᵀFs)`` → backtracking line
search → KL rollback. It works in the flat-vector domain in
``ravel_pytree`` order (``ops/flat.py``), so iterates and step norms
compare one-for-one with the reference.

For a policy whose params are this rank's blocks of a parameter axis
(``policy.tp``, ``parallel/tp.py``) the same two stage bodies run without
the fused kernel over the concatenation of the local leaves, with every
inner product (CG's, the step scale's, the norms, the audit's cosine)
all-reducing its split part over the axis and counting the replicated
part once. The reference's tree-domain update (``make_tree_trpo_update``,
here a name for it) keeps its leaves sharded the same way; where it
applies pytree arithmetic the port applies the flat ops to the local
blocks.

As in the reference, nothing in the update waits on the host: the CG exit
and the line-search acceptance are device-side predicates
(``ops/cg.py``, ``ops/linesearch.py``), the damping λ is a device scalar
(adapted on the device with ``cfg.adaptive_damping``), and the head-block
refresh cadence is a Python counter.

The Fisher operator under ``fvp_mode="auto"`` or ``"fused"`` is the fused
kernel (``ops/fused_fvp.py``: K1 in f32, K1-bf16 for the ladder's bf16
rung or a bfloat16 policy) for a plain-MLP diagonal-Gaussian policy. An
ineligible policy under ``"auto"`` gets the ``torch.func`` Gauss-Newton
operator (``ops/fvp.make_ggn_fvp``, over ``policy.apply_cast`` at the
ladder's dtype) — a choice made when the operator is selected — and under
``"fused"`` raises. The conv, recurrent and mixture-of-experts
families have no ``mlp_spec``, so they always take the GGN, as the
reference takes the XLA GGN for them; a recurrent batch passes its window
as a ``SeqObs`` through ``policy.apply`` and the GGN alike.
``fvp_mode="jvp_grad"`` applies the Hessian of the stop-gradient KL
(``ops/fvp.make_fvp``) instead. ``cg_precondition="jacobi"`` (or True)
preconditions CG with a Hutchinson diagonal of the cheap operator
(``ops/precond.py``): ``cg_precond_probes`` more runs of it per update.

The solver precision ladder (a :class:`LadderState` passed in): every
``cfg.solve_audit_every`` updates the same system is re-solved at full
precision on the full batch with the ``torch.func`` GGN (never the cheap
operator's kernel: the audit is what catches a broken cheap operator),
and the solution cosine gates the cheap solution; ``solve_fallback_limit``
consecutive failures pin the ladder at the full solve. Where the
reference skips work under ``lax.cond`` (the cheap solve when pinned, the
full solve on updates that are neither audited nor pinned), the port
skips it too, on host mirrors of the ladder: the update count is a host
integer, and ``pinned`` can change only on an audited update, so it is
read back once after each audited update — one sync per
``solve_audit_every`` updates, none on the others. The ``LadderState``
tensors stay the source of the stats and of ``convert.py``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from trpo_torch.config import TRPOConfig
from trpo_torch.models.mlp import ACTIVATIONS
from trpo_torch.models.policy import Policy
from trpo_torch.models.recurrent import SeqObs
from trpo_torch.ops.allreduce import all_sum, weight_total, wmean, wshare
from trpo_torch.ops.cg import conjugate_gradient
from trpo_torch.ops.flat import flatten_params, tree_map
from trpo_torch.ops.fused_fvp import (
    fused_fvp_supported,
    make_fused_gaussian_mlp_fvp,
)
from trpo_torch.ops.fvp import make_fvp, make_ggn_fvp
from trpo_torch.ops.linesearch import backtracking_linesearch
from trpo_torch.ops.precond import (
    PrecondState,
    apply_gaussian_head_block_inv,
    gaussian_head_gram,
    head_gram_eigh,
    hutchinson_diag_inv,
    rademacher_probes,
)
from trpo_torch.ops.treemath import tree_where

__all__ = [
    "LadderState",
    "SolvePack",
    "TRPOBatch",
    "TRPOStats",
    "init_ladder",
    "ladder_enabled",
    "ladder_stateful",
    "make_staged_trpo_update",
    "make_tree_trpo_update",
    "make_trpo_update",
    "standardize_advantages",
    "surrogate_and_dist",
]


class TRPOBatch(NamedTuple):
    """One update's experience, leading axis ``(B,)`` = flattened
    (time, env). A recurrent policy's batch keeps the ``(T, N)`` axes
    instead and passes a ``models.recurrent.SeqObs`` as ``obs``: every
    reduction of the update is a shape-agnostic weighted mean."""
    obs: Any                  # (B, *obs_shape), or a SeqObs
    actions: torch.Tensor     # (B, A) or (B,); (T, N, ...) with a SeqObs
    advantages: torch.Tensor  # (B,) — already standardized
    old_dist: Any             # {"mean": (B, A), "log_std": (B, A)}
    weight: torch.Tensor      # (B,) — 1.0 real step, 0.0 padding
    is_weight: Any = None     # (B,) importance weight of a STALE window
    #   (the overlapped loop, cfg.train_overlap): π_anchor(a|s) /
    #   π_behavior(a|s), detached, multiplied into the surrogate's ratio
    #   while old_dist holds the anchor (the current params' dist). None
    #   (every on-policy caller) leaves the surrogate's ops unchanged.
    row_ids: Any = None       # on a mesh: each local row's index in the
    #   GLOBAL batch along the axis fvp_subsample thins (rows; env columns
    #   of a SeqObs window), so the curvature subsample is the one-rank
    #   run's. None: rank r of D holds rows r·B … (r+1)·B − 1.


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
    damping: Any                     # λ used this update (device scalar)
    linesearch_trials: torch.Tensor
    nan_guard: torch.Tensor
    cg_budget: Any                   # the CG cap the used solve ran under
    precond_next: Any = None  # PrecondState for the next update, or None
    damping_next: Any = None  # λ for the next update
    # solver precision ladder: populated when a LadderState is passed in
    solve_cosine: Any = float("nan")  # audit cosine; NaN when not audited
    solve_audited: Any = False
    solve_fallback: Any = False      # the update used the full solution
    solve_pinned: Any = False        # the ladder was pinned this update
    ladder_next: Any = None          # LadderState for the next update
    # iterations of the cheap solve (the one on cfg.fvp_dtype / the
    # subsample), -1 when it did not run (a pinned ladder); it differs from
    # cg_iterations only on an update that used the full solution. The
    # cheap operator runs cg_iterations_cheap + 1 times: once per iteration
    # that took effect (ops/cg.py), once for sᵀFs
    cg_iterations_cheap: Any = None


class LadderState(NamedTuple):
    """The solver precision ladder's state between updates (the
    reference's seven device scalars), and two host mirrors the update
    keeps so that it never waits on the device to choose its branches."""
    step: torch.Tensor         # int32: updates performed (audit cadence)
    cg_budget: torch.Tensor    # int32: current adaptive CG iteration cap
    fail_streak: torch.Tensor  # int32: consecutive failed audits
    pinned: torch.Tensor       # bool: full precision from now on
    cosine_min: torch.Tensor   # f32: worst audit cosine (init 1.0)
    audit_runs: torch.Tensor   # int32: full-precision re-solves executed
    fallbacks: torch.Tensor    # int32: per-update fallbacks taken
    step_host: int = 0         # host mirror of ``step``
    pinned_host: bool = False  # host mirror of ``pinned``


LADDER_FIELDS = LadderState._fields[:7]


def ladder_enabled(cfg: TRPOConfig) -> bool:
    """True when a cheap-solve rung is on (bf16 matvec and/or curvature
    subsampling): there is something for the audit to check."""
    return cfg.fvp_dtype == "bf16" or (
        cfg.fvp_subsample is not None and cfg.fvp_subsample < 1.0
    )


def ladder_stateful(cfg: TRPOConfig) -> bool:
    """True when the update needs a ``LadderState`` threaded through it:
    the audit machine (cheap rung + audit cadence) or the adaptive CG
    budget."""
    return (
        ladder_enabled(cfg) and cfg.solve_audit_every > 0
    ) or cfg.cg_budget_adaptive


def init_ladder(cfg: TRPOConfig, device="cpu") -> LadderState:
    i32 = lambda v: torch.full((), v, dtype=torch.int32,  # noqa: E731
                               device=device)
    ceiling = cfg.resolved_cg_budget_ceiling()
    return LadderState(
        step=i32(0),
        cg_budget=i32(ceiling if cfg.cg_budget_adaptive else cfg.cg_iters),
        fail_streak=i32(0),
        pinned=torch.zeros((), dtype=torch.bool, device=device),
        cosine_min=torch.ones((), device=device),
        audit_runs=i32(0),
        fallbacks=i32(0),
    )


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
    damping: torch.Tensor
    precond_next: Any
    ladder_next: Any
    solve_cosine: Any
    solve_audited: Any
    solve_fallback: Any
    solve_pinned: Any
    cg_budget: Any
    cg_iterations_cheap: Any


def _ratio_adv(policy: Policy, dist_params, batch: TRPOBatch,
               logp_old) -> torch.Tensor:
    """Per-row ``π(a|s)/π_old(a|s) · A``."""
    logp = policy.dist.logp(dist_params, batch.actions)
    ratio = torch.exp(logp - logp_old)
    if batch.is_weight is not None:
        # stale-window correction: the ratio is anchored at the current
        # params, the behavior policy's mismatch a constant weight
        ratio = ratio * batch.is_weight.detach()
    return ratio * batch.advantages


def surrogate_and_dist(policy: Policy, params, batch: TRPOBatch,
                       logp_old=None, group=None) -> Tuple[torch.Tensor, Any]:
    """``(surrogate, dist_params)`` from one forward: the surrogate is
    ``-E[π(a|s)/π_old(a|s) · A]`` as a log-prob difference, averaged over
    every rank of ``group``."""
    if logp_old is None:
        logp_old = policy.dist.logp(batch.old_dist, batch.actions)
    dist_params = policy.apply(params, batch.obs)
    surr = -wmean(_ratio_adv(policy, dist_params, batch, logp_old),
                  batch.weight, group)
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


def _keep(batch: TRPOBatch, n: int, fraction: float, group) -> torch.Tensor:
    """The local indices of the curvature subsample along an axis of
    local length ``n``. On a mesh the keep set is computed over GLOBAL
    indices (``batch.row_ids``) and intersected with this rank's rows, so
    it is the one-rank run's set; per-rank strides would pick another."""
    dev = batch.weight.device
    if group is None:
        return torch.as_tensor(_fvp_keep_indices(n, fraction), device=dev)
    world = torch.distributed.get_world_size(group)
    ids = batch.row_ids
    if ids is None:
        ids = torch.distributed.get_rank(group) * n + torch.arange(n)
    mask = torch.zeros(n * world, dtype=torch.bool)
    mask[torch.as_tensor(_fvp_keep_indices(n * world, fraction))] = True
    return torch.nonzero(mask[ids.cpu()]).flatten().to(dev)


def _fvp_batch(batch: TRPOBatch, fraction: Optional[float],
               group=None) -> TRPOBatch:
    """The deterministic curvature subsample the FVPs run on; gradient,
    line search and rollback stay full-batch. A flat batch thins its rows;
    a recurrent (``SeqObs``) one thins the ENV axis, as the reference
    does: striding time would break the window's replay."""
    if fraction is None or fraction == 1.0:
        return batch
    if isinstance(batch.obs, SeqObs):
        keep = _keep(batch, batch.obs.reset.shape[1], fraction, group)
        sub = lambda x: x[:, keep]  # noqa: E731
        obs = SeqObs(obs=sub(batch.obs.obs), reset=sub(batch.obs.reset),
                     h0=batch.obs.h0[keep])
        return tree_map(sub, batch._replace(obs=None, row_ids=None))._replace(
            obs=obs)
    keep = _keep(batch, batch.weight.shape[0], fraction, group)
    return tree_map(lambda x: x[keep], batch._replace(row_ids=None))


def _maybe_fused_fvp(policy: Policy, cfg: TRPOConfig, params0,
                     fb: TRPOBatch, damping, dtype=None):
    """The fused kernel's flat operator when the policy qualifies, else
    None (``"auto"``); an explicit ``"fused"`` raises instead of falling
    back. ``dtype`` (the ladder's bf16 rung) overrides the policy's own
    compute dtype: float32 builds K1, bfloat16 K1-bf16."""
    explicit = cfg.fvp_mode == "fused"
    if cfg.fvp_mode not in ("auto", "fused"):
        return None

    def bail(reason):
        if explicit:
            raise ValueError(f'fvp_mode="fused" unsupported here: {reason}')
        return None

    spec = policy.mlp_spec
    if spec is None:
        return bail("policy has no plain-MLP spec (conv/MoE/recurrent)")
    if getattr(policy.dist, "name", None) != "diag_gaussian":
        return bail("the fused FVP covers the diagonal-Gaussian head only")
    if not (isinstance(params0, dict) and set(params0) == {"net", "log_std"}):
        return bail("unexpected params structure")
    kernel_dtype = spec["compute_dtype"] if dtype is None else dtype
    if kernel_dtype not in (torch.float32, torch.bfloat16):
        return bail(f"no fused FVP kernel computes in {kernel_dtype}")
    if not fused_fvp_supported(spec["activation"], params0["net"]):
        return bail(
            f"activation {spec['activation']!r} / torso shape not "
            "kernel-eligible"
        )
    return make_fused_gaussian_mlp_fvp(
        params0["net"], fb.obs, fb.weight, params0["log_std"], damping,
        activation=spec["activation"], compute_dtype=kernel_dtype,
    ).flat


def _next_damping(cfg: TRPOConfig, damping, ls_success, rollback):
    """Levenberg–Marquardt-style feedback on the CG damping: a failed line
    search or a KL rollback grows λ for the next update, a clean step
    shrinks it, clipped to ``[damping_min, damping_max]``; all on the
    device."""
    grow = rollback | ~ls_success
    factor = torch.where(grow, cfg.damping_grow, cfg.damping_shrink)
    return torch.clamp(damping * factor, cfg.damping_min, cfg.damping_max)


def _skewed_operator(op, skew: float, n: int, device, space=None):
    """Test lever (``cfg.solve_fault_skew``): ``v ↦ D·op(D·v)`` with ``D``
    the alternating diagonal (1 on even coordinates, 1 + skew on odd, of
    the one-rank flat vector). The operator stays symmetric positive
    definite, so CG converges, but to a wrong system, which the audit's
    full-precision re-solve sees as a low solution cosine."""
    if space is None:
        idx = torch.arange(n, dtype=torch.float32, device=device)
    else:
        idx = space.index.to(device=device, dtype=torch.float32)
    d = 1.0 + float(skew) * (idx % 2.0)
    return lambda v: d * op(d * v)


def _head_block_inv(policy: Policy, cfg: TRPOConfig, params0, fb: TRPOBatch,
                    damping: float, to_params, precond, group=None):
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
            "diagonal-Gaussian policy (it inverts that head's Fisher "
            "block); pass cg_precondition=False for a conv, MoE or "
            "recurrent policy"
        )
    act = ACTIVATIONS[spec["activation"]]

    def torso_apply(net, obs):
        h = obs.reshape(obs.shape[0], -1)
        for layer in net["layers"][:-1]:
            h = act(h @ layer["w"] + layer["b"])
        return h

    log_std_m = params0["log_std"]
    if policy.tp is not None:
        # the head block inverts each output column's block on its own:
        # a whole or column-parallel head applies it to this rank's
        # columns (their log-stds); the torso's features come out of the
        # sharded forward, whole
        from trpo_torch.models.mlp import apply_mlp

        tp = policy.tp
        if tp.specs["net"]["layers"][-1]["w"] == 0:
            raise ValueError(
                'cg_precondition="head_block" needs the head whole or split '
                "by its output columns; this layout splits its input rows "
                "over the parameter axis (a torso of one hidden layer): pass "
                "cg_precondition=False or add a hidden layer")
        if tp.specs["net"]["layers"][-1]["w"] == 1:
            k = log_std_m.shape[0] // tp.size
            log_std_m = log_std_m.narrow(0, tp.rank * k, k)
        ttp = tp.sub("net")
        ttp = ttp._replace(specs={"layers": ttp.specs["layers"][:-1]})

        def torso_apply(net, obs):  # noqa: F811
            return act(apply_mlp({"layers": net["layers"][:-1]},
                                 obs.reshape(obs.shape[0], -1),
                                 spec["activation"], tp=ttp))

    def fresh():
        with torch.no_grad():
            S = gaussian_head_gram(torso_apply, params0["net"], fb.obs,
                                   fb.weight, group)
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
        s_eig, U, fb.weight, log_std_m, damping, group
    )
    return (lambda r: flatten_params(tree_M(to_params(r)))[0]), precond_next


def _solve_stage(policy: Policy, cfg: TRPOConfig, to_params: Callable,
                 x0: torch.Tensor, batch: TRPOBatch, damping=None,
                 precond: Optional[PrecondState] = None,
                 ladder: Optional[LadderState] = None,
                 jacobi_probes=None, group=None,
                 allow_fused: bool = True, space=None) -> SolvePack:
    """Gradient and surrogate in one pass → damped-Fisher operator →
    (audited / budget-adaptive) CG solve → KL-radius step scaling. With
    ``group`` every batch reduction is summed over its ranks: the
    gradient and the surrogate in one all-reduce, each FVP in one.
    ``space`` (a ``parallel.tp.FlatSpace``): ``x0`` holds this rank's
    blocks of a parameter axis, and every inner product is the space's."""
    dot, norm = ((torch.dot, torch.linalg.vector_norm) if space is None
                 else (space.dot, space.norm))
    x0 = x0.detach()
    dev = x0.device
    with torch.no_grad():
        logp_old = policy.dist.logp(batch.old_dist, batch.actions)
    xg = x0.clone().requires_grad_(True)
    # each rank differentiates its rows' share of the global mean; the
    # gradient and the surrogate are summed in one collective
    wtot = weight_total(batch.weight, group)
    with torch.enable_grad():
        dist0 = policy.apply(to_params(xg), batch.obs)
        surr_local = -wshare(_ratio_adv(policy, dist0, batch, logp_old),
                             batch.weight, wtot)
        (g,) = torch.autograd.grad(surr_local, xg)
    red = all_sum(torch.cat([g.float(), surr_local.detach().reshape(1)]),
                  group)
    g, surr_before = red[:-1], red[-1]
    surr_before = surr_before.detach()
    dist0 = tree_map(torch.Tensor.detach, dist0)
    grad_norm = norm(g)
    neg_g = -1.0 * g

    if damping is None:
        damping = torch.full((), float(cfg.cg_damping), device=dev)
    damping = torch.as_tensor(damping, dtype=torch.float32, device=dev)
    if not allow_fused and cfg.fvp_mode == "fused":
        raise ValueError(
            'fvp_mode="fused" is unavailable on this path (mesh '
            "sharding, or population members on a mesh) — use "
            'fvp_mode="auto" (falls back to "ggn" here) or "ggn". An '
            'explicit "fused" must never silently time the wrong operator.'
        )
    fb = _fvp_batch(batch, cfg.fvp_subsample, group)
    params0 = to_params(x0)

    def build_fvp(b: TRPOBatch, dtype, fused_ok: bool, skew: float):
        """``v ↦ (F + λI)v`` over batch ``b`` with the products in
        ``dtype`` (None: the policy's own compute dtype)."""
        if dtype is None:
            apply_b = lambda x: policy.apply(to_params(x), b.obs)  # noqa
        else:
            if getattr(policy, "apply_cast", None) is None:
                raise ValueError(
                    'fvp_dtype="bf16" needs a policy with a dtype-castable '
                    "forward (apply_cast: the plain-MLP and conv policies; "
                    'recurrent and MoE have none) — use fvp_dtype="f32" '
                    "here"
                )
            apply_b = lambda x: policy.apply_cast(  # noqa: E731
                to_params(x), b.obs, dtype)
        op = None
        if fused_ok and allow_fused:
            op = _maybe_fused_fvp(policy, cfg, params0, b, damping, dtype)
        if op is None and cfg.fvp_mode == "jvp_grad":
            # the Hessian of KL(stop_grad(π_θ) ‖ π_x) at x = θ, with the
            # anchor at the policy's own dtype; on a mesh each rank's share
            # of the global mean, summed after the product
            with torch.no_grad():
                anchor = policy.apply(params0, b.obs)
            wtot_b = weight_total(b.weight, group)

            def kl_fixed(x):
                return wshare(policy.dist.kl(anchor, apply_b(x)), b.weight,
                              wtot_b)

            op = make_fvp(kl_fixed, x0, damping=damping, group=group)
        elif op is None:
            op = make_ggn_fvp(apply_b, policy.dist.fisher_weight, x0,
                              b.weight, damping=damping, group=group)
        if skew:
            op = _skewed_operator(op, skew, x0.shape[0], dev, space)
        return op

    fvp = build_fvp(fb, torch.bfloat16 if cfg.fvp_dtype == "bf16" else None,
                    True, cfg.solve_fault_skew)

    M_inv, precond_next = None, None
    if cfg.cg_precondition == "head_block":
        M_inv, precond_next = _head_block_inv(
            policy, cfg, params0, fb, damping, to_params, precond, group
        )
    elif cfg.cg_precondition:
        # Jacobi: a Hutchinson diagonal of the operator CG iterates (one
        # more run of it per probe), floored at λ; fixed-seed probes
        probes = jacobi_probes
        if space is not None:
            # the one-rank run's probes, cut to this rank's entries
            from trpo_torch.parallel.tp import local_entries

            probes = [local_entries(space, p) for p in (
                probes if probes is not None else rademacher_probes(
                    space.n_global, cfg.cg_precond_probes, dev))]
        with torch.no_grad():
            d_inv = hutchinson_diag_inv(fvp, neg_g, cfg.cg_precond_probes,
                                        damping, probes=probes)
        M_inv = lambda r: d_inv * r  # noqa: E731

    audit_on = (ladder is not None and cfg.solve_audit_every > 0
                and ladder_enabled(cfg))
    budget_on = ladder is not None and cfg.cg_budget_adaptive
    ceiling = int(cfg.resolved_cg_budget_ceiling())

    def solve(op, iters):
        """One CG solve and the step-scale FVP ``shs = ½ sᵀ(F+λI)s`` on the
        operator that produced it."""
        cg = conjugate_gradient(
            op, neg_g, cg_iters=iters, residual_tol=cfg.cg_residual_tol,
            M_inv=M_inv, residual_rtol=cfg.cg_residual_rtol,
            max_iters=max(ceiling, cfg.cg_iters), dot=dot,
        )
        shs = 0.5 * dot(cg.x, op(cg.x))
        return cg.x, shs, cg.iterations, cg.residual_norm_sq

    with torch.no_grad():
        ladder_next = None
        if not (audit_on or budget_on):
            stepdir, shs, cg_iterations, cg_residual = solve(fvp,
                                                             cfg.cg_iters)
            solve_cosine, audited, fallback, pinned = (float("nan"), False,
                                                       False, False)
            budget_used = cfg.cg_iters
            it_cheap = cg_iterations
        else:
            flag = lambda v: torch.full((), v, dtype=torch.bool,  # noqa
                                        device=dev)
            i32 = lambda v: torch.full((), v, dtype=torch.int32,  # noqa
                                       device=dev)
            budget = (torch.clamp(ladder.cg_budget, cfg.cg_budget_floor,
                                  ceiling) if budget_on else cfg.cg_iters)
            budget_used = torch.as_tensor(budget, dtype=torch.int32,
                                          device=dev)
            do_audit = False
            if audit_on:
                pinned = ladder.pinned
                do_audit = (not ladder.pinned_host
                            and ladder.step_host % cfg.solve_audit_every == 0)
                # pinned updates pay only the full solve; updates that are
                # neither audited nor pinned pay only the cheap one
                if ladder.pinned_host:
                    cheap = (torch.zeros_like(neg_g), torch.zeros((),
                             device=dev), i32(0), torch.zeros((), device=dev))
                else:
                    cheap = solve(fvp, budget)
                x_c, shs_c, it_c, res_c = cheap
                if ladder.pinned_host or do_audit:
                    full = solve(build_fvp(batch, None, False, 0.0),
                                 cfg.cg_iters)
                else:
                    full = cheap
                x_f, shs_f, it_f, res_f = full
                if do_audit:
                    cos_raw = dot(x_c, x_f) / torch.clamp(
                        norm(x_c) * norm(x_f), min=1e-30)
                    solve_cosine = cos_raw
                    fallback = cos_raw < cfg.solve_cosine_floor
                else:
                    solve_cosine = torch.full((), float("nan"), device=dev)
                    fallback = flag(False)
                audited = flag(do_audit)
                use_full = pinned | fallback
                stepdir = torch.where(use_full, x_f, x_c)
                shs = torch.where(use_full, shs_f, shs_c)
                cg_iterations = torch.where(use_full, it_f, it_c)
                cg_residual = torch.where(use_full, res_f, res_c)
                # the cap of the solve that produced the used solution
                budget_used = torch.where(use_full, i32(cfg.cg_iters),
                                          budget_used)
                it_cheap = i32(-1) if ladder.pinned_host else it_c
            else:
                stepdir, shs, cg_iterations, cg_residual = solve(fvp, budget)
                it_c = it_cheap = cg_iterations
                solve_cosine = torch.full((), float("nan"), device=dev)
                audited = fallback = pinned = flag(False)

            if budget_on:
                # shrink to the residual rule's exit (+1); grow +2 toward
                # the ceiling after an unconverged solve; hold when pinned
                early = it_c < budget_used
                shrink = torch.clamp(it_c + 1, cfg.cg_budget_floor, ceiling)
                grow = torch.clamp(budget_used + 2, max=ceiling)
                budget_next = torch.where(
                    pinned, budget_used, torch.where(early, shrink, grow))
            else:
                budget_next = budget_used
            streak_next = torch.where(
                fallback, ladder.fail_streak + 1,
                torch.where(audited, torch.zeros_like(ladder.fail_streak),
                            ladder.fail_streak))
            pinned_next = pinned | (streak_next >= cfg.solve_fallback_limit)
            ladder_next = LadderState(
                step=ladder.step + 1,
                cg_budget=budget_next.to(torch.int32),
                fail_streak=streak_next.to(torch.int32),
                pinned=pinned_next,
                cosine_min=torch.minimum(
                    ladder.cosine_min,
                    torch.where(audited, solve_cosine,
                                torch.ones_like(ladder.cosine_min))),
                audit_runs=ladder.audit_runs + audited.to(torch.int32),
                fallbacks=ladder.fallbacks + fallback.to(torch.int32),
                step_host=ladder.step_host + 1,
                # pinned changes only on an audited update: one read-back
                pinned_host=bool(pinned_next.item()) if do_audit
                else ladder.pinned_host,
            )

        shs = torch.clamp(shs, min=1e-12)
        lm = torch.sqrt(shs / cfg.max_kl)
        fullstep = (1.0 / lm) * stepdir
        expected_improve_rate = dot(neg_g, stepdir) / lm
    return SolvePack(
        fullstep=fullstep,
        expected_improve_rate=expected_improve_rate,
        surr_before=surr_before,
        dist0=dist0,
        logp_old=logp_old,
        grad_norm=grad_norm,
        cg_iterations=cg_iterations,
        cg_residual=cg_residual,
        damping=damping,
        precond_next=precond_next,
        ladder_next=ladder_next,
        solve_cosine=solve_cosine,
        solve_audited=audited,
        solve_fallback=fallback,
        solve_pinned=pinned,
        cg_budget=budget_used,
        cg_iterations_cheap=it_cheap,
    )


def _finish_stage(policy: Policy, cfg: TRPOConfig, to_params: Callable,
                  x0: torch.Tensor, batch: TRPOBatch,
                  pack: SolvePack, group=None,
                  space=None) -> Tuple[Any, TRPOStats]:
    """Backtracking line search along the scaled step → KL rollback →
    final params and stats; every mean over the ranks of ``group``. The
    accept, the rollback and the NaN guard read reduced values only, so
    every rank takes the same branch. ``space`` as in
    :func:`_solve_stage`."""
    norm = torch.linalg.vector_norm if space is None else space.norm
    x0 = x0.detach()
    logp_old = pack.logp_old

    def surr_with_dist(x):
        return surrogate_and_dist(policy, to_params(x), batch, logp_old,
                                  group)

    ls_constraint = None
    if cfg.linesearch_kl_cap:
        kl_cap = cfg.kl_rollback_factor * cfg.max_kl
        ls_constraint = lambda x, dist: (  # noqa: E731
            wmean(policy.dist.kl(batch.old_dist, dist), batch.weight, group)
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
        kl_after = wmean(policy.dist.kl(batch.old_dist, dist_ls),
                         batch.weight, group)
        rollback = kl_after > cfg.kl_rollback_factor * cfg.max_kl
        x_new = torch.where(rollback, x0, ls.x)
        final_dist = tree_where(rollback, pack.dist0, dist_ls)
        logp_new = policy.dist.logp(final_dist, batch.actions)
        ratio_new = torch.exp(logp_new - logp_old)
        if batch.is_weight is not None:
            # the same weighting as the surrogate the search optimized
            ratio_new = ratio_new * batch.is_weight
        surr_after = -wmean(ratio_new * batch.advantages, batch.weight,
                            group)
        entropy = wmean(policy.dist.entropy(final_dist), batch.weight,
                        group)
        damping_next = (
            _next_damping(cfg, pack.damping, ls.success, rollback)
            if cfg.adaptive_damping else pack.damping
        )
        nan_guard = ~(
            torch.isfinite(pack.grad_norm)
            & torch.isfinite(surr_after)
            & torch.isfinite(entropy)
        )
        stats = TRPOStats(
            surrogate_before=pack.surr_before,
            surrogate_after=surr_after,
            kl=wmean(policy.dist.kl(batch.old_dist, final_dist),
                     batch.weight, group),
            entropy=entropy,
            grad_norm=pack.grad_norm,
            step_norm=norm(x_new - x0),
            cg_iterations=pack.cg_iterations,
            cg_residual=pack.cg_residual,
            linesearch_success=ls.success,
            step_fraction=ls.step_fraction,
            rolled_back=rollback,
            damping=pack.damping,
            linesearch_trials=ls.trials,
            nan_guard=nan_guard,
            cg_budget=pack.cg_budget,
            precond_next=pack.precond_next,
            damping_next=damping_next,
            solve_cosine=pack.solve_cosine,
            solve_audited=pack.solve_audited,
            solve_fallback=pack.solve_fallback,
            solve_pinned=pack.solve_pinned,
            ladder_next=pack.ladder_next,
            cg_iterations_cheap=pack.cg_iterations_cheap,
        )
    return to_params(x_new), stats


def make_staged_trpo_update(policy: Policy, cfg: TRPOConfig,
                            jacobi_probes=None, *, group=None,
                            allow_fused: bool = True):
    """:func:`make_trpo_update` split at the solve → line-search seam:
    ``(solve, finish)`` with ``solve(params, batch, damping=None,
    precond=None, ladder=None) -> SolvePack`` (gradient, CG solve, step
    scaling) and ``finish(params, batch, pack) -> (new_params, stats)``
    (line search, KL rollback, stats). ``finish(params, batch,
    solve(params, batch, ...))`` runs the same two stage bodies as the
    fused update, so it is bitwise equal to it. The overlapped loop
    (``agent._overlap_learner_step``) times the two stages apart.

    ``group`` (a process group over the batch axis) makes it the
    data-parallel update: ``batch`` is this rank's rows and every batch
    reduction is summed over the group (``parallel/sharded.py``).
    ``allow_fused=False`` keeps the fused kernel out, as the reference's
    mesh and population paths do: ``"auto"`` takes the Gauss-Newton
    operator and an explicit ``"fused"`` raises.

    A policy sharded over a parameter axis (``policy.tp``, a
    ``parallel.tp.ModelAxis``) takes this rank's blocks as ``params``: the
    solve runs over their concatenation with the axis's inner product
    (``parallel.tp.make_flat_space``), and never with the fused kernel,
    as the reference's tree update (the kernel does not partition a
    sharded torso)."""
    spaces = []   # the axis's inner product, from the first call's blocks
    if policy.tp is not None:
        allow_fused = False

    def space_of(params):
        if policy.tp is None:
            return None
        if not spaces:
            from trpo_torch.parallel.tp import make_flat_space

            spaces.append(make_flat_space(params, policy.tp))
        return spaces[0]

    def solve(params, batch: TRPOBatch, damping=None,
              precond: Optional[PrecondState] = None,
              ladder: Optional[LadderState] = None) -> SolvePack:
        flat0, unravel = flatten_params(params)
        return _solve_stage(policy, cfg, unravel, flat0.float().detach(),
                            batch, damping, precond, ladder, jacobi_probes,
                            group, allow_fused, space_of(params))

    def finish(params, batch: TRPOBatch, pack: SolvePack):
        flat0, unravel = flatten_params(params)
        return _finish_stage(policy, cfg, unravel, flat0.float().detach(),
                             batch, pack, group, space_of(params))

    return solve, finish


def make_trpo_update(policy: Policy, cfg: TRPOConfig, jacobi_probes=None, *,
                     group=None, allow_fused: bool = True):
    """The update in the flat-vector domain: ``update(params, batch,
    damping=None, precond=None, ladder=None) -> (new_params, stats)``.
    ``damping`` (a device scalar) overrides ``cfg.cg_damping``;
    ``precond`` (a ``PrecondState``) arms the amortized head-block refresh;
    ``ladder`` (a :class:`LadderState`) arms the solve audit and the
    adaptive CG budget, and without it the cheap path runs unaudited.
    ``jacobi_probes`` (``cg_precond_probes`` flat ±1 vectors) replaces the
    Jacobi preconditioner's own draws (a test lever). It is the two stages
    of :func:`make_staged_trpo_update` composed (``group`` and
    ``allow_fused`` as there)."""
    solve, finish = make_staged_trpo_update(policy, cfg, jacobi_probes,
                                            group=group,
                                            allow_fused=allow_fused)

    def update(params, batch: TRPOBatch, damping=None,
               precond: Optional[PrecondState] = None,
               ladder: Optional[LadderState] = None):
        return finish(params, batch,
                      solve(params, batch, damping, precond, ladder))

    return update


def make_tree_trpo_update(policy: Policy, cfg: TRPOConfig, *, group=None):
    """The reference's name for the update without the fused kernel, the
    one a parameter axis takes (:func:`make_trpo_update`)."""
    return make_trpo_update(policy, cfg, group=group, allow_fused=False)


def standardize_advantages(adv: torch.Tensor, weight: torch.Tensor,
                           group=None) -> torch.Tensor:
    """Zero-mean unit-variance advantages over real (unpadded) steps of
    every rank of ``group``."""
    mean = wmean(adv, weight, group)
    var = wmean((adv - mean) ** 2, weight, group)
    return (adv - mean) / (torch.sqrt(var) + 1e-8) * weight
