"""Data-parallel TRPO: the batch split over ranks, every batch reduction
an explicit collective (counterpart: ``trpo_tpu/parallel/sharded.py``).

The reference jits its update with the batch sharded over the ``"data"``
axis and lets GSPMD insert the ``psum``s; its explicit ``shard_map`` FVPs
spell the same collective by hand. In the port every rank holds its own
slice of the batch and the update's reductions go through
``ops/allreduce.py`` with the axis's process group, so one function does
both jobs: :func:`make_sharded_update` is the port's update with a group,
and the three sharded FVPs are the per-rank operators with one all-reduce
each.

Every mean is ``Σ(x·w) / Σw`` over all ranks, so padding rows of weight 0
(:func:`pad_batch`) and uneven shards change nothing.

Each function takes a ``parallel.mesh.Mesh`` and the name of its batch
axis; a batch argument is this rank's LOCAL rows (:func:`shard_batch`
cuts them from the global batch).
"""

from __future__ import annotations

from typing import Callable

import torch

from trpo_torch.config import TRPOConfig
from trpo_torch.models.policy import Policy
from trpo_torch.ops.allreduce import (
    all_gather_cat, all_sum, weight_total, wshare)
from trpo_torch.ops.flat import flatten_params, tree_map
from trpo_torch.ops.fused_fvp import (
    fused_fvp_supported,
    make_fused_gaussian_mlp_fvp,
)
from trpo_torch.ops.fvp import make_fvp, make_ggn_fvp
from trpo_torch.trpo import TRPOBatch, make_trpo_update

__all__ = [
    "LocalSliceEnv",
    "gather_leading_axis",
    "gather_state",
    "global_draw_policy",
    "local_state",
    "make_sharded_fused_fvp",
    "make_sharded_fvp",
    "make_sharded_ggn_fvp",
    "make_sharded_update",
    "pad_batch",
    "shard_batch",
    "shard_leading_axis",
]


def shard_leading_axis(mesh, tree, axis: str = "data", dim: int = 0):
    """This rank's slice of dimension ``dim`` of every leaf of ``tree``:
    the one placement rule of the port (the env axis of the rollout carry,
    the batch axis of update inputs, ``dim=1`` of time-major
    trajectories). Leaves with no dimension ``dim`` (scalars) are kept
    whole. The dimension must divide the axis size; pad first
    (:func:`pad_batch`) if it does not."""
    n, r = mesh.shape[axis], mesh.coordinate(axis)

    def cut(x):
        if not isinstance(x, torch.Tensor) or x.ndim <= dim:
            return x
        size = x.shape[dim]
        if size % n:
            raise ValueError(
                f"dimension {dim} of size {size} does not divide over the "
                f"{axis}={n} mesh axis; pad it first (pad_batch)")
        k = size // n
        return x.narrow(dim, r * k, k)

    return tree_map(cut, tree)


def gather_leading_axis(mesh, tree, axis: str = "data", dim: int = 0):
    """The inverse of :func:`shard_leading_axis`: every rank's slice of
    dimension ``dim`` joined in rank order (one all-gather per leaf)."""
    group = mesh.group(axis)
    return tree_map(
        lambda x: all_gather_cat(x, group, dim)
        if isinstance(x, torch.Tensor) and x.ndim > dim else x, tree)


def gather_state(mesh, state, param_layout=None):
    """A ``TrainState`` with its env carry gathered over the batch axis
    and, with ``param_layout`` (``(axis, split dims)``, the agent's
    ``param_layout``), its policy params over that parameter axis: the
    global state, as a one-rank run holds it (a collective: every rank
    calls it). Everything else in the state is replicated."""
    if param_layout is not None:
        from trpo_torch.parallel.tp import gather_policy_params

        axis, specs = param_layout
        state = state._replace(policy_params=gather_policy_params(
            state.policy_params, mesh, specs, axis))
    if getattr(state, "env_carry", None) is None:
        return state
    return state._replace(env_carry=gather_leading_axis(
        mesh, state.env_carry, mesh.axis_names[0]))


def local_state(mesh, state, param_layout=None):
    """The inverse of :func:`gather_state`: this rank's slice of the env
    carry and, with ``param_layout``, its blocks of the policy params."""
    if param_layout is not None:
        from trpo_torch.parallel.tp import shard_policy_params

        axis, specs = param_layout
        state = state._replace(policy_params=shard_policy_params(
            state.policy_params, mesh, axis, specs))
    if getattr(state, "env_carry", None) is None:
        return state
    return state._replace(env_carry=shard_leading_axis(
        mesh, state.env_carry, mesh.axis_names[0]))


class LocalSliceEnv:
    """A device env whose ``reset(n, generator)`` draws the resets of all
    ``size·n`` envs of the mesh from ``generator`` and keeps rank
    ``rank``'s ``n``: every rank draws what the one-rank run draws, so its
    envs start where that run's do. Everything else is the env's."""

    def __init__(self, env, rank: int, size: int):
        self.env, self.rank, self.size = env, rank, size

    def reset(self, n_envs: int, generator=None):
        states, obs = self.env.reset(n_envs * self.size, generator)
        cut = lambda x: x.narrow(0, self.rank * n_envs, n_envs)  # noqa
        return tree_map(cut, states), cut(obs)

    def __getattr__(self, name):
        return getattr(self.env, name)


class _GlobalDrawDist:
    """``dist`` whose :meth:`sample` draws the noise of all ``size`` ranks'
    rows and keeps rank ``rank``'s slice (the same numbers a one-rank run
    draws for those rows)."""

    def __init__(self, dist, rank: int, size: int):
        self._dist, self._rank, self._size = dist, rank, size

    def sample(self, params, noise=None, generator=None):
        if noise is None:
            ref = params["logits"] if "logits" in params else params["mean"]
            n = ref.shape[0]
            noise = self._dist.draw_noise(
                (n * self._size,) + tuple(ref.shape[1:]), generator,
                ref.device, ref.dtype).narrow(0, self._rank * n, n)
        return self._dist.sample(params, noise=noise)

    def __getattr__(self, name):
        return getattr(self._dist, name)


def global_draw_policy(policy: Policy, rank: int, size: int) -> Policy:
    """``policy`` sampling as rank ``rank`` of ``size`` over the global
    noise (:class:`_GlobalDrawDist`); its other parts unchanged."""
    return policy._replace(dist=_GlobalDrawDist(policy.dist, rank, size))


def pad_batch(batch: TRPOBatch, multiple: int) -> TRPOBatch:
    """Zero-weight-pad the batch so its leading dim divides ``multiple``:
    padding rows carry ``weight=0``, so every weighted mean of the update
    is unchanged."""
    b = batch.weight.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return batch

    def pad(x):
        if x is None:
            return None
        return torch.cat([x, torch.zeros((rem,) + tuple(x.shape[1:]),
                                         dtype=x.dtype, device=x.device)])

    return TRPOBatch(
        obs=pad(batch.obs),
        actions=pad(batch.actions),
        advantages=pad(batch.advantages),
        old_dist=tree_map(pad, batch.old_dist),
        weight=pad(batch.weight),  # zeros: padding is weightless
        is_weight=pad(batch.is_weight),
    )


def shard_batch(mesh, batch: TRPOBatch, axis: str = "data") -> TRPOBatch:
    """Pad the GLOBAL batch to the axis size and keep this rank's
    contiguous rows."""
    return shard_leading_axis(mesh, pad_batch(batch, mesh.shape[axis]), axis)


def make_sharded_update(policy: Policy, cfg: TRPOConfig, mesh,
                        axis: str = "data") -> Callable:
    """The TRPO update over a batch sharded on ``axis``: ``update(params,
    local_batch, damping=None, precond=None, ladder=None) -> (params,
    stats)``, with every batch reduction all-reduced over the axis. Params,
    damping, preconditioner and ladder are replicated, and come back equal
    on every rank. As on the reference's mesh, ``fvp_mode="auto"`` takes
    the Gauss-Newton operator and an explicit ``"fused"`` raises."""
    return make_trpo_update(policy, cfg, group=mesh.group(axis),
                            allow_fused=False)


def _sharded_fvp(cfg: TRPOConfig, build: Callable) -> Callable:
    """``fvp_fn(params, local_batch, v) -> (F + λI)v`` around
    ``build(params, local_batch) -> v ↦ (F + λI)v``; ``fvp_fn.operator``
    is ``build`` itself, so a CG solve builds the operator once."""

    def fvp_fn(params, batch: TRPOBatch, v: torch.Tensor) -> torch.Tensor:
        return build(params, batch)(v)

    fvp_fn.operator = build
    return fvp_fn


def make_sharded_fvp(policy: Policy, cfg: TRPOConfig, mesh,
                     axis: str = "data") -> Callable:
    """The jvp∘grad Fisher-vector product over a sharded batch: each rank
    differentiates its rows' KL sum normalised by the global weight, the
    Hessian-vector products are summed over ranks, and the damping is
    added after the sum."""
    group = mesh.group(axis)

    def build(params, batch: TRPOBatch):
        flat0, unravel = flatten_params(params)
        flat0 = flat0.float().detach()
        wtot = weight_total(batch.weight, group)
        with torch.no_grad():
            cur = policy.apply(params, batch.obs)

        def kl_local(flat):
            dist = policy.apply(unravel(flat), batch.obs)
            return wshare(policy.dist.kl(cur, dist), batch.weight, wtot)

        return make_fvp(kl_local, flat0, damping=cfg.cg_damping, group=group)

    return _sharded_fvp(cfg, build)


def make_sharded_ggn_fvp(policy: Policy, cfg: TRPOConfig, mesh,
                         axis: str = "data") -> Callable:
    """The Gauss-Newton factorization over a sharded batch (the port's
    default operator off the fused kernel): each rank's forward tangent,
    dist-space Fisher and pullback over its rows, weighted by the global
    weight sum, then one all-reduce and the damping."""
    group = mesh.group(axis)

    def build(params, batch: TRPOBatch):
        flat0, unravel = flatten_params(params)
        return make_ggn_fvp(
            lambda x: policy.apply(unravel(x), batch.obs),
            policy.dist.fisher_weight, flat0.float().detach(), batch.weight,
            damping=cfg.cg_damping, group=group)

    return _sharded_fvp(cfg, build)


def make_sharded_fused_fvp(policy: Policy, cfg: TRPOConfig, mesh,
                           axis: str = "data") -> Callable:
    """:func:`make_sharded_ggn_fvp` on the fused kernel: each rank launches
    K1 (K1-bf16 for a bfloat16 policy) on its local rows with no damping,
    rescales the local weighted mean by its share of the global weight
    (the reference's ``psum(num)/psum(w)`` contract, with ``Σw`` reduced
    once when the operator is built), then one all-reduce of the product
    crosses the mesh and the damping is added after it. A rank whose rows
    all weigh 0 contributes zeros.

    Eligibility is the port's fused-kernel rule (``fused_fvp_supported``:
    a plain MLP diagonal Gaussian, any widths); the reference's
    128-lane-multiple widths are a TPU VMEM constraint the CUDA kernels do
    not have."""
    spec = getattr(policy, "mlp_spec", None)
    if spec is None or getattr(policy.dist, "name", None) != "diag_gaussian":
        raise ValueError(
            "make_sharded_fused_fvp needs the plain-MLP diagonal-Gaussian "
            "policy (fused-kernel eligibility); use make_sharded_ggn_fvp")
    group = mesh.group(axis)

    def build(params, batch: TRPOBatch):
        if not fused_fvp_supported(spec["activation"], params["net"]):
            raise ValueError(
                f"activation {spec['activation']!r} / torso shape not "
                "kernel-eligible; use make_sharded_ggn_fvp")
        op = make_fused_gaussian_mlp_fvp(
            params["net"], batch.obs, batch.weight, params["log_std"], 0.0,
            activation=spec["activation"],
            compute_dtype=spec["compute_dtype"])
        # the kernel's weighted mean over the local rows, rescaled to this
        # rank's share of the global mean: Σ_local w / Σ_global w. The
        # weights are the same at every CG iteration, so their sum crosses
        # the mesh once, here, and each product in one all-reduce; on one
        # rank the factor is exactly 1 and the operator is K1's, bit for
        # bit
        w = batch.weight.reshape(-1).float()
        share = torch.clamp(torch.sum(w), min=1.0) / weight_total(w, group)

        def fvp(v: torch.Tensor) -> torch.Tensor:
            v = v.float()
            return all_sum(op.flat(v) * share, group) + cfg.cg_damping * v

        return fvp

    return _sharded_fvp(cfg, build)
