"""Gaussian-head block preconditioner for the natural-gradient solve
(counterpart: ``trpo_tpu/ops/precond.py``, the ``head_block`` path).

For a linear head ``mean = h W + b`` with state-independent ``log_std``,
the (W, b) Fisher block is exactly ``S̃ ⊗ diag(m)`` with
``S̃ = h̃ᵀ diag(wₙ) h̃`` over ``h̃ = [h, 1]`` and ``m = e^{-2σ}``, and the
log-std block is ``2·Σwₙ·I``. So ``(F + λI)⁻¹`` restricted to the head is a
closed form through one ``eigh`` of the (H+1)² Gram; the torso is left as
the identity. The Gram factors are the expensive part and are refreshed
every ``precond_refresh_every`` updates (:class:`PrecondState`, carried in
``TrainState``); the log-std and damping parts are applied fresh.

The Jacobi preconditioner (``cg_precondition="jacobi"``):
:func:`hutchinson_diag` estimates ``diag(A)`` of an SPD operator from
Rademacher probes ``v`` (``E[v ⊙ Av] = diag(A)``), each one application of
``A`` — in the update, the same operator CG iterates (K1 under ``auto``).
:func:`hutchinson_diag_inv` floors the estimate at the damping λ
(``diag(F + λI) ≥ λ``) and inverts it. The probes come from a fixed-seed
generator, so updates reproduce; ``probes`` passes given ones instead
(the tests pass the reference's draws).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from trpo_torch.ops.allreduce import all_sum, weight_total
from trpo_torch.ops.flat import tree_leaves, tree_map

__all__ = [
    "PrecondState",
    "apply_gaussian_head_block_inv",
    "gaussian_head_gram",
    "head_gram_eigh",
    "hutchinson_diag",
    "hutchinson_diag_inv",
    "init_gaussian_head_precond",
    "make_gaussian_head_block_inv",
    "rademacher_probes",
]


class PrecondState(NamedTuple):
    u: torch.Tensor      # (H+1, H+1) eigenvectors of the head Gram S̃
    s_eig: torch.Tensor  # (H+1,) eigenvalues, clamped ≥ 0
    age: int             # updates since init; refresh when age % k == 0


def gaussian_head_gram(torso_apply: Callable, net_params: Any,
                       obs: torch.Tensor, weight: torch.Tensor,
                       group=None) -> torch.Tensor:
    """``S̃ = h̃ᵀ diag(wₙ) h̃`` over ``h̃ = [h, 1]``, (H+1, H+1) f32, where
    ``torso_apply(net_params, obs)`` returns the last hidden activation;
    summed over the ranks of ``group`` (data parallelism)."""
    h = torso_apply(net_params, obs).float()
    w = weight.reshape(-1).float()
    wn = w / weight_total(w, group)
    h1 = torch.cat([h, torch.ones_like(h[:, :1])], dim=1)
    return all_sum((h1 * wn[:, None]).T @ h1, group)


def head_gram_eigh(S: torch.Tensor):
    """``(s_eig, U)`` of the head Gram, eigenvalues clamped ≥ 0."""
    s_eig, U = torch.linalg.eigh(S.float())
    return torch.clamp(s_eig, min=0.0), U


def init_gaussian_head_precond(params) -> PrecondState:
    """Zero factors at age 0: the first update refreshes before use."""
    w_head = params["net"]["layers"][-1]["w"]
    H = w_head.shape[0]
    return PrecondState(
        u=torch.zeros(H + 1, H + 1, device=w_head.device),
        s_eig=torch.zeros(H + 1, device=w_head.device),
        age=0,
    )


def apply_gaussian_head_block_inv(s_eig, U, weight, log_std, damping,
                                  group=None):
    """The tree map ``r ↦ M⁻¹r`` over ``{"net", "log_std"}`` for the
    (possibly stale) factors and the CURRENT log-std and damping."""
    w = weight.reshape(-1).float()
    wn_sum = all_sum((w / weight_total(w, group)).sum(), group)
    m = torch.exp(-2.0 * log_std.float())
    denom = torch.clamp(s_eig[:, None] * m[None, :] + damping, min=1e-12)
    sigma_denom = torch.clamp(2.0 * wn_sum + damping, min=1e-12)

    def apply_tree(r):
        layers = r["net"]["layers"]
        head = layers[-1]
        X = torch.cat([head["w"].float(), head["b"].float()[None, :]], dim=0)
        Y = U @ ((U.T @ X) / denom)
        new_layers = list(layers[:-1]) + [{"w": Y[:-1, :], "b": Y[-1, :]}]
        return {
            "net": {**r["net"], "layers": new_layers},
            "log_std": r["log_std"].float() / sigma_denom,
        }

    return apply_tree


def make_gaussian_head_block_inv(torso_apply: Callable, net_params: Any,
                                 obs: torch.Tensor, weight: torch.Tensor,
                                 log_std: torch.Tensor, damping):
    """The per-update head-block preconditioner ``r ↦ M⁻¹r`` over params
    trees: :func:`gaussian_head_gram` → :func:`head_gram_eigh` →
    :func:`apply_gaussian_head_block_inv`."""
    S = gaussian_head_gram(torso_apply, net_params, obs, weight)
    s_eig, U = head_gram_eigh(S)
    return apply_gaussian_head_block_inv(s_eig, U, weight, log_std, damping)


def _rademacher_like(like: Any, generator: torch.Generator) -> Any:
    """A ±1 f32 probe shaped like ``like`` (a tensor or a tree)."""
    return tree_map(
        lambda x: torch.randint(0, 2, x.shape, generator=generator,
                                device=x.device).float() * 2.0 - 1.0, like)


def rademacher_probes(n: int, n_probes: int, device) -> list:
    """The ``n_probes`` probes :func:`hutchinson_diag` draws for a flat
    vector of ``n`` entries on ``device`` from its default generator."""
    generator = torch.Generator(device=device).manual_seed(0)
    like = torch.empty(n, device=device)
    return [_rademacher_like(like, generator) for _ in range(n_probes)]


def hutchinson_diag(f_Av: Callable[[Any], Any], like: Any, n_probes: int,
                    generator: Optional[torch.Generator] = None,
                    probes: Optional[Sequence[Any]] = None) -> Any:
    """``diag(A)`` of the SPD operator ``f_Av`` from ``n_probes``
    Rademacher probes shaped like ``like`` (a flat vector or a tree):
    ``Σ v ⊙ Av / n_probes``. The probes come from ``generator`` (default:
    a fresh one seeded 0 on ``like``'s device), or are ``probes[i]``."""
    if n_probes < 1:
        raise ValueError(f"n_probes must be >= 1, got {n_probes}")
    like = tree_map(lambda x: x.float(), like)
    if probes is None and generator is None:
        dev = tree_leaves(like)[0].device
        generator = torch.Generator(device=dev).manual_seed(0)
    acc = tree_map(torch.zeros_like, like)
    for i in range(n_probes):
        v = (_rademacher_like(like, generator) if probes is None
             else tree_map(lambda p, x: torch.tensor(
                 p, dtype=torch.float32, device=x.device), probes[i], like))
        av = tree_map(lambda t: t.float(), f_Av(v))
        acc = tree_map(lambda a, vv, avv: a + vv * avv, acc, v, av)
    return tree_map(lambda t: t / n_probes, acc)


def hutchinson_diag_inv(f_Av: Callable[[Any], Any], like: Any,
                        n_probes: int, floor,
                        generator: Optional[torch.Generator] = None,
                        probes: Optional[Sequence[Any]] = None) -> Any:
    """``1 / max(diag estimate, floor)``: the Jacobi preconditioner's
    inverse diagonal. Pass the damping λ as ``floor``."""
    diag = hutchinson_diag(f_Av, like, n_probes, generator, probes)
    return tree_map(
        lambda d: 1.0 / torch.clamp(d, min=torch.as_tensor(
            floor, dtype=torch.float32, device=d.device)), diag)
