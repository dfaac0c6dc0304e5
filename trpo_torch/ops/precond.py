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

The Hutchinson/Jacobi preconditioner waits (ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

__all__ = [
    "PrecondState",
    "apply_gaussian_head_block_inv",
    "gaussian_head_gram",
    "head_gram_eigh",
    "init_gaussian_head_precond",
]


class PrecondState(NamedTuple):
    u: torch.Tensor      # (H+1, H+1) eigenvectors of the head Gram S̃
    s_eig: torch.Tensor  # (H+1,) eigenvalues, clamped ≥ 0
    age: int             # updates since init; refresh when age % k == 0


def gaussian_head_gram(torso_apply: Callable, net_params: Any,
                       obs: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``S̃ = h̃ᵀ diag(wₙ) h̃`` over ``h̃ = [h, 1]``, (H+1, H+1) f32, where
    ``torso_apply(net_params, obs)`` returns the last hidden activation."""
    h = torso_apply(net_params, obs).float()
    w = weight.reshape(-1).float()
    wn = w / torch.clamp(w.sum(), min=1.0)
    h1 = torch.cat([h, torch.ones_like(h[:, :1])], dim=1)
    return (h1 * wn[:, None]).T @ h1


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


def apply_gaussian_head_block_inv(s_eig, U, weight, log_std, damping):
    """The tree map ``r ↦ M⁻¹r`` over ``{"net", "log_std"}`` for the
    (possibly stale) factors and the CURRENT log-std and damping."""
    w = weight.reshape(-1).float()
    wn_sum = (w / torch.clamp(w.sum(), min=1.0)).sum()
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
