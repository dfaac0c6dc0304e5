"""Value-function baseline (counterpart: ``trpo_tpu/vf.py``).

An MLP critic fit with ``train_steps`` full-batch Adam steps on the
weighted MSE. Adam is written out to match ``optax.adam``: moments
``μ ← β₁μ + (1−β₁)g``, ``ν ← β₂ν + (1−β₂)g²``, bias correction with the
incremented count, then ``−lr · μ̂ / (√ν̂ + ε)``, ε = 1e-8. The
``initialized`` flag makes the critic predict zeros before its first fit,
so iteration 0's advantages are raw returns, as in the reference.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from trpo_torch.models.mlp import apply_mlp, init_mlp
from trpo_torch.ops.flat import flatten_params, tree_map

__all__ = ["AdamState", "VFState", "ValueFunctionDef", "create_value_function"]


class AdamState(NamedTuple):
    count: int   # steps taken
    mu: Any      # first moments, shaped like the params
    nu: Any      # second moments


class VFState(NamedTuple):
    params: dict
    opt_state: AdamState
    initialized: bool   # False → predict zeros


class ValueFunctionDef(NamedTuple):
    init: Any       # CPU generator -> VFState (CPU tensors)
    predict: Any    # (VFState, obs) -> (B,) values
    fit: Any        # (VFState, obs, targets, weight) -> (VFState, loss)


def create_value_function(
    obs_dim: int,
    hidden: Tuple[int, ...] = (64, 64),
    activation: str = "relu",
    learning_rate: float = 1e-3,
    train_steps: int = 50,
    compute_dtype=torch.float32,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> ValueFunctionDef:

    def init(generator: torch.Generator) -> VFState:
        params = init_mlp(generator, obs_dim, hidden, 1, final_scale=1.0)
        return VFState(
            params=params,
            opt_state=AdamState(0, tree_map(torch.zeros_like, params),
                                tree_map(torch.zeros_like, params)),
            initialized=False,
        )

    def forward(params, obs):
        return apply_mlp(params, obs.reshape(-1, obs_dim), activation,
                         compute_dtype)[:, 0]

    def predict(state: VFState, obs):
        vals = forward(state.params, obs)
        return vals if state.initialized else torch.zeros_like(vals)

    def fit(state: VFState, obs, targets, weight):
        """``train_steps`` full-batch Adam steps on the weighted MSE, on
        the flat parameter vector (elementwise, so the layout does not
        change a value)."""
        obs = obs.reshape(-1, obs_dim)
        targets = targets.reshape(-1)
        weight = weight.reshape(-1)
        wsum = torch.clamp(weight.sum(), min=1.0)
        flat, unravel = flatten_params(state.params)
        flat = flat.detach()
        count = state.opt_state.count
        mu = flatten_params(state.opt_state.mu)[0]
        nu = flatten_params(state.opt_state.nu)[0]
        loss = None
        for _ in range(train_steps):
            x = flat.clone().requires_grad_(True)
            with torch.enable_grad():
                err = forward(unravel(x), obs) - targets
                loss = torch.sum(err * err * weight) / wsum
                (g,) = torch.autograd.grad(loss, x)
            count += 1
            mu = b1 * mu + (1.0 - b1) * g
            nu = b2 * nu + (1.0 - b2) * g * g
            # bias corrections in f32, as optax computes them
            c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
            c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
            m_hat = mu / c1.to(mu.device)
            v_hat = nu / c2.to(nu.device)
            flat = flat - learning_rate * (m_hat / (torch.sqrt(v_hat) + eps))
        return (
            VFState(unravel(flat), AdamState(count, unravel(mu), unravel(nu)),
                    True),
            loss.detach(),
        )

    return ValueFunctionDef(init=init, predict=predict, fit=fit)

