"""Mixture-of-experts policy torso (counterpart: ``trpo_tpu/models/moe.py``).

A soft (dense) mixture: ``K`` MLP torsos run on every row and a learned
softmax gate blends their outputs into the distribution head. Routing is
smooth, so the Fisher operator differentiates it like any other net. Each
layer is one ``einsum`` over the expert-stacked ``(K, d_in, d_out)``
weights, and the blend contracts the expert axis.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from trpo_torch.distributions import Categorical, DiagGaussian
from trpo_torch.models.mlp import ACTIVATIONS, init_linear
from trpo_torch.models.policy import BoxSpec, DiscreteSpec, Policy

__all__ = ["apply_moe_mlp", "init_moe_mlp", "make_moe_policy"]


def init_moe_mlp(generator: torch.Generator, n_experts: int, in_dim: int,
                 hidden, out_dim: int):
    """Expert-stacked MLP params: each leaf gains a leading ``(K,)`` axis
    (``w (K, d_in, d_out)``, ``b (K, d_out)``)."""
    sizes = [in_dim, *hidden, out_dim]
    layers = []
    for d_in, d_out in zip(sizes[:-1], sizes[1:]):
        per_expert = [init_linear(generator, d_in, d_out)
                      for _ in range(n_experts)]
        layers.append({"w": torch.stack([p["w"] for p in per_expert]),
                       "b": torch.stack([p["b"] for p in per_expert])})
    return {"layers": layers}


def apply_moe_mlp(params, gate_weights, x, activation="tanh",
                  compute_dtype=torch.float32):
    """All experts forward densely, then the gate blends them: ``x (B,
    d)``, ``gate_weights (B, K)`` → ``(B, out)`` f32."""
    act = ACTIVATIONS[activation]
    cd = compute_dtype
    h = x.to(cd)  # (B, d); gains the expert axis at layer 0
    layers = params["layers"]
    for i, layer in enumerate(layers):
        eq = "bi,kio->bko" if h.ndim == 2 else "bki,kio->bko"
        h = torch.einsum(eq, h, layer["w"].to(cd)) + layer["b"].to(cd)[None]
        if i < len(layers) - 1:
            h = act(h)
    return torch.einsum("bko,bk->bo", h, gate_weights.to(cd)).float()


def make_moe_policy(
    obs_shape: Tuple[int, ...],
    action_spec,
    hidden: Tuple[int, ...] = (64,),
    n_experts: int = 4,
    activation: str = "tanh",
    init_log_std: float = 0.0,
    compute_dtype=torch.float32,
) -> Policy:
    """Soft-MoE policy: ``gate(obs)`` blends ``n_experts`` MLP torsos into
    the distribution head; the activation follows the blend. The same
    :class:`Policy` contract as ``make_policy``, without a fused-kernel
    spec or a castable forward."""
    if activation not in ACTIVATIONS:
        raise KeyError(
            f"unknown activation {activation!r}; have {sorted(ACTIVATIONS)}"
        )
    if n_experts < 2:
        raise ValueError(f"n_experts must be >= 2, got {n_experts}")
    if isinstance(action_spec, DiscreteSpec):
        out_dim, dist = action_spec.n, Categorical
    elif isinstance(action_spec, BoxSpec):
        out_dim, dist = action_spec.dim, DiagGaussian
    else:
        raise TypeError(f"unsupported action spec: {action_spec!r}")
    if len(obs_shape) != 1:
        raise ValueError("MoE torso takes 1-D observations")
    obs_dim = math.prod(obs_shape)
    feat_dim = hidden[-1] if hidden else obs_dim
    cd = compute_dtype

    def init(generator: torch.Generator):
        params = {
            "gate": init_linear(generator, obs_dim, n_experts, scale=0.01),
            "experts": init_moe_mlp(generator, n_experts, obs_dim,
                                    hidden[:-1], feat_dim),
            # small final scale: a near-uniform initial policy
            "head": init_linear(generator, feat_dim, out_dim, scale=0.01),
        }
        if dist is DiagGaussian:
            params["log_std"] = torch.full((out_dim,), float(init_log_std))
        return params

    def apply(params, obs):
        x = obs.reshape(obs.shape[0], -1)
        gate = torch.softmax(
            x.to(cd) @ params["gate"]["w"].to(cd) + params["gate"]["b"].to(cd),
            dim=-1)
        feats = ACTIVATIONS[activation](
            apply_moe_mlp(params["experts"], gate, x, activation, cd))
        raw = (feats.to(cd) @ params["head"]["w"].to(cd)
               + params["head"]["b"].to(cd)).float()
        if dist is Categorical:
            return {"logits": raw}
        return {"mean": raw, "log_std": params["log_std"].expand_as(raw)}

    return Policy(init=init, apply=apply, dist=dist, action_spec=action_spec)
