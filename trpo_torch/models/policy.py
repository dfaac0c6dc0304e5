"""Policy abstraction: obs -> distribution parameters (counterpart:
``trpo_tpu/models/policy.py``).

The plain-MLP branch with either head: the categorical (logits) head for
discrete actions, or the diagonal Gaussian with a state-independent
learned ``log_std`` beside an MLP mean. Conv, recurrent and
mixture-of-experts torsos wait for a later slice (ROADMAP.md Queue 1
item 14).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from trpo_torch.distributions import Categorical, DiagGaussian
from trpo_torch.models.mlp import apply_mlp, init_mlp

__all__ = ["BoxSpec", "DiscreteSpec", "Policy", "make_policy"]


@dataclasses.dataclass(frozen=True)
class DiscreteSpec:
    """n discrete actions."""
    n: int


@dataclasses.dataclass(frozen=True)
class BoxSpec:
    """dim-dimensional continuous actions."""
    dim: int


class Policy(NamedTuple):
    init: Callable[[torch.Generator], Any]   # CPU generator -> params
    apply: Callable[[Any, torch.Tensor], Any]  # (params, obs) -> dist params
    dist: Any
    action_spec: Any
    # structural metadata for the fused FVP kernel (ops/fused_fvp.py)
    mlp_spec: Any = None
    # ``apply`` with the matmul dtype overridden per call,
    # ``apply_cast(params, obs, dtype)``: the bf16 rung's GGN matvec
    # (cfg.fvp_dtype) for policies the fused kernel does not cover
    apply_cast: Any = None


def make_policy(
    obs_shape: Tuple[int, ...],
    action_spec,
    hidden: Tuple[int, ...] = (64,),
    activation: str = "tanh",
    init_log_std: float = 0.0,
    compute_dtype=torch.float32,
) -> Policy:
    """Build an MLP policy for ``obs_shape``: categorical logits for a
    ``DiscreteSpec``, a diagonal Gaussian for a ``BoxSpec``.

    ``init(generator)`` draws the params on the CPU generator it is given
    (callers move them to their device)."""
    if isinstance(action_spec, DiscreteSpec):
        out_dim, dist = action_spec.n, Categorical
    elif isinstance(action_spec, BoxSpec):
        out_dim, dist = action_spec.dim, DiagGaussian
    else:
        raise TypeError(f"unsupported action spec: {action_spec!r}")
    if len(obs_shape) != 1:
        raise NotImplementedError(
            "conv torsos are not ported to trpo_torch yet "
            "(ROADMAP.md Queue 1 item 14)"
        )
    obs_dim = math.prod(obs_shape)

    def init(generator: torch.Generator):
        params = {"net": init_mlp(generator, obs_dim, hidden, out_dim)}
        if dist is DiagGaussian:
            params["log_std"] = torch.full((out_dim,), float(init_log_std))
        return params

    def apply_cast(params, obs, dtype):
        obs = obs.reshape(obs.shape[0], -1)
        raw = apply_mlp(params["net"], obs, activation, dtype)
        if dist is Categorical:
            return {"logits": raw}
        return {"mean": raw, "log_std": params["log_std"].expand_as(raw)}

    def apply(params, obs):
        return apply_cast(params, obs, compute_dtype)

    return Policy(
        init=init,
        apply=apply,
        dist=dist,
        action_spec=action_spec,
        mlp_spec={
            "activation": activation,
            "compute_dtype": compute_dtype,
            "hidden": tuple(hidden),
        },
        apply_cast=apply_cast,
    )
