"""Policy abstraction: obs -> distribution parameters (counterpart:
``trpo_tpu/models/policy.py``).

The plain-MLP branch with the diagonal-Gaussian head: a state-independent
learned ``log_std`` beside an MLP mean. Conv, recurrent and
mixture-of-experts torsos and the categorical head wait for later slices
(ROADMAP.md Queue 1 items 2 and 14).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from trpo_torch.distributions import DiagGaussian
from trpo_torch.models.mlp import apply_mlp, init_mlp

__all__ = ["BoxSpec", "Policy", "make_policy"]


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


def make_policy(
    obs_shape: Tuple[int, ...],
    action_spec,
    hidden: Tuple[int, ...] = (64,),
    activation: str = "tanh",
    init_log_std: float = 0.0,
    compute_dtype=torch.float32,
) -> Policy:
    """Build an MLP diagonal-Gaussian policy for ``obs_shape``.

    ``init(generator)`` draws the params on the CPU generator it is given
    (callers move them to their device)."""
    if not isinstance(action_spec, BoxSpec):
        raise NotImplementedError(
            f"action spec {action_spec!r}: only BoxSpec (diagonal Gaussian) "
            "is ported to trpo_torch yet (ROADMAP.md Queue 1 item 2)"
        )
    if len(obs_shape) != 1:
        raise NotImplementedError(
            "conv torsos are not ported to trpo_torch yet "
            "(ROADMAP.md Queue 1 item 14)"
        )
    obs_dim = math.prod(obs_shape)
    out_dim = action_spec.dim

    def init(generator: torch.Generator):
        return {
            "net": init_mlp(generator, obs_dim, hidden, out_dim),
            "log_std": torch.full((out_dim,), float(init_log_std)),
        }

    def apply(params, obs):
        obs = obs.reshape(obs.shape[0], -1)
        mean = apply_mlp(params["net"], obs, activation, compute_dtype)
        return {"mean": mean, "log_std": params["log_std"].expand_as(mean)}

    return Policy(
        init=init,
        apply=apply,
        dist=DiagGaussian,
        action_spec=action_spec,
        mlp_spec={
            "activation": activation,
            "compute_dtype": compute_dtype,
            "hidden": tuple(hidden),
        },
    )
