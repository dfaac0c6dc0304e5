"""Policy abstraction: obs -> distribution parameters (counterpart:
``trpo_tpu/models/policy.py``).

1-D observations get an MLP, ``(H, W, C)`` pixels the Nature conv torso
(``models/conv.py``) and a dense head; either feeds the categorical
(logits) head for discrete actions, or the diagonal Gaussian with a
state-independent learned ``log_std`` beside an MLP mean. The recurrent
and mixture-of-experts families are ``models/recurrent.py`` and
``models/moe.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from trpo_torch.distributions import Categorical, DiagGaussian
from trpo_torch.models.conv import (
    apply_atari_torso,
    init_atari_torso,
    torso_features,
)
from trpo_torch.models.mlp import apply_mlp, init_mlp

__all__ = ["BoxSpec", "DiscreteSpec", "Policy", "make_policy",
           "spec_from_env"]


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
    # structural metadata for the fused FVP kernel (ops/fused_fvp.py);
    # None for the conv, recurrent and mixture-of-experts families
    mlp_spec: Any = None
    # ``apply`` with the matmul dtype overridden per call,
    # ``apply_cast(params, obs, dtype)``: the bf16 rung's GGN matvec
    # (cfg.fvp_dtype) for policies the fused kernel does not cover; None
    # for the families without a castable forward (recurrent, MoE)
    apply_cast: Any = None
    # parallel.tp.ModelAxis when ``apply`` runs on this rank's blocks of a
    # parameter axis (the layout the tree update's solve reads), else None
    tp: Any = None


def make_policy(
    obs_shape: Tuple[int, ...],
    action_spec,
    hidden: Tuple[int, ...] = (64,),
    activation: str = "tanh",
    init_log_std: float = 0.0,
    compute_dtype=torch.float32,
    conv_torso: Optional[bool] = None,
    tp=None,
) -> Policy:
    """Build a policy for ``obs_shape``: an MLP on 1-D observations, the
    Atari conv torso and a dense head on ``(H, W, C)`` ones (by default,
    or as ``conv_torso`` says); categorical logits for a ``DiscreteSpec``,
    a diagonal Gaussian for a ``BoxSpec``.

    ``init(generator)`` draws the params on the CPU generator it is given
    (callers move them to their device). ``tp`` (a
    ``parallel.tp.ModelAxis``) makes ``apply`` the sharded forward over
    this rank's blocks of the params (``parallel.tp.shard_policy_params``);
    the conv torso stays replicated."""
    if conv_torso is None:
        conv_torso = len(obs_shape) == 3
    if isinstance(action_spec, DiscreteSpec):
        out_dim, dist = action_spec.n, Categorical
    elif isinstance(action_spec, BoxSpec):
        out_dim, dist = action_spec.dim, DiagGaussian
    else:
        raise TypeError(f"unsupported action spec: {action_spec!r}")

    if conv_torso:
        if len(obs_shape) != 3:
            raise ValueError("conv torso needs (H, W, C) observations")
        feat_dim = torso_features(tuple(obs_shape))

        def init_net(generator: torch.Generator):
            return {"torso": init_atari_torso(generator,
                                              in_channels=obs_shape[2]),
                    "head": init_mlp(generator, feat_dim, hidden, out_dim)}

        def head_forward(params, obs, dtype):
            feats = apply_atari_torso(params["torso"], obs,
                                      compute_dtype=dtype)
            return apply_mlp(params["head"], feats, activation, dtype,
                             None if tp is None else tp.sub("head"))
    else:
        obs_dim = math.prod(obs_shape)

        def init_net(generator: torch.Generator):
            return {"net": init_mlp(generator, obs_dim, hidden, out_dim)}

        def head_forward(params, obs, dtype):
            obs = obs.reshape(obs.shape[0], -1)
            return apply_mlp(params["net"], obs, activation, dtype,
                             None if tp is None else tp.sub("net"))

    def init(generator: torch.Generator):
        params = init_net(generator)
        if dist is DiagGaussian:
            params["log_std"] = torch.full((out_dim,), float(init_log_std))
        return params

    def apply_cast(params, obs, dtype):
        raw = head_forward(params, obs, dtype)
        if dist is Categorical:
            return {"logits": raw}
        return {"mean": raw, "log_std": params["log_std"].expand_as(raw)}

    def apply(params, obs):
        return apply_cast(params, obs, compute_dtype)

    mlp_spec = None
    if not conv_torso:
        mlp_spec = {
            "activation": activation,
            "compute_dtype": compute_dtype,
            "hidden": tuple(hidden),
        }
    return Policy(
        init=init,
        apply=apply,
        dist=dist,
        action_spec=action_spec,
        mlp_spec=mlp_spec,
        apply_cast=apply_cast,
        tp=tp,
    )


def spec_from_env(env) -> Tuple[Tuple[int, ...], Any]:
    """``(obs_shape, action_spec)`` of a port env (device env or host
    adapter: both carry ``obs_shape``/``action_spec``) or of a gymnasium
    env (its spaces)."""
    if hasattr(env, "obs_shape") and hasattr(env, "action_spec"):
        return tuple(env.obs_shape), env.action_spec
    obs_shape = tuple(env.observation_space.shape)
    space = env.action_space
    if hasattr(space, "n"):
        return obs_shape, DiscreteSpec(int(space.n))
    return obs_shape, BoxSpec(int(space.shape[0]))
