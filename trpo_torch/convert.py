"""Carry weights and state between trpo_tpu and trpo_torch as numpy arrays.

The input side takes ``trpo_tpu``'s trees already converted to numpy (for
example with ``jax.tree_util.tree_map(np.asarray, tree)``), so this module
imports nothing of JAX. Both packages use the same tree layout,
``{"net": {"layers": [{"w": (in, out), "b": (out,)}]}, "log_std": (A,)}``,
so the conversion is leafwise, with one exception: a conv filter (the only
4-D leaf, ``models/conv.py``) is ``HWIO`` in the reference and ``OIHW``
here, so it crosses as ``w.permute(3, 2, 0, 1)`` (and back as
``permute(2, 3, 1, 0)``). The recurrent cells' fused ``wx``/``wh``/``b``
and the mixture's expert-stacked ``(K, ...)`` leaves and gate have the
same layout in both. The solver ladder's state and the damping scalar
cross the same way, so tests can start both packages from the same
``LadderState``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from trpo_torch.ops.flat import tree_map
from trpo_torch.rollout import Trajectory
from trpo_torch.trpo import LADDER_FIELDS, LadderState
from trpo_torch.utils.normalize import RunningStats
from trpo_torch.vf import AdamState, VFState

__all__ = [
    "compat_vf_from_numpy",
    "damping_from_numpy",
    "ladder_from_numpy",
    "ladder_to_numpy",
    "obs_norm_from_numpy",
    "obs_norm_to_numpy",
    "policy_params_from_numpy",
    "policy_params_to_numpy",
    "trajectory_from_numpy",
    "vf_state_from_numpy",
]


def _tensor(x, device):
    return torch.as_tensor(np.array(x), device=device)


def _leaf_from_numpy(x, device) -> torch.Tensor:
    t = _tensor(x, device).float()
    return t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t


def policy_params_from_numpy(tree: Any, device="cpu") -> Any:
    """A params tree of numpy arrays → the same tree of f32 tensors (conv
    filters ``HWIO`` → ``OIHW``)."""
    return tree_map(lambda x: _leaf_from_numpy(x, device), tree)


def policy_params_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`policy_params_from_numpy`."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.permute(2, 3, 1, 0) if t.ndim == 4 else t).numpy()
    return tree_map(leaf, tree)


def ladder_from_numpy(ladder: Any, device="cpu") -> LadderState:
    """The reference's ``LadderState`` (an object with its seven fields, or
    a dict) of numpy scalars → :class:`LadderState`, host mirrors set from
    the values."""
    get = (ladder.get if isinstance(ladder, dict)
           else lambda name: getattr(ladder, name))
    i32 = lambda x: _tensor(x, device).to(torch.int32)  # noqa: E731
    return LadderState(
        step=i32(get("step")),
        cg_budget=i32(get("cg_budget")),
        fail_streak=i32(get("fail_streak")),
        pinned=_tensor(get("pinned"), device).bool(),
        cosine_min=_tensor(get("cosine_min"), device).float(),
        audit_runs=i32(get("audit_runs")),
        fallbacks=i32(get("fallbacks")),
        step_host=int(np.asarray(get("step"))),
        pinned_host=bool(np.asarray(get("pinned"))),
    )


def ladder_to_numpy(ladder: LadderState) -> dict:
    """The seven device fields of a :class:`LadderState` as numpy."""
    return {k: getattr(ladder, k).detach().cpu().numpy()
            for k in LADDER_FIELDS}


def obs_norm_from_numpy(stats: Any, device="cpu") -> Any:
    """The reference's ``RunningStats`` (``count``, ``mean``, ``m2``: an
    object with those fields, or a dict) of numpy arrays →
    :class:`~trpo_torch.utils.normalize.RunningStats` of f32 tensors;
    None stays None."""
    if stats is None:
        return None
    get = (stats.get if isinstance(stats, dict)
           else lambda name: getattr(stats, name))
    return RunningStats(*(_tensor(get(f), device).float()
                          for f in RunningStats._fields))


def obs_norm_to_numpy(stats: Any) -> Any:
    """The inverse of :func:`obs_norm_from_numpy`, as a dict."""
    if stats is None:
        return None
    return {f: getattr(stats, f).detach().cpu().numpy()
            for f in RunningStats._fields}


def damping_from_numpy(x, device="cpu") -> torch.Tensor:
    """The damping scalar (``TrainState.cg_damping``) as an f32 tensor."""
    return _tensor(x, device).float().reshape(())


def vf_state_from_numpy(params: Any, adam_mu: Any, adam_nu: Any, count: int,
                        initialized: bool, device="cpu") -> VFState:
    """The critic state from the reference's MLP params and its
    ``optax.adam`` moments and step count."""
    conv = lambda t: tree_map(  # noqa: E731
        lambda x: _tensor(x, device).float(), t
    )
    return VFState(
        params=conv(params),
        opt_state=AdamState(int(count), conv(adam_mu), conv(adam_nu)),
        initialized=bool(initialized),
    )


def compat_vf_from_numpy(vf, params: Any, adam_mu: Any, adam_nu: Any,
                         count: int):
    """Load ``trpo_tpu.compat.VF``'s MLP params and its ``optax.adam``
    moments and step count (numpy, the reference's ``{"layers": [{"w":
    (in, out), "b"}]}`` layout) into the port's ``compat.VF`` ``vf``:
    its net is built at the params' input width, each ``w`` crosses as
    the ``nn.Linear`` weight ``w.T``, and ``torch.optim.Adam`` gets the
    moments and the count as its per-parameter state. Returns ``vf``."""
    layers = params["layers"]
    vf._create_net(int(np.shape(layers[0]["w"])[0]))
    linears = [m for m in vf.net if isinstance(m, torch.nn.Linear)]
    if len(linears) != len(layers):
        raise ValueError(f"{len(layers)} layers for a VF of "
                         f"{len(linears)}")
    dev = linears[0].weight.device
    to = lambda x: _tensor(x, dev).float()  # noqa: E731
    with torch.no_grad():
        for lin, layer, mu, nu in zip(linears, layers, adam_mu["layers"],
                                      adam_nu["layers"]):
            for param, key in ((lin.weight, "w"), (lin.bias, "b")):
                flip = (lambda t: t.T.contiguous()) if key == "w" else (
                    lambda t: t)
                param.copy_(flip(to(layer[key])))
                vf.opt.state[param] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": flip(to(mu[key])),
                    "exp_avg_sq": flip(to(nu[key])),
                }
    return vf


def trajectory_from_numpy(traj: Any, device="cpu") -> Trajectory:
    """A trajectory with the reference's field names (an object with
    attributes, or a dict) of numpy arrays → :class:`Trajectory`. Pixel
    observations stay uint8; a recurrent trajectory's ``reset``,
    ``policy_h0``, ``policy_h`` and ``policy_h_next`` cross when present."""
    get = (traj.get if isinstance(traj, dict)
           else lambda name: getattr(traj, name, None))
    old = get("old_dist")
    actions = np.asarray(get("actions"))

    def obs(x):
        t = _tensor(x, device)
        return t if t.dtype == torch.uint8 else t.float()

    def opt(name, cast):
        x = get(name)
        return None if x is None else cast(_tensor(x, device))

    return Trajectory(
        obs=obs(get("obs")),
        actions=_tensor(actions, device).long()
        if np.issubdtype(actions.dtype, np.integer)
        else _tensor(actions, device).float(),
        rewards=_tensor(get("rewards"), device).float(),
        terminated=_tensor(get("terminated"), device).bool(),
        done=_tensor(get("done"), device).bool(),
        old_dist={k: _tensor(old[k], device).float() for k in old},
        next_obs=obs(get("next_obs")),
        episode_return=_tensor(get("episode_return"), device).float(),
        episode_length=_tensor(get("episode_length"), device).to(
            torch.int32),
        reset=opt("reset", torch.Tensor.bool),
        policy_h0=opt("policy_h0", torch.Tensor.float),
        policy_h=opt("policy_h", torch.Tensor.float),
        policy_h_next=opt("policy_h_next", torch.Tensor.float),
    )
