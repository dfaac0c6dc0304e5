"""Carry weights and state between trpo_tpu and trpo_torch as numpy arrays.

The input side takes ``trpo_tpu``'s trees already converted to numpy (for
example with ``jax.tree_util.tree_map(np.asarray, tree)``), so this module
imports nothing of JAX. Both packages use the same tree layout,
``{"net": {"layers": [{"w": (in, out), "b": (out,)}]}, "log_std": (A,)}``,
so the conversion is leafwise.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from trpo_torch.ops.flat import tree_map
from trpo_torch.rollout import Trajectory
from trpo_torch.vf import AdamState, VFState

__all__ = [
    "policy_params_from_numpy",
    "policy_params_to_numpy",
    "trajectory_from_numpy",
    "vf_state_from_numpy",
]


def _tensor(x, device):
    return torch.as_tensor(np.array(x), device=device)


def policy_params_from_numpy(tree: Any, device="cpu") -> Any:
    """A params tree of numpy arrays → the same tree of f32 tensors."""
    return tree_map(lambda x: _tensor(x, device).float(), tree)


def policy_params_to_numpy(tree: Any) -> Any:
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


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


def trajectory_from_numpy(traj: Any, device="cpu") -> Trajectory:
    """A trajectory with the reference's field names (an object with
    attributes, or a dict) of numpy arrays → :class:`Trajectory`."""
    get = (traj.get if isinstance(traj, dict)
           else lambda name: getattr(traj, name))
    old = get("old_dist")
    return Trajectory(
        obs=_tensor(get("obs"), device).float(),
        actions=_tensor(get("actions"), device).float(),
        rewards=_tensor(get("rewards"), device).float(),
        terminated=_tensor(get("terminated"), device).bool(),
        done=_tensor(get("done"), device).bool(),
        old_dist={k: _tensor(old[k], device).float()
                  for k in ("mean", "log_std")},
        next_obs=_tensor(get("next_obs"), device).float(),
        episode_return=_tensor(get("episode_return"), device).float(),
        episode_length=_tensor(get("episode_length"), device).to(
            torch.int32),
    )
