"""Environments (counterpart: ``trpo_tpu/envs``).

``make(name)`` builds:

* the batched device envs: ``"cartpole"``, ``"cartpole-po"`` (CartPole
  with its velocities hidden), ``"pendulum"``, ``"fake"`` (a scripted
  chain for tests), ``"chain"`` (``ChainLocomotion`` at any width),
  ``"halfcheetah-sim"``, ``"humanoid-sim"``, ``"catch"`` (40×40×1 pixels)
  and ``"pong-sim"`` (Catch at the Nature-DQN shape, 84×84×4);
* ``"native:cartpole"``, ``"native:pendulum"``: the batched C++ steppers
  on the host (``envs/native.py``, any width);
* ``"gym:<EnvId>"``: gymnasium envs on the host (``envs/gym_adapter.py``;
  needs gymnasium and the id's simulator).

``"gymproc:<EnvId>"`` (the worker-process pool) is not ported yet
(ROADMAP.md Queue 1 item 18.3).
"""

import inspect

from trpo_torch.envs.cartpole import CartPole  # noqa: F401
from trpo_torch.envs.catch import CatchPixels  # noqa: F401
from trpo_torch.envs.fake import FakeEnv  # noqa: F401
from trpo_torch.envs.locomotion import (  # noqa: F401
    ChainLocomotion,
    HalfCheetahSim,
    HumanoidSim,
)
from trpo_torch.envs.pendulum import Pendulum  # noqa: F401
from trpo_torch.envs.wrappers import MaskObservation  # noqa: F401


def _pong_sim(grid: int = 21, cell_px: int = 4, frames: int = 4,
              device=None):
    """Catch at the Nature-DQN Atari input shape: 84×84×4 uint8
    frame-stacked pixels."""
    return CatchPixels(grid=grid, cell_px=cell_px, frames=frames,
                       device=device)


def _cartpole_po(max_episode_steps: int = 500, device=None):
    """CartPole with velocities hidden (obs = [x, theta])."""
    return MaskObservation(
        CartPole(max_episode_steps=max_episode_steps, device=device),
        indices=(0, 2),
    )


# The widest fleet the gym: family builds from cfg.fleet_n_envs: it makes
# one simulator object per env, so a thousands-wide fleet preset there is
# a misconfiguration, refused at agent construction. Device envs and
# native: take any width.
HOST_ENV_FLEET_MAX = 256

DEVICE_ENVS = {
    "cartpole": CartPole,
    "cartpole-po": _cartpole_po,
    "pendulum": Pendulum,
    "fake": FakeEnv,
    "chain": ChainLocomotion,
    "halfcheetah-sim": HalfCheetahSim,
    "humanoid-sim": HumanoidSim,
    "catch": CatchPixels,
    "pong-sim": _pong_sim,
}


HOST_PREFIXES = ("gym:", "native:")


def make(name: str, max_episode_steps=None, device=None, **kwargs):
    """Build an env by name; ``max_episode_steps=None`` keeps its own
    horizon. An env with a fixed horizon (Catch: the ball reaches the
    bottom in ``grid − 1`` steps) rejects an override with ``TypeError``,
    as the reference does. ``kwargs`` go to the constructor: for the host
    families ``n_envs``, ``seed``, ``normalize_obs`` (and gymnasium's own,
    e.g. ``render_mode``); ``device`` is for device envs only."""
    if max_episode_steps is not None:
        kwargs["max_episode_steps"] = max_episode_steps
    if name.startswith("gym:"):
        from trpo_torch.envs.gym_adapter import GymVecEnv

        return GymVecEnv(name[len("gym:"):], **kwargs)
    if name.startswith("native:"):
        from trpo_torch.envs.native import NativeVecEnv

        return NativeVecEnv(name[len("native:"):], **kwargs)
    if name.startswith("gymproc:"):
        raise NotImplementedError(
            f"env {name!r}: the gymproc: worker pool is not ported to "
            "trpo_torch yet (ROADMAP.md Queue 1 item 18.3); use gym: or "
            "native:")
    if name in DEVICE_ENVS:
        cls = DEVICE_ENVS[name]
        if "max_episode_steps" in kwargs and "max_episode_steps" not in \
                inspect.signature(cls).parameters:
            raise TypeError(
                f"env {name!r} has a fixed horizon; "
                "max_episode_steps is not supported"
            )
        return cls(device=device, **kwargs)
    raise KeyError(
        f"unknown env {name!r}; have {sorted(DEVICE_ENVS)}, "
        "'native:<kind>' or 'gym:<EnvId>'")


def is_device_env(env) -> bool:
    """True for the batched device envs (``reset``/``step`` on tensors);
    False for the host adapters (``host_step``)."""
    return hasattr(env, "step") and hasattr(env, "reset") and hasattr(
        env, "obs_shape") and not hasattr(env, "host_step")
