"""Environments (counterpart: ``trpo_tpu/envs``).

``make(name)`` builds the batched device envs of the port:
``"cartpole"``, ``"cartpole-po"`` (CartPole with its velocities hidden),
``"pendulum"``, ``"halfcheetah-sim"``, ``"humanoid-sim"``, ``"catch"``
(40×40×1 pixels) and ``"pong-sim"`` (Catch at the Nature-DQN shape,
84×84×4). The host-simulator families (``gym:``, ``native:``) wait for a
later slice (ROADMAP.md Queue 1 item 13).
"""

import inspect

from trpo_torch.envs.cartpole import CartPole  # noqa: F401
from trpo_torch.envs.catch import CatchPixels  # noqa: F401
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


DEVICE_ENVS = {
    "cartpole": CartPole,
    "cartpole-po": _cartpole_po,
    "pendulum": Pendulum,
    "halfcheetah-sim": HalfCheetahSim,
    "humanoid-sim": HumanoidSim,
    "catch": CatchPixels,
    "pong-sim": _pong_sim,
}


def make(name: str, max_episode_steps=None, device=None):
    """Build an env by name; ``max_episode_steps=None`` keeps its own
    horizon. An env with a fixed horizon (Catch: the ball reaches the
    bottom in ``grid − 1`` steps) rejects an override with ``TypeError``,
    as the reference does."""
    if name in DEVICE_ENVS:
        cls = DEVICE_ENVS[name]
        kwargs = {"device": device}
        if max_episode_steps is not None:
            if "max_episode_steps" not in inspect.signature(cls).parameters:
                raise TypeError(
                    f"env {name!r} has a fixed horizon; "
                    "max_episode_steps is not supported"
                )
            kwargs["max_episode_steps"] = max_episode_steps
        return cls(**kwargs)
    raise NotImplementedError(
        f"env {name!r} is not ported to trpo_torch yet (have "
        f"{sorted(DEVICE_ENVS)}; ROADMAP.md Queue 1 items 3 and 13)"
    )
