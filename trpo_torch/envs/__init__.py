"""Environments (counterpart: ``trpo_tpu/envs``).

``make(name)`` builds the batched device envs of the port: ``"cartpole"``,
``"pendulum"``, ``"halfcheetah-sim"`` and ``"humanoid-sim"``. The pixel
envs and the host-simulator families wait for later slices (ROADMAP.md
Queue 1 items 7 and 13).
"""

from trpo_torch.envs.cartpole import CartPole  # noqa: F401
from trpo_torch.envs.locomotion import (  # noqa: F401
    ChainLocomotion,
    HalfCheetahSim,
    HumanoidSim,
)
from trpo_torch.envs.pendulum import Pendulum  # noqa: F401

DEVICE_ENVS = {
    "cartpole": CartPole,
    "pendulum": Pendulum,
    "halfcheetah-sim": HalfCheetahSim,
    "humanoid-sim": HumanoidSim,
}


def make(name: str, max_episode_steps=None, device=None):
    """Build an env by name; ``max_episode_steps=None`` keeps its own
    horizon."""
    if name in DEVICE_ENVS:
        kwargs = {"device": device}
        if max_episode_steps is not None:
            kwargs["max_episode_steps"] = max_episode_steps
        return DEVICE_ENVS[name](**kwargs)
    raise NotImplementedError(
        f"env {name!r} is not ported to trpo_torch yet (have "
        f"{sorted(DEVICE_ENVS)}; ROADMAP.md Queue 1 items 7 and 13)"
    )
