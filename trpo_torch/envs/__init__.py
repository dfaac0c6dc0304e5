"""Environments (counterpart: ``trpo_tpu/envs``).

``make(name)`` builds the batched device envs of this slice:
``"halfcheetah-sim"`` and ``"humanoid-sim"``. The classic-control envs,
the pixel envs and the host-simulator families wait for later slices
(ROADMAP.md Queue 1 items 7 and 13).
"""

from trpo_torch.envs.locomotion import (  # noqa: F401
    ChainLocomotion,
    HalfCheetahSim,
    HumanoidSim,
)

_DEVICE_ENVS = {
    "halfcheetah-sim": HalfCheetahSim,
    "humanoid-sim": HumanoidSim,
}


def make(name: str, max_episode_steps=None, device=None):
    """Build an env by name; ``max_episode_steps=None`` keeps its own
    horizon."""
    if name in _DEVICE_ENVS:
        kwargs = {"device": device}
        if max_episode_steps is not None:
            kwargs["max_episode_steps"] = max_episode_steps
        return _DEVICE_ENVS[name](**kwargs)
    raise NotImplementedError(
        f"env {name!r} is not ported to trpo_torch yet (have "
        f"{sorted(_DEVICE_ENVS)}; ROADMAP.md Queue 1 items 7 and 13)"
    )
