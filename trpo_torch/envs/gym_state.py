"""One gymnasium env's state, captured and restored (counterpart:
``trpo_tpu/envs/gym_state.py``).

MuJoCo envs save ``qpos``/``qvel``/``ctrl``/``qacc_warmstart``/``time``
(``MujocoEnv.set_state``), classic-control envs their ``state``
attribute, and an opaque simulator saves ``None`` and restarts its
episode on restore. The episode-reset RNG (``np_random``'s bit-generator
state) and TimeLimit's step count ride along, so a resumed run replays
the resets the uninterrupted one would have. numpy only.
"""

from __future__ import annotations

import numpy as np

__all__ = ["find_time_limit", "snapshot_one", "restore_one"]


def find_time_limit(env):
    """The wrapper carrying TimeLimit's ``_elapsed_steps``, wherever it
    sits in the chain; None when the env has no TimeLimit."""
    e = env
    while e is not None and e is not getattr(e, "unwrapped", None):
        if hasattr(e, "_elapsed_steps"):
            return e
        e = getattr(e, "env", None)
    return None


def snapshot_one(env):
    """Best-effort state dict for one wrapped gymnasium env (or None)."""
    u = env.unwrapped
    tl = find_time_limit(env)
    elapsed = None if tl is None else tl._elapsed_steps
    rng_state = None
    np_random = getattr(u, "np_random", None)
    if np_random is not None and hasattr(np_random, "bit_generator"):
        rng_state = np_random.bit_generator.state
    if hasattr(u, "data") and hasattr(u, "set_state"):
        return {
            "backend": "mujoco",
            "qpos": np.asarray(u.data.qpos, np.float64).copy(),
            "qvel": np.asarray(u.data.qvel, np.float64).copy(),
            "ctrl": np.asarray(u.data.ctrl, np.float64).copy(),
            "qacc_warmstart": np.asarray(
                u.data.qacc_warmstart, np.float64
            ).copy(),
            "time": float(u.data.time),
            "elapsed": elapsed,
            "np_random": rng_state,
        }
    if getattr(u, "state", None) is not None:
        return {
            "backend": "state",
            "state": np.asarray(u.state, np.float64).copy(),
            "elapsed": elapsed,
            "np_random": rng_state,
        }
    return None  # opaque simulator — restart on restore


def restore_one(env, sim):
    """Install ``sim`` (from :func:`snapshot_one`) into ``env``.

    ``sim=None`` (opaque backend): resets the env and returns the fresh
    episode's raw observation — the caller must surface it (obs cache,
    zeroed episode counters). Otherwise returns None."""
    if sim is None:
        obs, _ = env.reset()
        return np.asarray(obs)
    u = env.unwrapped
    # reset first: wrappers (TimeLimit) and lazy backend state need a
    # live episode to overwrite
    env.reset()
    if sim["backend"] == "mujoco":
        u.set_state(sim["qpos"], sim["qvel"])
        u.data.time = sim["time"]
        if sim.get("ctrl") is not None:
            u.data.ctrl[:] = sim["ctrl"]
        if sim.get("qacc_warmstart") is not None:
            u.data.qacc_warmstart[:] = sim["qacc_warmstart"]
    else:
        u.state = np.asarray(sim["state"], np.float64)
    if sim.get("np_random") is not None:
        u.np_random.bit_generator.state = sim["np_random"]
    if sim.get("elapsed") is not None:
        tl = find_time_limit(env)
        if tl is not None:
            tl._elapsed_steps = sim["elapsed"]
    return None
