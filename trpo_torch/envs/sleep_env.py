"""A gymnasium env whose ``step`` sleeps a fixed time (counterpart:
``trpo_tpu/envs/sleep_env.py``): a test env for the pipelined host
rollout. ``time.sleep`` releases the GIL and the core, so G group threads
stepping sleep-bound envs finish a window in about 1/G of the serial time
on any host — the concurrency structure of real simulator stepping
without its arithmetic.
"""

from __future__ import annotations

import time

import numpy as np

try:
    import gymnasium
    _Env = gymnasium.Env
except ImportError:  # the module stays importable; the env needs gymnasium
    gymnasium, _Env = None, object

__all__ = ["SleepEnv"]


class SleepEnv(_Env):
    """4-dim Box obs, 2 discrete actions; ``step`` sleeps ``sleep_ms``."""

    metadata = {"render_modes": []}

    def __init__(self, sleep_ms: float = 2.0, episode_len: int = 1000):
        if gymnasium is None:
            raise ImportError("SleepEnv is a gymnasium env; install "
                              "gymnasium to use it")
        self.observation_space = gymnasium.spaces.Box(
            -1.0, 1.0, shape=(4,), dtype=np.float32
        )
        self.action_space = gymnasium.spaces.Discrete(2)
        self._sleep_s = float(sleep_ms) * 1e-3
        self._episode_len = int(episode_len)
        self._t = 0
        self._rng = np.random.default_rng(0)

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._obs(), {}

    def _obs(self):
        return self._rng.standard_normal(4).astype(np.float32)

    def step(self, action):
        time.sleep(self._sleep_s)
        self._t += 1
        truncated = self._t >= self._episode_len
        return self._obs(), float(action), False, truncated, {}
