"""Cross-batch running mean of completed-episode returns (counterpart:
``trpo_tpu/envs/episode_stats.py``, ``RunningEpisodeMean``).

Long-horizon presets complete no episode on most iterations, so a batch's
``mean_episode_reward`` is NaN there. ``learn`` logs ``reward_running``,
the episode-weighted mean over the last ``window`` batches that completed
episodes: finite from the first finished episode on. It lives on the host
and aggregates the stats ``learn`` has already fetched; a resumed run
restarts the window.

:class:`EpisodeStatsMixin` is the per-env bookkeeping of the host env
families (``envs/native.py``, ``envs/gym_adapter.py``): the running return
and length of each env, and ``last_episode_returns``/``lengths``, the
snapshot the host rollout records every step. The snapshot includes the
current step and the running sums reset after it, so on a ``done`` step
the snapshot holds that episode's totals.
"""

from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["EpisodeStatsMixin", "RunningEpisodeMean"]


class RunningEpisodeMean:
    def __init__(self, window: int = 100):
        self._entries: deque = deque(maxlen=int(window))  # (sum, count)

    def update(self, mean_reward: float, n_episodes: int) -> None:
        """Fold one batch's (mean, episode count) in; a batch with no
        finished episode (count 0, NaN mean) changes nothing."""
        n = int(n_episodes)
        if n > 0 and mean_reward == mean_reward:
            self._entries.append((float(mean_reward) * n, n))

    @property
    def count(self) -> int:
        """Episodes inside the current window."""
        return sum(c for _, c in self._entries)

    @property
    def mean(self) -> float:
        """Episode-weighted mean return over the window; NaN before any
        episode has finished."""
        n = self.count
        if n == 0:
            return float("nan")
        return sum(s for s, _ in self._entries) / n


class EpisodeStatsMixin:
    """Call ``_init_episode_stats(n_envs)`` in ``__init__`` and
    ``_update_episode_stats_slice`` once per (group) step."""

    def _init_episode_stats(self, n_envs: int) -> None:
        self.last_episode_returns = np.zeros(n_envs, np.float32)
        self.last_episode_lengths = np.zeros(n_envs, np.int64)
        self._running_returns = np.zeros(n_envs, np.float32)
        self._running_lengths = np.zeros(n_envs, np.int64)

    def _update_episode_stats_slice(self, rewards: np.ndarray,
                                    ended: np.ndarray, lo: int,
                                    hi: int) -> None:
        """Accumulate one step of envs ``[lo, hi)``, snapshot, then zero
        the ones whose episode ended; the other envs keep their snapshot
        (group stepping)."""
        self._running_returns[lo:hi] += rewards
        self._running_lengths[lo:hi] += 1
        self.last_episode_returns[lo:hi] = self._running_returns[lo:hi]
        self.last_episode_lengths[lo:hi] = self._running_lengths[lo:hi]
        self._running_returns[lo:hi][ended] = 0.0
        self._running_lengths[lo:hi][ended] = 0

    def _episode_stats_snapshot(self) -> dict:
        """Copies of the counters, for the checkpoint sidecar."""
        return {
            "running_returns": self._running_returns.copy(),
            "running_lengths": self._running_lengths.copy(),
            "last_returns": self.last_episode_returns.copy(),
            "last_lengths": self.last_episode_lengths.copy(),
        }

    def _episode_stats_restore(self, snap: dict) -> None:
        self._running_returns[:] = snap["running_returns"]
        self._running_lengths[:] = snap["running_lengths"]
        self.last_episode_returns[:] = snap["last_returns"]
        self.last_episode_lengths[:] = snap["last_lengths"]
