"""Cross-batch running mean of completed-episode returns (counterpart:
``trpo_tpu/envs/episode_stats.py``, ``RunningEpisodeMean``).

Long-horizon presets complete no episode on most iterations, so a batch's
``mean_episode_reward`` is NaN there. ``learn`` logs ``reward_running``,
the episode-weighted mean over the last ``window`` batches that completed
episodes: finite from the first finished episode on. It lives on the host
and aggregates the stats ``learn`` has already fetched; a resumed run
restarts the window. The host-env bookkeeping mixin waits for the host env
families (ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

from collections import deque

__all__ = ["RunningEpisodeMean"]


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
