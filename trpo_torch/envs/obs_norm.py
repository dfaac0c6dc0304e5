"""Running observation normalization inside a host env adapter
(counterpart: ``trpo_tpu/envs/obs_norm.py``).

One statistics object per adapter, shared by all its envs and folded with
the Chan/Welford merge in f64 (the math of ``utils/normalize.py``). The
agent mirrors the statistics into the f32 ``TrainState.obs_norm`` at every
iteration boundary (:meth:`ObsNormMixin.obs_stats_state` out,
:meth:`ObsNormMixin.set_obs_stats_state` in), so a checkpoint carries them
and a resumed run re-seeds the adapter with them; evaluation freezes the
folding.

Group-stepping threads (``rollout.pipelined_host_rollout``) fold into the
same statistics, so every fold and every read happens under one lock. In
deferred mode (:meth:`ObsNormMixin.begin_deferred_fold`) a window
normalizes under the statistics of its start and the raw batches are
merged afterwards in group order: the result does not depend on how the
threads interleaved.

On a mesh each data rank's adapter holds a slice of the envs, and
:meth:`ObsNormMixin.fold_across` makes every fold take the batch of all
ranks (an all-gather, in global row order), so the statistics are the
one-rank run's; a deferred window's batches are gathered once at its end
and merged rank by rank, the one-rank run's group order. Each fold is a
collective, so every rank folds at the same points: the reset rows of a
restarted worker (one rank's fault) are normalized and not folded there.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["ObsNormMixin"]


class ObsNormMixin:
    """Call ``_init_obs_norm(obs_shape, enabled)`` in ``__init__`` before
    the first observation batch, then pass every outgoing batch through
    ``_fold_and_normalize`` or ``_fold_and_normalize_slice``."""

    def _init_obs_norm(self, obs_shape, enabled: bool) -> None:
        self.has_obs_norm = bool(enabled)
        self._norm_frozen = False
        self._norm_lock = threading.Lock()
        self._deferred = None
        self._fold_gather = None
        if self.has_obs_norm:
            self._n_count = 0.0
            self._n_mean = np.zeros(obs_shape, np.float64)
            self._n_m2 = np.zeros(obs_shape, np.float64)

    def _fold(self, obs_batch: np.ndarray) -> None:
        """Fold a raw batch into the statistics (every mesh rank's rows
        with :meth:`fold_across`); the caller holds the lock."""
        if self._fold_gather is not None:
            obs_batch = self._fold_gather(obs_batch)
        self._merge(obs_batch)

    def _merge(self, obs_batch: np.ndarray) -> None:
        """Chan/Welford-merge the rows of ``obs_batch``, this process's
        alone."""
        b = np.asarray(obs_batch, np.float64)
        n_b = float(b.shape[0])
        mean_b = b.mean(axis=0)
        m2_b = ((b - mean_b) ** 2).sum(axis=0)
        delta = mean_b - self._n_mean
        tot = self._n_count + n_b
        self._n_mean = self._n_mean + delta * (n_b / tot)
        self._n_m2 = self._n_m2 + m2_b + delta ** 2 * (
            self._n_count * n_b / tot)
        self._n_count = tot

    def _apply_norm(self, obs: np.ndarray) -> np.ndarray:
        """``obs`` normalized under the current statistics, clipped to
        ±10, as f32 (unchanged before the first fold)."""
        if not self.has_obs_norm or self._n_count == 0.0:
            return obs
        var = self._n_m2 / max(self._n_count, 1.0)
        std = np.sqrt(var + 1e-8)
        return np.clip((obs - self._n_mean) / std, -10.0,
                       10.0).astype(np.float32)

    def _fold_and_normalize(self, obs_batch: np.ndarray) -> np.ndarray:
        """Fold a full raw ``(N, *obs)`` batch (unless frozen) and return
        it normalized."""
        if not self.has_obs_norm:
            return obs_batch
        # the raw batch stays: installing other statistics later
        # re-normalizes the cached current observations from it
        self._raw_obs = np.asarray(obs_batch).copy()
        with self._norm_lock:
            if not self._norm_frozen:
                self._fold(obs_batch)
            return self._apply_norm(obs_batch)

    def _fold_and_normalize_slice(self, obs_batch: np.ndarray, lo: int,
                                  hi: int, extra=None, restart: bool = False):
        """Rows ``[lo, hi)``: replace their raw cache, fold them (or buffer
        them in deferred mode), and return them normalized; ``extra`` (the
        pre-reset ``final_obs``) is normalized under the same statistics
        in the same lock hold, and not folded. ``restart=True``: the reset
        rows of a restarted worker, which on a mesh are normalized and not
        folded (one rank's fault: the others make no matching fold)."""
        if not self.has_obs_norm:
            return obs_batch if extra is None else (obs_batch, extra)
        self._raw_obs[lo:hi] = obs_batch
        with self._norm_lock:
            if restart and self._fold_gather is not None:
                pass
            elif self._deferred is not None:
                self._deferred.setdefault(lo, []).append(obs_batch)
            elif not self._norm_frozen:
                self._fold(obs_batch)
            normed = self._apply_norm(obs_batch)
            if extra is None:
                return normed
            return normed, self._apply_norm(extra)

    def fold_across(self, gather) -> None:
        """Fold every batch from now on as ``gather(batch)`` (on a mesh:
        every data rank's rows, in global order; a collective, so every
        rank folds at the same points), and refold the current
        observations so: call it right after construction, whose one fold
        covered this adapter's rows alone."""
        if not self.has_obs_norm:
            return
        with self._norm_lock:
            self._fold_gather = gather
            self._n_count = 0.0
            self._n_mean = np.zeros_like(self._n_mean)
            self._n_m2 = np.zeros_like(self._n_m2)
            if not self._norm_frozen:
                self._fold(self._raw_obs)
            self._obs = self._apply_norm(self._raw_obs)

    def begin_deferred_fold(self) -> None:
        """Buffer every slice fold from now on; the window normalizes under
        the statistics as of now."""
        if not self.has_obs_norm:
            return
        with self._norm_lock:
            self._deferred = {}

    def end_deferred_fold(self) -> None:
        """Merge the buffered batches in (group, arrival) order, then
        re-normalize the cached current observations. On a mesh every
        rank's batches are gathered (two collectives: the rows, then their
        batch sizes) and merged rank by rank, as the one-rank run merges
        its groups."""
        if not self.has_obs_norm:
            return
        with self._norm_lock:
            deferred, self._deferred = self._deferred, None
            if deferred and not self._norm_frozen:
                batches = [b for lo in sorted(deferred) for b in deferred[lo]]
                if self._fold_gather is not None:
                    rows = self._fold_gather(np.concatenate(batches))
                    sizes = self._fold_gather(np.asarray(
                        [len(b) for b in batches], np.int64))
                    batches = np.split(rows, np.cumsum(sizes)[:-1])
                for batch in batches:
                    self._merge(batch)
                if getattr(self, "_raw_obs", None) is not None:
                    self._obs = self._apply_norm(self._raw_obs)

    def obs_stats_state(self):
        """``(count, mean, m2)`` as f32 arrays, the checkpointable mirror;
        None without normalization."""
        if not self.has_obs_norm:
            return None
        return (np.float32(self._n_count), self._n_mean.astype(np.float32),
                self._n_m2.astype(np.float32))

    def set_obs_stats_state(self, state) -> None:
        """Install ``(count, mean, m2)`` and re-normalize the cached current
        observations under them."""
        count, mean, m2 = state
        with self._norm_lock:
            self._n_count = float(count)
            self._n_mean = np.asarray(mean, np.float64)
            self._n_m2 = np.asarray(m2, np.float64)
            self._obs = self._apply_norm(self._raw_obs)

    def freeze_obs_stats(self, frozen: bool = True) -> None:
        """Stop (or resume) folding: evaluation must not move the
        training statistics."""
        self._norm_frozen = frozen
