"""Env-worker supervision (counterpart: ``trpo_tpu/resilience/supervisor.py``).

``ProcVecEnv`` detects a dead or hung worker (``WorkerDiedError``);
:class:`SupervisedEnv` wraps the pool, catches that error from any env
operation and revives the casualty:

1. **Restart with backoff**: kill what is left of the worker, wait
   ``backoff_base · 2^(attempt-1)`` seconds (at most ``backoff_max``),
   respawn the slice (``ProcVecEnv.restart_worker``: fresh envs, the
   construction seeding, its episodes restart), then retry the operation.
2. **Degradation**: after ``max_worker_restarts`` failed revivals of one
   worker, re-host its slice in this process (``proc_env._LocalConn``):
   the data stays correct, the slice loses its process. A revival counts
   as failed only when the worker dies again within ``heal_window``
   seconds; one that holds longer resets the budget, so rare isolated
   crashes over a long run never add up to degradation.
3. **Floor**: when fewer than ``min_proc_workers`` process-backed workers
   remain (or a slice cannot be revived at all), raise
   :class:`WorkerPoolError`.

With a ``bus`` each transition is a ``health`` event: ``worker_restart``,
``worker_degraded``, ``worker_pool_floor``.

A retried step re-steps the surviving workers with the same actions (their
first replies were gathered and dropped to keep the pipes in step), so one
fault costs at most one repeated transition per surviving env plus the
restarted slice's episodes in flight — the documented fault model.

Every attribute the wrapper does not define is the pool's, so the rollout,
the agent's probes (``host_step_slice``, ``has_obs_norm``, the sidecar)
and ``envs.is_device_env`` see the pool's surface unchanged. With an
``injector`` (``resilience.inject.FaultInjector``) each step call gives it
the env-level trigger point: the step count is taken under the wrapper's
lock, so pipelined group threads count each call once.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from trpo_torch.envs.proc_env import WorkerDiedError

__all__ = ["SupervisedEnv", "SupervisionConfig", "WorkerPoolError"]


class WorkerPoolError(RuntimeError):
    """The pool fell below the configured floor, or a slice could not be
    revived at all: training cannot go on with correct data."""


@dataclasses.dataclass
class SupervisionConfig:
    max_worker_restarts: int = 2   # process restarts of one worker before
    #                                its slice degrades to in-process
    min_proc_workers: int = 0      # abort below this many process-backed
    #                                workers (0 = degrade all the way)
    backoff_base: float = 0.5      # seconds; restart n waits base·2^(n-1)
    backoff_max: float = 5.0
    heal_window: float = 60.0      # seconds a revived worker must hold for
    #                                its restart budget to reset


class SupervisedEnv:
    """``ProcVecEnv`` with the detect → revive loop around every operation
    that reaches a worker (module docstring)."""

    def __init__(self, env, config: Optional[SupervisionConfig] = None,
                 bus=None, injector=None):
        self._env = env
        self.cfg = config or SupervisionConfig()
        self.bus = bus
        self.injector = injector
        self.restarts: dict = {}       # worker -> revival attempts so far
        self._last_restart: dict = {}  # worker -> monotonic restart time
        self._degraded: set = set()    # workers re-hosted in-process
        self._step_count = 0
        # group threads step concurrently: a revival must not race itself
        # and the injector's step clock must tick once per call
        self._lock = threading.Lock()

    # -- delegation --------------------------------------------------------

    def __getattr__(self, name):
        # only reached for names SupervisedEnv does not define
        return getattr(self._env, name)

    @property
    def env(self):
        """The wrapped pool."""
        return self._env

    @property
    def degraded_workers(self) -> tuple:
        return tuple(sorted(self._degraded))

    # -- supervised operations ---------------------------------------------

    def host_step(self, actions):
        return self._supervised(lambda: self._env.host_step(actions),
                                count_step=True)

    def host_step_slice(self, actions, lo, hi):
        return self._supervised(
            lambda: self._env.host_step_slice(actions, lo, hi),
            count_step=True)

    def reset_all(self, seed=None):
        return self._supervised(lambda: self._env.reset_all(seed=seed))

    def env_state_snapshot(self):
        return self._supervised(self._env.env_state_snapshot)

    def env_state_restore(self, snap):
        return self._supervised(lambda: self._env.env_state_restore(snap))

    def render_frame(self):
        return self._supervised(self._env.render_frame)

    def close(self):
        self._env.close()

    # -- detect → revive ---------------------------------------------------

    def _supervised(self, fn, count_step: bool = False):
        if count_step:
            with self._lock:
                self._step_count += 1
                idx = self._step_count
            if self.injector is not None:
                self.injector.on_env_step(idx, self._env)
        while True:
            try:
                return fn()
            except WorkerDiedError as e:
                with self._lock:
                    self._revive(e)

    def _emit(self, check: str, level: str, message: str, **data) -> None:
        if self.bus is not None:
            self.bus.emit("health", check=check, level=level,
                          message=message, data=data or None)

    def _revive(self, err: WorkerDiedError) -> None:
        for w in err.workers:
            last = self._last_restart.get(w)
            if last is not None and (
                    time.monotonic() - last > self.cfg.heal_window):
                # the last revival held for the whole window: a fresh
                # fault, not a failed revival
                self.restarts[w] = 0
            n = self.restarts.get(w, 0) + 1
            self.restarts[w] = n
            if w in self._degraded:
                raise WorkerPoolError(
                    f"in-process fallback for worker {w} "
                    f"({self._env.env_id}) failed — slice is unrevivable"
                ) from err
            if n <= self.cfg.max_worker_restarts:
                delay = min(self.cfg.backoff_base * 2 ** (n - 1),
                            self.cfg.backoff_max)
                self._emit(
                    "worker_restart", "warn",
                    f"env worker {w} {err.kind} (attempt {n}/"
                    f"{self.cfg.max_worker_restarts}); restarting after "
                    f"{delay:.2g}s backoff — its episodes restart",
                    worker=w, attempt=n, kind=err.kind, backoff_s=delay)
                time.sleep(delay)
                try:
                    self._env.restart_worker(w)
                    self._last_restart[w] = time.monotonic()
                    continue
                except Exception:
                    pass  # the respawn itself failed: degrade now
            self._emit(
                "worker_degraded", "warn",
                f"env worker {w} exceeded {self.cfg.max_worker_restarts} "
                "restarts; re-hosting its slice in-process (degraded: "
                "correct data, no process parallelism)",
                worker=w, restarts=n)
            try:
                self._env.restart_worker(w, local=True)
            except Exception as e:
                raise WorkerPoolError(
                    f"worker {w} ({self._env.env_id}) could not be revived "
                    f"in-process: {type(e).__name__}: {e}") from e
            self._degraded.add(w)
            live = self._env.n_workers - len(self._degraded)
            if live < self.cfg.min_proc_workers:
                self._emit(
                    "worker_pool_floor", "error",
                    f"only {live} process-backed env workers remain "
                    f"(< floor {self.cfg.min_proc_workers}) — aborting",
                    live=live, floor=self.cfg.min_proc_workers)
                raise WorkerPoolError(
                    f"process-backed env workers ({live}) fell below the "
                    f"configured floor ({self.cfg.min_proc_workers})")
