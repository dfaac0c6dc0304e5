"""N gymnasium envs over W worker processes (counterpart:
``trpo_tpu/envs/proc_env.py``).

Python-stepped simulators serialize on the interpreter lock, so the
threaded pipeline (``rollout.pipelined_host_rollout``) cannot overlap two
groups' stepping. :class:`ProcVecEnv` splits the N envs into W contiguous
slices, one per ``spawn``-started worker process, and steps them in
parallel, with actions and observations crossing over pipes.

It speaks :class:`~trpo_torch.envs.gym_adapter.GymVecEnv`'s surface
(``host_step``, ``host_step_slice``, ``reset_all``, ``current_obs``, the
checkpoint sidecar, ``render_frame``, the episode counters and the shared
observation normalization) and gives the same steps bit for bit for the
same seed: env ``i`` is seeded ``seed + i``, finished envs auto-reset the
same way, and the normalization statistics are folded here in the parent
(``ObsNormMixin``), one fold per (group) step over the gathered raw slice.
Its snapshots have ``GymVecEnv``'s schema, so either adapter restores the
other's.

Workers own contiguous slices, so ``host_step_slice`` groups aligned to
worker boundaries touch one worker each (``host_pipeline_groups =
n_workers``); a group that splits a worker is refused before anything is
sent.

A worker calls numpy and gymnasium only. Its import chain (this module,
``envs/gym_state.py``, the numpy mixins and the lazy ``envs`` package) is
free of ``torch``, so a worker starts in gymnasium's import time.

Failure handling: ``step_timeout`` bounds every reply gather; a worker
whose pipe closes or that stays silent past it raises
:class:`WorkerDiedError` (naming the worker, the failure kind and the last
actions it was sent), and ``restart_worker`` replaces it — with a fresh
process, or in-process (:class:`_LocalConn`, the degraded mode that
``resilience/supervisor.py`` falls back to). Every reply of a command is
drained before an error is raised, so the pipe protocol never desyncs.

Without gymnasium (the card's machine has none) construction raises
``RuntimeError`` naming it before any worker process starts.
"""

from __future__ import annotations

import importlib.util
import multiprocessing as mp
import os
import sys
import threading
from collections import deque

import numpy as np

from trpo_torch.envs.episode_stats import EpisodeStatsMixin
from trpo_torch.envs.obs_norm import ObsNormMixin

__all__ = ["ProcVecEnv", "WorkerDiedError"]

# serializes the __main__ hiding of _spawn_worker: two overlapping starts
# (a supervisor's restart on a pipeline thread beside another) would each
# read the other's hidden state and restore it wrong
_SPAWN_LOCK = threading.Lock()


class WorkerDiedError(RuntimeError):
    """A worker stopped answering: its pipe closed (the process exited or
    was killed) or it exceeded ``step_timeout`` (hung). Carries what
    supervision needs to revive it: ``worker`` (and ``workers`` when one
    gather found several casualties), ``kind`` (``"died"`` or
    ``"timeout"``) and ``last_action``, the last action batch it was sent
    (None before the first step)."""

    def __init__(self, worker: int, env_id: str, kind: str = "died",
                 last_action=None, workers=None):
        self.worker = worker
        self.workers = sorted(workers) if workers else [worker]
        self.kind = kind
        self.env_id = env_id
        self.last_action = last_action
        act = ("no action sent yet" if last_action is None
               else f"last action {np.array_str(np.asarray(last_action))}")
        super().__init__(
            f"ProcVecEnv worker {self.workers} ({env_id}) "
            f"{'timed out' if kind == 'timeout' else 'died'} "
            f"mid-command ({act})")


def _construct_envs(env_id: str, count: int, seed_base: int, kwargs: dict):
    """``count`` envs and the handshake's metadata, shared by the worker
    body and the in-process fallback so both build identical envs. Returns
    ``(envs, spec, clip, obs_shape, obs0)``.

    ``"package.module:attr"`` with ``attr`` a class or factory builds the
    envs directly (no registry needed in the spawned interpreter; the
    overlap probe ``envs/sleep_env.py`` uses it), unless importing the
    module registered ``attr`` as a gymnasium id: gymnasium's own
    ``"module:EnvId"`` form wins, so the registry's wrappers are kept."""
    import gymnasium

    env_ctor = None
    if ":" in env_id:
        mod_name, attr = env_id.split(":", 1)
        try:
            obj = getattr(importlib.import_module(mod_name), attr)
        except (ImportError, AttributeError):
            obj = None
        if callable(obj) and attr not in gymnasium.registry:
            env_ctor = obj
    if env_ctor is not None:
        envs = [env_ctor(**kwargs) for _ in range(count)]
    else:
        envs = [gymnasium.make(env_id, **kwargs) for _ in range(count)]
    space = envs[0].action_space
    if hasattr(space, "n"):
        spec, clip = ("discrete", int(space.n)), None
    else:
        spec = ("box", int(space.shape[0]))
        clip = (np.asarray(space.low, np.float32),
                np.asarray(space.high, np.float32))
    obs0 = np.stack([env.reset(seed=seed_base + j)[0]
                     for j, env in enumerate(envs)])
    return envs, spec, clip, tuple(envs[0].observation_space.shape), obs0


def _serve(envs: list, clip, obs0: np.ndarray, msg: tuple):
    """Run ONE worker command on ``envs``; returns ``(reply, close)``. The
    one copy of the command semantics, shared by the worker loop and the
    in-process fallback (each wraps errors its own way)."""
    from trpo_torch.envs.gym_state import restore_one, snapshot_one

    cmd = msg[0]
    if cmd == "step":
        actions = msg[1]
        m = len(envs)
        next_obs = np.empty((m,) + obs0.shape[1:], obs0.dtype)
        final_obs = np.empty_like(next_obs)
        rewards = np.zeros(m, np.float32)
        term = np.zeros(m, bool)
        trunc = np.zeros(m, bool)
        for j, env in enumerate(envs):
            a = actions[j]
            if clip is not None:
                a = np.clip(a, clip[0], clip[1])
            obs_j, r, tm, tr, _ = env.step(a)
            rewards[j] = r
            term[j] = tm
            trunc[j] = tr
            final_obs[j] = obs_j
            if tm or tr:
                obs_j, _ = env.reset()
            next_obs[j] = obs_j
        return ("ok", next_obs, rewards, term, trunc, final_obs), False
    if cmd == "reset_all":
        seed = msg[1]
        return ("ok", np.stack([
            env.reset(seed=None if seed is None else seed + j)[0]
            for j, env in enumerate(envs)])), False
    if cmd == "snapshot":
        return ("ok", [snapshot_one(env) for env in envs]), False
    if cmd == "restore":
        reset_obs = {}
        for j, (env, sim) in enumerate(zip(envs, msg[1])):
            raw = restore_one(env, sim)
            if raw is not None:
                reset_obs[j] = raw
        return ("ok", reset_obs), False
    if cmd == "render":
        return ("ok", envs[0].render()), False
    if cmd == "close":
        for env in envs:
            env.close()
        return ("ok",), True
    return ("err", f"unknown command {cmd!r}"), False


def _error_reply(e: Exception) -> tuple:
    import traceback

    return ("err", f"{type(e).__name__}: {e}\n{traceback.format_exc()}")


def _worker(conn, env_id: str, count: int, seed_base: int, kwargs: dict):
    """The worker loop: builds ``count`` envs, then steps, snapshots and
    restores them on command until ``close`` or the parent's exit."""
    try:
        envs, spec, clip, obs_shape, obs0 = _construct_envs(
            env_id, count, seed_base, kwargs)
        conn.send(("ready", spec, obs_shape, obs0))
    except Exception as e:
        conn.send(_error_reply(e))
        return
    while True:
        try:
            msg = conn.recv()
        except EOFError:  # the parent died: exit quietly
            break
        try:
            reply, close = _serve(envs, clip, obs0, msg)
        except Exception as e:
            reply, close = _error_reply(e), False
        conn.send(reply)
        if close:
            break


class _LocalConn:
    """A worker slice run in this process: the degraded mode supervision
    falls back to after ``max_worker_restarts``. It speaks the pipe surface
    the parent uses (``send``/``poll``/``recv``/``close``) and runs each
    command at once through the same :func:`_construct_envs`/:func:`_serve`
    as a worker, so the data stays correct; the slice only loses its
    process. The first ``recv`` returns the ``ready`` handshake."""

    def __init__(self, env_id: str, count: int, seed_base: int,
                 kwargs: dict):
        self._envs, spec, self._clip, obs_shape, self._obs0 = (
            _construct_envs(env_id, count, seed_base, kwargs))
        self._pending: deque = deque(
            [("ready", spec, obs_shape, self._obs0)])
        self._closed = False

    def send(self, msg) -> None:
        if self._closed:
            raise BrokenPipeError("local env slice is closed")
        try:
            reply, close = _serve(self._envs, self._clip, self._obs0, msg)
        except Exception as e:
            reply, close = _error_reply(e), False
        self._pending.append(reply)
        if close:
            self._closed = True

    def poll(self, timeout=None) -> bool:
        return bool(self._pending)

    def recv(self):
        if not self._pending:
            raise EOFError("no pending reply on local env slice")
        return self._pending.popleft()

    def close(self) -> None:
        if not self._closed:
            for env in self._envs:
                env.close()
            self._closed = True


class ProcVecEnv(EpisodeStatsMixin, ObsNormMixin):
    """N gymnasium envs over W worker processes — GymVecEnv's surface."""

    def __init__(self, env_id: str, n_envs: int = 8, seed: int = 0,
                 normalize_obs: bool = False, n_workers=None,
                 step_timeout=None, env_offset: int = 0, **kwargs):
        """``n_workers`` defaults to ``min(n_envs, cpu count)``;
        ``step_timeout`` (seconds, None = wait forever) bounds every reply
        gather (:class:`WorkerDiedError` past it); ``env_offset`` seeds
        env ``i`` as env ``env_offset + i`` of a wider fleet (a data
        rank's slice on a mesh)."""
        if importlib.util.find_spec("gymnasium") is None:
            raise RuntimeError(
                "ProcVecEnv worker failed to start: gymnasium is required "
                "for gymproc:* envs (ModuleNotFoundError: No module named "
                "'gymnasium'); use the device envs ('cartpole', "
                "'pendulum', the -sim stand-ins) or the native: envs")
        self.env_id = env_id
        self.n_envs = n_envs
        self.env_offset = env_offset
        seed = seed + env_offset
        self.step_timeout = step_timeout
        if n_workers is None:
            n_workers = max(1, min(n_envs, os.cpu_count() or 1))
        if not 1 <= n_workers <= n_envs:
            raise ValueError(
                f"n_workers must be in [1, n_envs={n_envs}], got {n_workers}")
        self.n_workers = n_workers
        # contiguous balanced slices, the first n_envs % W one env longer
        q, r = divmod(n_envs, n_workers)
        self._slices = []
        lo = 0
        for w in range(n_workers):
            hi = lo + q + (1 if w < r else 0)
            self._slices.append((lo, hi))
            lo = hi
        # restart_worker rebuilds a slice from its construction arguments
        self._seed = seed
        self._kwargs = dict(kwargs)
        self._last_actions: dict = {}
        self._conns, self._procs = [], []
        try:
            for w in range(n_workers):  # all start, then all handshake
                conn, p = self._spawn_worker(w)
                self._conns.append(conn)
                self._procs.append(p)
            obs_parts = []
            for w, conn in enumerate(self._conns):
                _, spec, obs_shape, obs0 = self._recv_ready(conn, w)
                obs_parts.append(obs0)
        except BaseException:
            self.close()
            raise

        from trpo_torch.models.policy import BoxSpec, DiscreteSpec

        self.obs_shape = tuple(obs_shape)
        if spec[0] == "discrete":
            self.action_spec = DiscreteSpec(spec[1])
            self._continuous = False
        else:
            self.action_spec = BoxSpec(spec[1])
            self._continuous = True
        self._init_obs_norm(self.obs_shape, normalize_obs)
        self._obs = self._fold_and_normalize(np.concatenate(obs_parts))
        self._init_episode_stats(n_envs)

    # -- worker lifecycle --------------------------------------------------

    def _spawn_worker(self, w: int):
        """Start slice ``w``'s worker; returns ``(parent_conn, process)``.
        The handshake is the caller's, so starts overlap."""
        lo, hi = self._slices[w]
        ctx = mp.get_context("spawn")
        # spawn re-runs the parent's __main__ in the child. A main read
        # from stdin has a __file__ the child cannot open, and a main that
        # is one of this package's modules (python -m trpo_torch.train)
        # would import torch in every worker; the worker needs neither,
        # so both are hidden while the process starts (one start at a time)
        with _SPAWN_LOCK:
            main_mod = sys.modules.get("__main__")
            hidden = {}
            main_file = getattr(main_mod, "__file__", None)
            main_spec = getattr(main_mod, "__spec__", None)
            if main_spec is not None and main_spec.name.startswith(
                    "trpo_torch."):
                hidden["__spec__"] = main_spec
                if main_file is not None:
                    hidden["__file__"] = main_file
            elif main_file is not None and not os.path.exists(main_file):
                hidden["__file__"] = main_file
            for name in hidden:
                if name == "__spec__":
                    main_mod.__spec__ = None
                else:
                    delattr(main_mod, name)
            try:
                parent, child = ctx.Pipe()
                p = ctx.Process(
                    target=_worker,
                    args=(child, self.env_id, hi - lo, self._seed + lo,
                          dict(self._kwargs)),
                    daemon=True)
                p.start()
                child.close()
            finally:
                for name, value in hidden.items():
                    setattr(main_mod, name, value)
        return parent, p

    def _recv_ready(self, conn, w: int):
        """Consume a worker's ``ready`` handshake (no ``step_timeout``:
        an interpreter start and its imports take longer than a step)."""
        try:
            msg = conn.recv()
        except (EOFError, ConnectionError, OSError) as e:
            raise WorkerDiedError(w, self.env_id) from e
        if msg[0] != "ready":
            raise RuntimeError(f"ProcVecEnv worker failed to start:\n{msg[1]}")
        return msg

    def restart_worker(self, w: int, local: bool = False) -> None:
        """Replace worker ``w`` with a fresh process, or with an in-process
        :class:`_LocalConn` slice (``local=True``), after killing what is
        left of the old one (SIGKILL: it also ends a SIGSTOPped worker).

        The slice's envs are rebuilt and reseeded as at construction
        (``seed + lo``), their reset observations fold into the shared
        normalization statistics (on a mesh they are normalized without a
        fold: no other rank restarts), and the slice's running episode
        sums zero: the episodes in flight are lost, the fault model's
        semantics (a ``gym:`` resume without a usable sidecar)."""
        lo, hi = self._slices[w]
        p = self._procs[w]
        if p is not None:
            try:
                p.kill()
                p.join(timeout=5)
            except (OSError, ValueError):
                pass
        try:
            self._conns[w].close()
        except OSError:
            pass
        self._last_actions.pop(w, None)
        if local:
            conn = _LocalConn(self.env_id, hi - lo, self._seed + lo,
                              dict(self._kwargs))
            proc = None
            msg = conn.recv()
        else:
            conn, proc = self._spawn_worker(w)
            msg = self._recv_ready(conn, w)
        self._conns[w] = conn
        self._procs[w] = proc
        self._obs[lo:hi] = self._fold_and_normalize_slice(msg[3], lo, hi,
                                                          restart=True)
        self._running_returns[lo:hi] = 0.0
        self._running_lengths[lo:hi] = 0

    def is_local_worker(self, w: int) -> bool:
        """True when slice ``w`` runs in this process (degraded mode)."""
        return isinstance(self._conns[w], _LocalConn)

    # -- worker RPC --------------------------------------------------------

    def _recv(self, w: int):
        """One reply from worker ``w`` within ``step_timeout``; a closed
        pipe or a timeout becomes :class:`WorkerDiedError`."""
        conn = self._conns[w]
        try:
            if self.step_timeout is not None and not conn.poll(
                    self.step_timeout):
                raise WorkerDiedError(
                    w, self.env_id, kind="timeout",
                    last_action=self._last_actions.get(w))
            return conn.recv()
        except (EOFError, ConnectionError, OSError) as e:
            raise WorkerDiedError(
                w, self.env_id,
                last_action=self._last_actions.get(w)) from e

    def _reply_all(self, ws):
        """One reply from EVERY worker in ``ws`` before anything raises, so
        no reply is left queued to be read as the answer to a later
        command. Dead or hung workers outrank error replies: they raise
        one :class:`WorkerDiedError` naming every casualty."""
        replies, errors, dead = {}, [], []
        first_died = None
        for w in ws:
            try:
                msg = self._recv(w)
            except WorkerDiedError as e:
                dead.append(w)
                first_died = first_died or e
                continue
            if msg[0] != "ok":
                errors.append(f"worker {w}:\n{msg[1]}")
            else:
                replies[w] = msg[1:]
        if dead:
            raise WorkerDiedError(
                dead[0], self.env_id, kind=first_died.kind,
                last_action=first_died.last_action, workers=dead)
        if errors:
            raise RuntimeError(
                f"ProcVecEnv ({self.env_id}):\n" + "\n".join(errors))
        return replies

    def _scatter_gather(self, msgs: dict):
        """Send every command of ``msgs`` (worker → message), then gather
        every reply. A failed send does not stop the scatter: the workers
        already sent to are drained first, then every casualty raises in
        one :class:`WorkerDiedError`."""
        dead, sent = [], []
        for w, msg in msgs.items():
            try:
                self._conns[w].send(msg)
                if msg[0] == "step":
                    self._last_actions[w] = msg[1]
                sent.append(w)
            except (BrokenPipeError, ConnectionError, OSError):
                dead.append(w)
        try:
            replies = self._reply_all(sent)
        except WorkerDiedError as e:
            if dead:
                raise WorkerDiedError(
                    min(e.workers + dead), self.env_id, kind=e.kind,
                    last_action=e.last_action,
                    workers=sorted(set(e.workers) | set(dead))) from e
            raise
        if dead:
            raise WorkerDiedError(
                dead[0], self.env_id,
                last_action=self._last_actions.get(dead[0]), workers=dead)
        return replies

    def _overlapping(self, lo: int, hi: int):
        """(worker, its local range, the global range) for each worker
        slice that meets ``[lo, hi)``."""
        out = []
        for w, (wlo, whi) in enumerate(self._slices):
            a, b = max(lo, wlo), min(hi, whi)
            if a < b:
                out.append((w, (a - wlo, b - wlo), (a, b)))
        return out

    # -- GymVecEnv surface -------------------------------------------------

    def host_step(self, actions: np.ndarray):
        """Step every env in parallel across the workers; auto-reset
        finished ones. Returns ``(next_obs, rewards, terminated,
        truncated, final_obs)``, as ``GymVecEnv.host_step``."""
        return self.host_step_slice(actions, 0, self.n_envs)

    def host_step_slice(self, actions: np.ndarray, lo: int, hi: int):
        """Step envs ``[lo, hi)``: the overlapping workers step their
        action slices concurrently, then the statistics and normalization
        fold here as in ``GymVecEnv``."""
        parts = self._overlapping(lo, hi)
        # checked before any send: a mid-scatter refusal would leave a
        # worker with an unread reply
        for w, (la, lb), _ in parts:
            if la != 0 or lb != self._slices[w][1] - self._slices[w][0]:
                raise ValueError(
                    f"host_step_slice [{lo}, {hi}) splits worker {w}'s env "
                    f"slice {self._slices[w]} — align groups to worker "
                    "boundaries (host_pipeline_groups=n_workers), or use "
                    "host_step")
        m = hi - lo
        next_obs = np.empty((m,) + self._obs.shape[1:], self._obs.dtype)
        final_obs = np.empty_like(next_obs)
        rewards = np.zeros(m, np.float32)
        terminated = np.zeros(m, bool)
        truncated = np.zeros(m, bool)
        replies = self._scatter_gather({
            w: ("step", actions[ga - lo: gb - lo])
            for w, _, (ga, gb) in parts})
        for w, _, (ga, gb) in parts:
            o, r, tm, tr, f = replies[w]
            s = slice(ga - lo, gb - lo)
            next_obs[s] = o
            rewards[s] = r
            terminated[s] = tm
            truncated[s] = tr
            final_obs[s] = f
        self._update_episode_stats_slice(
            rewards, np.logical_or(terminated, truncated), lo, hi)
        next_obs, final_obs = self._fold_and_normalize_slice(
            next_obs, lo, hi, extra=final_obs)
        self._obs[lo:hi] = next_obs
        return next_obs, rewards, terminated, truncated, final_obs

    def reset_all(self, seed=None) -> np.ndarray:
        """Hard-reset every env (``seed`` reseeds env ``i`` with
        ``seed + env_offset + i``); returns a copy of the new
        observations."""
        if seed is not None:
            seed = seed + self.env_offset
        replies = self._scatter_gather({
            w: ("reset_all", None if seed is None else seed + wlo)
            for w, (wlo, _) in enumerate(self._slices)})
        self._obs = self._fold_and_normalize(np.concatenate(
            [replies[w][0] for w in range(self.n_workers)]))
        self._running_returns[:] = 0.0
        self._running_lengths[:] = 0
        return self._obs.copy()

    def current_obs(self) -> np.ndarray:
        return self._obs.copy()

    # -- checkpoint sidecar (GymVecEnv's schema: cross-restorable) ---------

    def env_state_snapshot(self) -> dict:
        replies = self._scatter_gather(
            {w: ("snapshot",) for w in range(self.n_workers)})
        sims = []
        for w in range(self.n_workers):
            sims.extend(replies[w][0])
        snap = {
            "env_id": self.env_id,
            "sims": sims,
            "obs": self._obs.copy(),
            **self._episode_stats_snapshot(),
        }
        if self.has_obs_norm:
            snap["raw_obs"] = self._raw_obs.copy()
        return snap

    def env_state_restore(self, snap: dict) -> None:
        if snap.get("env_id") != self.env_id:
            raise ValueError(
                f"snapshot is for {snap.get('env_id')!r}, this adapter is "
                f"{self.env_id!r}")
        if len(snap["sims"]) != self.n_envs:
            raise ValueError(
                f"snapshot holds {len(snap['sims'])} envs, this adapter has "
                f"{self.n_envs} — resume with the same n_envs")
        if self.has_obs_norm and "raw_obs" not in snap:
            raise ValueError(
                "snapshot was taken without normalize_obs; resume with the "
                "same normalize_obs setting")
        replies = self._scatter_gather({
            w: ("restore", list(snap["sims"][wlo:whi]))
            for w, (wlo, whi) in enumerate(self._slices)})
        reset_obs = {}
        for w, (wlo, _) in enumerate(self._slices):
            for j, raw in replies[w][0].items():
                reset_obs[wlo + j] = raw
        self._obs = np.asarray(snap["obs"]).copy()
        if self.has_obs_norm:
            self._raw_obs = np.asarray(snap["raw_obs"]).copy()
        self._episode_stats_restore(snap)
        for i, raw in reset_obs.items():  # opaque backend: restarted
            if self.has_obs_norm:
                self._raw_obs[i] = raw
                with self._norm_lock:
                    self._obs[i] = self._apply_norm(raw)
            else:
                self._obs[i] = raw
            self._running_returns[i] = 0.0
            self._running_lengths[i] = 0

    def render_frame(self) -> np.ndarray:
        """An RGB frame of env 0 (worker 0), as ``GymVecEnv``'s."""
        frame = self._scatter_gather({0: ("render",)})[0][0]
        if frame is None:
            raise RuntimeError(
                "rendering returned None — construct ProcVecEnv with "
                "render_mode='rgb_array'")
        return np.asarray(frame)

    def close(self):
        for conn in getattr(self, "_conns", []):
            try:
                conn.send(("close",))
            except (BrokenPipeError, OSError):
                pass
        for p in getattr(self, "_procs", []):
            if p is None:  # an in-process slice: nothing to join
                continue
            p.join(timeout=5)
            if p.is_alive():
                # SIGKILL: a SIGSTOPped worker would hold SIGTERM pending
                # forever and outlive the parent
                p.kill()
                p.join(timeout=5)
        for conn in getattr(self, "_conns", []):
            try:
                conn.close()
            except OSError:
                pass
