"""Request micro-batchers: coalesce concurrent requests under a latency
deadline (counterpart: ``trpo_tpu/serve/batcher.py``).

A card answers a padded batch-8 inference in about the time of a batch-1
one, so a server should not dispatch each request alone. Two batchers
share one scaffold (:class:`_DeadlineBatcher`: bounded queue, one
dispatcher thread, the deadline/full dispatch rule, the adaptive
deadline, a bounded latency window):

* :class:`MicroBatcher` — the stateless plane: observations in front of
  an :class:`~trpo_torch.serve.engine.InferenceEngine`, futures
  resolving to ``(action, step)``.
* :class:`SessionBatcher` — continuous batching for recurrent sessions:
  ``(sid, carry, obs)`` entries in front of a
  :class:`~trpo_torch.serve.session.RecurrentServeEngine`. One dispatch
  GATHERS up to ``engine.max_batch`` waiting sessions into ONE
  ``step_batch`` call and SCATTERS ``(action, new_carry, step)`` back.
  Two entries for the SAME session never share an epoch (the later one
  is held back: it would read the first one's stale carry).

Dispatch rule: a batch goes when the queue reaches the engine's top rung
(**full**), or when the oldest request has spent HALF its
``deadline_ms`` budget waiting (**deadline**; the inference gets the
other half), or at close. ``adaptive_deadline`` caps that wait at
``adaptive_headroom ×`` the EMA of the observed dispatch cost (never
above the half-budget): a fast model under a slow request rate stops
idling on the off-chance that more requests coalesce.

Backpressure: the queue is bounded (``max_queue``) and ``submit`` blocks
while it is full (optionally up to a timeout). The per-request latency
window is a fixed-size deque. An engine failure fails exactly the
requests of that batch; the dispatcher survives. ``close`` stops
admission, drains what was accepted, and joins the dispatcher.

With a ``bus`` (``obs.events.EventBus``) each dispatch emits one
``serve`` event (requests coalesced, padded rung, queue depth left
behind, oldest latency), as the reference's does. A traced request
(``submit(..., trace=(ctx, parent_span_id))``) gets a ``batch.queue_wait``
span (submit → gather) and a per-trace copy of the dispatch span
(``engine.infer`` / ``engine.step_batch``), every copy of one epoch
wearing the SAME span id; an engine failure forces its traces.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeoutError
from typing import Optional

import numpy as np
import torch

from trpo_torch.obs.trace import mint_span_id
from trpo_torch.utils.metrics import quantile_nearest_rank

__all__ = ["MicroBatcher", "SessionBatcher"]


class _Pending:
    __slots__ = ("obs", "t", "future", "trace")

    def __init__(self, obs, t: float, trace=None):
        self.obs = obs
        self.t = t
        self.future: Future = Future()
        # (TraceContext, parent span id, wall-clock submit time) of a
        # traced request, or None
        self.trace = trace


class _SessionPending:
    __slots__ = ("sid", "carry", "obs", "t", "future", "trace")

    def __init__(self, sid: str, carry, obs, t: float, trace=None):
        self.sid = sid
        self.carry = carry
        self.obs = obs
        self.t = t
        self.future: Future = Future()
        self.trace = trace  # see _Pending.trace


class _DeadlineBatcher:
    """Bounded queue + dispatcher thread + deadline/full dispatch rule +
    adaptive deadline + bounded latency window. Subclasses implement
    :meth:`_dispatch` and may override :meth:`_take_batch_locked`."""

    def __init__(
        self,
        engine,
        deadline_ms: float = 10.0,
        max_queue: int = 1024,
        bus=None,
        latency_window: int = 2048,
        adaptive_deadline: bool = False,
        adaptive_headroom: float = 2.0,
        cost_ema_alpha: float = 0.2,
        thread_name: str = "serve-batcher",
    ):
        if deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if adaptive_headroom <= 0:
            raise ValueError(
                f"adaptive_headroom must be > 0, got {adaptive_headroom}")
        if not 0 < cost_ema_alpha <= 1:
            raise ValueError(
                f"cost_ema_alpha must be in (0, 1], got {cost_ema_alpha}")
        self.engine = engine
        self.bus = bus
        self.deadline_ms = float(deadline_ms)
        self.max_queue = int(max_queue)
        self.adaptive_deadline = bool(adaptive_deadline)
        self.adaptive_headroom = float(adaptive_headroom)
        self._cost_alpha = float(cost_ema_alpha)
        self._cost_ema_ms: Optional[float] = None
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._closed = False
        # counters under _cond; the latency window under its own lock so a
        # metrics scrape never contends with submit/dispatch
        self.requests_total = 0
        self.batches_total = 0
        self.errors_total = 0
        self.queue_high_water = 0
        self.latency_window = int(latency_window)
        self._lat_lock = threading.Lock()
        self._latencies_ms: deque = deque(maxlen=self.latency_window)
        self._thread = threading.Thread(
            target=self._loop, name=thread_name, daemon=True)
        self._thread.start()

    # -- client side -------------------------------------------------------

    def _enqueue(self, pending, timeout: Optional[float] = None) -> Future:
        """Admit one entry (backpressure-bounded); ``RuntimeError`` after
        :meth:`close`. With ``timeout``, a queue that stays full past it
        raises ``concurrent.futures.TimeoutError`` (the entry was never
        admitted, so a retry is safe)."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            while len(self._queue) >= self.max_queue and not self._closed:
                if deadline is not None and time.perf_counter() >= deadline:
                    raise _FutureTimeoutError(
                        f"{type(self).__name__} queue full for {timeout}s")
                self._cond.wait(0.05)
            if self._closed:
                raise RuntimeError(f"{type(self).__name__} is closed")
            self._queue.append(pending)
            self.requests_total += 1
            self.queue_high_water = max(self.queue_high_water,
                                        len(self._queue))
            self._cond.notify_all()
        return pending.future

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def latency_samples(self) -> int:
        """Samples in the (bounded) latency window."""
        with self._lat_lock:
            return len(self._latencies_ms)

    def latency_quantiles_ms(self, qs=(0.5, 0.99)) -> dict:
        """Nearest-rank quantiles over the recent per-request latencies
        (empty before the first completed request)."""
        with self._lat_lock:
            lats = list(self._latencies_ms)
        if not lats:
            return {}
        return {q: quantile_nearest_rank(lats, q) for q in qs}

    @property
    def dispatch_cost_ema_ms(self) -> Optional[float]:
        """EMA of the per-dispatch engine cost (None before the first
        successful dispatch): the adaptive deadline's signal."""
        with self._lat_lock:
            return self._cost_ema_ms

    def _observe_dispatch(self, cost_ms: float, lats) -> None:
        with self._lat_lock:
            self._latencies_ms.extend(lats)
            self._cost_ema_ms = (
                cost_ms if self._cost_ema_ms is None
                else self._cost_alpha * cost_ms
                + (1.0 - self._cost_alpha) * self._cost_ema_ms)

    def _effective_half_budget_ms(self) -> float:
        """The wait the dispatcher honors: the half-deadline, shrunk with
        ``adaptive_deadline`` to ``adaptive_headroom ×`` the cost EMA
        (floored at 0.1 ms so concurrent submitters still coalesce)."""
        half = self.deadline_ms / 2.0
        if not self.adaptive_deadline:
            return half
        with self._lat_lock:
            ema = self._cost_ema_ms
        if ema is None:
            return half
        return min(half, max(self.adaptive_headroom * ema, 0.1))

    # -- dispatcher --------------------------------------------------------

    def _take_batch_locked(self, full: int) -> list:
        """Pop the batch one dispatch takes (called under ``_cond``)."""
        return [self._queue.popleft()
                for _ in range(min(full, len(self._queue)))]

    def _loop(self) -> None:
        full = self.engine.max_batch
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                age_ms = (time.perf_counter() - self._queue[0].t) * 1e3
                budget_ms = self._effective_half_budget_ms() - age_ms
                if (len(self._queue) < full and budget_ms > 0
                        and not self._closed):
                    self._cond.wait(budget_ms / 1e3)
                    continue  # more requests may have landed
                batch = self._take_batch_locked(full)
                depth_after = len(self._queue)
                self._cond.notify_all()  # wake submitters blocked on space
            self._dispatch(batch, depth_after)

    def _dispatch(self, batch, depth_after: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def _fail_batch(self, batch, exc: Exception) -> None:
        """Fail THESE requests; the dispatcher survives for the next."""
        with self._cond:
            self.errors_total += len(batch)
        for p in batch:
            if p.trace is not None:
                # an engine failure is an anomaly: the trace survives
                # sampling, so the 500 has attribution
                p.trace[0].force()
            p.future.set_exception(exc)

    def _timed(self, batch, call, span_name: str):
        """Run ``call()`` as one dispatch of ``batch``: record its cost and
        the batch's latencies and book the traced requests' spans, or fail
        the batch. Returns ``(result, latencies)``, or None after a
        failure."""
        t0, wall = time.perf_counter(), time.time()
        try:
            out = call()
        except Exception as e:  # scoped to this batch's futures
            self._fail_batch(batch, e)
            return None
        done = time.perf_counter()
        lats = [(done - p.t) * 1e3 for p in batch]
        self._observe_dispatch((done - t0) * 1e3, lats)
        self._trace_epoch(batch, span_name,
                          self.engine.padded_shape(len(batch)), t0, wall,
                          done)
        with self._cond:
            self.batches_total += 1
        return out, lats

    def _trace_epoch(self, batch, span_name: str, rung: int,
                     t_gather: float, wall_infer: float,
                     done: float) -> None:
        """Book the epoch's spans into every traced participant's context:
        a ``batch.queue_wait`` span (submit → gather) and its copy of the
        dispatch span, every copy wearing the SAME span id, so N coalesced
        requests point at ONE dispatch."""
        traced = [p for p in batch if p.trace is not None]
        if not traced:
            return
        epoch_id = mint_span_id()
        cost_ms = (done - t_gather) * 1e3
        for p in traced:
            ctx, parent_id, t_wall = p.trace
            qid = ctx.record("batch.queue_wait", start=t_wall,
                             dur_ms=max(0.0, (t_gather - p.t) * 1e3),
                             parent_id=parent_id)
            ctx.record(span_name, start=wall_infer, dur_ms=cost_ms,
                       parent_id=qid, span_id=epoch_id, width=len(batch),
                       rung=rung)

    def _emit_dispatch(self, batch, depth_after: int, lats) -> None:
        if self.bus is not None:
            self.bus.emit("serve", requests=len(batch),
                          padded=self.engine.padded_shape(len(batch)),
                          queue_depth=depth_after, latency_ms=max(lats))

    def close(self) -> None:
        """Stop accepting requests, drain what is queued, and join the
        dispatcher: every accepted future still resolves."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=30.0)


class MicroBatcher(_DeadlineBatcher):
    """Deadline-bounded request coalescing in front of an
    :class:`~trpo_torch.serve.engine.InferenceEngine` (stateless /act)."""

    def submit(self, obs, trace=None) -> Future:
        """Enqueue ONE observation; the future resolves to ``(action,
        step)``, ``step`` being the checkpoint step of the snapshot that
        computed it. Blocks while the queue is at its bound; raises
        ``RuntimeError`` after :meth:`close`. ``trace`` is the caller's
        ``(TraceContext, parent span id)``, or None."""
        obs = np.asarray(obs, self.engine.obs_dtype)
        if obs.shape != self.engine.obs_shape:
            raise ValueError(
                f"obs must have shape {self.engine.obs_shape}, "
                f"got {obs.shape}")
        if trace is not None:
            trace = (trace[0], trace[1], time.time())
        return self._enqueue(_Pending(obs, time.perf_counter(), trace))

    def _dispatch(self, batch, depth_after: int) -> None:
        obs = np.stack([p.obs for p in batch], axis=0)
        out = self._timed(batch, lambda: self.engine.infer(
            obs, return_step=True), "engine.infer")
        if out is None:
            return
        (actions, step), lats = out
        for p, action in zip(batch, actions):
            p.future.set_result((np.asarray(action), step))
        self._emit_dispatch(batch, depth_after, lats)


class SessionBatcher(_DeadlineBatcher):
    """Continuous batching for recurrent sessions: gather up to
    ``engine.max_batch`` waiting sessions' ``(carry, obs)`` into ONE
    rung-padded ``step_batch`` dispatch, scatter ``(action, new_carry,
    step)`` back. One session appears at most once per epoch.

    On a CUDA engine the carries stay on its device: an epoch stacks them
    there (uploading a fresh or resumed session's host carry once) and
    hands each session back a row of the new carries on the device, so the
    steady state moves no carry byte through the host. On a CPU engine
    carries stay numpy arrays.
    """

    def __init__(self, engine, deadline_ms: float = 3.0, **kw):
        kw.setdefault("thread_name", "serve-session-batcher")
        super().__init__(engine, deadline_ms=deadline_ms, **kw)
        device = getattr(engine, "device", None)
        self._carry_device = (
            device if device is not None
            and torch.device(device).type == "cuda" else None)
        self.epoch_width_last = 0
        self.epoch_width_sum = 0
        self.holdbacks_total = 0

    @property
    def epochs_total(self) -> int:
        """One batch IS one gather/scatter epoch."""
        return self.batches_total

    @property
    def epoch_width_mean(self) -> Optional[float]:
        with self._cond:
            if not self.batches_total:
                return None
            return self.epoch_width_sum / self.batches_total

    def submit(self, sid: str, carry, obs,
               timeout: Optional[float] = None, trace=None) -> Future:
        """Enqueue ONE session step; the future resolves to ``(action,
        new_carry, step)``. The caller owns the carry's read-modify-write
        order (the HTTP front end holds the session lock from submit to
        result). ``timeout`` bounds the QUEUE wait
        (``concurrent.futures.TimeoutError``; the step never ran).
        ``trace``: the caller's ``(TraceContext, parent span id)``."""
        if not isinstance(sid, str) or not sid:
            raise ValueError(f"sid must be a non-empty string, got {sid!r}")
        if not isinstance(carry, torch.Tensor):
            carry = np.asarray(carry, np.float32)
        if tuple(carry.shape) != (self.engine.state_size,):
            raise ValueError(
                f"carry must have shape ({self.engine.state_size},), "
                f"got {tuple(carry.shape)}")
        obs = np.asarray(obs, self.engine.obs_dtype)
        if obs.shape != self.engine.obs_shape:
            raise ValueError(
                f"obs must have shape {self.engine.obs_shape}, "
                f"got {obs.shape}")
        if trace is not None:
            trace = (trace[0], trace[1], time.time())
        return self._enqueue(
            _SessionPending(sid, carry, obs, time.perf_counter(), trace),
            timeout=timeout)

    def _take_batch_locked(self, full: int) -> list:
        """Gather one epoch in arrival order: each session's FIRST waiting
        entry; later duplicates keep their order for the next epoch."""
        batch, seen, held = [], set(), []
        while self._queue and len(batch) < full:
            p = self._queue.popleft()
            if p.sid in seen:
                held.append(p)
                continue
            seen.add(p.sid)
            batch.append(p)
        if held:
            self.holdbacks_total += len(held)
            self._queue.extendleft(reversed(held))
        return batch

    def _dispatch(self, batch, depth_after: int) -> None:
        dev = self._carry_device
        if dev is not None:
            carries = torch.stack([
                torch.as_tensor(p.carry, dtype=torch.float32, device=dev)
                for p in batch])
        else:
            carries = np.stack([np.asarray(p.carry, np.float32)
                                for p in batch])
        obs = np.stack([p.obs for p in batch], axis=0)
        out = self._timed(batch, lambda: self.engine.step_batch(
            carries, obs, return_step=True), "engine.step_batch")
        if out is None:
            return
        (actions, new_carries, step), lats = out
        with self._cond:
            self.epoch_width_last = len(batch)
            self.epoch_width_sum += len(batch)
        for i, p in enumerate(batch):
            p.future.set_result((np.asarray(actions[i]), new_carries[i],
                                 step))
        self._emit_dispatch(batch, depth_after, lats)
