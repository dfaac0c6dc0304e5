"""The stats drain of the asynchronous host-env driver (counterpart:
``trpo_tpu/utils/async_pipe.py``).

``agent.TRPOAgent._learn_host_async`` hands each iteration's stats, still
being computed on the device, to a :class:`StatsDrain`: a thread that waits
for them (the ``ready`` event given with them), brings them to the host
(``fetch``) and runs the consumer (logging, the stop rules, the callback),
so none of that sits between one iteration's update and the next rollout.

The contract (held by ``tests/test_torch_host_learn.py``): items reach the
consumer in submission order, each exactly once; a consumer that returns a
truthy value sets :attr:`StatsDrain.stop_requested`; the first exception
of the drain thread is raised again on the caller's thread at the next
``raise_if_failed``/``drain``/``close``, and items after it are discarded
(so a bounded ``submit`` never blocks behind a dead consumer). With
``maxsize > 0`` ``submit`` blocks while that many items are pending, which
caps how far the stop rules can lag.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Optional

__all__ = ["StatsDrain"]

_SENTINEL = object()


class StatsDrain:
    """``consume(tag, host_stats)`` runs on the drain thread after
    ``fetch(stats)`` (default: the stats as given) has brought them over;
    ``timer`` (a ``PhaseTimer``) records each item as a ``stats_drain``
    span under ``span_context``."""

    def __init__(self, consume: Callable[[Any, Any], Any],
                 fetch: Optional[Callable[[Any], Any]] = None, timer=None,
                 maxsize: int = 0,
                 span_context: tuple = ()):
        self._consume = consume
        self._fetch = fetch or (lambda stats: stats)
        self._timer = timer
        self._span_context = tuple(span_context)
        self.maxsize = maxsize
        self._q: queue.Queue = queue.Queue(maxsize)
        self._gauge_lock = threading.Lock()
        self._high_water = 0
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(target=self._run,
                                        name="trpo-stats-drain", daemon=True)
        self._thread.start()

    def submit(self, tag, stats, ready=None) -> None:
        """Queue one iteration's stats; ``ready`` (e.g. a CUDA event) is
        waited on by the drain thread before the fetch. Blocks at
        ``maxsize`` pending items."""
        if self._closed:
            raise RuntimeError("StatsDrain is closed")
        self._q.put((tag, stats, ready))
        with self._gauge_lock:
            self._high_water = max(self._high_water, self._q.qsize())

    @property
    def depth(self) -> int:
        """Items pending now (racy by nature: a gauge, not a count)."""
        return self._q.qsize()

    @property
    def high_water(self) -> int:
        """The most items ever pending at a submit."""
        with self._gauge_lock:
            return self._high_water

    @property
    def stop_requested(self) -> bool:
        """True once ``consume`` returned truthy, or raised."""
        return self._stop.is_set()

    def raise_if_failed(self) -> None:
        if self._error is not None:
            raise self._error

    def drain(self) -> None:
        """Wait until every item submitted so far is consumed; raise the
        drain thread's error, if any."""
        self._q.join()
        self.raise_if_failed()

    def close(self) -> None:
        """Drain, stop the thread, raise its error; idempotent."""
        if not self._closed:
            self._closed = True
            self._q.put(_SENTINEL)
            self._thread.join()
        self.raise_if_failed()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _SENTINEL:
                    return
                if self._error is not None:
                    continue  # after an error: discard, keep join() live
                tag, stats, ready = item
                span = (self._timer.span("stats_drain",
                                         context=self._span_context)
                        if self._timer is not None else None)
                try:
                    if ready is not None:
                        ready.synchronize()
                    if self._consume(tag, self._fetch(stats)):
                        self._stop.set()
                except BaseException as e:  # noqa: BLE001 — raised later
                    self._error = e
                    self._stop.set()
                finally:
                    if span is not None:
                        span.end()
            finally:
                self._q.task_done()
