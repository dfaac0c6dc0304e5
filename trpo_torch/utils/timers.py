"""Phase timers (counterpart: ``trpo_tpu/utils/timers.py``).

``PhaseTimer`` keeps per-phase cumulative and last-call wall times. Phases
nest: each thread carries a stack of open phase names, and a phase entered
inside another records under the slash-joined path ("iteration/rollout").
Each phase is also a :func:`span`, so a profiler trace names it.

:func:`span` is the program's one tracing primitive: a
``torch.profiler.record_function`` range while a profiler records on the
calling thread, and nothing at all (one thread-local check) otherwise.
Given a CUDA device it also records a pair of CUDA events at its edges
into ``ops/_build.SPANS``, read once the device is synchronized; every
span opened is counted by name in ``ops/_build.SPAN_COUNTS``.
:func:`host_read` is ``Tensor.item()`` (``tolist()`` for more than one
element) counted by site in ``ops/_build.HOST_READS`` (a read of a CUDA
value, which waits for the device) under the same rule, and
:func:`tally` keeps a host value a span's reader needs (the positions a
call ran on, the tokens an expert took) in ``ops/_build.TALLIES``.

Stages that start on one thread and record on another (the pipelined
rollout's group threads, the async driver's stats drain) use
:meth:`PhaseTimer.span`: an explicit begin/end handle whose name is
prefixed with a :meth:`PhaseTimer.current_context` capture of the
launching thread's open phases, so it nests under the phase that started
it. All accounting is under one lock.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Optional, Tuple

import torch
from torch.autograd import _profiler_enabled

# ``trpo_torch.ops`` imports this module (``ops/cg.py``, ``ops/linesearch.py``)
# and ``ops/_build`` imports ``trpo_torch.obs``, which imports ``utils``: the
# package's modules are imported where they are used, never at the top.

__all__ = ["PhaseTimer", "host_read", "span", "synchronize_tree", "tally"]

_OFF = contextlib.nullcontext()
_open = threading.local()   # this thread's open span names, innermost last


class _Range:
    """An open :func:`span` while a profiler records."""

    __slots__ = ("name", "device", "_range", "_parent", "_start")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self):
        from trpo_torch.ops import _build

        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        _build.SPAN_COUNTS[self.name] += 1
        self._range = torch.autograd.profiler.record_function(self.name)
        self._range.__enter__()
        self._start = None
        if self.device is not None and self.device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        if self._start is not None:
            from trpo_torch.ops import _build

            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            _build.SPANS.add(_build.SpanRecord(self.name, self._parent,
                                               self._start, end))
        self._range.__exit__(*exc)
        _open.stack.pop()
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A named range of the program: ``with span("trpo/cg_solve", dev):``.
    With no profiler recording on this thread it returns one shared empty
    context (no object is built, no clock read). While one records it is a
    ``record_function(name)`` range, counted in ``SPAN_COUNTS``; with a
    CUDA ``device`` it is also device-timed, by events on that device's
    current stream kept in ``SPANS`` with the innermost enclosing span's
    name."""
    if not _profiler_enabled():
        return _OFF
    return _Range(name, device)


def host_read(t: torch.Tensor, site: str):
    """``t.item()``, or ``t.tolist()`` for a ``t`` of more than one
    element: one transfer either way. While a profiler records on this
    thread, a read of a CUDA ``t`` (a wait on the device) is counted under
    ``site`` in ``ops/_build.HOST_READS``."""
    if _profiler_enabled() and t.is_cuda:
        from trpo_torch.ops import _build

        _build.HOST_READS[site] += 1
    return t.item() if t.numel() == 1 else t.tolist()


def tally(name: str, value) -> None:
    """While a profiler records on this thread, append the host value
    ``value`` to ``ops/_build.TALLIES[name]`` (up to ``SPAN_CAP`` of them
    a name); nothing otherwise. A span that tallies once a call keeps its
    values in the order of its device-timed records."""
    if _profiler_enabled():
        from trpo_torch.ops import _build

        kept = _build.TALLIES[name]
        if len(kept) < _build.SPAN_CAP:
            kept.append(value)


def synchronize_tree(tree) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree``. CUDA
    calls return before the device finishes, so a host clock without this
    measures the enqueue."""
    from trpo_torch.ops.flat import tree_leaves

    devices = {leaf.device for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class _Span:
    """An open span; ``end()`` records it (only the first call)."""

    __slots__ = ("_timer", "name", "_start", "_done")

    def __init__(self, timer: "PhaseTimer", name: str):
        self._timer = timer
        self.name = name
        self._start = time.perf_counter()
        self._done = False

    def end(self) -> float:
        """Close the span; returns its duration in seconds."""
        dt = time.perf_counter() - self._start
        if not self._done:
            self._done = True
            self._timer.record(self.name, dt)
        return dt


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.last = {}
        self._lock = threading.Lock()
        self._tls = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_context(self) -> Tuple[str, ...]:
        """This thread's open-phase path, for :meth:`span` on another
        thread."""
        return tuple(self._stack())

    def span(self, name: str, context: Tuple[str, ...] = ()) -> _Span:
        """Begin a span recorded under ``context + (name,)`` when its
        ``end()`` runs, on whichever thread."""
        return _Span(self, "/".join(tuple(context) + (name,)))

    def record(self, name: str, seconds: float) -> None:
        """Fold one completed measurement in."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1
            self.last[name] = seconds

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time a phase. ``block_on`` (a tensor or a tree of them) is
        waited for before the clock stops (:func:`synchronize_tree`)."""
        stack = self._stack()
        full = "/".join(stack + [name])
        stack.append(name)
        start = time.perf_counter()
        try:
            with span(full):
                yield
                if block_on is not None:
                    synchronize_tree(block_on)
        finally:
            stack.pop()
            self.record(full, time.perf_counter() - start)

    def last_ms(self, name: str) -> float:
        with self._lock:
            return self.last.get(name, 0.0) * 1e3

    def summary(self) -> dict:
        with self._lock:
            return {
                name: {
                    "mean_ms": self.totals[name] / self.counts[name] * 1e3,
                    "total_s": self.totals[name],
                    "calls": self.counts[name],
                }
                for name in self.totals
            }
