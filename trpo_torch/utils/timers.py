"""Phase timers (counterpart: ``trpo_tpu/utils/timers.py``).

``PhaseTimer`` keeps per-phase cumulative and last-call wall times. Phases
nest: each thread carries a stack of open phase names, and a phase entered
inside another records under the slash-joined path ("iteration/rollout").
With ``use_profiler`` each phase is also a ``torch.profiler.record_function``
range, so it shows up by name in a profiler trace. The reference's
cross-thread spans serve its asynchronous host-env pipeline, which is not
ported (ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch

from trpo_torch.ops.flat import tree_leaves

__all__ = ["PhaseTimer", "synchronize_tree"]


def synchronize_tree(tree) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree``. CUDA
    calls return before the device finishes, so a host clock without this
    measures the enqueue."""
    devices = {leaf.device for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    def __init__(self, use_profiler: bool = False):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.last = {}
        self.use_profiler = use_profiler
        self._lock = threading.Lock()
        self._tls = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

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
        ctx = (torch.profiler.record_function(full) if self.use_profiler
               else contextlib.nullcontext())
        stack.append(name)
        start = time.perf_counter()
        try:
            with ctx:
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
