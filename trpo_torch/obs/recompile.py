"""Recompile monitor: count what can silently repeat on the card
(counterpart: ``trpo_tpu/obs/recompile.py``).

The reference counts XLA retraces: a drifting shape retraces a jitted
program every iteration and training quietly runs at compile speed. The
port has no traced programs. What can silently repeat on the card
instead is:

* a kernel build (``ops/_build.build``, one ``nvcc`` per CUDA source;
  ``envs/native_build.build``, the host envs' C++ library), which should
  happen once per source set, before the first launch;
* a CUDA graph capture (``serve/engine.py``, one per rung per loaded
  snapshot), which should happen at a load or a reload, never on the
  request path.

Each such site calls :func:`notify` with a program name. That is a small
registry of callbacks: no torch function is patched. A started
:class:`RecompileMonitor` counts the notifications per program and emits
one ``recompile`` event each (``program``, ``count``, ``unexpected``,
``elapsed_s``); after :meth:`RecompileMonitor.mark_steady` every further
one is flagged ``unexpected``. With no monitor started, :func:`notify`
costs one empty-list check.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

__all__ = ["RecompileMonitor", "notify", "subscribe", "unsubscribe"]

_listeners: list = []
_listeners_lock = threading.Lock()


def subscribe(fn: Callable[[str, Optional[float]], None]) -> None:
    """Call ``fn(program, elapsed_s)`` on every build or capture."""
    with _listeners_lock:
        _listeners.append(fn)


def unsubscribe(fn) -> None:
    with _listeners_lock:
        if fn in _listeners:
            _listeners.remove(fn)


def notify(program: str, elapsed_s: Optional[float] = None) -> None:
    """Report one kernel build or graph capture named ``program``."""
    if not _listeners:
        return
    with _listeners_lock:
        listeners = list(_listeners)
    for fn in listeners:
        fn(program, elapsed_s)


class RecompileMonitor:
    """Per-program counter of builds and captures.

    Usage::

        mon = RecompileMonitor(bus)
        with mon:                      # or mon.start() / mon.stop()
            warmup()
            mon.mark_steady()
            train()                    # builds/captures here are unexpected
        mon.unexpected_retraces()      # {program: count}
    """

    def __init__(self, bus=None):
        self._bus = bus
        self._lock = threading.Lock()
        self.compiles: dict = {}
        self.unexpected: dict = {}
        self._steady = False
        self._active = False

    def start(self) -> None:
        if not self._active:
            subscribe(self._observe)
            self._active = True

    def stop(self) -> None:
        if self._active:
            unsubscribe(self._observe)
            self._active = False

    def __enter__(self) -> "RecompileMonitor":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def mark_steady(self) -> None:
        """Declare warmup over: every build or capture from here on is
        unexpected. Idempotent."""
        with self._lock:
            self._steady = True

    def _observe(self, program: str, elapsed_s: Optional[float]) -> None:
        with self._lock:
            count = self.compiles[program] = self.compiles.get(program,
                                                               0) + 1
            unexpected = self._steady
            if unexpected:
                self.unexpected[program] = self.unexpected.get(program,
                                                               0) + 1
        if self._bus is not None:
            self._bus.emit("recompile", program=program, count=count,
                           unexpected=unexpected, elapsed_s=elapsed_s)

    def total_compiles(self) -> dict:
        with self._lock:
            return dict(self.compiles)

    def unexpected_retraces(self) -> dict:
        """Per-program builds and captures seen after :meth:`mark_steady`."""
        with self._lock:
            return dict(self.unexpected)
