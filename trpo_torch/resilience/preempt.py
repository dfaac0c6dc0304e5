"""Preemption-safe shutdown (counterpart: ``trpo_tpu/resilience/preempt.py``).

:class:`PreemptionGuard` turns SIGTERM/SIGINT into a flag that ``learn``
reads at the top of each chunk; it then writes a final checkpoint and
raises :class:`Preempted`, and the CLI exits with the requeue exit code
(``cfg.requeue_exit_code``, 75 = ``EX_TEMPFAIL``), so a wrapper can
resubmit exactly the runs that asked for it. A second signal raises
``KeyboardInterrupt`` at once. Signal handlers are process-wide and can
only be installed from the main thread; entered elsewhere the guard stays
inert.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional

__all__ = ["Preempted", "PreemptionGuard"]


class Preempted(RuntimeError):
    """Raised by ``learn`` after an orderly preemption shutdown. Carries
    the final ``state``, the checkpointed ``step`` (0 = nothing saved),
    the triggering ``signum`` and the ``exit_code`` to requeue with."""

    def __init__(self, message: str, state=None, step: int = 0,
                 signum: Optional[int] = None, exit_code: int = 75):
        super().__init__(message)
        self.state = state
        self.step = step
        self.signum = signum
        self.exit_code = exit_code


class PreemptionGuard:
    """Context manager installing cooperative SIGTERM/SIGINT handling;
    ``enabled=False`` leaves the handlers untouched."""

    def __init__(self, enabled: bool = True,
                 signals=(signal.SIGTERM, signal.SIGINT)):
        self.enabled = enabled
        self.signals = tuple(signals)
        self.triggered = False
        self.signum: Optional[int] = None
        self._prev: dict = {}

    def _handler(self, signum, frame):
        if self.triggered:
            raise KeyboardInterrupt(
                f"second signal {signum} during preemption shutdown"
            )
        self.triggered = True
        self.signum = signum

    def __enter__(self) -> "PreemptionGuard":
        if (self.enabled
                and threading.current_thread() is threading.main_thread()):
            for sig in self.signals:
                self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
