"""Fleet lifecycle events: the typed records the scheduler emits
(counterpart: ``trpo_tpu/fleet/events.py``).

The member lifecycle is a small state machine::

    pending ──launch──▶ running ──exit 0───────────▶ finished ──▶ culled?
       ▲                   │
       │                   ├─exit 75 (preempted)──▶ preempted
       │                   │                            │ requeue budget ok
       │                   │                            ▼
       └──────requeued◀────┴─exit !=0,!=75 (crash)──(requeued | failed)

``finished`` members may additionally be marked ``culled`` by the
selection hook (bottom-k by final score — the seam PBT-style
exploit/explore later plugs into); ``culled`` is a *selection* verdict
layered on a terminal state, not a scheduling one.

Every transition goes on the run-event bus as a ``fleet`` record
(kind vocabulary in ``obs/events.FLEET_STATES`` so the validator needs
no fleet import). Extra per-transition context rides as optional fields
(``exit_code``, ``reason``, ``resume_step``, ``score``) — the schema is
additive, readers tolerate fields they don't know.
"""

from __future__ import annotations

import math
from typing import Optional

from trpo_torch.obs.events import FLEET_STATES

__all__ = ["FLEET_STATES", "TERMINAL_STATES", "emit_fleet"]

# states after which the scheduler will never relaunch the member
TERMINAL_STATES = ("finished", "failed", "culled")


def emit_fleet(
    bus,
    member: str,
    state: str,
    attempt: int,
    *,
    exit_code: Optional[int] = None,
    reason: Optional[str] = None,
    resume_step: Optional[int] = None,
    score: Optional[float] = None,
) -> Optional[dict]:
    """Emit one ``fleet`` lifecycle record (no-op without a bus —
    the scheduler is usable as a library without telemetry)."""
    if bus is None:
        return None
    if state not in FLEET_STATES:
        raise ValueError(
            f"unknown fleet state {state!r} (have {FLEET_STATES})"
        )
    extra = {}
    if exit_code is not None:
        extra["exit_code"] = int(exit_code)
    if reason is not None:
        extra["reason"] = str(reason)
    if resume_step is not None:
        extra["resume_step"] = int(resume_step)
    if score is not None and math.isfinite(score):
        # a no-episode member scores -inf, which JsonlSink's json.dumps
        # would write as the non-RFC `-Infinity` token and poison the
        # event log for strict JSONL consumers — omit instead
        extra["score"] = float(score)
    return bus.emit(
        "fleet", member=member, state=state, attempt=int(attempt), **extra
    )
