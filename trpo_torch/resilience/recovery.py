"""Update-level recovery (counterpart: ``trpo_tpu/resilience/recovery.py``).

With ``cfg.recover_on_nan="restore"`` the ``learn`` loop parks a
last-good snapshot of the ``TrainState`` before each chunk
(:meth:`RecoveryPolicy.snapshot`). When a stats row shows a nonfinite
update (NaN entropy, or the update's device-side ``nan_guard``), the row
is logged and :meth:`~RecoveryPolicy.flag` ged, and the loop
:meth:`~RecoveryPolicy.recover` s: the snapshot comes back, the chunk
re-runs from it (device envs re-run the same computation, so a one-off
fault continues bit-exactly), and ``cg_damping`` is escalated through the
adaptive-damping state when that is on. After ``cfg.max_recoveries``
consecutive recoveries the policy raises :class:`TrainingDiverged`.
With a ``bus`` every recovery emits a ``recovery`` event.

The snapshot is a deep copy: every tensor leaf is cloned and the rollout
generator, which the rollout advances in place, is copied with its state.
The rest of the update builds new tensors rather than writing into the
old ones (the critic's Adam moments, the ladder, the preconditioner), but
the copy does not rely on that.
"""

from __future__ import annotations

import sys
from typing import Any, Optional, Tuple

import torch

from trpo_torch.ops.flat import tree_map

__all__ = ["RecoveryPolicy", "TrainingDiverged", "copy_state"]


class TrainingDiverged(FloatingPointError):
    """Consecutive recoveries exhausted. A ``FloatingPointError``, so
    callers of the NaN-entropy abort catch it unchanged."""


def _copy_leaf(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.clone()
    if isinstance(leaf, torch.Generator):
        gen = torch.Generator(device=leaf.device)
        gen.set_state(leaf.get_state())
        return gen
    return leaf


def copy_state(state: Any) -> Any:
    """A deep copy of a state tree: tensors cloned, generators copied."""
    return tree_map(_copy_leaf, state)


class RecoveryPolicy:
    def __init__(self, cfg, keep: int = 2, bus=None):
        self.cfg = cfg
        self.bus = bus
        self._keep = keep
        self._snaps: dict = {}
        self._pending: Optional[Tuple[int, str]] = None
        # only a clean row at or past the last flagged iteration proves a
        # recovery worked: a re-run chunk reproduces its clean prefix, and
        # letting that reset the counter would restore a deterministic
        # mid-chunk NaN forever instead of diverging
        self._last_flagged: Optional[int] = None
        self.consecutive = 0
        self.total_recoveries = 0

    def snapshot(self, iteration: int, state) -> None:
        """Park a copy of ``state`` as the restore point for
        ``iteration`` (the 1-based iteration about to run)."""
        self._snaps[iteration] = copy_state(state)
        while len(self._snaps) > self._keep:
            del self._snaps[min(self._snaps)]

    def mark_clean(self, iteration: int) -> None:
        """A healthy row for ``iteration``: reset the consecutive count,
        unless a flag is pending or the row precedes the last flag."""
        if self._pending is not None:
            return
        if self._last_flagged is None or iteration >= self._last_flagged:
            self.consecutive = 0

    @property
    def pending(self) -> Optional[Tuple[int, str]]:
        """(iteration, reason) awaiting :meth:`recover`, or None."""
        return self._pending

    def flag(self, iteration: int, reason: str) -> None:
        """``iteration``'s row showed a nonfinite update; the first flag
        wins until :meth:`recover`."""
        if self._pending is None:
            self._pending = (iteration, reason)
            self._last_flagged = iteration

    def recover(self):
        """Restore the newest snapshot at or before the flagged iteration;
        returns ``(snapshot_iteration, state)``. Raises
        :class:`TrainingDiverged` past ``max_recoveries`` consecutive
        recoveries."""
        iteration, reason = self._pending
        self._pending = None
        keys = [k for k in self._snaps if k <= iteration]
        self.consecutive += 1
        self.total_recoveries += 1
        if self.consecutive > self.cfg.max_recoveries:
            raise TrainingDiverged(
                f"nonfinite update at iteration {iteration} ({reason}): "
                f"{self.cfg.max_recoveries} consecutive recoveries "
                "exhausted; aborting training"
            )
        if not keys:
            raise TrainingDiverged(
                f"nonfinite update at iteration {iteration} ({reason}) "
                "with no snapshot to restore"
            )
        at = max(keys)
        # hand out a copy: the stored snapshot must survive a retry that
        # fails again
        state = copy_state(self._snaps[at])
        escalated = None
        if state.cg_damping is not None:
            # a recovery is the strongest "this step was bad" signal the
            # adaptive damping can get
            state = state._replace(cg_damping=torch.clamp(
                state.cg_damping * self.cfg.damping_grow,
                max=self.cfg.damping_max))
            if self.bus is not None:
                escalated = float(state.cg_damping)
        if self.bus is not None:
            self.bus.emit("recovery", action="restore", reason=reason,
                          iteration=iteration, restored_to=at,
                          consecutive=self.consecutive,
                          total=self.total_recoveries,
                          cg_damping=escalated)
        print(f"recovery: nonfinite update at iteration {iteration} "
              f"({reason}); restored the state before iteration {at} "
              f"(consecutive {self.consecutive})", file=sys.stderr)
        return at, state
