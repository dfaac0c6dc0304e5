"""Resilience of the training loop (counterpart: ``trpo_tpu/resilience``).

* ``preempt``: SIGTERM/SIGINT → final checkpoint → ``Preempted`` carrying
  the requeue exit code.
* ``recovery``: last-good ``TrainState`` snapshot, restore on a nonfinite
  update, ``TrainingDiverged`` after ``max_recoveries`` consecutive
  failures.

The fault injector and the env-worker supervisor wait for the host env
families and the telemetry layer (ROADMAP.md Queue 1 items 13 and 18).
"""

from trpo_torch.resilience.preempt import (  # noqa: F401
    Preempted,
    PreemptionGuard,
)
from trpo_torch.resilience.recovery import (  # noqa: F401
    RecoveryPolicy,
    TrainingDiverged,
)
