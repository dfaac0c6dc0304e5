"""Resilience: every failure mode of a run is either survived or cleanly
resumable, and each is injectable, so its recovery path is test-pinned
(counterpart: ``trpo_tpu/resilience``).

* ``inject``: seeded, typed fault injection — worker kill/hang and step
  delays on the ``gymproc:`` pool, a NaN-poisoned update, SIGTERM, and the
  serving plane's replica, reload, journal, storm and network faults —
  each firing a ``fault_injected`` event.
* ``supervisor``: env-worker supervision — reply timeouts →
  ``WorkerDiedError`` → restart with backoff → in-process degradation →
  the ``min_env_workers`` floor.
* ``recovery``: last-good ``TrainState`` snapshot, restore on a nonfinite
  update, ``TrainingDiverged`` after ``max_recoveries`` consecutive
  failures.
* ``preempt``: SIGTERM/SIGINT → final checkpoint → ``Preempted`` carrying
  the requeue exit code.
"""

from trpo_torch.envs.proc_env import WorkerDiedError  # noqa: F401
from trpo_torch.resilience.inject import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    PromoterKilled,
    parse_fault_specs,
)
from trpo_torch.resilience.preempt import (  # noqa: F401
    Preempted,
    PreemptionGuard,
)
from trpo_torch.resilience.recovery import (  # noqa: F401
    RecoveryPolicy,
    TrainingDiverged,
)
from trpo_torch.resilience.supervisor import (  # noqa: F401
    SupervisedEnv,
    SupervisionConfig,
    WorkerPoolError,
)

__all__ = [
    "FaultInjector",
    "FaultSpec",
    "PromoterKilled",
    "parse_fault_specs",
    "Preempted",
    "PreemptionGuard",
    "RecoveryPolicy",
    "TrainingDiverged",
    "SupervisedEnv",
    "SupervisionConfig",
    "WorkerPoolError",
    "WorkerDiedError",
]
