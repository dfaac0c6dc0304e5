"""Elastic fleet orchestrator (counterpart: ``trpo_tpu/fleet/``):
preemptible multi-run scheduling with auto-requeue, checkpoint resume,
a fleet-wide health/perf gate, PBT rounds, and the train→serve
promotion flywheel.

* :mod:`trpo_torch.fleet.spec` — :class:`FleetSpec`/:class:`MemberSpec`,
  the ``--grid seed=0..3,...`` expansion and the JSON spec-file form;
* :mod:`trpo_torch.fleet.scheduler` — :class:`FleetScheduler`: bounded
  worker slots, requeue-on-preemption with zero lost iterations,
  crash budgets, the selection (cull) hook, PBT exploit/explore and
  the fleet gate;
* :mod:`trpo_torch.fleet.scrape` — member discovery via ``run.json``
  descriptors, /status scraping, and the fleet-level ``/status`` +
  ``/metrics`` endpoint;
* :mod:`trpo_torch.fleet.events` — the typed ``fleet`` lifecycle
  records on the run-event bus;
* :mod:`trpo_torch.fleet.promote` — the train→serve flywheel:
  :func:`pick_winner` through the compare-gate, the crash-safe
  :class:`PromotionController` driving marker-gated checkpoints through
  the serving canary, and :func:`feedback_scores` reading served
  realized returns back into the next round's scoring.

``python -m trpo_torch.scripts.fleet`` is the CLI;
``python -m trpo_torch.scripts.flywheel_smoke`` drives the closed loop.
"""

from trpo_torch.fleet.events import (  # noqa: F401
    FLEET_STATES,
    TERMINAL_STATES,
    emit_fleet,
)
from trpo_torch.fleet.promote import (  # noqa: F401
    PromotionController,
    feedback_scores,
    pick_winner,
)
from trpo_torch.fleet.scheduler import (  # noqa: F401
    FleetScheduler,
    MemberRecord,
    default_member_argv,
    score_event_records,
)
from trpo_torch.fleet.scrape import (  # noqa: F401
    FleetStatusServer,
    read_descriptor,
    render_fleet_prometheus,
    scrape_member,
)
from trpo_torch.fleet.spec import (  # noqa: F401
    FleetSpec,
    MemberSpec,
    expand_grid,
    load_spec_file,
    member_cli_args,
    member_total_iterations,
)

__all__ = [
    "FLEET_STATES",
    "TERMINAL_STATES",
    "emit_fleet",
    "PromotionController",
    "feedback_scores",
    "pick_winner",
    "FleetScheduler",
    "MemberRecord",
    "default_member_argv",
    "score_event_records",
    "FleetStatusServer",
    "read_descriptor",
    "render_fleet_prometheus",
    "scrape_member",
    "FleetSpec",
    "MemberSpec",
    "expand_grid",
    "load_spec_file",
    "member_cli_args",
    "member_total_iterations",
]
