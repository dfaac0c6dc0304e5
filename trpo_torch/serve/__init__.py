"""Policy-inference serving (counterpart: ``trpo_tpu/serve/``). The data
plane is one replica that answers ``/act`` and ``/session`` from a
checkpoint directory:

* :mod:`trpo_torch.serve.engine` — :class:`InferenceEngine`: eval-mode
  ``act`` at a ladder of batch shapes, one CUDA graph per rung on a card,
  the snapshot swapped whole on a hot reload.
* :mod:`trpo_torch.serve.session` — the recurrent session protocol:
  :class:`RecurrentServeEngine` (one graph per session rung over
  ``(carry, obs)``), :class:`SessionStore`, :class:`CarryJournal` and its
  fencing.
* :mod:`trpo_torch.serve.batcher` — :class:`MicroBatcher` and
  :class:`SessionBatcher`: deadline-bounded coalescing.
* :mod:`trpo_torch.serve.server` — :class:`PolicyServer`: the HTTP front
  end (TCP and a Unix socket, JSON and binary frames) with a checkpoint
  watcher.
* :mod:`trpo_torch.serve.wire` — the binary frame codec.

The control plane composes replicas of the data plane:

* :mod:`trpo_torch.serve.replicaset` — :class:`ReplicaSet` (N supervised
  replicas, in-process or ``python -m trpo_torch.serve`` children, with
  leases and a crash budget) and :class:`CanaryController` (gated
  checkpoint deployment).
* :mod:`trpo_torch.serve.router` — :class:`Router`: one ``/act`` and
  session front end over the set (least-queue dispatch, one retry,
  affinity with journal-backed failover, admission control).
* :mod:`trpo_torch.serve.autoscaler` — :class:`Autoscaler`: scale-out on
  an SLO breach, lossless drains on scale-in.
* :mod:`trpo_torch.serve.transport` — :class:`LocalExecTransport` and
  :class:`TemplateTransport` (named hosts, placement, bounded discovery).

``python -m trpo_torch.serve`` is the CLI (``--replicas N`` puts a router
in front of N replicas). Every component takes the run-event bus
(``bus=``) and the front ends a tracer (``tracer=``, ``obs/trace.py``);
fault injection and request capture are ROADMAP.md Queue 1 items 18.4
and 18.5.
"""

from trpo_torch.serve.autoscaler import Autoscaler
from trpo_torch.serve.batcher import MicroBatcher, SessionBatcher
from trpo_torch.serve.engine import InferenceEngine, SimulatedCostEngine
from trpo_torch.serve.replicaset import (
    CanaryController,
    InProcessReplica,
    ReplicaSet,
    SubprocessReplica,
    render_launch_argv,
)
from trpo_torch.serve.router import Router
from trpo_torch.serve.server import PolicyServer
from trpo_torch.serve.session import (
    CarryJournal,
    RecurrentServeEngine,
    SessionStore,
    SimulatedCostSessionEngine,
    fence_path,
    fence_session,
    journal_path,
    mint_session_id,
    read_carry_journal,
    read_fences,
)
from trpo_torch.serve.transport import (
    LocalExecTransport,
    TemplateTransport,
    TransportPartitioned,
)

__all__ = [
    "InferenceEngine",
    "SimulatedCostEngine",
    "MicroBatcher",
    "SessionBatcher",
    "PolicyServer",
    "RecurrentServeEngine",
    "SimulatedCostSessionEngine",
    "SessionStore",
    "CarryJournal",
    "journal_path",
    "read_carry_journal",
    "fence_path",
    "fence_session",
    "read_fences",
    "mint_session_id",
    "InProcessReplica",
    "SubprocessReplica",
    "render_launch_argv",
    "ReplicaSet",
    "Router",
    "CanaryController",
    "Autoscaler",
    "LocalExecTransport",
    "TemplateTransport",
    "TransportPartitioned",
]
