"""Policy-inference serving, the data plane (counterpart:
``trpo_tpu/serve/``): one replica that answers ``/act`` and ``/session``
from a checkpoint directory.

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

``python -m trpo_torch.serve`` is the CLI. The control plane (router,
replica set, autoscaler, transports, canary) is ROADMAP.md Queue 1 item 17;
the event bus, tracing, fault injection and capture are item 18.
"""

from trpo_torch.serve.batcher import MicroBatcher, SessionBatcher
from trpo_torch.serve.engine import InferenceEngine, SimulatedCostEngine
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
]
