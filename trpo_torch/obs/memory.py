"""Device-memory accounting: watch the card's memory, catch leaks
(counterpart: ``trpo_tpu/obs/memory.py``).

Two surfaces ride the event bus as ``memory`` records:

* **Live gauges** (``scope="live"``), once per iteration:
  :func:`live_memory_gauges` reads the caching allocator —
  ``torch.cuda.memory_allocated`` (``live_buffer_bytes``: bytes held by
  live tensors), ``memory_reserved`` and ``max_memory_allocated`` — or
  zeros with ``device: "cpu"`` on the CPU, where torch keeps no
  allocator statistics. Sampled from ``Telemetry.on_iteration``, so on
  the async driver's drain thread, off the iteration path.
* **Leak detection.** The gauges feed ``HealthMonitor.observe_memory``:
  live bytes growing monotonically across a full steady-state window is
  a retained reference, surfaced once as ``health:memory_leak``.

A stated difference: the reference's compiled-program accounting
(``scope="program"``: one jitted program's ``memory_analysis()`` from an
ahead-of-time compile) has no counterpart, because the port runs eager
PyTorch and hand-written kernels with no compiled whole program to
analyse. :func:`program_memory_analysis` raises ``NotImplementedError``
saying so, and ``--memory-accounting`` emits no ``scope="program"``
record.
"""

from __future__ import annotations

import torch

__all__ = ["live_memory_gauges", "program_memory_analysis", "MemoryMonitor"]


def program_memory_analysis(*_args, **_kwargs):
    """Not available in the port (module docstring): there is no
    compiled program whose memory an ahead-of-time compile could
    report."""
    raise NotImplementedError(
        "program_memory_analysis analyses a jitted program's compiled "
        "memory (the reference's XLA memory_analysis); trpo_torch runs "
        "eager PyTorch and hand-written kernels with no compiled program "
        "to analyse — use live_memory_gauges (torch.cuda allocator "
        "statistics) instead")


def live_memory_gauges(device=None) -> dict:
    """The caching allocator's gauges on ``device`` (the current CUDA
    device when None and CUDA is available), or zeros with ``device:
    "cpu"`` on the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu", "live_buffer_bytes": 0,
                "device_bytes_reserved": 0, "device_peak_bytes": 0}
    return {
        "device": str(device),
        "live_buffer_bytes": int(torch.cuda.memory_allocated(device)),
        "device_bytes_reserved": int(torch.cuda.memory_reserved(device)),
        "device_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
    }


class MemoryMonitor:
    """The run-attached accountant: live gauges per iteration, the leak
    rule through the health monitor (shared with ``--health-checks``
    when both are on, private otherwise)."""

    def __init__(self, bus=None, health=None, device=None):
        self.bus = bus
        self.health = health
        self.device = device

    def on_iteration(self, iteration: int) -> dict:
        """Sample the gauges, emit the ``scope="live"`` event, feed the
        leak rule."""
        gauges = live_memory_gauges(self.device)
        if self.bus is not None:
            self.bus.emit("memory", scope="live", iteration=int(iteration),
                          **gauges)
        if self.health is not None:
            self.health.observe_memory(int(iteration),
                                       gauges["live_buffer_bytes"])
        return gauges
