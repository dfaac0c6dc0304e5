"""``Telemetry`` — the one object a driver threads through a run
(counterpart: ``trpo_tpu/obs/telemetry.py``).

It bundles the event bus (sinks from CLI flags), the health monitor, the
recompile monitor, the memory accountant, the live status endpoint and an
iteration-windowed ``torch.profiler`` capture, so ``agent.learn`` takes
one optional argument and the CLI wiring lives in one place:

* ``--metrics-jsonl PATH``  → a JSONL sink on the bus (manifest,
  iteration, phase, health, recompile and memory records, the
  reference's schema);
* ``--health-checks``       → the health monitor and a console sink for
  health/recompile findings;
* ``--status-port P``       → ``obs/server.StatusSink`` on the bus and a
  background HTTP server (``GET /status``, ``GET /metrics``); ``P=0`` is
  ephemeral, and the bound port is announced as a ``status`` event right
  after the manifest. Unset: no sink, no thread;
* ``--memory-accounting``   → ``obs/memory.MemoryMonitor``: per-iteration
  allocator gauges and the ``health:memory_leak`` window rule (no
  ``scope="program"`` record: ``obs/memory.py`` says why);
* ``--profile-dir D [--profile-iteration N]`` → a ``torch.profiler``
  trace (CPU and, on the card, CUDA activity) written to ``D`` as a
  Chrome trace: of the window around iteration N, or of the whole run
  without N. The trace names the ``PhaseTimer`` phases inside and, on
  the thread the profiler records, the update's ``trpo/*`` spans
  (``utils/timers.span``).

Lifecycle (driven by ``agent.learn``): ``start_run(cfg, ...)`` emits the
run manifest (and the ``status`` announcement) and starts the recompile
monitor; ``mark_steady()`` after warmup flips further kernel builds and
graph captures to "unexpected"; ``on_iteration`` runs the health rules
and memory gauges on each row (thread-safe: the async driver calls it
from the drain thread); ``observe_drain`` takes the async driver's queue
gauges; ``profile_tick`` opens and closes the profiler window;
``finish_run(timer)`` closes an open window (it runs in ``learn``'s
``finally``, so a raising run still writes its trace), emits the
PhaseTimer's summaries as ``phase`` events, marks the status snapshot
finished and stops the recompile monitor. The creator (CLI, test) calls
``close()`` to flush the sinks and stop the status server.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from trpo_torch.obs.events import (
    ConsoleSink,
    EventBus,
    JsonlSink,
    manifest_fields,
)
from trpo_torch.obs.health import HealthConfig, HealthMonitor
from trpo_torch.obs.recompile import RecompileMonitor

__all__ = ["Telemetry"]


class Telemetry:
    def __init__(
        self,
        events_jsonl: Optional[str] = None,
        health_checks: bool = False,
        recompile_monitor: bool = True,
        profile_dir: Optional[str] = None,
        profile_iteration: Optional[int] = None,
        health_config: Optional[HealthConfig] = None,
        status_port: Optional[int] = None,
        memory_accounting: bool = False,
        sinks=(),
    ):
        bus_sinks = list(sinks)
        if events_jsonl:
            bus_sinks.append(JsonlSink(events_jsonl))
        if health_checks:
            # findings must be visible even without a JSONL file
            bus_sinks.append(ConsoleSink(kinds=("health", "recompile")))
        elif memory_accounting and not events_jsonl and not sinks:
            # the leak finding must not vanish into a sinkless bus
            bus_sinks.append(ConsoleSink(kinds=("health",)))
        self.status = None
        self.status_server = None
        if status_port is not None:
            from trpo_torch.obs.server import StatusSink

            # the sink sees every record from the manifest on
            self.status = StatusSink()
            bus_sinks.append(self.status)
        self.bus = EventBus(*bus_sinks)
        self.health = (HealthMonitor(bus=self.bus, config=health_config)
                       if health_checks else None)
        self.memory = None
        if memory_accounting:
            from trpo_torch.obs.memory import MemoryMonitor

            # the leak rule lives in a HealthMonitor: the --health-checks
            # one when present, a private one otherwise
            self.memory = MemoryMonitor(
                bus=self.bus,
                health=self.health
                or HealthMonitor(bus=self.bus, config=health_config))
        if self.status is not None:
            from trpo_torch.obs.server import StatusServer

            self.status_server = StatusServer(self.status, status_port)
        self.recompile = (RecompileMonitor(bus=self.bus)
                          if recompile_monitor else None)
        self.profile_dir = profile_dir
        self.profile_iteration = profile_iteration
        self.profile_traces: list = []   # Chrome trace files written
        self._profiler = None
        self._profiled = False
        self._device = None
        self._timer = None
        self._closed = False

    # -- run lifecycle -----------------------------------------------------

    def start_run(self, config: Any = None, device=None, **extra) -> None:
        """Emit the manifest (and the ``status`` announcement), start the
        recompile monitor; without ``profile_iteration`` a ``profile_dir``
        run is traced from here to :meth:`finish_run`."""
        self._device = torch.device(device) if device is not None else None
        if self.memory is not None:
            self.memory.device = self._device
        self.bus.emit("run_manifest",
                      **manifest_fields(config, extra, device=device))
        if self.status_server is not None:
            self.bus.emit(
                "status",
                port=self.status_server.port,
                url=self.status_server.url,
                endpoints=list(self.status_server.ENDPOINTS),
            )
        if self.recompile is not None:
            self.recompile.start()
        if self.profile_dir is not None and self.profile_iteration is None:
            self._start_profile()

    def mark_steady(self) -> None:
        if self.recompile is not None:
            self.recompile.mark_steady()

    def attach_timer(self, timer) -> None:
        """The driver's PhaseTimer, so the live snapshot carries per-phase
        timings during the run (``summary()`` is lock-protected)."""
        self._timer = timer

    def on_iteration(self, iteration: int, stats: dict) -> None:
        """Health rules and memory gauges on one row. Iteration events
        come from ``StatsLogger`` (it re-emits through the bus), so this
        hook never emits them twice."""
        if self.health is not None:
            self.health.observe_iteration(iteration, stats)
        if self.memory is not None:
            self.memory.on_iteration(iteration)
        if self.status is not None and self._timer is not None:
            self.status.set_phases(self._timer.summary())

    def observe_drain(self, depth: int, high_water: int,
                      maxsize: int) -> None:
        if self.health is not None:
            self.health.observe_drain(depth, high_water, maxsize)
        if self.status is not None:
            self.status.set_gauges(depth=depth, high_water=high_water,
                                   maxsize=maxsize)

    # -- the profiler window -----------------------------------------------

    def profile_tick(self, next_iteration: int, span: int = 1) -> None:
        """Called before each chunk with the absolute 1-based iteration
        about to run and the chunk's length: opens the profiler when the
        chunk contains ``profile_iteration``, closes it (and writes the
        trace) once the window has passed. A target already behind the
        run (a resume past N) captures the first chunk."""
        if self.profile_dir is None or self.profile_iteration is None:
            return
        if (self._profiler is None and not self._profiled
                and next_iteration + span > self.profile_iteration):
            self._start_profile()
        elif (self._profiler is not None
              and next_iteration > self.profile_iteration):
            self._stop_profile()

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = (self._device.type == "cuda" if self._device is not None
                else torch.cuda.is_available())
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.__enter__()

    def _stop_profile(self) -> None:
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        self._profiled = True
        prof.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        tag = (f"iter{self.profile_iteration}"
               if self.profile_iteration is not None else "run")
        path = os.path.join(self.profile_dir,
                            f"trace_{tag}_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        self.profile_traces.append(path)

    # -- teardown ----------------------------------------------------------

    def finish_run(self, timer=None) -> None:
        """End-of-``learn`` hook (in its ``finally``): close an open
        profile window, emit the PhaseTimer's summaries as ``phase``
        events, mark the status snapshot finished, stop the recompile
        monitor (a later build or capture — a greedy eval, a server — is
        not the run's). Safe to call more than once."""
        self._stop_profile()
        if timer is not None:
            for name, row in timer.summary().items():
                self.bus.emit("phase", name=name, ms=row["mean_ms"],
                              calls=row["calls"], total_s=row["total_s"])
        if self.status is not None:
            self.status.mark_finished()
        if self.recompile is not None:
            self.recompile.stop()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.finish_run()
        if self.status_server is not None:
            self.status_server.close()
        self.bus.close()
