"""Telemetry and run introspection (counterpart: ``trpo_tpu/obs/``): the
run-event bus (``events``), request tracing (``trace``), the solver
counters carried in ``TrainState`` (``device_metrics``), the health,
recompile and memory monitors, the live status endpoint (``server``) and
the ``Telemetry`` bundle that ``agent.learn`` drives."""

from trpo_torch.obs.device_metrics import (  # noqa: F401
    DeviceMetrics,
    accumulate_update,
    init_device_metrics,
    metrics_stats,
)
from trpo_torch.obs.events import (  # noqa: F401
    EVENT_KINDS,
    SCHEMA_VERSION,
    ConsoleSink,
    EventBus,
    JsonlSink,
    manifest_fields,
    validate_event,
)
from trpo_torch.obs.health import HealthConfig, HealthMonitor  # noqa: F401
from trpo_torch.obs.memory import (  # noqa: F401
    MemoryMonitor,
    live_memory_gauges,
    program_memory_analysis,
)
from trpo_torch.obs.recompile import RecompileMonitor  # noqa: F401
from trpo_torch.obs.server import (  # noqa: F401
    StatusServer,
    StatusSink,
    render_prometheus,
)
from trpo_torch.obs.telemetry import Telemetry  # noqa: F401
from trpo_torch.obs.trace import Tracer  # noqa: F401

__all__ = [
    "DeviceMetrics", "accumulate_update", "init_device_metrics",
    "metrics_stats", "EVENT_KINDS", "SCHEMA_VERSION", "ConsoleSink",
    "EventBus", "JsonlSink", "manifest_fields", "validate_event",
    "HealthConfig", "HealthMonitor", "MemoryMonitor", "live_memory_gauges",
    "program_memory_analysis", "RecompileMonitor", "StatusServer",
    "StatusSink", "render_prometheus", "Telemetry", "Tracer",
]
