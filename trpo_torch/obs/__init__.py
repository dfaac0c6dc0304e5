"""Telemetry and run introspection (counterpart: ``trpo_tpu/obs/``): the
run-event bus (``events``), request tracing (``trace``), the solver
counters carried in ``TrainState`` (``device_metrics``), the health,
recompile and memory monitors, the live status endpoint (``server``),
the ``Telemetry`` bundle that ``agent.learn`` drives, and the offline and
live analysis plane: request capture (``capture``), replay bundles
(``replay``), cross-run analysis (``analyze``), scrape aggregation
(``aggregate``) and SLO alerting (``alerts``)."""

from trpo_torch.obs.aggregate import (  # noqa: F401
    CallbackTarget,
    HttpTarget,
    JournalTarget,
    MetricsAggregator,
    Series,
)
from trpo_torch.obs.alerts import (  # noqa: F401
    FAULT_ALERT_RULES,
    AlertEngine,
    Rule,
    default_rules,
)
from trpo_torch.obs.capture import (  # noqa: F401
    RequestCapture,
    capture_records,
    decode_payload,
    encode_obs_payload,
)

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
from trpo_torch.obs.replay import (  # noqa: F401
    BUNDLE_VERSION,
    BundleError,
    action_match,
    build_bundle,
    load_bundle,
    scan_journals,
    write_bundle,
)
from trpo_torch.obs.server import (  # noqa: F401
    StatusServer,
    StatusSink,
    render_prometheus,
)
from trpo_torch.obs.telemetry import Telemetry  # noqa: F401
from trpo_torch.obs.trace import Tracer  # noqa: F401

__all__ = [
    "CallbackTarget", "HttpTarget", "JournalTarget", "MetricsAggregator",
    "Series", "FAULT_ALERT_RULES", "AlertEngine", "Rule", "default_rules",
    "RequestCapture", "capture_records", "decode_payload",
    "encode_obs_payload", "BUNDLE_VERSION", "BundleError", "action_match",
    "build_bundle", "load_bundle", "scan_journals", "write_bundle",
    "DeviceMetrics", "accumulate_update", "init_device_metrics",
    "metrics_stats", "EVENT_KINDS", "SCHEMA_VERSION", "ConsoleSink",
    "EventBus", "JsonlSink", "manifest_fields", "validate_event",
    "HealthConfig", "HealthMonitor", "MemoryMonitor", "live_memory_gauges",
    "program_memory_analysis", "RecompileMonitor", "StatusServer",
    "StatusSink", "render_prometheus", "Telemetry", "Tracer",
]
