"""Observability of the port: the process-wide metric registry
(:mod:`.metrics`), nestable spans written as per-process JSONL
(:mod:`.trace`), the Prometheus and bench-JSON exporters (:mod:`.export`),
the SLO health plane (:mod:`.health` over :mod:`.anomaly` and the flight
recorder :mod:`.flight`), request lifecycles (:mod:`.requests`), the
approximation-provenance ledger (:mod:`.provenance`) and the cost plane
over it (:mod:`.costs`), the bench regression sentinel (:mod:`.regress`),
the live ``/metrics``, ``/healthz`` and ``/costs.json`` endpoint
(:mod:`.httpd`), the Chrome trace-event export (:mod:`.perfetto`) and
the inspector ``python -m repro_torch.obs``, each an own copy of the
reference's module.

Stdlib-only: importable before torch or numpy enter the process.
"""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    get_registry,
    set_registry,
)
from .trace import (
    TRACE_DIR_ENV,
    Tracer,
    configure,
    current_tracer,
    event,
    read_trace,
    span,
    tracing_enabled,
)
from .export import (
    dump_metrics,
    prometheus_text,
    read_metrics,
    write_bench_json,
)
from .anomaly import (
    Anomaly,
    AnomalyPlane,
    ControlEvent,
    EventLog,
    RobustDetector,
    robust_zscores,
)
from .health import (
    BurnRate,
    HealthPlane,
    SLOMonitor,
    state_penalty,
    state_rank,
)
from .flight import FlightRecorder, read_postmortems
from .regress import Rule, compare_bench, flatten, load_rules
from .provenance import ProvenanceLedger, audit, ledger_for, read_ledger
from .requests import BREAKDOWN_KEYS, RequestTimeline, build_timelines, critical_path
from .costs import cost_report, mlp_macs_per_layer, plan_cost_row
from .httpd import MetricsServer
from .perfetto import chrome_trace, export_chrome

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "get_registry",
    "set_registry",
    "TRACE_DIR_ENV",
    "Tracer",
    "configure",
    "current_tracer",
    "event",
    "read_trace",
    "span",
    "tracing_enabled",
    "dump_metrics",
    "prometheus_text",
    "read_metrics",
    "write_bench_json",
    "Anomaly",
    "AnomalyPlane",
    "ControlEvent",
    "EventLog",
    "RobustDetector",
    "robust_zscores",
    "BurnRate",
    "HealthPlane",
    "SLOMonitor",
    "state_penalty",
    "state_rank",
    "FlightRecorder",
    "read_postmortems",
    "Rule",
    "compare_bench",
    "flatten",
    "load_rules",
    "ProvenanceLedger",
    "audit",
    "ledger_for",
    "read_ledger",
    "BREAKDOWN_KEYS",
    "RequestTimeline",
    "build_timelines",
    "critical_path",
    "cost_report",
    "mlp_macs_per_layer",
    "plan_cost_row",
    "MetricsServer",
    "chrome_trace",
    "export_chrome",
]
