"""Observability of the port: the process-wide metric registry
(:mod:`.metrics`), nestable spans written as per-process JSONL
(:mod:`.trace`), the Prometheus and bench-JSON exporters (:mod:`.export`),
the SLO health plane (:mod:`.health` over :mod:`.anomaly` and the flight
recorder :mod:`.flight`), request lifecycles (:mod:`.requests`), the
approximation-provenance ledger (:mod:`.provenance`) and the cost plane
over it (:mod:`.costs`), each an own copy of the reference's module.  The
rest of ``repro.obs`` (the HTTP endpoint, the Perfetto export, the
regression sentinel and the ``__main__`` inspector) is not ported yet.

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
from .provenance import ProvenanceLedger, audit, ledger_for, read_ledger
from .requests import BREAKDOWN_KEYS, RequestTimeline, build_timelines, critical_path
from .costs import cost_report, mlp_macs_per_layer, plan_cost_row

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
]
