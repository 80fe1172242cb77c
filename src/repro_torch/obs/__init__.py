"""Observability of the port: the process-wide metric registry
(:mod:`.metrics`), nestable spans written as per-process JSONL
(:mod:`.trace`) and the Prometheus and bench-JSON exporters
(:mod:`.export`), each an own copy of the reference's module.  The rest
of ``repro.obs`` (health, anomaly, flight recorder, provenance, costs,
the HTTP endpoint and the Perfetto export) is not ported yet.

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
]
