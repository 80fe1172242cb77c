"""Exporters: Prometheus text format and atomic bench-JSON views.

Own copy of ``repro.obs.export``, whole.

The bench JSONs CI tracks (``BENCH_serve/kernels/qos.json``) are *views
over the metric registry*, not hand-assembled dicts: a subsystem records
into its :class:`~repro_torch.obs.metrics.MetricRegistry` and the exporter
renders whatever is there.  Everything lands on disk through the same
``os.replace`` discipline as the operator store, so a crash mid-serve
never leaves a truncated artifact.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

from .metrics import Counter, Gauge, Histogram, MetricRegistry
from .trace import atomic_write_json

__all__ = [
    "prometheus_text",
    "write_bench_json",
    "dump_metrics",
    "read_metrics",
    "METRICS_GLOB",
]

METRICS_GLOB = "metrics-*.json"   # per-process snapshots inside a trace dir

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _NAME_OK.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


def _prom_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{_prom_label_value(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def prometheus_text(registry: MetricRegistry) -> str:
    """Render a registry in the Prometheus exposition text format.

    Counters render as ``<name>_total``, histograms as the conventional
    cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count`` triplet.
    """
    by_family: dict[str, list] = {}
    kinds: dict[str, str] = {}
    for name, labels, metric in registry.entries():
        by_family.setdefault(name, []).append((labels, metric))
        kinds[name] = metric.kind

    lines: list[str] = []
    for name in sorted(by_family):
        kind = kinds[name]
        pname = _prom_name(name)
        if kind == "counter":
            pname += "_total"
        lines.append(f"# TYPE {pname} {kind}")
        for labels, metric in by_family[name]:
            if isinstance(metric, (Counter, Gauge)):
                lines.append(f"{pname}{_prom_labels(labels)} "
                             f"{metric.value:g}")
            elif isinstance(metric, Histogram):
                cum = 0
                for i, bound in enumerate(metric.buckets):
                    cum += metric.counts[i]
                    lines.append(
                        f"{pname}_bucket"
                        f"{_prom_labels(labels, {'le': f'{bound:g}'})} {cum}")
                lines.append(
                    f"{pname}_bucket"
                    f"{_prom_labels(labels, {'le': '+Inf'})} {metric.count}")
                lines.append(f"{pname}_sum{_prom_labels(labels)} "
                             f"{metric.sum:g}")
                lines.append(f"{pname}_count{_prom_labels(labels)} "
                             f"{metric.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_bench_json(path: str | os.PathLike, doc: dict) -> None:
    """Write one bench/telemetry JSON document atomically, creating parent
    directories — the one way any CI-tracked JSON reaches disk."""
    atomic_write_json(Path(path), doc)


# ---------------------------------------------------------------------------
# metric snapshots inside a trace dir (file per process, merged at read)
# ---------------------------------------------------------------------------
def dump_metrics(trace_dir: str | os.PathLike, registry: MetricRegistry,
                 *, tag: str | None = None) -> Path:
    """Snapshot ``registry`` into ``<trace_dir>/metrics-<tag>.json``
    (atomic).  Same file-per-process layout as the span files; the obs
    CLI merges every snapshot it finds."""
    if tag is None:
        import socket

        tag = f"{socket.gethostname()}-{os.getpid()}"
    path = Path(trace_dir) / f"metrics-{tag}.json"
    atomic_write_json(path, registry.snapshot())
    return path


def read_metrics(trace_dir: str | os.PathLike) -> MetricRegistry:
    """Merge every per-process metric snapshot under a trace dir."""
    import json

    reg = MetricRegistry()
    for path in sorted(Path(trace_dir).glob(METRICS_GLOB)):
        try:
            reg.merge(json.loads(path.read_text()))
        except json.JSONDecodeError:
            continue   # torn writer; snapshots are atomic so only possible
            #            for files produced by foreign tools
    return reg
