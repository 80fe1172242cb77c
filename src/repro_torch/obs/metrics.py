"""Process-wide metric registry: counters, gauges, bucketed histograms.

Own copy of ``repro.obs.metrics``, whole.

The signal plane every subsystem (fleet, search engines, serving) records
into.  Stdlib-only by design — fleet workers import this before jax and a
bare image can always read a snapshot.  Three metric kinds:

* :class:`Counter` — monotone float; merged across processes by summing.
* :class:`Gauge`   — last-written value (queue depth, backoff level).
* :class:`Histogram` — fixed cumulative buckets *plus* a bounded sample
  reservoir.  While fewer than ``max_samples`` observations have been
  recorded the quantiles are **exact** (numpy-``percentile``-compatible
  linear interpolation over the raw samples); after the reservoir wraps
  they degrade gracefully to bucket interpolation.  Bucket counts are
  always exact, so merged snapshots never lie about distribution mass.

A :class:`MetricRegistry` keys metrics by ``(kind, name, labels)``;
``snapshot()`` emits a plain JSON-able document and ``merge()`` folds a
snapshot from another process back in — the fleet's file-per-process
trace layout carries one snapshot per worker and the reader merges them.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Iterable, Mapping

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "DEFAULT_BUCKETS",
    "LATENCY_MS_BUCKETS",
    "get_registry",
    "set_registry",
]

# generic magnitude ladder (seconds-ish quantities)
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)
# decode-step latency in milliseconds (sub-ms reduced CPU models up to
# multi-second pathological steps)
LATENCY_MS_BUCKETS: tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0,
)

QUANTILES = (0.5, 0.95, 0.99)   # the p50/p95/p99 every exporter reports


def _labels_key(labels: Mapping[str, object]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotone accumulator (float so second-counters work too)."""

    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increments are non-negative, got {n}")
        self.value += float(n)

    def to_doc(self) -> dict:
        return {"value": self.value}

    def merge_doc(self, doc: dict) -> None:
        self.value += float(doc["value"])


class Gauge:
    """Last-written value."""

    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += float(n)

    def to_doc(self) -> dict:
        return {"value": self.value}

    def merge_doc(self, doc: dict) -> None:
        # cross-process merge has no write order; "most extreme" is the
        # useful aggregate for the gauges we keep (queue depth, backoff)
        self.value = max(self.value, float(doc["value"]))


class Histogram:
    """Fixed cumulative buckets + a bounded reservoir for exact quantiles.

    ``counts[i]`` is the number of observations ``<= buckets[i]``
    (non-cumulative storage; exporters cumulate), with one overflow slot.
    """

    kind = "histogram"

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS,
                 max_samples: int = 4096) -> None:
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: deque[float] = deque(maxlen=int(max_samples))

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._samples.append(v)
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def exact(self) -> bool:
        """Quantiles are exact while the reservoir holds every sample."""
        return self.count == len(self._samples)

    def quantile(self, q: float) -> float | None:
        """numpy-``percentile``-compatible (linear interpolation) while the
        reservoir is complete; bucket-interpolated once it has wrapped."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return None
        if self._samples and self.exact:
            xs = sorted(self._samples)
            rank = q * (len(xs) - 1)
            lo = int(math.floor(rank))
            hi = min(lo + 1, len(xs) - 1)
            return xs[lo] + (rank - lo) * (xs[hi] - xs[lo])
        # bucket interpolation: walk the cumulative counts to the target
        # rank, interpolate linearly inside the crossing bucket
        target = q * self.count
        cum = 0
        lo_bound = self.min
        for i, c in enumerate(self.counts):
            hi_bound = (self.buckets[i] if i < len(self.buckets) else self.max)
            if c and cum + c >= target:
                frac = (target - cum) / c
                return min(max(lo_bound + frac * (hi_bound - lo_bound),
                               self.min), self.max)
            cum += c
            if c:
                lo_bound = hi_bound
        return self.max

    def percentiles(self) -> dict:
        return {f"p{int(q * 100)}": self.quantile(q) for q in QUANTILES}

    def to_doc(self) -> dict:
        return {
            "buckets": list(self.buckets),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
            "min": None if self.count == 0 else self.min,
            "max": None if self.count == 0 else self.max,
            "samples": [float(s) for s in self._samples],
        }

    def merge_doc(self, doc: dict) -> None:
        if tuple(doc["buckets"]) != self.buckets:
            raise ValueError(
                f"cannot merge histograms with different buckets: "
                f"{tuple(doc['buckets'])} vs {self.buckets}")
        for i, c in enumerate(doc["counts"]):
            self.counts[i] += int(c)
        self.count += int(doc["count"])
        self.sum += float(doc["sum"])
        if doc.get("min") is not None:
            self.min = min(self.min, float(doc["min"]))
        if doc.get("max") is not None:
            self.max = max(self.max, float(doc["max"]))
        for s in doc.get("samples", ()):
            self._samples.append(float(s))


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricRegistry:
    """All of one process's metrics, keyed by ``(name, labels)``.

    Thread-safe for creation (the serving loop and a watcher thread may
    race a first ``counter()`` call); individual metric updates are plain
    float ops under the GIL.
    """

    def __init__(self) -> None:
        self._metrics: dict[tuple[str, tuple], object] = {}
        self._kinds: dict[str, str] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str, labels: Mapping[str, object],
             factory):
        key = (name, _labels_key(labels))
        with self._lock:
            known = self._kinds.get(name)
            if known is not None and known != kind:
                raise TypeError(
                    f"metric {name!r} is a {known}, not a {kind}")
            m = self._metrics.get(key)
            if m is None:
                m = factory()
                self._metrics[key] = m
                self._kinds[name] = kind
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, buckets: Iterable[float] | None = None,
                  **labels) -> Histogram:
        return self._get(
            "histogram", name, labels,
            lambda: Histogram(DEFAULT_BUCKETS if buckets is None else buckets))

    # ------------------------------------------------------------------ views
    def entries(self) -> list[tuple[str, dict, object]]:
        """``(name, labels-dict, metric)`` rows, deterministically ordered."""
        with self._lock:
            items = sorted(self._metrics.items())
        return [(name, dict(labels), m) for (name, labels), m in items]

    def find(self, name: str, **labels) -> object | None:
        """The metric at exactly ``(name, labels)``, or ``None``."""
        with self._lock:
            return self._metrics.get((name, _labels_key(labels)))

    def with_name(self, name: str) -> list[tuple[dict, object]]:
        """Every labeled instance of one metric family."""
        return [(labels, m) for n, labels, m in self.entries() if n == name]

    def snapshot(self) -> dict:
        """JSON-able document: the cross-process interchange format."""
        return {
            "metrics": [
                {"name": name, "kind": m.kind, "labels": labels,
                 **m.to_doc()}
                for name, labels, m in self.entries()
            ],
        }

    def merge(self, snapshot: dict) -> None:
        """Fold another process's :meth:`snapshot` into this registry."""
        for row in snapshot.get("metrics", ()):
            kind, name, labels = row["kind"], row["name"], row["labels"]
            if kind not in _KINDS:
                raise ValueError(f"unknown metric kind {kind!r} in snapshot")
            if kind == "histogram":
                m = self.histogram(name, buckets=row["buckets"], **labels)
            else:
                m = self._get(kind, name, labels, _KINDS[kind])
            m.merge_doc(row)

    @classmethod
    def from_snapshots(cls, snapshots: Iterable[dict]) -> "MetricRegistry":
        reg = cls()
        for snap in snapshots:
            reg.merge(snap)
        return reg


# the process-wide default registry subsystems record into unless handed
# an explicit one (Telemetry keeps its own so concurrent serves and tests
# never cross-contaminate counters)
_REGISTRY = MetricRegistry()


def get_registry() -> MetricRegistry:
    return _REGISTRY


def set_registry(registry: MetricRegistry) -> MetricRegistry:
    """Swap the process-wide registry (tests); returns the previous one."""
    global _REGISTRY
    prev, _REGISTRY = _REGISTRY, registry
    return prev
