"""Streaming anomaly detection with control-event attribution.

The metric plane (:mod:`.metrics`) records what happened; this module
notices when what happened *changed* — and names the control action
that changed it.
Two pieces:

* :class:`RobustDetector` — one signal's streaming detector: an EWMA of
  the raw samples is scored against a robust baseline (median + MAD over
  a bounded window of *prior* samples).  Robust statistics mean a single
  spike cannot drag the baseline toward itself the way a mean/stddev
  z-score would, so steps, spikes and ramps all register while seeded
  steady noise does not (``tests/test_health.py`` runs 10k noisy steps
  with zero false fires).  After a fire the detector **re-baselines**
  (window reseeded at the new regime) and holds a short refractory
  cooldown, so one step change is one anomaly, not one per step.
* :class:`EventLog` / :class:`AnomalyPlane` — attribution.  The serving
  engine notes every control action (``serve.swap``, ``serve.refresh``,
  ``serve.control``, ``serve.preempt``, ``serve.resume``) into a
  bounded event ring; when a
  detector fires, the anomaly is pinned to the nearest *prior* event
  within an attribution horizon — "ms/step stepped +4σ, 2 steps after
  swap 3f2a→91cc (event 8c11…)" instead of just "latency went up".

Everything is stdlib-only and O(window) per observation, so the health
plane stays inside the serve smoke's ≤2% ms/step overhead gate.  The
detector keeps a sorted copy of its window beside it, so the median and
the MAD cost a binary search, where two ``statistics.median`` calls
sorted the window twice; both give ``statistics.median``'s numbers bit
for bit.

Own copy of ``repro.obs.anomaly``, whole.
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics
from collections import deque
from dataclasses import dataclass, field

__all__ = [
    "Anomaly",
    "ControlEvent",
    "EventLog",
    "RobustDetector",
    "AnomalyPlane",
    "robust_zscores",
]

# MAD -> sigma consistency constant for the normal distribution
MAD_SIGMA = 1.4826


def robust_zscores(values) -> list[float]:
    """Batch robust z-scores (median/MAD) for a list of samples — the
    fleet's job-wall-time outlier flagging uses this offline form.  A
    zero MAD (over half the samples identical) scores exact-median
    samples 0 and everything else ``inf``-like via a tiny floor."""
    xs = [float(v) for v in values]
    if len(xs) < 2:
        return [0.0 for _ in xs]
    med = statistics.median(xs)
    mad = statistics.median(abs(x - med) for x in xs)
    scale = max(MAD_SIGMA * mad, 1e-12)
    return [(x - med) / scale for x in xs]


@dataclass(frozen=True)
class ControlEvent:
    """One noted control-plane action (swap/refresh/control/preempt)."""

    step: int
    name: str
    event_id: str = ""        # trace span id when tracing is configured
    attrs: dict = field(default_factory=dict)

    def describe(self) -> str:
        inner = " ".join(f"{k}={self.attrs[k]}" for k in sorted(self.attrs))
        return (f"{self.name}@{self.step}"
                + (f" [{self.event_id}]" if self.event_id else "")
                + (f" ({inner})" if inner else ""))


class EventLog:
    """Bounded ring of recent control events, queried by anomaly step."""

    def __init__(self, capacity: int = 256) -> None:
        self._ring: deque[ControlEvent] = deque(maxlen=int(capacity))

    def note(self, name: str, step: int, event_id: str = "",
             **attrs) -> ControlEvent:
        ev = ControlEvent(step=int(step), name=name,
                          event_id=event_id or "", attrs=dict(attrs))
        self._ring.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self._ring)

    def events(self) -> list[ControlEvent]:
        return list(self._ring)

    def nearest(self, step: int, *, horizon: int = 64) -> ControlEvent | None:
        """The most recent event at or before ``step`` within ``horizon``
        observations — the action an anomaly at ``step`` is pinned to.
        Detection lags the cause (EWMA smoothing, consecutive-sample
        confirmation), so "nearest prior" is the right direction."""
        best = None
        for ev in self._ring:
            if ev.step <= step and step - ev.step <= horizon:
                if best is None or ev.step >= best.step:
                    best = ev
        return best


@dataclass(frozen=True)
class Anomaly:
    """One fired detection, with its attribution (or lack of one)."""

    signal: str
    step: int
    value: float            # EWMA-smoothed statistic that crossed
    zscore: float
    baseline: float         # window median at fire time
    direction: str          # "up" | "down"
    cause: ControlEvent | None = None

    def to_doc(self) -> dict:
        doc = {
            "signal": self.signal,
            "step": self.step,
            "value": round(self.value, 6),
            "zscore": round(self.zscore, 3),
            "baseline": round(self.baseline, 6),
            "direction": self.direction,
        }
        if self.cause is not None:
            doc["cause"] = {
                "event": self.cause.name,
                "step": self.cause.step,
                "event_id": self.cause.event_id,
                "attrs": self.cause.attrs,
                "distance": self.step - self.cause.step,
            }
        return doc

    def describe(self) -> str:
        return (f"{self.signal}@{self.step}: {self.direction} to "
                f"{self.value:.4g} (baseline {self.baseline:.4g}, "
                f"z={self.zscore:+.1f})"
                + (f" <- {self.cause.describe()}"
                   if self.cause is not None else " <- no recent event"))


def _median_sorted(data: list[float]) -> float:
    """``statistics.median`` of an ascending list: the middle value, or
    the mean of the two middle values for an even count."""
    n = len(data)
    if n % 2 == 1:
        return data[n // 2]
    i = n // 2
    return (data[i - 1] + data[i]) / 2


def _mad_sorted(data: list[float], med: float) -> float:
    """``statistics.median(abs(b - med) for b in data)`` for an ascending
    ``data``, without sorting the deviations.

    The deviations of the values below ``med``, read from ``med``
    outward, ascend (``abs(b - med)`` is ``med - b`` exactly there), and
    so do those of the rest: the sorted deviations are the merge of two
    ascending runs.  A binary search finds how many of the ``n // 2``
    smallest come from the lower run (the least count whose next lower
    deviation is no smaller than the last upper one taken); the middle
    values are then the largest of those taken and the smallest of the
    others."""
    n = len(data)
    j = bisect.bisect_left(data, med)   # data[:j] < med <= data[j:]
    m = n - j
    i = n // 2
    lo, hi = max(0, i - m), min(i, j)
    while lo < hi:
        a = (lo + hi) // 2
        if data[j + i - a - 1] - med <= med - data[j - 1 - a]:
            hi = a
        else:
            lo = a + 1
    a = lo
    inf = float("inf")
    upper = min(med - data[j - 1 - a] if a < j else inf,
                data[j + i - a] - med if i - a < m else inf)
    if n % 2 == 1:
        return upper
    lower = max(med - data[j - a] if a > 0 else -inf,
                data[j + i - a - 1] - med if i - a > 0 else -inf)
    return (lower + upper) / 2


class RobustDetector:
    """Streaming EWMA + median/MAD robust z-score detector for one signal.

    Per observation: the raw sample folds into an EWMA; the EWMA is
    scored as ``(ewma - median(window)) / (1.4826 * MAD(window))`` where
    the window holds the last ``window`` EWMA values from *before* the
    current observation — the statistic under test never contaminates
    its own baseline.  A fire needs ``|z| >= threshold`` (after
    ``warmup`` baseline samples); it then re-baselines the window at the
    current regime and holds ``cooldown`` refractory observations, so a
    sustained shift yields exactly one anomaly.

    ``min_scale`` floors the MAD so a perfectly constant baseline (MAD 0)
    still scores a departure as a finite, fire-able z.
    """

    def __init__(self, signal: str, *, window: int = 64, warmup: int = 12,
                 threshold: float = 6.0, alpha: float = 0.35,
                 cooldown: int | None = None,
                 min_scale: float = 1e-9) -> None:
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha {alpha} outside (0, 1]")
        if warmup < 2 or window < warmup:
            raise ValueError(
                f"need window >= warmup >= 2 (got {window}/{warmup})")
        self.signal = signal
        self.window = int(window)
        self.warmup = int(warmup)
        self.threshold = float(threshold)
        self.alpha = float(alpha)
        self.cooldown = self.warmup if cooldown is None else int(cooldown)
        self.min_scale = float(min_scale)
        self._baseline: deque[float] = deque(maxlen=self.window)
        self._sorted: list[float] = []   # the window's values, ascending
        self._ewma: float | None = None
        self._refractory = 0
        self.fired = 0

    def _push(self, x: float) -> None:
        """Append ``x`` to the window, and keep its sorted copy in step:
        the value a full deque evicts leaves the copy too."""
        if len(self._baseline) == self.window:
            old = self._baseline[0]
            del self._sorted[bisect.bisect_left(self._sorted, old)]
        self._baseline.append(x)
        bisect.insort(self._sorted, x)

    def _restart(self, x: float) -> None:
        self._baseline.clear()
        self._baseline.append(x)
        self._sorted[:] = [x]

    def _score(self, x: float) -> tuple[float, float]:
        med = _median_sorted(self._sorted)
        mad = _mad_sorted(self._sorted, med)
        scale = max(MAD_SIGMA * mad, self.min_scale)
        return (x - med) / scale, med

    def observe(self, value: float, step: int) -> Anomaly | None:
        """Feed one sample; returns the :class:`Anomaly` on a fire."""
        v = float(value)
        self._ewma = (v if self._ewma is None
                      else self.alpha * v + (1 - self.alpha) * self._ewma)
        x = self._ewma
        if self._refractory > 0:
            self._refractory -= 1
            self._push(x)
            return None
        if len(self._baseline) < self.warmup:
            self._push(x)
            return None
        z, med = self._score(x)
        if abs(z) < self.threshold:
            self._push(x)
            return None
        # fire, then re-baseline at the new regime: the window restarts
        # from the post-change level so a sustained step is one anomaly
        # and the *next* change is judged against the new normal
        self.fired += 1
        self._restart(x)
        self._refractory = self.cooldown
        return Anomaly(signal=self.signal, step=int(step), value=x,
                       zscore=z, baseline=med,
                       direction="up" if z > 0 else "down")


class AnomalyPlane:
    """All of one engine's detectors plus the shared attribution log.

    ``observe(signal, value, step)`` lazily creates a detector per signal
    (overrides per signal via ``configs``), attributes any fire to the
    nearest prior control event, and keeps a bounded list of fired
    anomalies for post-mortems/reports.
    """

    DEFAULTS = dict(window=64, warmup=12, threshold=6.0, alpha=0.35)

    def __init__(self, *, configs: dict[str, dict] | None = None,
                 horizon: int = 64, capacity: int = 256,
                 event_capacity: int = 256) -> None:
        self._configs = dict(configs or {})
        self.horizon = int(horizon)
        self.events = EventLog(capacity=event_capacity)
        self.detectors: dict[str, RobustDetector] = {}
        self.anomalies: deque[Anomaly] = deque(maxlen=int(capacity))

    def note_event(self, name: str, step: int, event_id: str = "",
                   **attrs) -> ControlEvent:
        return self.events.note(name, step, event_id, **attrs)

    def detector(self, signal: str) -> RobustDetector:
        det = self.detectors.get(signal)
        if det is None:
            cfg = {**self.DEFAULTS, **self._configs.get(signal, {})}
            det = self.detectors[signal] = RobustDetector(signal, **cfg)
        return det

    def observe(self, signal: str, value: float, step: int) -> Anomaly | None:
        fired = self.detector(signal).observe(value, step)
        if fired is None:
            return None
        fired = dataclasses.replace(
            fired, cause=self.events.nearest(fired.step,
                                             horizon=self.horizon))
        self.anomalies.append(fired)
        return fired

    @property
    def fired_total(self) -> int:
        return sum(d.fired for d in self.detectors.values())

    def to_doc(self) -> dict:
        return {
            "fired_total": self.fired_total,
            "by_signal": {s: d.fired for s, d in self.detectors.items()},
            "anomalies": [a.to_doc() for a in self.anomalies],
        }
