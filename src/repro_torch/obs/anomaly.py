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

Everything is stdlib-only (``statistics.median`` over small windows) and
O(window) per observation, so the health plane stays inside the serve
smoke's ≤2% ms/step overhead gate.

Own copy of ``repro.obs.anomaly``, whole.
"""

from __future__ import annotations

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
        self._ewma: float | None = None
        self._refractory = 0
        self.fired = 0

    def _score(self, x: float) -> tuple[float, float]:
        med = statistics.median(self._baseline)
        mad = statistics.median(abs(b - med) for b in self._baseline)
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
            self._baseline.append(x)
            return None
        if len(self._baseline) < self.warmup:
            self._baseline.append(x)
            return None
        z, med = self._score(x)
        if abs(z) < self.threshold:
            self._baseline.append(x)
            return None
        # fire, then re-baseline at the new regime: the window restarts
        # from the post-change level so a sustained step is one anomaly
        # and the *next* change is judged against the new normal
        self.fired += 1
        self._baseline.clear()
        self._baseline.append(x)
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
