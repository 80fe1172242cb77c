"""SLO health plane: multi-window burn rates, states, and the bundle
that ties monitors + anomaly attribution + flight recorder together.

The serving tier declares per-class contracts (``gold:0.02@8ms`` — a
drift budget and a p95 per-step latency SLO); telemetry and the class
scheduler *measure* against them but nothing *acts*.  This module turns the measurements into
states:

* :class:`BurnRate` — one SLO's multi-window burn-rate monitor, SRE
  style but over **observation counts** instead of wall-clock (serves
  here are synthetic and step-driven; counts make the math exactly
  hand-computable in tests).  ``burn = bad_fraction / budget_fraction``:
  burn 1.0 spends the error budget exactly, burn 3.0 spends it 3× too
  fast.  Paging requires the *short and long* windows to both run hot —
  the short window gives fast detection, the long window refuses to page
  on a blip — and de-escalation needs ``clear_patience`` consecutive
  calm evaluations (hysteresis), so states never flap.
* :class:`SLOMonitor` — per-QoS-class monitors built straight from the
  declared :class:`~repro_torch.sensitivity.classes.ClassBook`: a latency
  monitor per class with an ``slo_ms`` (budget fraction = the implied
  1 - 0.95, since ``slo_ms`` is declared as a p95) and a drift monitor
  per class with a finite drift budget.
* :class:`HealthPlane` — the engine-facing bundle: SLO monitors + the
  :class:`~repro_torch.obs.anomaly.AnomalyPlane` + the
  :class:`~repro_torch.obs.flight.FlightRecorder`, one ``observe_step`` call
  per decode step, ``note_event`` mirrors of the control-plane trace
  events, gauge exports (``health_state``, ``serve_slo_ok{class}``) into
  the metric registry so the Prometheus text carries them, and automatic
  post-mortem dumps on page transitions, fired anomalies, and crashes.

Everything is O(window) integer/float work per step — the serve smoke
gates the whole plane at ≤2% ms/step overhead.

Own copy of ``repro.obs.health``, whole.
"""

from __future__ import annotations

from collections import deque

from .anomaly import AnomalyPlane
from .flight import FlightRecorder
from .metrics import MetricRegistry, get_registry

__all__ = [
    "BurnRate",
    "SLOMonitor",
    "HealthPlane",
    "STATES",
    "state_rank",
    "state_penalty",
]

# severity order; rank comparisons everywhere use this
STATES = ("ok", "warn", "page")
_RANK = {s: i for i, s in enumerate(STATES)}

# routing penalty added to a replica's load score per health state: a
# warn replica looks one queued request busier, a paged replica four —
# enough that the router measurably sheds load without black-holing the
# replica entirely (it still drains what only it can serve)
_PENALTY = {"ok": 0.0, "warn": 1.0, "page": 4.0}


def state_rank(state: str) -> int:
    return _RANK[state]


def state_penalty(state: str) -> float:
    return _PENALTY[state]


def _worst(states) -> str:
    return max(states, key=state_rank, default="ok")


class BurnRate:
    """One SLO's multi-window burn-rate monitor over observation counts.

    Each ``observe(bad)`` folds one boolean into a short and a long
    sliding window.  ``burn = bad_fraction / budget`` per window, where
    ``budget`` is the allowed bad fraction (0.05 for a p95-declared SLO).
    With budget 0.1 and 3 violations in a 10-observation window the
    short burn is exactly 3.0 — tests hand-compute these.

    States: **page** when both windows burn at ``page_burn`` or hotter
    (fast *and* sustained), **warn** when both reach ``warn_burn``, else
    calm.  Escalation is immediate; de-escalation waits for
    ``clear_patience`` consecutive calm(er) evaluations.  Windows
    shorter than ``min_count`` observations never page (cold-start
    guard).
    """

    def __init__(self, *, budget: float, short_window: int = 32,
                 long_window: int = 128, warn_burn: float = 1.0,
                 page_burn: float = 2.0, clear_patience: int = 8,
                 min_count: int = 4) -> None:
        if not 0 < budget <= 1:
            raise ValueError(f"budget fraction {budget} outside (0, 1]")
        if short_window < 1 or long_window < short_window:
            raise ValueError(
                f"need long_window >= short_window >= 1 "
                f"(got {long_window}/{short_window})")
        if page_burn < warn_burn:
            raise ValueError(
                f"page_burn {page_burn} below warn_burn {warn_burn}")
        self.budget = float(budget)
        self.warn_burn = float(warn_burn)
        self.page_burn = float(page_burn)
        self.clear_patience = max(1, int(clear_patience))
        self.min_count = max(1, int(min_count))
        self._short: deque[int] = deque(maxlen=int(short_window))
        self._long: deque[int] = deque(maxlen=int(long_window))
        self.state = "ok"
        self._calm = 0
        self.observations = 0
        self.violations = 0

    def _burn(self, window: deque) -> float:
        if not window:
            return 0.0
        return (sum(window) / len(window)) / self.budget

    @property
    def burn_short(self) -> float:
        return self._burn(self._short)

    @property
    def burn_long(self) -> float:
        return self._burn(self._long)

    def observe(self, bad: bool) -> str:
        """Fold one observation; returns the (possibly new) state."""
        flag = 1 if bad else 0
        self._short.append(flag)
        self._long.append(flag)
        self.observations += 1
        self.violations += flag
        target = self._target()
        if state_rank(target) > state_rank(self.state):
            self.state = target          # escalate immediately
            self._calm = 0
        elif state_rank(target) < state_rank(self.state):
            self._calm += 1              # de-escalate under hysteresis
            if self._calm >= self.clear_patience:
                self.state = target
                self._calm = 0
        else:
            self._calm = 0
        return self.state

    def _target(self) -> str:
        if len(self._short) < self.min_count:
            return "ok"
        s, l = self.burn_short, self.burn_long
        if s >= self.page_burn and l >= self.page_burn:
            return "page"
        if s >= self.warn_burn and l >= self.warn_burn:
            return "warn"
        return "ok"

    def to_doc(self) -> dict:
        return {
            "state": self.state,
            "budget": self.budget,
            "burn_short": round(self.burn_short, 4),
            "burn_long": round(self.burn_long, 4),
            "observations": self.observations,
            "violations": self.violations,
        }


class SLOMonitor:
    """Per-class burn-rate monitors derived from the declared tiers.

    A class with an ``slo_ms`` gets a latency monitor (an observation is
    bad when that step's ms-per-step exceeded the SLO; the budget
    fraction is ``1 - quantile`` for the p95 the spec declares).  A class
    with a finite positive drift budget gets a drift monitor fed only on
    shadow-measured steps (bad = measured drift above budget; drift is a
    mean-style budget so the allowed-overrun fraction is configurable,
    default 20%).
    """

    def __init__(self, book=None, *, quantile: float = 0.95,
                 drift_bad_fraction: float = 0.2,
                 short_window: int = 32, long_window: int = 128,
                 warn_burn: float = 1.0, page_burn: float = 2.0,
                 clear_patience: int = 8, min_count: int = 4) -> None:
        if not 0 < quantile < 1:
            raise ValueError(f"quantile {quantile} outside (0, 1)")
        self._mk = dict(short_window=short_window, long_window=long_window,
                        warn_burn=warn_burn, page_burn=page_burn,
                        clear_patience=clear_patience, min_count=min_count)
        self.latency: dict[str, BurnRate] = {}
        self.drift: dict[str, BurnRate] = {}
        self.slo_ms: dict[str, float] = {}
        self.drift_budget: dict[str, float] = {}
        if book is not None:
            for c in book:
                if c.slo_ms is not None:
                    self.add_latency_slo(c.name, c.slo_ms,
                                         budget=1.0 - quantile)
                if 0 < c.drift_budget < float("inf"):
                    self.add_drift_slo(c.name, c.drift_budget,
                                       budget=drift_bad_fraction)

    def add_latency_slo(self, cls: str, slo_ms: float, *,
                        budget: float) -> None:
        self.slo_ms[cls] = float(slo_ms)
        self.latency[cls] = BurnRate(budget=budget, **self._mk)

    def add_drift_slo(self, cls: str, drift_budget: float, *,
                      budget: float) -> None:
        self.drift_budget[cls] = float(drift_budget)
        self.drift[cls] = BurnRate(budget=budget, **self._mk)

    def __bool__(self) -> bool:
        return bool(self.latency or self.drift)

    # ------------------------------------------------------------------ feed
    def observe_latency(self, cls: str, step_ms: float) -> str | None:
        mon = self.latency.get(cls)
        if mon is None:
            return None
        return mon.observe(float(step_ms) > self.slo_ms[cls])

    def observe_drift(self, cls: str, drift: float) -> str | None:
        mon = self.drift.get(cls)
        if mon is None:
            return None
        return mon.observe(float(drift) > self.drift_budget[cls])

    # ------------------------------------------------------------------ read
    def class_state(self, cls: str) -> str:
        states = []
        if cls in self.latency:
            states.append(self.latency[cls].state)
        if cls in self.drift:
            states.append(self.drift[cls].state)
        return _worst(states)

    @property
    def classes(self) -> list[str]:
        return sorted(set(self.latency) | set(self.drift))

    @property
    def worst_state(self) -> str:
        return _worst(self.class_state(c) for c in self.classes)

    def to_doc(self) -> dict:
        doc = {}
        for cls in self.classes:
            row: dict = {"state": self.class_state(cls)}
            if cls in self.latency:
                row["latency"] = {"slo_ms": self.slo_ms[cls],
                                  **self.latency[cls].to_doc()}
            if cls in self.drift:
                row["drift"] = {"drift_budget": self.drift_budget[cls],
                                **self.drift[cls].to_doc()}
            doc[cls] = row
        return doc


class HealthPlane:
    """One engine's health: SLO monitors + anomaly plane + flight
    recorder, fed once per decode step.

    ``observe_step`` fans one step's telemetry out to every monitor and
    detector, exports the resulting states as registry gauges, records
    the frame into the flight ring, and dumps a post-mortem bundle on a
    page transition or a fired anomaly (crashes dump via
    :meth:`record_crash`).  ``penalty`` is what the replica router adds
    to this engine's load score.
    """

    def __init__(self, book=None, *, registry: MetricRegistry | None = None,
                 postmortem_dir=None, tag: str | None = None,
                 slo: SLOMonitor | None = None,
                 anomaly: AnomalyPlane | None = None,
                 recorder: FlightRecorder | None = None,
                 monitor_config: dict | None = None,
                 anomaly_config: dict | None = None,
                 capacity: int = 512, max_bundles: int = 16) -> None:
        self.registry = registry if registry is not None else get_registry()
        self.slo = slo if slo is not None \
            else SLOMonitor(book, **(monitor_config or {}))
        self.anomaly = anomaly if anomaly is not None \
            else AnomalyPlane(**(anomaly_config or {}))
        self.recorder = recorder if recorder is not None \
            else FlightRecorder(capacity=capacity,
                                postmortem_dir=postmortem_dir, tag=tag,
                                max_bundles=max_bundles)
        self.anomalies_fired = 0
        self.pages = 0
        self._last_states: dict[str, str] = {}
        self._step = 0

    # ----------------------------------------------------------------- events
    def note_event(self, name: str, step: int | None = None,
                   event_id: str = "", **attrs) -> None:
        """Mirror of a control-plane trace event (``serve.swap``,
        ``serve.refresh``, ``serve.control``, ``serve.preempt``,
        ``serve.resume``): feeds anomaly attribution and the flight
        ring.  ``step`` defaults to the last observed step (events
        between steps belong to it)."""
        at = self._step if step is None else int(step)
        self.anomaly.note_event(name, at, event_id, **attrs)
        self.recorder.note("event", name=name, step=at,
                           event_id=event_id, **attrs)

    def set_context(self, **kv) -> None:
        self.recorder.set_context(**kv)

    # ------------------------------------------------------------------- step
    def observe_step(self, *, step: int, step_ms: float,
                     classes: dict | None = None,
                     drift: float | None = None, backlog: int = 0,
                     occupancy: float = 0.0, preemptions: int = 0,
                     plan_id: str | None = None, level: int | None = None,
                     pages: dict | None = None,
                     class_state: dict | None = None) -> dict:
        """Feed one decode step.  ``classes`` maps each *active* class to
        its row (any dict; only membership is used for latency
        attribution — every active class experienced ``step_ms``).
        ``preemptions`` is this step's count (a rate, not a cumulative).
        Returns ``{"state", "transitions", "anomalies", "dumps"}``.
        """
        self._step = int(step)
        transitions: list[dict] = []
        for cls in (classes or {}):
            self.slo.observe_latency(cls, step_ms)
        if drift is not None:
            for cls in (classes or {}):
                self.slo.observe_drift(cls, drift)
        for cls in self.slo.classes:
            now = self.slo.class_state(cls)
            before = self._last_states.get(cls, "ok")
            if now != before:
                transitions.append(
                    {"class": cls, "from": before, "to": now, "step": step})
                self._last_states[cls] = now

        anomalies = []
        for signal, value in (("ms_per_step", step_ms),
                              ("drift", drift),
                              ("preempt_rate", float(preemptions)),
                              ("queue_depth", float(backlog))):
            if value is None:
                continue
            fired = self.anomaly.observe(signal, float(value), step)
            if fired is not None:
                anomalies.append(fired)
        self.anomalies_fired += len(anomalies)

        # export: state gauges ride the registry so the Prometheus text
        # and metric snapshots carry them (satellite: SLO OK/MISS series)
        for cls in self.slo.classes:
            st = self.slo.class_state(cls)
            self.registry.gauge("serve_slo_ok",
                                **{"class": cls}).set(1.0 if st == "ok"
                                                      else 0.0)
            self.registry.gauge("health_state",
                                **{"class": cls}).set(state_rank(st))
        self.registry.gauge("health_anomalies").set(self.anomalies_fired)

        # flight ring: the step frame + current engine shape
        self.recorder.set_context(plan_id=plan_id, level=level,
                                  step=step, pages=pages,
                                  class_state=class_state)
        self.recorder.note("step", step=step, step_ms=round(step_ms, 4),
                           classes=sorted(classes or {}), drift=drift,
                           backlog=backlog,
                           occupancy=round(occupancy, 4),
                           preemptions=preemptions, plan_id=plan_id)
        for a in anomalies:
            self.recorder.note("anomaly", **a.to_doc())
        for t in transitions:
            self.recorder.note("slo", **t)

        dumps = []
        paged = [t for t in transitions if t["to"] == "page"]
        if paged:
            self.pages += len(paged)
            p = self.recorder.dump(
                "slo_breach",
                detail="; ".join(f"{t['class']}: {t['from']}->page"
                                 for t in paged),
                extra={"health": self.report()})
            if p is not None:
                dumps.append(str(p))
        if anomalies:
            p = self.recorder.dump(
                "anomaly",
                detail="; ".join(a.describe() for a in anomalies),
                extra={"health": self.report()})
            if p is not None:
                dumps.append(str(p))
        return {"state": self.worst_state, "transitions": transitions,
                "anomalies": anomalies, "dumps": dumps}

    def record_crash(self, exc: BaseException) -> str | None:
        """Dump the ring on an engine crash; re-raise at the call site."""
        p = self.recorder.dump(
            "crash", detail=f"{type(exc).__name__}: {exc}",
            extra={"health": self.report()})
        return None if p is None else str(p)

    # ------------------------------------------------------------------- read
    @property
    def worst_state(self) -> str:
        return self.slo.worst_state

    @property
    def penalty(self) -> float:
        """Load-score penalty the replica router adds for this engine."""
        return state_penalty(self.worst_state)

    def report(self) -> dict:
        return {
            "state": self.worst_state,
            "classes": self.slo.to_doc(),
            "anomalies_fired": self.anomalies_fired,
            "pages": self.pages,
            "dumps": self.recorder.dumps,
            "recent_anomalies": [a.to_doc()
                                 for a in list(self.anomaly.anomalies)[-8:]],
        }
