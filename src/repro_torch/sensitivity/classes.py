"""Per-request QoS classes: named traffic tiers with their own drift
budgets.

Own copy of ``repro.sensitivity.classes``, whole.

One serve, several service levels: a ``gold`` request decodes on a more
exact plan than ``batch`` traffic in the same process, against the same
ladder, with no extra captures (per-class plans share the ladder's stack
shapes, so the class a batch serves under is just which stack is copied
into the captured decode step's LUT buffer).

The scheduler's contract is **isolation**: a class's effective level
depends only on (a) the shared load-driven global level and (b) that
class's *own* budget cap and measured-drift backoff.  Tightening
``batch``'s budget can therefore never worsen ``gold``'s drift — the
invariant ``tests/test_sensitivity.py`` pins down.

* :class:`QoSClass` / :class:`ClassBook` — the declared tiers, parsed
  from a CLI spec like ``gold:0.02,std:0.05,batch:0.2`` (listed order is
  drain priority).  A tier may additionally declare a p95 ms-per-step
  latency SLO — ``gold:0.02@8ms`` — which is what entitles its arrivals
  to *preempt* lower tiers in the continuous-batching engine
  (the reference's ``repro.serving.slots``).
* :class:`ClassScheduler` — per-class level resolution over a
  :class:`~repro_torch.serving.controller.PlanLadder`: a *cap* (the deepest
  level whose predicted drift fits the class budget) plus a measured
  backoff (a class whose shadow-measured EWMA drift overruns its budget
  tightens itself one level; sustained headroom relaxes it back).
* :func:`parse_class_mix` — the loadgen side: ``gold:0.1,std:0.6,...``
  arrival fractions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..obs.metrics import MetricRegistry, get_registry

__all__ = [
    "QoSClass",
    "ClassBook",
    "ClassScheduler",
    "parse_class_mix",
]


@dataclass(frozen=True)
class QoSClass:
    """One traffic tier: its name, drift budget (mean |Δlogit| vs the
    exact shadow step), drain priority (lower drains first), and an
    optional p95 ms-per-step latency SLO.  A declared ``slo_ms`` is a
    *contract*, not a hint: under continuous batching it entitles this
    tier's arrivals to preempt running lower-tier slots."""

    name: str
    drift_budget: float
    priority: int = 0
    slo_ms: float | None = None

    def __post_init__(self) -> None:
        # ValueError (not assert): these come straight from CLI specs and
        # must fail loudly even under `python -O`
        if not self.name:
            raise ValueError("a QoS class needs a name")
        if self.drift_budget < 0:
            raise ValueError(
                f"class {self.name!r} has negative drift budget "
                f"{self.drift_budget}")
        if self.slo_ms is not None and self.slo_ms <= 0:
            raise ValueError(
                f"class {self.name!r} has non-positive latency SLO "
                f"{self.slo_ms} ms")


class ClassBook:
    """The declared tiers of one serve, in drain-priority order."""

    def __init__(self, classes: Sequence[QoSClass]) -> None:
        if not classes:
            raise ValueError("a class book declares at least one tier")
        ordered = sorted(classes, key=lambda c: c.priority)
        names = [c.name for c in ordered]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names {names}")
        self.classes: tuple[QoSClass, ...] = tuple(ordered)
        self._by_name = {c.name: c for c in ordered}

    @classmethod
    def parse(cls, spec: str) -> "ClassBook":
        """``"gold:0.02@8ms,std:0.05,batch:0.2"`` — listed order is
        priority; an optional ``@<p95>ms`` suffix declares the tier's
        per-step latency SLO (the ``ms`` unit tag itself is optional)."""
        classes = []
        for i, part in enumerate(p for p in spec.split(",") if p.strip()):
            try:
                body, _, slo = part.partition("@")
                name, budget = body.split(":")
                budget = float(budget)
                slo_ms = (float(slo.strip().removesuffix("ms"))
                          if slo.strip() else None)
            except ValueError:
                raise ValueError(
                    f"bad class spec {part!r} in {spec!r}; expected "
                    f"name:drift_budget[@p95ms][,...] "
                    f"(e.g. gold:0.02@8ms,batch:0.2)") from None
            classes.append(QoSClass(name.strip(), budget, priority=i,
                                    slo_ms=slo_ms))
        return cls(classes)

    def __len__(self) -> int:
        return len(self.classes)

    def __iter__(self):
        return iter(self.classes)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.classes)

    def get(self, name: str) -> QoSClass:
        return self._by_name[name]

    def route(self, name: str) -> str:
        """Map a request's class tag to a declared tier; unknown tags ride
        the lowest-priority tier (best effort, never dropped)."""
        return name if name in self._by_name else self.classes[-1].name

    def equal_mix(self) -> tuple[tuple[str, float], ...]:
        f = 1.0 / len(self.classes)
        return tuple((c.name, f) for c in self.classes)

    def drain_weights(self) -> dict[str, int]:
        """Default weighted-fair drain shares: each tier gets twice the
        next one's (``2^(n-1-i)`` in priority order), so ``gold`` still
        dominates but ``batch`` is never starved the way a strict
        priority drain starves it under sustained high-tier load."""
        n = len(self.classes)
        return {c.name: 1 << (n - 1 - i)
                for i, c in enumerate(self.classes)}


def parse_class_mix(spec: str) -> tuple[tuple[str, float], ...]:
    """``"gold:0.1,std:0.6,batch:0.3"`` -> normalized arrival fractions
    for :class:`repro_torch.serving.loadgen.LoadProfile.class_mix`."""
    pairs = []
    for part in (p for p in spec.split(",") if p.strip()):
        try:
            name, frac = part.split(":")
            pairs.append((name.strip(), float(frac)))
        except ValueError:
            raise ValueError(
                f"bad class-mix entry {part!r} in {spec!r}; expected "
                f"name:fraction[,name:fraction...]") from None
    if not pairs:
        raise ValueError(f"empty class mix {spec!r}")
    if any(f < 0 for _, f in pairs):
        raise ValueError(f"class mix {spec!r} has a negative fraction")
    total = sum(f for _, f in pairs)
    if total <= 0:
        raise ValueError(f"class mix {spec!r} sums to 0")
    return tuple((n, f / total) for n, f in pairs)


class ClassScheduler:
    """Resolve each class's serving level over a plan ladder.

    ``level_for(name, global_level)`` = ``min(global level, class cap)``
    where the cap is the deepest ladder level whose *predicted* drift fits
    the class budget, minus the class's own measured backoff.  All state
    is per-class; nothing one class observes moves another (isolation).
    """

    def __init__(self, book: ClassBook, ladder, *, ewma_alpha: float = 0.4,
                 shadow_every: int = 4, headroom: float = 0.5,
                 relax_patience: int = 4,
                 registry: MetricRegistry | None = None) -> None:
        assert 0 < ewma_alpha <= 1 and 0 <= headroom < 1
        self.book = book
        self.ewma_alpha = float(ewma_alpha)
        self.shadow_every = max(1, int(shadow_every))
        self.headroom = float(headroom)
        self.relax_patience = max(1, int(relax_patience))
        self._tight: dict[str, int] = {c.name: 0 for c in book}
        self._drift: dict[str, float] = {c.name: 0.0 for c in book}
        self._calm: dict[str, int] = {c.name: 0 for c in book}
        self._served: dict[str, int] = {c.name: 0 for c in book}
        # backoff state is observable: the trace-dir metric snapshot shows
        # which classes ever tightened, and how deep, without a debugger
        self._registry = registry if registry is not None else get_registry()
        self.adopt(ladder)

    # ------------------------------------------------------------------ state
    def adopt(self, ladder) -> None:
        """(Re)bind to a ladder — startup and watcher-refresh path.  Caps
        recompute against the new predicted drifts; measured backoffs
        carry over (clamped)."""
        self.ladder = ladder
        self.caps = {}
        for c in self.book:
            cap = 0
            for i, plan in enumerate(ladder.plans):
                if plan.predicted_total <= c.drift_budget:
                    cap = i
            self.caps[c.name] = cap
            self._tight[c.name] = min(self._tight[c.name], cap)

    @property
    def top_level(self) -> int:
        return len(self.ladder) - 1

    def cap(self, name: str) -> int:
        return max(0, self.caps[name] - self._tight[name])

    def level_for(self, name: str, global_level: int | None = None) -> int:
        g = self.top_level if global_level is None else int(global_level)
        return min(g, self.cap(name))

    def wants_shadow(self, name: str) -> bool:
        """Per-class shadow cadence: every ``shadow_every``-th batch *of
        that class*.  Keying on the global batch index would alias with
        the deterministic priority drain (a class always landing on odd
        indices would never be measured and its backoff never engage).
        Counts the call, so invoke exactly once per served batch."""
        i = self._served[name]
        self._served[name] = i + 1
        return i % self.shadow_every == 0

    # ---------------------------------------------------------------- control
    def observe(self, name: str, drift: float) -> bool:
        """Fold one measured shadow drift into the class's EWMA; tighten
        the class one level on overrun, relax after sustained headroom.
        Returns whether the class's backoff changed."""
        a = self.ewma_alpha
        self._drift[name] = a * max(0.0, float(drift)) \
            + (1 - a) * self._drift[name]
        budget = self.book.get(name).drift_budget
        if self._drift[name] > budget and self.cap(name) > 0:
            self._tight[name] += 1
            self._calm[name] = 0
            # decay the EWMA toward the budget so one spike does not keep
            # ratcheting the class down on every subsequent sample
            self._drift[name] = budget * self.headroom
            self._note_backoff(name, "tighten")
            return True
        if self._drift[name] <= budget * self.headroom \
                and self._tight[name] > 0:
            self._calm[name] += 1
            if self._calm[name] >= self.relax_patience:
                self._tight[name] -= 1
                self._calm[name] = 0
                self._note_backoff(name, "relax")
                return True
        else:
            self._calm[name] = 0
        return False

    def _note_backoff(self, name: str, move: str) -> None:
        self._registry.counter("class_backoff_moves_total", move=move,
                               **{"class": name}).inc()
        self._registry.gauge("class_backoff_level",
                             **{"class": name}).set(self._tight[name])

    def measured_drift(self, name: str) -> float:
        return self._drift[name]

    def snapshot(self, global_level: int | None = None) -> dict:
        """Per-class state for telemetry / bench dumps."""
        return {
            c.name: {
                "drift_budget": c.drift_budget,
                "slo_ms": c.slo_ms,
                "cap": self.cap(c.name),
                "level": self.level_for(c.name, global_level),
                "ewma_drift": round(self._drift[c.name], 6),
            }
            for c in self.book
        }
