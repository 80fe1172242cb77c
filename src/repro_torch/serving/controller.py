"""QoS controller: walk the operator frontier between batches.

Own copy of ``repro.serving.controller``, whole.

The controller owns a :class:`PlanLadder` — a monotone sequence of QoS
plans from "most exact" (level 0) down to "full greedy descent" (last
level), built once from the frontier via :func:`repro_torch.library.qos.plan_ladder`
and rebuilt on library refreshes.  Between batches it observes an EWMA of
per-step decode latency plus the *measured* logit drift against an exact
shadow step (sampled every ``shadow_every`` batches) and decides whether
to move one level:

* **up** (cheaper operators) when smoothed latency sits above the target
  band *and* measured drift leaves headroom under the budget;
* **down** (more exact) when measured drift eats into the budget — drift
  pressure beats load pressure — or when latency sits comfortably below
  the band, so idle capacity buys accuracy back.

Moves need ``patience`` consecutive out-of-band observations and are
followed by ``cooldown`` quiet batches; inside the deadband both streaks
reset.  Together these are the hysteresis that keeps an oscillating load
from flapping plans (pinned by ``tests/test_serving.py`` and its port's replay).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..library.qos import LayerPlan, plan_ladder, stack_luts

__all__ = ["ControllerConfig", "PlanLadder", "QoSController",
           "effective_load_ms"]


def effective_load_ms(raw_ms: float, *, backlog: int = 0, capacity: int = 1,
                      occupancy: float | None = None) -> float:
    """The Little's-law-flavoured load signal the controller observes.

    Raw step latency is nearly plan-independent, so outstanding work is
    what says "trade accuracy for throughput".  The fixed-batch loop
    (``occupancy=None``) scales service time by whole-queue backlog:
    ``raw * (1 + backlog / capacity)``.  Under continuous batching that
    double-counts — most "backlog" is requests *already being served* —
    so the signal becomes slot occupancy plus true admission-queue
    depth: ``raw * (occupancy + backlog / capacity)``, where ``backlog``
    counts only requests still waiting for a slot.  An idle continuous
    pool therefore reports near-zero load instead of its raw step time,
    and a full pool with an empty queue reports exactly ``raw``."""
    cap = max(1, int(capacity))
    if occupancy is None:
        return raw_ms * (1.0 + backlog / cap)
    return raw_ms * (float(occupancy) + backlog / cap)


@dataclass(frozen=True)
class ControllerConfig:
    target_ms_per_step: float = 50.0   # latency target the EWMA is held to
    drift_budget: float = 0.05         # mean |Δlogit| allowed vs exact shadow
    ewma_alpha: float = 0.4            # smoothing for latency and drift
    deadband: float = 0.15             # +/- fraction around the target: no-op
    patience: int = 2                  # consecutive out-of-band obs to move
    cooldown: int = 2                  # quiet batches after any move
    shadow_every: int = 4              # shadow-drift sampling period (batches)
    drift_headroom: float = 0.7        # may only move up while
    #                                    ewma_drift <= headroom * budget

    def __post_init__(self) -> None:
        assert self.target_ms_per_step > 0 and self.patience >= 1
        assert 0 < self.ewma_alpha <= 1 and 0 <= self.deadband < 1


class PlanLadder:
    """The frontier materialized as swap-ready levels.

    Holds the compiled operator list the plans index into, and caches each
    level's stacked LUT array(s) so a swap re-stacks nothing.  ``stacker``
    overrides how a plan materializes — the mixed-width ladder
    (:func:`repro_torch.precision.plans.build_mixed_ladder`) stacks one array
    per width group instead of a single ``(L, side, side)`` array.
    """

    def __init__(self, compiled, plans: Sequence[LayerPlan],
                 exact_area: float, sensitivities: np.ndarray,
                 requested_levels: int | None = None, *,
                 stacker=None) -> None:
        assert plans, "ladder needs at least the all-exact plan"
        self.compiled = list(compiled)
        self.plans = list(plans)
        self.exact_area = float(exact_area)
        self.sensitivities = np.asarray(sensitivities, dtype=np.float64)
        # a sparse frontier may dedup below the requested resolution; keep
        # the request so a refresh against a denser frontier regains it
        self.requested_levels = (len(self.plans) if requested_levels is None
                                 else int(requested_levels))
        self._stacker = stacker
        self._stacks: dict[int, object] = {}

    @classmethod
    def build(cls, compiled, n_layers: int, *, exact_area: float,
              sensitivities: Sequence[float] | np.ndarray | None = None,
              levels: int = 6) -> "PlanLadder":
        sens = (np.ones(n_layers) if sensitivities is None
                else np.asarray(sensitivities, dtype=np.float64))
        plans = plan_ladder(compiled, sens, exact_area=exact_area,
                            levels=levels)
        return cls(compiled, plans, exact_area, sens, requested_levels=levels)

    def __len__(self) -> int:
        return len(self.plans)

    def plan(self, level: int) -> LayerPlan:
        return self.plans[level]

    def luts(self, level: int):
        stack = self._stacks.get(level)
        if stack is None:
            if self._stacker is not None:
                stack = self._stacker(self.plans[level])
            else:
                stack = stack_luts(self.plans[level], self.compiled)
            self._stacks[level] = stack
        return stack

    def refresh(self, compiled, exact_area: float,
                sensitivities=None) -> "PlanLadder":
        """Rebuild against a refreshed frontier, keeping the sensitivity
        model and the *originally requested* resolution — the watcher
        path (a denser frontier may now fill levels a sparse one
        couldn't).  A ladder built on a measured ``(L, O)`` cost matrix
        must be handed a re-priced ``sensitivities`` for the new frontier
        (the serving engine derives one from its sensitivity profile);
        the stale matrix would not line up with the refreshed operator
        columns.  Mixed-width ladders refresh through
        :func:`repro_torch.precision.plans.build_mixed_ladder` instead (the
        frozen width map and operator masks are not representable here)."""
        assert self._stacker is None, (
            "custom-stacked (mixed-width) ladders refresh via "
            "precision.plans.build_mixed_ladder, not PlanLadder.refresh"
        )
        sens = self.sensitivities if sensitivities is None else sensitivities
        return PlanLadder.build(
            compiled, len(sens), exact_area=exact_area,
            sensitivities=sens, levels=self.requested_levels,
        )


class QoSController:
    def __init__(self, ladder: PlanLadder, config: ControllerConfig,
                 *, level: int = 0) -> None:
        self.ladder = ladder
        self.config = config
        self.level = min(level, len(ladder) - 1)
        self.ewma_ms: float | None = None
        self.ewma_drift = 0.0
        self._hot = 0          # consecutive obs above the band
        self._cool = 0         # consecutive obs below the band
        self._over = 0         # consecutive obs over the drift budget
        self._quiet = 0        # cooldown countdown
        self.moves = 0
        self.last_reason: str | None = None

    # ------------------------------------------------------------------ state
    @property
    def plan(self) -> LayerPlan:
        return self.ladder.plan(self.level)

    def luts(self) -> np.ndarray:
        return self.ladder.luts(self.level)

    def wants_shadow(self, batch_idx: int) -> bool:
        """Should the engine sample an exact shadow step this batch?"""
        return (self.config.drift_budget > 0
                and batch_idx % max(1, self.config.shadow_every) == 0)

    # ---------------------------------------------------------------- control
    def observe(self, ms_per_step: float, drift: float | None = None
                ) -> int | None:
        """Feed one batch's measurements; returns the new level when the
        controller decides to move, else ``None``."""
        a = self.config.ewma_alpha
        self.ewma_ms = (ms_per_step if self.ewma_ms is None
                        else a * ms_per_step + (1 - a) * self.ewma_ms)
        if drift is not None:
            self.ewma_drift = a * float(drift) + (1 - a) * self.ewma_drift

        if self._quiet > 0:
            self._quiet -= 1
            return None

        hi = self.config.target_ms_per_step * (1 + self.config.deadband)
        lo = self.config.target_ms_per_step * (1 - self.config.deadband)
        if self.ewma_drift > self.config.drift_budget:
            self._over += 1
        else:
            self._over = 0
        if self.ewma_ms > hi:
            self._hot, self._cool = self._hot + 1, 0
        elif self.ewma_ms < lo:
            self._hot, self._cool = 0, self._cool + 1
        else:
            self._hot = self._cool = 0   # deadband: hysteresis resets streaks

        p = self.config.patience
        headroom = (self.ewma_drift
                    <= self.config.drift_headroom * self.config.drift_budget)
        if self._over >= p and self.level > 0:
            return self._move(-1, "drift")           # accuracy first
        if self._hot >= p and headroom and self.level < len(self.ladder) - 1:
            return self._move(+1, "load")
        if self._cool >= p and self.level > 0:
            return self._move(-1, "idle")
        return None

    def _move(self, delta: int, reason: str) -> int:
        self.level += delta
        self._hot = self._cool = self._over = 0
        self._quiet = self.config.cooldown
        self.moves += 1
        self.last_reason = reason
        return self.level

    def adopt(self, ladder: PlanLadder, *, level: int | None = None) -> None:
        """Switch to an already-built ladder, clamping the level.  The
        level index is preserved (the ladder's budget grid shifts with the
        frontier, but relative position on it is the controller's
        operating point)."""
        self.ladder = ladder
        self.level = min(self.level if level is None else level,
                         len(ladder) - 1)

    def refresh(self, compiled, exact_area: float) -> None:
        """Rebuild the ladder against a refreshed frontier and adopt it.
        The serving engine's watcher path instead builds first and adopts
        only after the new stack validated (see
        :meth:`repro_torch.serving.engine.ServingEngine.refresh_library`)."""
        self.adopt(self.ladder.refresh(compiled, exact_area))
