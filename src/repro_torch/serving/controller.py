"""The plan ladder a QoS controller walks between batches.

Own copy of ``repro.serving.controller``, trimmed to :class:`PlanLadder`:
a monotone sequence of QoS plans from "most exact" (level 0) down to
"full greedy descent" (last level), built from the frontier by
:func:`repro_torch.library.qos.plan_ladder`, each level's stack built
once.  The controller that walks it (``QoSController``,
``ControllerConfig``, ``effective_load_ms``) is ROADMAP.md §1's next
item.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..library.qos import LayerPlan, plan_ladder, stack_luts

__all__ = ["PlanLadder"]


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
