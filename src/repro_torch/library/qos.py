"""Runtime QoS selection: per-layer operators under an accuracy budget.

Own copy of ``repro.library.qos``; plans, ladders and stacks are equal to
the reference's on the same frontier.  QoS-Nets-style: each model layer
may route its matmuls through a *different* frontier operator.
Degradation is modelled linearly -- ``predicted drift of layer l on
operator o = sensitivity[l] * mae16(o)`` -- with per-layer sensitivities
*measured* by probing one layer at a time (:func:`measure_sensitivities`).
Selection is greedy area-descent:

1. every layer starts on the exact operator (cost 0),
2. repeatedly take the single-layer downgrade with the best
   area-saved-per-predicted-drift ratio,
3. stop at the first step that would exceed the budget.

The stop-at-first-violation rule makes the accepted steps a prefix of a
budget-independent sequence, so a tighter budget can never produce a
*larger* total area.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Iterator, Sequence

import numpy as np

from .compile import CompiledLut
from .store import OperatorRecord

__all__ = [
    "LayerChoice",
    "LayerPlan",
    "select_plan",
    "refresh_plan",
    "plan_ladder",
    "plan_layer_areas",
    "validate_lut_stack",
    "measure_layer_costs",
    "measure_sensitivities",
    "stack_luts",
]


@dataclass
class LayerChoice:
    """The operator one layer runs on.  ``key is None`` = exact multiplier."""

    layer: int
    key: str | None
    area: float
    predicted_drift: float = 0.0


@dataclass
class LayerPlan:
    """A full per-layer assignment plus the budget accounting behind it."""

    choices: list[LayerChoice]
    budget: float
    predicted_total: float      # sum of per-layer predicted drifts
    exact_area: float           # area of the exact reference operator

    @property
    def n_layers(self) -> int:
        return len(self.choices)

    @property
    def total_area(self) -> float:
        return float(sum(c.area for c in self.choices))

    @property
    def exact_total_area(self) -> float:
        return self.exact_area * self.n_layers

    @property
    def area_saving(self) -> float:
        tot = self.exact_total_area
        return 1.0 - self.total_area / tot if tot else 0.0

    def operators_used(self) -> dict[str | None, int]:
        out: dict[str | None, int] = {}
        for c in self.choices:
            out[c.key] = out.get(c.key, 0) + 1
        return out

    @property
    def plan_id(self) -> str:
        """Stable short identity of the *assignment* (per-layer operator
        keys only) — two plans that route every layer identically share an
        id even if selected under different budgets.  The serving runtime
        uses it to suppress no-op swaps and label telemetry."""
        blob = ",".join(c.key or "exact" for c in self.choices)
        return hashlib.sha256(blob.encode()).hexdigest()[:10]


def plan_layer_areas(plan: LayerPlan,
                     area_hi_by_key: dict[str, float] | None = None
                     ) -> list[tuple[float, float]]:
    """Per-layer ``(area_lo, area_hi)`` bracket for a plan's choices.

    A choice's own ``area`` is the composed *lower* bound (glue adders
    ignored); ``area_hi_by_key`` maps operator keys to their glue-inclusive upper
    bounds (``CompiledLut.area_hi``).  Exact layers carry the exact
    baseline on both ends, so ``exact_area - area`` prices to a zero
    dividend without special-casing.  Keys missing from the map fall
    back to a collapsed bracket.
    """
    out: list[tuple[float, float]] = []
    for c in plan.choices:
        if c.key is None:
            out.append((plan.exact_area, plan.exact_area))
        else:
            hi = (area_hi_by_key or {}).get(c.key, c.area)
            out.append((float(c.area), float(max(c.area, hi))))
    return out


def _cost_matrix(
    operators: Sequence[tuple[OperatorRecord, CompiledLut]],
    sensitivities: Sequence[float] | np.ndarray,
) -> np.ndarray:
    """Normalize ``sensitivities`` into a per-(layer, operator) cost matrix:
    either a per-layer vector ``(L,)`` of drift per unit mae16 (the cheap
    linear model), or an already-measured ``(L, O)`` matrix."""
    sens = np.asarray(sensitivities, dtype=np.float64)
    assert (sens >= 0).all(), "drift costs must be non-negative"
    if sens.ndim == 1:
        maes = np.array([comp.mae16 for _, comp in operators])
        return sens[:, None] * maes[None, :]           # (L, O) linear model
    if sens.ndim != 2 or sens.shape[1] != len(operators):
        # ValueError (not assert) on purpose: a measured matrix priced
        # against a *stale* frontier reaches here through the serving
        # watcher's refresh path, which must skip the refresh and keep
        # serving rather than die on a background fleet sweep.  (The
        # layer dimension is whatever the caller measured; a wrong layer
        # count surfaces in validate_lut_stack.)
        raise ValueError(
            f"cost matrix is {sens.shape} but the frontier has "
            f"{len(operators)} operator(s); measured matrices must be "
            f"re-priced against a refreshed frontier"
        )
    return sens


def _downgrade_ladders(
    operators: Sequence[tuple[OperatorRecord, CompiledLut]],
    costs: np.ndarray,
    exact_area: float | Sequence[float] | np.ndarray,
    allowed: np.ndarray | None = None,
) -> list[list[tuple[str | None, float, float]]]:
    """Per-layer downgrade ladder: exact first, then cost-ascending operators
    that strictly save area over the previous rung (dominated rungs and
    rungs costlier than a cheaper-area option never help).

    ``exact_area`` may be per-layer: a mixed-width plan anchors each layer
    to the exact multiplier of *that layer's* serving width.  ``allowed``
    is an optional ``(L, O)`` boolean mask restricting which operators a
    layer may run (a frozen width map restricts each layer to operators of
    its own width — see :mod:`repro_torch.precision.plans`)."""
    n_layers = costs.shape[0]
    ex = np.broadcast_to(
        np.asarray(exact_area, dtype=np.float64), (n_layers,))
    ladders: list[list[tuple[str | None, float, float]]] = []
    for l in range(n_layers):
        order = sorted((o for o in range(len(operators))
                        if allowed is None or allowed[l, o]),
                       key=lambda o: (costs[l, o], operators[o][0].area))
        ladder: list[tuple[str | None, float, float]] = [
            (None, float(ex[l]), 0.0)]
        for o in order:
            rec = operators[o][0]
            if rec.area < ladder[-1][1]:
                ladder.append((rec.key, rec.area, float(costs[l, o])))
        ladders.append(ladder)
    return ladders


def _greedy_steps(
    ladders: list[list[tuple[str | None, float, float]]],
) -> Iterator[tuple[int, float]]:
    """The budget-independent greedy descent: yields ``(layer, d_cost)`` for
    each single-layer downgrade in best-area-saved-per-drift order.  Every
    budget's plan is a prefix of this sequence — that shared prefix is both
    the monotonicity invariant and what lets :func:`plan_ladder` place its
    levels on actual descent breakpoints."""
    level = [0] * len(ladders)
    while True:
        best = None  # (ratio, layer) — deterministic tie-break on layer id
        for l, ladder in enumerate(ladders):
            if level[l] + 1 >= len(ladder):
                continue
            _, a_cur, e_cur = ladder[level[l]]
            _, a_nxt, e_nxt = ladder[level[l] + 1]
            d_area = a_cur - a_nxt
            d_cost = e_nxt - e_cur
            ratio = d_area / d_cost if d_cost > 0 else np.inf
            if best is None or ratio > best[0]:
                best = (ratio, l, d_cost)
        if best is None:
            return
        _, l, d_cost = best
        level[l] += 1
        yield l, max(0.0, d_cost)


def select_plan(
    operators: Sequence[tuple[OperatorRecord, CompiledLut]],
    sensitivities: Sequence[float] | np.ndarray,
    budget: float,
    *,
    exact_area: float | Sequence[float] | np.ndarray,
    allowed: np.ndarray | None = None,
) -> LayerPlan:
    """Greedy area-descent over the (layer, operator) lattice.

    ``operators``: frontier operators with their compiled tables (any
    order).  ``sensitivities``: either a per-layer vector ``(L,)`` of
    drift per unit mae16 (the cheap linear model), or a measured cost
    matrix ``(L, len(operators))`` of per-(layer, operator) drifts
    aligned with ``operators`` — LUT errors are biased, so measured
    per-operator costs predict far better than the linear model.
    ``budget``: total predicted drift allowed.  ``exact_area`` may be a
    per-layer vector and ``allowed`` an ``(L, O)`` operator mask (see
    :func:`_downgrade_ladders`).
    """
    costs = _cost_matrix(operators, sensitivities)
    n_layers = costs.shape[0]
    ladders = _downgrade_ladders(operators, costs, exact_area, allowed)

    level = [0] * n_layers
    spent = 0.0
    for l, d_cost in _greedy_steps(ladders):
        if spent + d_cost > budget:
            break  # first violation stops the pass (monotonicity invariant)
        level[l] += 1
        spent += d_cost

    choices = []
    for l in range(n_layers):
        key, a, e = ladders[l][level[l]]
        choices.append(LayerChoice(l, key, a, predicted_drift=e))
    # per-layer exact areas (mixed-width anchors) collapse to their mean so
    # exact_total_area still sums the true per-layer exact baseline
    return LayerPlan(
        choices=choices, budget=float(budget), predicted_total=float(spent),
        exact_area=float(np.mean(np.asarray(exact_area, dtype=np.float64))),
    )


def refresh_plan(
    plan: LayerPlan,
    operators: Sequence[tuple[OperatorRecord, CompiledLut]],
    sensitivities: Sequence[float] | np.ndarray,
    *,
    exact_area: float | Sequence[float] | np.ndarray,
    allowed: np.ndarray | None = None,
) -> LayerPlan:
    """Re-select under ``plan``'s original budget against a refreshed
    frontier — the incremental entry point the serving controller and
    library watcher call when a background fleet sweep densifies the
    store mid-serve.  The budget is carried over verbatim, so repeated
    refreshes keep the area-vs-budget monotonicity of :func:`select_plan`.
    """
    return select_plan(operators, sensitivities, plan.budget,
                       exact_area=exact_area, allowed=allowed)


def plan_ladder(
    operators: Sequence[tuple[OperatorRecord, CompiledLut]],
    sensitivities: Sequence[float] | np.ndarray,
    *,
    exact_area: float | Sequence[float] | np.ndarray,
    levels: int = 6,
    allowed: np.ndarray | None = None,
) -> list[LayerPlan]:
    """A monotone ladder of plans walking the area/accuracy frontier.

    Level 0 is the most accurate plan (budget 0 — only free downgrades),
    the last level is the full greedy descent (every layer on its cheapest
    rung).  Intermediate levels sit on *actual* breakpoints of the greedy
    sequence — cumulative-cost quantiles — so every rung change is a real
    plan change, not an empty budget increment.  Total area is strictly
    decreasing along the ladder; predicted drift is non-decreasing.
    """
    assert levels >= 2, "a ladder spans at least its two endpoints"
    costs = _cost_matrix(operators, sensitivities)
    ladders = _downgrade_ladders(operators, costs, exact_area, allowed)
    cum: list[float] = []
    spent = 0.0
    for _, d_cost in _greedy_steps(ladders):
        spent += d_cost
        cum.append(spent)

    budgets = [0.0]
    if cum:
        # descending linspace so the *last* breakpoint (full descent) is in
        # every ladder, even when levels only leaves one point for it
        idx = sorted({int(round(i))
                      for i in np.linspace(len(cum) - 1, 0,
                                           max(1, levels - 1))})
        for i in idx:
            if cum[i] > budgets[-1]:  # zero-cost runs collapse into one level
                budgets.append(cum[i])
    return [select_plan(operators, sensitivities, b, exact_area=exact_area,
                        allowed=allowed)
            for b in budgets]


def validate_lut_stack(prev, new) -> None:
    """Guard a between-batch hot-swap: the refreshed LUT stack must match
    the live one in shape and dtype, otherwise it could not be copied into
    the buffer the decode step reads.  Raises :class:`ValueError` with both signatures.

    Mixed-width serving carries one stack per width group as a
    ``{bits: (n_group, side, side)}`` dict; the group structure is part of
    the live buffers' shapes, so both sides must be dicts over identical widths
    and every group stack must match individually.
    """
    if isinstance(prev, dict) or isinstance(new, dict):
        pw = sorted(prev) if isinstance(prev, dict) else None
        nw = sorted(new) if isinstance(new, dict) else None
        if pw is None or nw is None or pw != nw:
            raise ValueError(
                f"mixed-width stack groups changed: widths {pw} -> {nw}; "
                f"the per-layer width map is frozen for the lifetime of a "
                f"serve (a width-map move needs a restart) — refusing."
            )
        for bits in pw:
            validate_lut_stack(prev[bits], new[bits])
        return
    ps, pd = tuple(prev.shape), prev.dtype
    ns, nd = tuple(new.shape), new.dtype
    if ps != ns or pd != nd:
        def _w(shape):   # best-effort width label for the error message
            side = shape[-1] if shape else 0
            b = max(side, 1).bit_length() - 1
            return f"{b}-bit" if side == 1 << b and side >= 2 else "?"

        raise ValueError(
            f"refreshed LUT stack is {ns}/{nd} ({_w(ns)}) but the serving "
            f"plan runs {ps}/{pd} ({_w(ps)}); a swap would change the "
            f"decode step's buffer — refusing.  (Did the refreshed frontier change "
            f"operator bit width or layer count?  A width move needs a "
            f"restart with --width, not a hot-swap.)"
        )


def measure_layer_costs(
    eval_drift: Callable[[list[np.ndarray | None]], float],
    n_layers: int,
    operators: Sequence[tuple[OperatorRecord, CompiledLut]],
) -> np.ndarray:
    """Measured ``(L, O)`` drift matrix: operator ``o`` probed at layer
    ``l`` alone.  L*O forwards — exact per-(layer, operator) costs for
    :func:`select_plan`, which matter because biased LUT errors break the
    linear-in-mae16 model badly."""
    costs = np.zeros((n_layers, len(operators)))
    for o, (_, comp) in enumerate(operators):
        for l in range(n_layers):
            luts: list[np.ndarray | None] = [None] * n_layers
            luts[l] = comp.lut
            costs[l, o] = max(0.0, eval_drift(luts))
    return costs


def measure_sensitivities(
    eval_drift: Callable[[list[np.ndarray | None]], float],
    n_layers: int,
    probe: CompiledLut,
) -> np.ndarray:
    """Per-layer drift per unit mae16, by probing one layer at a time.

    ``eval_drift(per_layer_luts)`` runs the model with layer ``l`` routed
    through ``per_layer_luts[l]`` (``None`` = exact) and returns a scalar
    drift against the all-exact baseline.  The probe should be a
    *coarse* operator so the signal is well above noise.
    """
    assert probe.mae16 > 0, "probe operator must be approximate"
    sens = np.zeros(n_layers)
    for l in range(n_layers):
        luts: list[np.ndarray | None] = [None] * n_layers
        luts[l] = probe.lut
        sens[l] = max(0.0, eval_drift(luts)) / probe.mae16
    return sens


def stack_luts(
    plan: LayerPlan,
    records: Sequence[tuple[OperatorRecord, CompiledLut]],
) -> np.ndarray:
    """Materialize a plan as the ``(L, side, side) int32`` array the model
    forward consumes; exact layers get the exact product table.

    The side follows the compiled frontier's target width — a 4-bit
    frontier stacks ``(L, 16, 16)``, an 8-bit (W8A8) one
    ``(L, 256, 256)`` — so a plan can never silently mix widths: every
    compiled table in ``records`` must share one side.
    """
    from ..precision.widths import exact_table

    sides = {comp.lut.shape[-1] for _, comp in records}
    if len(sides) > 1:
        raise ValueError(
            f"frontier mixes LUT sides {sorted(sides)}; a plan stack must "
            f"be single-width"
        )
    side = sides.pop() if sides else 16
    bits = side.bit_length() - 1
    by_key = {rec.key: comp for rec, comp in records}
    exact = exact_table("mul", bits).astype(np.int32)
    out = np.zeros((plan.n_layers, side, side), dtype=np.int32)
    for c in plan.choices:
        out[c.layer] = exact if c.key is None else by_key[c.key].lut
    return out
