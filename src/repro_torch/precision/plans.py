"""Per-width planning: which width a model serves at, and the plan
ladders the serving runtime walks at that width.

Own copy of ``repro.precision.plans``.  :mod:`repro_torch.library.qos` is
width-agnostic -- it sees operators as ``(record, compiled table)``
pairs with areas and error metrics.  What makes a plan *4-bit* or
*8-bit* is which frontier those pairs came from and which exact
reference anchors the area accounting.  This module owns that choice:

* :func:`select_width` -- the model-config side: a config built with
  ``.with_approx_mlp(bits=8)`` serves W8A8, default stays W4A4.
* :func:`load_frontier` -- the library side: the width-compiled frontier
  triple ``(compiled, exact_area, bits)`` (thin, explicit wrapper over
  :func:`repro_torch.library.compile.load_mul_frontier`).
* :class:`WidthFrontier` + :func:`build_ladder` -- one loaded width held
  together with its plan-ladder construction.
* the mixed half -- :class:`MixedFrontier`, :func:`select_width_map`,
  :func:`stack_mixed_luts`, :func:`build_mixed_ladder`: a per-layer width
  map over two frontiers at once.

Layering: this module sits *above* :mod:`repro_torch.library` (it imports
compile/qos) and *below* :mod:`repro_torch.serving` (the serving engine
consumes the plans built here).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from .widths import NATIVE_BLOCK_BITS, WidthSpec, exact_table, get_width

__all__ = [
    "DEFAULT_WIDTH_BITS",
    "select_width",
    "load_frontier",
    "WidthFrontier",
    "build_ladder",
    "MixedFrontier",
    "load_mixed_frontier",
    "mixed_cost_matrix",
    "select_width_map",
    "mixed_comparison",
    "choose_mixed_budget",
    "build_mixed_ladder",
    "stack_mixed_luts",
    "exact_mixed_stacks",
    "group_layers",
    "width_of_key",
]

DEFAULT_WIDTH_BITS = NATIVE_BLOCK_BITS


def select_width(cfg=None, requested: int | None = None) -> WidthSpec:
    """Resolve the serving width: an explicit request wins, else the
    model config's ``approx_bits``, else the native 4-bit default.

    A mismatch between the two (config says 8, caller asks 4) raises —
    a quantized checkpoint's width is not a runtime preference.  A config
    that has not opted into LUT routing yet (``approx_mlp=False``) pins
    nothing: its ``approx_bits`` default is not a commitment.
    """
    cfg_bits = None
    if cfg is not None and getattr(cfg, "approx_mlp", False):
        cfg_bits = getattr(cfg, "approx_bits", None)
    if requested is not None and cfg_bits is not None \
            and int(requested) != int(cfg_bits):
        raise ValueError(
            f"requested width {requested} contradicts the model config's "
            f"approx_bits={cfg_bits}"
        )
    bits = requested if requested is not None else (cfg_bits or
                                                    DEFAULT_WIDTH_BITS)
    return get_width(int(bits))


def load_frontier(library, width: WidthSpec | int):
    """The width-compiled multiplier frontier of a store:
    ``(compiled, exact_area, bits)``, areas and error metrics both at the
    target width (composed, for widths above the native block width)."""
    from ..library.compile import load_mul_frontier

    w = width if isinstance(width, WidthSpec) else get_width(width)
    if w.bits == NATIVE_BLOCK_BITS:
        # native regime: keep the legacy loader semantics (block frontier)
        return load_mul_frontier(library)
    return load_mul_frontier(library, target_bits=w.bits)


@dataclass
class WidthFrontier:
    """One store's frontier, pinned to one serving width."""

    width: WidthSpec
    compiled: list            # [(OperatorRecord, CompiledLut)]
    exact_area: float
    library: str | None = None
    meta: dict = field(default_factory=dict)

    @classmethod
    def load(cls, library, width: WidthSpec | int) -> "WidthFrontier":
        w = width if isinstance(width, WidthSpec) else get_width(width)
        compiled, exact_area, bits = load_frontier(library, w)
        return cls(width=w, compiled=compiled, exact_area=float(exact_area),
                   library=str(library), meta={"frontier_bits": bits})

    def __len__(self) -> int:
        return len(self.compiled)

    def select_plan(self, sensitivities, budget: float):
        from ..library.qos import select_plan

        return select_plan(self.compiled, sensitivities, budget,
                           exact_area=self.exact_area)

    def ladder(self, n_layers: int, *, sensitivities=None, levels: int = 6):
        return build_ladder(self.compiled, n_layers,
                            exact_area=self.exact_area,
                            sensitivities=sensitivities, levels=levels)


def build_ladder(compiled, n_layers: int, *, exact_area: float,
                 sensitivities=None, levels: int = 6):
    """A serving :class:`~repro_torch.serving.controller.PlanLadder` over one
    width's frontier — every level's LUT stack shares the frontier's
    table side, so controller moves and watcher refreshes stay
    swap-compatible (``validate_lut_stack``)."""
    from ..serving.controller import PlanLadder

    sens = (np.ones(n_layers) if sensitivities is None
            else np.asarray(sensitivities, dtype=np.float64))
    return PlanLadder.build(compiled, n_layers, exact_area=exact_area,
                            sensitivities=sens, levels=levels)


# ---------------------------------------------------------------------------
# mixed-width plans: a per-layer width map over two frontiers at once
# ---------------------------------------------------------------------------
# A uniform-width serve prices every layer against one frontier.  The
# cross-layer lever the approximate-computing surveys point at is *mixed*
# assignment: sensitive layers stay on the native 4-bit tiles (the exact
# 16x16 tile is the cheapest zero-drift anchor there is), tolerant layers
# take aggressively-approximated composed 256x256 W8A8 tables whose
# composed areas undercut the exact native multiplier while their *model*
# drift stays low (the finer 8-bit quantization grid shrinks the scale
# every table error is multiplied by).  The width map is frozen per serve
# -- the group stacks are fixed buffers of the decode step -- so plan
# swaps inside a map copy into the same buffers, exactly like the
# single-width contract.

def width_of_key(key: str | None, native_bits: int = NATIVE_BLOCK_BITS) -> int:
    """Serving width encoded in a merged-frontier operator key
    (``"w8:<content key>"``); ``None`` (the exact rung of the *union*
    selection) anchors at the native width."""
    if key is None:
        return native_bits
    if not key.startswith("w") or ":" not in key:
        raise ValueError(f"not a width-namespaced operator key: {key!r}")
    return int(key[1:key.index(":")])


def group_layers(width_map, bits: int) -> tuple[int, ...]:
    """Layers serving at ``bits``, in layer order — the packing order of
    that width group's ``(n_group, side, side)`` stack."""
    return tuple(l for l, b in enumerate(width_map) if int(b) == int(bits))


@dataclass
class MixedFrontier:
    """Two (or more) width-compiled frontiers of one store, merged.

    ``compiled`` holds every frontier operator once, its record key
    namespaced with its serving width (``"w4:..."`` / ``"w8:..."``) so a
    merged plan's per-layer keys are unambiguous; ``op_bits[o]`` is the
    serving width of ``compiled[o]``.  ``by_width`` keeps the per-width
    frontiers (original keys) for uniform-plan comparisons and profile
    lookups.
    """

    by_width: dict[int, WidthFrontier]
    compiled: list                 # merged [(namespaced record, CompiledLut)]
    op_bits: np.ndarray            # (O,) serving width per merged operator
    library: str | None = None

    @property
    def widths(self) -> tuple[int, ...]:
        return tuple(sorted(self.by_width))

    @property
    def native_bits(self) -> int:
        return min(self.by_width)

    def exact_area(self, bits: int) -> float:
        return self.by_width[int(bits)].exact_area

    def exact_areas(self, width_map) -> np.ndarray:
        """Per-layer exact-multiplier areas under a width map."""
        return np.array([self.exact_area(b) for b in width_map])


def load_mixed_frontier(library, widths=(4, 8)) -> MixedFrontier:
    """Load and merge one store's frontier at every serving width.

    Raises :class:`LookupError` (from the per-width loaders) when the
    store holds no multipliers.
    """
    by_width = {int(b): WidthFrontier.load(library, int(b))
                for b in sorted(widths)}
    compiled, op_bits = [], []
    for bits, fr in sorted(by_width.items()):
        for rec, comp in fr.compiled:
            compiled.append(
                (dataclasses.replace(rec, key=f"w{bits}:{rec.key}"), comp))
            op_bits.append(bits)
    return MixedFrontier(by_width=by_width, compiled=compiled,
                         op_bits=np.asarray(op_bits), library=str(library))


def _width_cost_block(fr: WidthFrontier, sens, n_layers: int) -> np.ndarray:
    """One width's ``(L, O_w)`` drift-cost block: a measured matrix is
    taken as-is, a per-layer vector prices each operator linearly by its
    compiled-table mae."""
    s = np.asarray(sens, dtype=np.float64)
    if s.ndim == 2:
        if s.shape != (n_layers, len(fr.compiled)):
            # ValueError so a stale measured matrix surfacing through the
            # watcher refresh skips the refresh instead of killing the
            # serve (the loop catches LookupError/ValueError only)
            raise ValueError(
                f"measured cost matrix is {s.shape}, frontier wants "
                f"({n_layers}, {len(fr.compiled)}); re-price against the "
                f"refreshed frontier (the sensitivity profile's costs)")
        return s
    assert s.shape == (n_layers,), s.shape
    maes = np.array([comp.mae for _, comp in fr.compiled])
    return s[:, None] * maes[None, :]


def mixed_cost_matrix(mixed: MixedFrontier, sens_by_width,
                      n_layers: int) -> np.ndarray:
    """The merged ``(L, O)`` cost matrix, column-aligned with
    ``mixed.compiled``.  ``sens_by_width[bits]`` is either a measured
    ``(L, O_bits)`` matrix aligned with that width's frontier or a
    per-layer ``(L,)`` sensitivity vector (drift per unit compiled-table
    mae at that width)."""
    blocks = [_width_cost_block(fr, sens_by_width[bits], n_layers)
              for bits, fr in sorted(mixed.by_width.items())]
    return np.concatenate(blocks, axis=1)


def select_width_map(mixed: MixedFrontier, sens_by_width, budget: float,
                     n_layers: int):
    """Choose the per-layer serving width: one greedy area-descent over
    the *union* of both frontiers' rungs (exact native tile as the
    zero-drift anchor), then read each layer's width off its chosen
    operator.  Returns ``(width_map, union_plan)``; the union plan's
    total area is the mixed-width area the acceptance benchmark compares
    against uniform plans."""
    from ..library.qos import select_plan

    costs = mixed_cost_matrix(mixed, sens_by_width, n_layers)
    plan = select_plan(mixed.compiled, costs, budget,
                       exact_area=mixed.exact_area(mixed.native_bits))
    width_map = tuple(width_of_key(c.key, mixed.native_bits)
                      for c in plan.choices)
    return width_map, plan


def mixed_comparison(mixed: MixedFrontier, sens_by_width, budget: float,
                     n_layers: int):
    """The acceptance measurement: mixed-width vs best uniform-width
    composed area at one shared drift budget.  Returns
    ``(report dict, width_map, union_plan)``."""
    from ..library.qos import select_plan

    width_map, plan = select_width_map(mixed, sens_by_width, budget,
                                       n_layers)
    uniform = {}
    for bits, fr in sorted(mixed.by_width.items()):
        costs_w = _width_cost_block(fr, sens_by_width[bits], n_layers)
        p = select_plan(fr.compiled, costs_w, budget,
                        exact_area=fr.exact_area)
        uniform[bits] = p.total_area
    best_uniform = min(uniform.values())
    report = {
        "budget": float(budget),
        "mixed_area": plan.total_area,
        "uniform_area": {str(b): a for b, a in uniform.items()},
        "best_uniform_area": best_uniform,
        "advantage": best_uniform - plan.total_area,
        "width_layers": {str(b): len(group_layers(width_map, b))
                         for b in mixed.widths},
        "width_map": [int(b) for b in width_map],
    }
    return report, width_map, plan


def choose_mixed_budget(mixed: MixedFrontier, sens_by_width,
                        n_layers: int, *, levels: int = 9) -> float:
    """Pick a drift budget where the mixed assignment actually pays:
    scan the union greedy descent's breakpoint budgets and take the one
    with the largest area advantage over the best uniform plan among
    those that use every width; fall back to any both-widths budget,
    then to the full-descent budget.  Deterministic (pure plan
    arithmetic, no model evaluation)."""
    from ..library.qos import plan_ladder

    costs = mixed_cost_matrix(mixed, sens_by_width, n_layers)
    plans = plan_ladder(mixed.compiled, costs,
                        exact_area=mixed.exact_area(mixed.native_bits),
                        levels=levels)
    best: tuple[float, float] | None = None    # (advantage, budget)
    fallback: float | None = None
    for p in plans[1:]:
        report, width_map, _ = mixed_comparison(
            mixed, sens_by_width, p.budget, n_layers)
        if len(set(width_map)) < len(mixed.widths):
            continue
        if fallback is None:
            fallback = p.budget
        if report["advantage"] > 0 and (best is None
                                        or report["advantage"] > best[0]):
            best = (report["advantage"], p.budget)
    if best is not None:
        return best[1]
    if fallback is not None:
        return fallback
    return plans[-1].budget


def stack_mixed_luts(plan, records, width_map) -> dict[int, np.ndarray]:
    """Materialize a width-map plan as one ``(n_group, side, side) int32``
    stack per width group (layer order within each group).  ``key is
    None`` serves the exact product table of the layer's width."""
    by_key = {rec.key: comp for rec, comp in records}
    out: dict[int, np.ndarray] = {}
    for bits in sorted(set(int(b) for b in width_map)):
        w = get_width(bits)
        exact = exact_table("mul", bits).astype(np.int32)
        layers = group_layers(width_map, bits)
        arr = np.zeros((len(layers), w.side, w.side), dtype=np.int32)
        for j, l in enumerate(layers):
            c = plan.choices[l]
            if c.key is None:
                arr[j] = exact
            else:
                comp = by_key[c.key]
                if comp.lut.shape[-1] != w.side:
                    raise ValueError(
                        f"layer {l} is mapped to {bits}-bit but its plan "
                        f"operator {c.key} compiled to a "
                        f"{comp.lut.shape[-1]}x{comp.lut.shape[-1]} table")
                arr[j] = comp.lut
        out[bits] = arr
    return out


def exact_mixed_stacks(width_map) -> dict[int, np.ndarray]:
    """The all-exact group stacks of a width map — the mixed serving
    engine's shadow-step baseline."""
    out: dict[int, np.ndarray] = {}
    for bits in sorted(set(int(b) for b in width_map)):
        w = get_width(bits)
        exact = exact_table("mul", bits).astype(np.int32)
        n = len(group_layers(width_map, bits))
        out[bits] = np.broadcast_to(exact, (n, w.side, w.side)).copy()
    return out


def build_mixed_ladder(mixed: MixedFrontier, width_map, sens_by_width,
                       *, levels: int = 6):
    """A serving :class:`~repro_torch.serving.controller.PlanLadder` *within* a
    frozen width map: each layer's downgrade rungs are restricted to its
    own width's operators (plus the exact table of that width as rung 0),
    and every level stacks as a ``{bits: (n_group, side, side)}`` dict —
    controller moves and watcher refreshes re-stack group arrays only,
    never changing the group buffers' shapes."""
    from ..library.qos import plan_ladder
    from ..serving.controller import PlanLadder

    width_map = tuple(int(b) for b in width_map)
    n_layers = len(width_map)
    costs = mixed_cost_matrix(mixed, sens_by_width, n_layers)
    allowed = (mixed.op_bits[None, :]
               == np.asarray(width_map)[:, None])
    ex = mixed.exact_areas(width_map)
    plans = plan_ladder(mixed.compiled, costs, exact_area=ex,
                        levels=levels, allowed=allowed)
    return PlanLadder(
        mixed.compiled, plans, float(ex.mean()), costs,
        requested_levels=levels,
        stacker=lambda plan: stack_mixed_luts(plan, mixed.compiled,
                                              width_map),
    )
