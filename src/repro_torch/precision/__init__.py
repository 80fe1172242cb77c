"""Multi-bit-width operator pipeline: width as a first-class axis.

Own copy of ``repro.precision``, with the same exports:

* :mod:`.widths` -- the width registry: code ranges, LUT shapes,
  signed-code biases, accumulator contracts.  Pure facts, numpy-only.
* :mod:`.compose` -- the composer: searched 1-4-bit blocks shift-add
  into 256x256 product tables, and the tile<->table inversion the W8A8
  kernel relies on.  Numpy-only.
* :mod:`.plans` -- the planner: width selection from a model config,
  width-compiled frontiers, per-width and mixed-width plan ladders.  It
  imports :mod:`repro_torch.library` (which imports this package back for
  the composer), so it loads lazily (PEP 562), as in the reference.
"""

from .compose import (
    CompositionError,
    chain_add,
    compose_blocks,
    compose_table,
    extract_tile,
    is_composed,
    tile_mul,
    tile_to_width,
    verify_exactness,
)
from .widths import (
    NATIVE_BLOCK_BITS,
    SUPPORTED_WIDTHS,
    WIDTHS,
    WidthSpec,
    exact_table,
    get_width,
    stack_shape,
    width_from_lut,
    width_from_side,
    width_from_stack,
)

_LAZY = {
    "DEFAULT_WIDTH_BITS": ".plans",
    "select_width": ".plans",
    "load_frontier": ".plans",
    "WidthFrontier": ".plans",
    "build_ladder": ".plans",
    "MixedFrontier": ".plans",
    "load_mixed_frontier": ".plans",
    "mixed_cost_matrix": ".plans",
    "select_width_map": ".plans",
    "mixed_comparison": ".plans",
    "choose_mixed_budget": ".plans",
    "build_mixed_ladder": ".plans",
    "stack_mixed_luts": ".plans",
    "exact_mixed_stacks": ".plans",
    "group_layers": ".plans",
    "width_of_key": ".plans",
}


def __getattr__(name: str):
    if name in _LAZY:
        from importlib import import_module

        value = getattr(import_module(_LAZY[name], __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "NATIVE_BLOCK_BITS",
    "SUPPORTED_WIDTHS",
    "WIDTHS",
    "WidthSpec",
    "exact_table",
    "get_width",
    "stack_shape",
    "width_from_lut",
    "width_from_side",
    "width_from_stack",
    "CompositionError",
    "chain_add",
    "compose_blocks",
    "compose_table",
    "extract_tile",
    "is_composed",
    "tile_mul",
    "tile_to_width",
    "verify_exactness",
    *_LAZY,
]
