from .compose import extract_tile, is_composed, tile_to_width
from .widths import (SUPPORTED_WIDTHS, WIDTHS, WidthSpec, exact_table,
                     get_width, width_from_lut, width_from_stack)

__all__ = [
    "WidthSpec",
    "WIDTHS",
    "SUPPORTED_WIDTHS",
    "get_width",
    "width_from_lut",
    "width_from_stack",
    "exact_table",
    "tile_to_width",
    "extract_tile",
    "is_composed",
]
