from .api import (
    ShardingContext,
    activate,
    axis_extent,
    current,
    fsdp_gather,
    shard,
    spec_for_logical,
)

__all__ = [
    "ShardingContext",
    "activate",
    "axis_extent",
    "current",
    "fsdp_gather",
    "shard",
    "spec_for_logical",
]
