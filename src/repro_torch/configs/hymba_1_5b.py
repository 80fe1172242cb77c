"""Hymba 1.5B [arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base].

32L d_model=1600 25H (GQA kv=5, head_dim=64) d_ff=5504 vocab=32001,
parallel attention + Mamba (SSM state 16) heads fused per layer; sliding
window on most layers with periodic global layers.
"""

from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    local_global_every=16,  # a few global layers, rest sliding-window
    local_window=1024,
    ssm=SSMConfig(state_dim=16, dt_rank=48),
)

REDUCED = ModelConfig(
    name="hymba-1.5b-reduced",
    family="hybrid",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=512,
    local_global_every=2,
    local_window=16,
    ssm=SSMConfig(state_dim=8, dt_rank=8),
)
