"""Mixtral 8x7B [arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1].

32L d_model=4096 32H (GQA kv=8) MoE 8 experts top-2 d_ff_expert=14336
vocab=32000, sliding-window attention (4096).
"""

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
)

REDUCED = ModelConfig(
    name="mixtral-8x7b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    sliding_window=32,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
)
