"""RWKV-6 (Finch) 3B [arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b].

32L d_model=2560 (attention-free, 40 heads of 64) d_ff=8960 vocab=65536,
data-dependent decay via LoRA.
"""

from ..models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # d_model / rwkv.head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
)

REDUCED = ModelConfig(
    name="rwkv6-3b-reduced",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab_size=512,
    rwkv=RWKVConfig(head_dim=16, decay_lora=8),
)
