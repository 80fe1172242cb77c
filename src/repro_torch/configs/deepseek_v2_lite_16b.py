"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite].

27L d_model=2048 16H, MLA kv_lora=512, MoE 64 routed top-6 + 2 shared,
d_ff_expert=1408, vocab=102400.

The reference's configuration, field for field: 64 routed experts (the
full V2 uses 160), and the real model's first dense layer (d_ff=10944)
kept MoE, as the reference keeps every layer alike.
"""

from ..models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
)

REDUCED = ModelConfig(
    name="deepseek-v2-lite-16b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=512,
    mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, n_shared=1),
)
