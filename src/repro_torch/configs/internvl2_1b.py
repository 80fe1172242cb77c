"""InternVL2-1B [arXiv:2404.16821; hf:OpenGVLab/InternVL2-1B].

LM backbone (Qwen2-0.5B-style): 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655.  The InternViT frontend is a stub, as in the reference:
a batch carries precomputed patch embeddings (B, 256, 1024) under
``"patches"``, projected into the LM width and prepended to the text.
"""

from ..models.config import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    rope_theta=1e6,
    vision=VisionConfig(n_patches=256, d_vision=1024),
)

REDUCED = ModelConfig(
    name="internvl2-1b-reduced",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    vision=VisionConfig(n_patches=16, d_vision=48),
)
