"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-plus].

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000, no biases.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=75e6,
)

REDUCED = ModelConfig(
    name="command-r-plus-104b-reduced",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
)
