"""Gemma 3 1B [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1, head_dim=256) d_ff=6912 vocab=262144,
5 local : 1 global attention pattern (local window 512), tied embeddings.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    qk_norm=True,
    local_global_every=6,   # every 6th layer is global (5:1 local:global)
    local_window=512,
    rope_theta=1e6,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma3-1b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=1,
    head_dim=32,
    d_ff=192,
    vocab_size=512,
    qk_norm=True,
    local_global_every=2,
    local_window=16,
    tie_embeddings=True,
)
