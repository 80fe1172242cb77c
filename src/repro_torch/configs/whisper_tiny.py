"""Whisper tiny [arXiv:2212.04356].

Encoder-decoder: 4+4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
The conv audio frontend is a stub: the model takes precomputed frame
embeddings (B, 1500, d_model).
"""

from ..models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    encoder=EncoderConfig(n_layers=4, n_frames=1500),
)

REDUCED = ModelConfig(
    name="whisper-tiny-reduced",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    encoder=EncoderConfig(n_layers=2, n_frames=64),
)
