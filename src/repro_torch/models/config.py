"""Model configuration: own copy of ``repro.models.config.ModelConfig``
for the dense family this port runs so far.

Families whose sub-configs (MoE, MLA, SSM, RWKV, encoder, vision) are not
ported yet have no fields here; :mod:`repro_torch.configs` refuses their
architectures.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None            # default d_model // n_heads
    # --- attention flavour ---
    qk_norm: bool = False
    sliding_window: int | None = None      # uniform sliding window
    local_global_every: int | None = None  # every k-th layer global
    local_window: int | None = None        # window of the local layers
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # --- numerics ---
    dtype: str = "bfloat16"
    attn_f32: bool = True   # f32 QK^T/PV in the plain attention path
    # --- approximate-arithmetic emulation ---
    approx_mlp: bool = False               # route MLP matmuls through the LUT
    approx_bits: int = 4                   # 4 (W4A4) or 8 (W8A8)

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        """Analytic parameter count of the dense family."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        H, Hkv, hd = self.n_heads, self.n_kv_heads, self.hd
        total = V * D if self.tie_embeddings else 2 * V * D
        per_layer = D * H * hd + 2 * D * Hkv * hd + H * hd * D + 3 * D * F
        return total + L * per_layer

    def with_approx_mlp(self, bits: int = 4) -> "ModelConfig":
        """Route MLP matmuls through the approximate-multiplier LUT at the
        given operand width (4 = W4A4, 8 = composed W8A8)."""
        return replace(self, approx_mlp=True, approx_bits=int(bits))
