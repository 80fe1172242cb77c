"""Model configuration: own copy of ``repro.models.config``, with every
family's sub-config (``moe``, ``mla``, ``ssm``, ``rwkv``, ``encoder``,
``vision``) field for field, and the dry-run's input shapes
(``ShapeConfig``, ``SHAPES``).

The port runs every family: the decoder-only ones in
:mod:`repro_torch.models.lm`, the encoder–decoder one (``audio``) in
:mod:`repro_torch.models.encdec`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0              # always-on shared experts (DeepSeek)
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01  # load-balancing loss
    impl: str = "blocked"          # 'blocked' (capacity batched matmul) |
    #                                'ragged' (dropless)
    capacity_factor: float = 1.25  # blocked impl: slots = T*K/E * cf


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int              # compressed KV width (c_kv)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16            # N
    d_inner: int | None = None     # defaults to d_model
    dt_rank: int = 32


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64           # rank of the data-dependent decay LoRA


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (conv frontend stubbed to frame embeddings)."""

    n_layers: int = 4
    n_frames: int = 1500           # encoder positions after the conv stub


@dataclass(frozen=True)
class VisionConfig:
    """ViT frontend stub: precomputed patch embeddings + linear projector."""

    n_patches: int = 256
    d_vision: int = 1024


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
    # --- family sub-configs ---
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    encoder: EncoderConfig | None = None
    vision: VisionConfig | None = None
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
    def attn_free(self) -> bool:
        return self.rwkv is not None

    @property
    def sub_quadratic(self) -> bool:
        """Bounded state or window (RWKV, SSM, sliding or local layers)."""
        return (
            self.rwkv is not None
            or self.ssm is not None
            or self.sliding_window is not None
            or self.local_global_every is not None
        )

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        H, Hkv, hd = self.n_heads, self.n_kv_heads, self.hd
        total = V * D if self.tie_embeddings else 2 * V * D
        per_layer = 0
        if self.rwkv is not None:
            hw = self.rwkv.head_dim
            nh = D // hw
            per_layer += 4 * D * D + D * D  # r/k/v/g + out
            per_layer += 2 * D * self.rwkv.decay_lora  # decay lora
            per_layer += nh * hw  # u
            per_layer += D * F + F * D + D * D  # channel mix
        elif self.mla is not None:
            mla = self.mla
            qk = mla.qk_nope_head_dim + mla.qk_rope_head_dim
            per_layer += D * (mla.kv_lora_rank + mla.qk_rope_head_dim)
            per_layer += D * H * qk
            per_layer += mla.kv_lora_rank * H * (mla.qk_nope_head_dim + mla.v_head_dim)
            per_layer += H * mla.v_head_dim * D
        else:
            per_layer += D * H * hd + 2 * D * Hkv * hd + H * hd * D
        if self.ssm is not None:  # hybrid adds the SSM path on top of attn
            di = self.ssm.d_inner or D
            per_layer += D * di + di * (2 * self.ssm.state_dim) + di * D
        if self.moe is not None:
            mo = self.moe
            per_layer += D * mo.n_experts
            per_layer += mo.n_experts * 3 * D * mo.d_ff_expert
            per_layer += mo.n_shared * 3 * D * mo.d_ff_expert
        elif self.rwkv is None:
            per_layer += 3 * D * F
        if self.encoder is not None:
            enc_layer = 4 * D * D + 2 * D * F  # self-attn + gelu mlp
            total += self.encoder.n_layers * enc_layer
            per_layer += 4 * D * D  # decoder cross-attention
        if self.vision is not None:
            total += self.vision.d_vision * D  # projector
        return total + L * per_layer

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.n_params()
        mo = self.moe
        inactive = (mo.n_experts - mo.top_k) * 3 * self.d_model * mo.d_ff_expert
        return self.n_params() - self.n_layers * inactive

    def with_approx_mlp(self, bits: int = 4) -> "ModelConfig":
        """Route MLP matmuls through the approximate-multiplier LUT at the
        given operand width (4 = W4A4, 8 = composed W8A8)."""
        return replace(self, approx_mlp=True, approx_bits=int(bits))


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape × step-kind) cell of the dry-run matrix."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
