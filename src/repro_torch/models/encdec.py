"""Whisper-style encoder–decoder (the ``audio`` family): init, the
teacher-forced forward and its loss, and one-token decode over caches
that hold each decoder layer's self-attention KV and its cross K/V.

The conv audio frontend is a stub, as in the reference: ``frames`` are
precomputed frame embeddings ``(B, n_frames, d_model)``.  Positions are
sinusoidal on both sides.  Every attention (the encoder's bidirectional
one, the decoder's causal and cross ones) runs the masked-softmax path,
as the reference's does, and the GELU FFNs take no LUT: ``forward_encdec``
accepts ``lut`` and drops it, as the reference does.

Parameters are plain dicts with one dict a layer in ``params["enc_layers"]``
and ``params["dec_layers"]`` (the reference stacks them for its
``lax.scan``; :func:`repro_torch.convert.params_from_jax` splits them).

The decode step applies RoPE in its self-attention
(:func:`repro_torch.models.layers.attention_decode`) where the forward
applies none, as the reference's does: decode reproduces the forward at
position 0 only, and is held against the reference's own decode step.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..parallel import fsdp_gather, shard
from . import layers as L
from .config import ModelConfig
from .lm import check_device, next_token_nll, remat_layer

Params = dict[str, Any]


def sinusoid(seq_len: int, d_model: int, *,
             device: str | torch.device = "cpu") -> torch.Tensor:
    """(seq_len, d_model) float32: sines then cosines, computed in float64
    with numpy and rounded once to float32, as the reference's table."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    inv = 1.0 / (10_000 ** (2 * dim / d_model))
    table = np.concatenate([np.sin(pos * inv), np.cos(pos * inv)], axis=-1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


# (seq_len, d_model, dtype, device) -> table; never evicted, since a
# captured decode step reads its table's address on every replay
_TABLES: dict[tuple, torch.Tensor] = {}


def _table(seq_len: int, d_model: int, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    key = (seq_len, d_model, dtype, device)
    if key not in _TABLES:
        _TABLES[key] = sinusoid(seq_len, d_model, device=device).to(dtype)
    return _TABLES[key]


def _init_cross(cfg: ModelConfig, gen: torch.Generator) -> Params:
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    dt = cfg.torch_dtype
    return {"wq": L._dense_init(gen, (D, H * hd), dt),
            "wk": L._dense_init(gen, (D, H * hd), dt),
            "wv": L._dense_init(gen, (D, H * hd), dt),
            "wo": L._dense_init(gen, (H * hd, D), dt)}


def init_encdec(cfg: ModelConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> Params:
    """Random weights from ``seed`` (a :class:`torch.Generator` on the
    target device), in ``cfg.dtype``; norms start at zero."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = cfg.torch_dtype

    def zeros():
        return torch.zeros((cfg.d_model,), dtype=dt, device=dev)

    enc_layers = [{"ln1": zeros(), "ln2": zeros(),
                   "attn": L.init_attention(cfg, gen),
                   "ffn": L.init_ffn(cfg, gen, gelu=True)}
                  for _ in range(cfg.encoder.n_layers)]
    dec_layers = [{"ln1": zeros(), "ln_x": zeros(), "ln2": zeros(),
                   "attn": L.init_attention(cfg, gen),
                   "cross": _init_cross(cfg, gen),
                   "ffn": L.init_ffn(cfg, gen, gelu=True)}
                  for _ in range(cfg.n_layers)]
    return {
        "embed": L._dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                               fan_in=cfg.d_model),
        "enc_layers": enc_layers,
        "dec_layers": dec_layers,
        "ln_enc": zeros(),
        "ln_f": zeros(),
        "lm_head": L._dense_init(gen, (cfg.d_model, cfg.vocab_size), dt),
    }


def _bidir_attention(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    S = x.shape[1]
    q, k, v = L._qkv(cfg, p, x)
    # every key visible: each query sits at position S, past every key
    out = L._masked_softmax_attn(
        q, k, v, torch.full((S,), S, device=x.device),
        torch.arange(S, device=x.device), None, f32_math=cfg.attn_f32)
    return L.linear(L.merge_heads(out), p["wo"])


def _cross_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """x (B, Sq, D); enc_k/enc_v (B, Sk, H, hd) precomputed."""
    Sq = x.shape[1]
    q = L.split_heads(L.linear(x, p["wq"]), cfg.n_heads, cfg.hd)
    Sk = enc_k.shape[1]
    out = L._masked_softmax_attn(
        q, enc_k, enc_v, torch.full((Sq,), Sk, device=x.device),
        torch.arange(Sk, device=x.device), None, f32_math=cfg.attn_f32)
    return L.linear(L.merge_heads(out), p["wo"])


def _cross_kv(cfg: ModelConfig, lp: Params, enc_out: torch.Tensor):
    k = L.split_heads(L.linear(enc_out, lp["cross"]["wk"]), cfg.n_heads, cfg.hd)
    v = L.split_heads(L.linear(enc_out, lp["cross"]["wv"]), cfg.n_heads, cfg.hd)
    return k, v


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, Tf, D) from the conv stub -> encoder output (B, Tf, D)."""
    dt = cfg.torch_dtype
    x = frames.to(dt) + _table(frames.shape[1], cfg.d_model, dt, frames.device)
    x = shard(x, "batch", None, None)
    for lp in params["enc_layers"]:
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        # added site: the residual replicated over "model" after the mixer
        # (repro_torch.models.lm._block_full says why)
        x = shard(x + _bidir_attention(cfg, lp["attn"], h), "batch", None, None)
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = shard(x + L.ffn(cfg, lp["ffn"], h), "batch", None, None)
    return L.rmsnorm(x, params["ln_enc"], cfg.norm_eps)


def _dec_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
               enc_out: torch.Tensor) -> torch.Tensor:
    S = x.shape[1]
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L._qkv(cfg, lp["attn"], h)
    pos = torch.arange(S, device=x.device)
    attn = L._masked_softmax_attn(q, k, v, pos, pos, None, f32_math=cfg.attn_f32)
    # added sites: the residual replicated over "model" after each mixer
    x = shard(x + L.linear(L.merge_heads(attn), lp["attn"]["wo"]), "batch", None, None)
    h = L.rmsnorm(x, lp["ln_x"], cfg.norm_eps)
    enc_k, enc_v = _cross_kv(cfg, lp, enc_out)
    x = shard(x + _cross_attention(cfg, lp["cross"], h, enc_k, enc_v), "batch", None, None)
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + L.ffn(cfg, lp["ffn"], h)


def forward_encdec(
    cfg: ModelConfig,
    params: Params,
    batch: dict,
    *,
    lut=None,
    backend: str = "auto",
    remat: str = "none",
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced: encode ``batch["frames"]``, decode
    ``batch["tokens"]``.  Returns (logits (B, S, V) float32, 0).

    ``lut`` and ``backend`` are accepted and unused: no matmul of this
    family routes through a LUT and no attention through a kernel.  With
    ``remat`` other than ``"none"`` each decoder layer is recomputed in
    the backward (the reference checkpoints its decoder scan body, under
    either policy, and not the encoder's)."""
    block = remat_layer(_dec_block, "none" if remat == "none" else "full")
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {remat!r}; 'none', 'full' or 'dots'")
    dev = resolve_device(device)
    check_device(params, dev)
    dt = cfg.torch_dtype
    enc_out = encode(cfg, params, torch.as_tensor(batch["frames"], device=dev))
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    S = tokens.shape[1]
    x = L.embed(params["embed"], tokens).to(dt) + _table(S, cfg.d_model, dt, dev)
    x = shard(x, "batch", None, None)
    for lp in params["dec_layers"]:
        x = shard(block(cfg, lp, x, enc_out), "batch", None, None)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = torch.matmul(x, fsdp_gather(params["lm_head"])).float()
    # added site: the logits' vocab over "model", as forward_lm constrains
    # them; unconstrained, the loss gathered them and the lm_head's weight
    # gradient ran whole on every rank of that axis
    logits = shard(logits, "batch", None, "model")
    return logits, torch.zeros((), dtype=torch.float32, device=dev)


def encdec_loss(cfg: ModelConfig, params: Params, batch: dict, *, lut=None,
                backend: str = "auto", remat: str = "none",
                device: str | torch.device = "cuda") -> torch.Tensor:
    """Mean next-token cross-entropy of the teacher-forced decoder."""
    logits, _ = forward_encdec(cfg, params, batch, backend=backend,
                               remat=remat, device=device)
    return next_token_nll(logits, torch.as_tensor(batch["tokens"],
                                                  device=logits.device))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_encdec_caches(cfg: ModelConfig, batch: int, seq_len: int, *,
                       device: str | torch.device = "cuda") -> list[Params]:
    """Per decoder layer: self-attention KV ``{"k", "v"}`` over
    ``seq_len`` slots and the cross K/V ``{"xk", "xv"}`` over the
    encoder's frames, staged by :func:`prefill_cross`."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    F = cfg.encoder.n_frames

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    return [{"k": zeros(batch, seq_len, cfg.n_kv_heads, cfg.hd),
             "v": zeros(batch, seq_len, cfg.n_kv_heads, cfg.hd),
             "xk": zeros(batch, F, cfg.n_heads, cfg.hd),
             "xv": zeros(batch, F, cfg.n_heads, cfg.hd)}
            for _ in range(cfg.n_layers)]


def prefill_cross(cfg: ModelConfig, params: Params, frames,
                  caches: list[Params]) -> list[Params]:
    """Encode once and write each decoder layer's cross K/V into its
    cache in place (the reference returns new caches); returns
    ``caches``."""
    dev = caches[0]["xk"].device
    enc_out = encode(cfg, params, torch.as_tensor(frames, device=dev))
    for lp, c in zip(params["dec_layers"], caches):
        k, v = _cross_kv(cfg, lp, enc_out)
        c["xk"].copy_(k)
        c["xv"].copy_(v)
    return caches


def decode_step_encdec(
    cfg: ModelConfig,
    params: Params,
    caches: list[Params],
    tokens: torch.Tensor,   # (B, 1) int
    pos,                    # int | 0-d or (1,) long tensor
    *,
    luts=None,
    width_map=None,
    backend: str = "auto",
) -> tuple[torch.Tensor, list[Params]]:
    """One decoder step over caches that :func:`prefill_cross` staged:
    writes the self-attention KV at ``pos`` in place and returns
    next-token logits (B, V) float32.

    The sinusoid row is selected on the device from ``pos``, so with a
    tensor position the step can be captured once and replayed at every
    position.  ``luts``, ``width_map`` and ``backend`` are the keywords
    the serving engines pass; no matmul of this family routes through a
    LUT, so a stack is refused."""
    if luts is not None:
        raise ValueError(f"{cfg.name}: the encoder–decoder family routes no "
                         "matmul through a LUT; serve it without a stack")
    dt = cfg.torch_dtype
    dev = params["embed"].device
    pos_t = L.decode_position(pos, dev)
    table = _table(caches[0]["k"].shape[1], cfg.d_model, dt, dev)
    x = L.embed(params["embed"], tokens.long()).to(dt) + table.index_select(0, pos_t)[None]
    for lp, cache in zip(params["dec_layers"], caches):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        attn_out, _ = L.attention_decode(cfg, lp["attn"], h, cache, pos_t, None)
        x = shard(x + attn_out, "batch", None, None)
        h = L.rmsnorm(x, lp["ln_x"], cfg.norm_eps)
        x = shard(x + _cross_attention(cfg, lp["cross"], h, cache["xk"], cache["xv"]),
                  "batch", None, None)
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        # added site: left sharded over "model", the residual made the next
        # layer's products, and the logits', run whole on every rank
        x = shard(x + L.ffn(cfg, lp["ffn"], h), "batch", None, None)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return torch.matmul(x, fsdp_gather(params["lm_head"])).float()[:, 0], caches
