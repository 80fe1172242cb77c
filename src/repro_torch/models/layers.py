"""Layer primitives of the dense family, as pure functions over plain
dicts of tensors (``init_*`` builds parameters, the apply functions take
``(cfg, params, activations, ...)``), with the JAX package's layouts:
activations ``(B, S, D)``, heads ``(B, S, H, hd)``.

Attention dispatch: ``attention_full`` sends CUDA tensors to the flash
kernel when the window is ``None`` or a Python int, as the reference
sends TPU arrays to its Pallas kernel; otherwise, and on the CPU, it runs
the masked-softmax einsum path, which also takes a window tensor.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..kernels import ops
from ..quant.int4 import approx_linear
from .config import ModelConfig

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
def _dense_init(gen: torch.Generator, shape, dtype, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(1, fan_in))
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms / rope / linear
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + w)


def linear(x: torch.Tensor, w: torch.Tensor, lut: torch.Tensor | None = None,
           *, backend: ops.Backend = "auto") -> torch.Tensor:
    """Matmul, optionally routed through the approximate-multiplier LUT."""
    if lut is not None:
        return approx_linear(x, w, lut, backend=backend)
    return torch.matmul(x, w)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin tables (..., head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd//2) — half-split rotation."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def init_attention(cfg: ModelConfig, gen: torch.Generator) -> Params:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.torch_dtype
    p = {
        "wq": _dense_init(gen, (D, H * hd), dt),
        "wk": _dense_init(gen, (D, Hkv * hd), dt),
        "wv": _dense_init(gen, (D, Hkv * hd), dt),
        "wo": _dense_init(gen, (H * hd, D), dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dt, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=dt, device=gen.device)
    return p


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(x, p["wq"]).reshape(B, S, H, hd)
    k = linear(x, p["wk"]).reshape(B, S, Hkv, hd)
    v = linear(x, p["wv"]).reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _masked_softmax_attn(q, k, v, q_pos, k_pos, window, k_valid=None,
                         f32_math: bool = True):
    """Einsum attention with causal and window masking.

    q (B, Sq, H, hd); k/v (B, Sk, Hkv, hd); q_pos (Sq,), k_pos (Sk,).
    ``window``: None, an int, or a 0-d tensor (-1 == global).  GQA
    repeats KV up to H heads.  Logits are float32 either way (products of
    bf16 values are exact in float32, as the reference's f32 accumulation);
    with ``f32_math`` off the probabilities round to ``v.dtype`` first.
    """
    H = q.shape[2]
    out_dtype = q.dtype
    Hkv = k.shape[2]
    if Hkv != H:
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = k_pos[None, :] <= q_pos[:, None]  # causal
    if window is not None:
        w = torch.as_tensor(window, device=q.device)
        in_window = k_pos[None, :] > q_pos[:, None] - w
        mask = mask & torch.where(w > 0, in_window, True)
    if k_valid is not None:
        mask = mask & k_valid[None, :]
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    if not f32_math:
        probs = probs.to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(out_dtype)


def attention_full(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,         # (B, S, D)
    window,                  # None | int | 0-d tensor (-1 = global)
    *,
    backend: ops.Backend = "auto",
) -> torch.Tensor:
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    pos = torch.arange(S, device=x.device)
    cos, sin = rope_tables(pos, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    use_flash = (ops.use_kernel(x, backend)
                 and (window is None or isinstance(window, int)))
    if use_flash:
        out = ops.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=True, window=window,
            backend=backend,
        ).transpose(1, 2)
    else:
        out = _masked_softmax_attn(q, k, v, pos, pos, window,
                                   f32_math=cfg.attn_f32)
    return linear(out.reshape(B, S, -1), p["wo"])


def decode_position(pos, device: torch.device) -> torch.Tensor:
    """The absolute position of a decode step as a one-element ``long``
    tensor on ``device``: a Python ``int`` is filled there (no copy from
    the host, so no synchronise), a 0-d or one-element tensor is
    reshaped.  Every value derived from it stays on the device, which is
    what lets a captured step replay at any position."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).long()
    return torch.full((1,), int(pos), dtype=torch.long, device=device)


def attention_decode(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                # (B, 1, D)
    cache: dict[str, torch.Tensor],  # {"k","v"}: (B, C, Hkv, hd)
    pos,                            # int | (1,) long tensor: the new token's
    #                                 absolute position
    window,                         # None | int — ring-buffer window if set
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One decode step of attention.  The cache is written in place, where
    the reference returns a new cache from ``dynamic_update_slice`` and
    relies on buffer donation to reuse the memory.  The slot is written
    through ``index_copy_`` with a one-element index: a 0-d tensor used
    as an index would read it back to the host."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(cfg, p, x)
    pos_t = decode_position(pos, x.device)
    cos, sin = rope_tables(pos_t, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k_new = apply_rope(k_new, cos[None], sin[None])

    C = cache["k"].shape[1]
    slot = pos_t % C if window is not None else pos_t
    cache["k"].index_copy_(1, slot, k_new)
    cache["v"].index_copy_(1, slot, v_new)

    idx = torch.arange(C, device=x.device)
    if window is not None:
        # ring buffer: slot i holds absolute position in (pos - C, pos]
        k_pos = torch.where(idx <= slot, pos_t - slot + idx,
                            pos_t - slot - C + idx)
        k_valid = (k_pos >= 0) & (k_pos > pos_t - C - 1)
    else:
        k_pos = idx
        k_valid = idx <= pos_t
    out = _masked_softmax_attn(q, cache["k"], cache["v"], pos_t, k_pos, None,
                               k_valid, f32_math=cfg.attn_f32)
    out = linear(out.reshape(B, 1, -1), p["wo"])
    return out, cache


# ---------------------------------------------------------------------------
# paged / per-row decode attention (continuous batching)
#
# Continuous batching mixes requests at different positions in one step,
# so these take ``pos`` as a (B,) tensor plus an ``active`` (B,) mask;
# global-attention KV lives in a shared page pool indexed by per-slot page
# tables (repro_torch.serving.kvcache).  Caches are written in place with
# ``index_copy_`` through flat row indices built on the device, so no value
# on the host depends on ``pos``, ``active`` or ``tables`` and the step can
# be captured once and replayed across joins, leaves and preemptions.
# ---------------------------------------------------------------------------
def _decode_attn_rows(q, k, v, mask, f32_math: bool = True):
    """Single-token attention with a per-row key mask.

    q (B, 1, H, hd); k/v (B, K, Hkv, hd); mask (B, K) bool -- True where
    row b may attend to key slot j.  The caller guarantees every row has
    at least one True (inactive rows see one masked-garbage slot, so the
    softmax never sees a row of ``-1e30`` only).  GQA repeats KV up to H
    heads; logits are float32 either way (products of bf16 values are
    exact in float32), and without ``f32_math`` the probabilities round to
    ``v.dtype`` first, as in the reference.
    """
    H = q.shape[2]
    out_dtype = q.dtype
    Hkv = k.shape[2]
    if Hkv != H:
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = torch.where(mask[:, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    if not f32_math:
        probs = probs.to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(out_dtype)


def _rows_rope(x: torch.Tensor, pos: torch.Tensor, head_dim: int,
               theta: float) -> torch.Tensor:
    """Per-row rope for single-token decode: x (B, 1, H, hd), pos (B,)."""
    cos, sin = rope_tables(pos, head_dim, theta)      # (B, hd//2)
    return apply_rope(x, cos[:, None], sin[:, None])


def attention_decode_ring(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                 # (B, 1, D)
    cache: dict[str, torch.Tensor],  # {"k","v"}: (B, C, Hkv, hd) per-slot ring
    pos: torch.Tensor,               # (B,) long: each slot's absolute position
    active: torch.Tensor,            # (B,) bool
    window: int,                     # ring capacity == attention window
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Sliding-window decode with per-row positions, the ring written in
    place.  Slot ``pos % C`` holds the newest token; a slot whose occupant
    just joined at ``pos=0`` masks out every stale ring entry the previous
    occupant left behind -- validity is derived from ``pos``, never from
    what the buffer happens to contain."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(cfg, p, x)
    q = _rows_rope(q, pos, cfg.hd, cfg.rope_theta)
    k_new = _rows_rope(k_new, pos, cfg.hd, cfg.rope_theta)

    C = cache["k"].shape[1]
    slot = pos % C
    rows = torch.arange(B, device=x.device)
    flat = rows * C + slot
    for name, new in (("k", k_new), ("v", v_new)):
        cache[name].view((B * C,) + cache[name].shape[2:]).index_copy_(
            0, flat, new[:, 0])

    idx = torch.arange(C, device=x.device)[None, :]   # (1, C)
    pos_c, slot_c = pos[:, None], slot[:, None]
    # ring slot i holds absolute position in (pos - C, pos]
    k_pos = torch.where(idx <= slot_c, pos_c - slot_c + idx,
                        pos_c - slot_c - C + idx)
    mask = (k_pos >= 0) & (k_pos > pos_c - C - 1)
    # inactive rows attend to exactly slot 0 (output discarded, but the
    # softmax must not see an empty row)
    mask = torch.where(active[:, None], mask, idx == 0)
    out = _decode_attn_rows(q, cache["k"], cache["v"], mask,
                            f32_math=cfg.attn_f32)
    out = linear(out.reshape(B, 1, -1), p["wo"])
    return out, cache


def _paged_write(pool: torch.Tensor, new_row: torch.Tensor, pos: torch.Tensor,
                 tables: torch.Tensor) -> None:
    """Write one new row a slot into the shared page pool, in place.

    pool (P+1, page_size, ...); new_row (B, ...); pos (B,) long; tables
    (B, T) long physical page ids.  Inactive slots carry all-scratch
    tables and ``pos=0``, so their writes all land on the scratch page's
    row 0.  ``index_copy_`` with duplicate indices is nondeterministic on
    CUDA (which duplicate wins is unspecified); that is harmless only
    because the scratch page is never read unmasked: an active row's
    table points there past its allocation, where ``j <= pos`` masks it,
    and an inactive row's output is discarded.
    """
    page_size = pool.shape[1]
    page = tables.gather(1, (pos // page_size)[:, None])[:, 0]
    flat = page * page_size + pos % page_size
    pool.view((-1,) + pool.shape[2:]).index_copy_(0, flat, new_row)


def _paged_read(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Gather each slot's pages back into a contiguous per-slot view:
    pool (P+1, page_size, ...) + tables (B, T) -> (B, T*page_size, ...)."""
    B, T = tables.shape
    v = pool.index_select(0, tables.reshape(-1))      # (B*T, page_size, ...)
    return v.reshape((B, T * pool.shape[1]) + pool.shape[2:])


def attention_decode_paged(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                 # (B, 1, D)
    cache: dict[str, torch.Tensor],  # {"kp","vp"}: (P+1, page_size, Hkv, hd)
    pos: torch.Tensor,               # (B,) long
    tables: torch.Tensor,            # (B, T) long physical page ids
    active: torch.Tensor,            # (B,) bool
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Global-attention decode over the shared page pool.  Each slot
    writes its new KV at ``table[pos // page_size], pos % page_size`` and
    attends over the gathered view of its own pages; positions a request
    has not written yet (stale KV from a freed request included) are
    masked by ``j <= pos``, and every table entry past a request's
    allocation is the scratch page, so page reuse needs no zeroing."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(cfg, p, x)
    q = _rows_rope(q, pos, cfg.hd, cfg.rope_theta)
    k_new = _rows_rope(k_new, pos, cfg.hd, cfg.rope_theta)

    _paged_write(cache["kp"], k_new[:, 0], pos, tables)
    _paged_write(cache["vp"], v_new[:, 0], pos, tables)

    k = _paged_read(cache["kp"], tables)              # (B, K, Hkv, hd)
    v = _paged_read(cache["vp"], tables)
    idx = torch.arange(k.shape[1], device=x.device)[None, :]   # logical positions
    mask = idx <= pos[:, None]
    mask = torch.where(active[:, None], mask, idx == 0)
    out = _decode_attn_rows(q, k, v, mask, f32_math=cfg.attn_f32)
    out = linear(out.reshape(B, 1, -1), p["wo"])
    return out, cache


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU)
# ---------------------------------------------------------------------------
def init_ffn(cfg: ModelConfig, gen: torch.Generator) -> Params:
    D, Fd = cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    return {
        "w1": _dense_init(gen, (D, Fd), dt),
        "w3": _dense_init(gen, (D, Fd), dt),
        "w2": _dense_init(gen, (Fd, D), dt),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each
    op rounding to ``x.dtype``: the reference's arithmetic.  In bf16 the
    fused ``F.silu`` (one rounding) differs from it in about a third of
    the elements, which flips W4A4 codes of the next matmul."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def ffn(cfg: ModelConfig, p: Params, x: torch.Tensor, lut=None, *,
        backend: ops.Backend = "auto") -> torch.Tensor:
    h = (silu(linear(x, p["w1"], lut, backend=backend))
         * linear(x, p["w3"], lut, backend=backend))
    return linear(h, p["w2"], lut, backend=backend)
