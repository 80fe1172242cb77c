"""Layer primitives of every decoder-only family, as pure functions over
plain dicts of tensors (``init_*`` builds parameters, the apply functions
take ``(cfg, params, activations, ...)``), with the JAX package's layouts:
activations ``(B, S, D)``, heads ``(B, S, H, hd)``.  Beside GQA attention
and the SwiGLU FFN: MLA attention with its absorbed decode over a
compressed cache, the MoE FFN (blocked dispatch), the selective-scan SSM
mixer and RWKV6's time and channel mix.  Decode caches and recurrent
states are written in place, so a decode step can be captured once as a
CUDA graph.

Attention dispatch: ``attention_full`` sends CUDA tensors to the flash
kernel when the window is ``None`` or a Python int, as the reference
sends TPU arrays to its Pallas kernel; otherwise, and on the CPU, it runs
the masked-softmax einsum path, which also takes a window tensor.

Sharding: ``shard(...)`` / ``axis_extent(...)`` stand at the reference's
sites with its logical names; they do nothing outside
``repro_torch.parallel.activate(mesh)``.  Under a mesh the parameters are
DTensors and each weight is gathered over its FSDP axes before its
product (``fsdp_gather``, what GSPMD inserts).  Where GSPMD reshards
silently and DTensor raises or picks a layout that repeats a product on
every rank, an "added site" comment marks the constraint added here:
``split_heads`` and ``merge_heads`` around a head count the ``model``
extent does not divide (their gradients sliced back, ``reshard``), the
repeated KV heads, MLA's down-projection, the attention (the flash kernel
too) and the RWKV scan run on local shards (``on_shards``; the scan by
value columns where ``model`` does not divide its heads), the SSM
scan's inputs, the MoE dispatch's tokens, routing and picks, the
embedding lookup (``embed``), and cache writes
(``parallel.api.index_copy_``).  The LUT product runs on local shards in
:func:`repro_torch.quant.int4.approx_linear`.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..kernels import ops
from ..parallel import axis_extent, fsdp_gather, shard
from ..parallel.api import (gather_rows, index_copy_, is_dtensor, on_shards, reshard,
                            scatter_rows, select_on_shards)
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


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  Under a mesh the table is gathered over its FSDP
    axes and a DTensor one is looked up through ``F.embedding``, whose
    vocab-parallel rule DTensor has (its rules for indexing, and for the
    index's backward, fail on some layouts and versions): the same rows."""
    table = fsdp_gather(table)
    if is_dtensor(table):
        # the vocab-parallel rows summed here, not by whatever consumes them
        return shard(torch.nn.functional.embedding(tokens, table), "batch", None, None)
    return table[tokens]


def linear(x: torch.Tensor, w: torch.Tensor, lut: torch.Tensor | None = None,
           *, backend: ops.Backend = "auto") -> torch.Tensor:
    """Matmul, optionally routed through the approximate-multiplier LUT.
    Under a mesh the weight is gathered over its FSDP axes first."""
    w = fsdp_gather(w)
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


def split_heads(y: torch.Tensor, *heads: int) -> torch.Tensor:
    """(B, S, H * hd) -> (B, S, H, hd) for ``heads = (H, hd)``.  Under a
    mesh whose ``model`` extent does not divide H the last dim is gathered
    first: a ``model`` shard of it would split a head, which DTensor
    cannot unflatten (GSPMD reshards there silently).  Its gradient comes
    back sharded as the product's output was, so the weight gradient is
    not repeated on every ``model`` rank.  Outside a mesh context only the
    reshape runs."""
    B, S = y.shape[:2]
    if heads[0] % axis_extent("model"):
        y = reshard(y, "batch", None, None)
    return y.reshape(B, S, *heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H * hd), the inverse of :func:`split_heads`:
    under a mesh whose ``model`` extent does not divide H the merged value
    is held replicated, so that its gradient comes back in a layout
    DTensor can unflatten into heads, and is then sliced over ``model``,
    so that the output projection and its weight gradient run on local
    columns, as GSPMD runs them.  Outside a mesh context only the reshape
    runs."""
    B, S, H = x.shape[:3]
    y = x.reshape(B, S, -1)
    if H % axis_extent("model"):
        y = reshard(shard(y, "batch", None, None), "batch", None, "model")
    return y


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = split_heads(linear(x, p["wq"]), H, hd)
    k = split_heads(linear(x, p["wk"]), Hkv, hd)
    v = split_heads(linear(x, p["wv"]), Hkv, hd)
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
    The repeat is a broadcast view: the backward of ``repeat_interleave``
    is an ``index_add_``, whose atomics make a CUDA gradient vary from run
    to run, where the broadcast's is a sum over the copies.

    Under a mesh whose ``model`` extent divides neither H nor Hkv no head
    is split, and the reference's reason to repeat (a grouped layout would
    replicate the scores where ``model`` splits heads) does not hold: the
    query heads are grouped over the KV heads instead
    (:func:`_grouped_attention_core`), so no (B, Sk, H, hd) copy of the
    keys or values exists, where XLA fuses the reference's repeat into
    the products.  Outside a mesh the route is the repeat's.
    """
    H = q.shape[2]
    Hkv = k.shape[2]
    m = axis_extent("model")
    if Hkv != H and m > 1 and H % m and Hkv % m:
        # added site: every rank holds all heads of its batch shard
        q = shard(q, "batch", None, None, None)
        k = shard(k, "batch", None, None, None)
        v = shard(v, "batch", None, None, None)
        out = on_shards(_grouped_attention_core, q, k, v, q_pos, k_pos, window,
                        k_valid, f32_math)
        return shard(out, "batch", None, None, None)
    if Hkv != H:
        k = _repeat_heads(k, H // Hkv)
        v = _repeat_heads(v, H // Hkv)
    # added site: q laid out as k and v, and the attention itself run on
    # each rank's (batch, head) shards, so the logits are sharded as the
    # reference's constraint on them says (batch, model, -, -)
    q = shard(q, "batch", None, "model", None)
    k = shard(k, "batch", None, "model", None)
    v = shard(v, "batch", None, "model", None)
    out = on_shards(_attention_core, q, k, v, q_pos, k_pos, window, k_valid,
                    f32_math)
    return shard(out, "batch", None, "model", None)


def _attention_core(q, k, v, q_pos, k_pos, window, k_valid, f32_math):
    """:func:`_masked_softmax_attn` after the repeat: H query and H KV
    heads."""
    out_dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _attention_mask(q_pos, k_pos, window, k_valid, q.device)
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    if not f32_math:
        probs = probs.to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(out_dtype)


def _attention_mask(q_pos, k_pos, window, k_valid, device) -> torch.Tensor:
    """(Sq, Sk) bool: causal, within ``window`` where it is positive, and
    ``k_valid``."""
    mask = k_pos[None, :] <= q_pos[:, None]  # causal
    if window is not None:
        w = torch.as_tensor(window, device=device)
        in_window = k_pos[None, :] > q_pos[:, None] - w
        mask = mask & torch.where(w > 0, in_window, True)
    if k_valid is not None:
        mask = mask & k_valid[None, :]
    return mask


def _grouped_attention_core(q, k, v, q_pos, k_pos, window, k_valid, f32_math):
    """:func:`_attention_core` with the H query heads folded as (Hkv, rep)
    against the Hkv KV heads: k and v are upcast at Hkv heads and never
    repeated.  The scores are laid out (B, Hkv, rep, Sq, Sk) from the
    product on, so that no op copies them into another order.  The same
    sums as the repeat's, in another product layout, so equal to it
    within float32 rounding."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    out_dtype = q.dtype
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, Sq, Hkv, rep, hd).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(B, Hkv, rep * Sq, hd)
    logits = (qg @ _heads_first(k).transpose(-1, -2)).view(B, Hkv, rep, Sq, -1) * scale
    mask = _attention_mask(q_pos, k_pos, window, k_valid, q.device)
    logits = torch.where(mask[None, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    if not f32_math:
        probs = probs.to(v.dtype)
    out = probs.float().reshape(B, Hkv, rep * Sq, -1) @ _heads_first(v)
    out = out.view(B, Hkv, rep, Sq, -1).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, -1).to(out_dtype)


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, Hkv, d) -> float32 (B, Hkv, S, d), upcast and laid out for
    the batched product in one copy."""
    return x.transpose(1, 2).to(torch.float32, memory_format=torch.contiguous_format)


def _repeat_heads(x: torch.Tensor, rep: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv * rep, hd), head ``h`` repeated
    ``rep`` times in place, as ``repeat_interleave(rep, dim=2)``."""
    B, S, Hkv, hd = x.shape
    m = axis_extent("model")
    if Hkv % m and Hkv * rep % m == 0 and is_dtensor(x):
        # added site: where "model" divides the query heads but not the KV
        # heads, each rank takes the KV heads of its own query heads only;
        # repeating them all would hold every query head's keys and values
        # on every rank (GSPMD fuses the repeat into the product)
        heads = shard(torch.arange(Hkv * rep, device=x.device) // rep, "model")
        return select_on_shards(shard(x, "batch", None, None, None), 2, heads)
    out = x[:, :, :, None, :].expand(B, S, Hkv, rep, hd).reshape(B, S, Hkv * rep, hd)
    if Hkv % m:
        # added site: under a mesh whose "model" extent does not divide
        # Hkv, the repeated heads' gradient comes back replicated, which
        # DTensor can fold onto Hkv heads (GSPMD reshards there silently)
        out = shard(out, "batch", None, None, None)
    return out


def attention_full(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,         # (B, S, D)
    window,                  # None | int | 0-d tensor (-1 = global)
    *,
    backend: ops.Backend = "auto",
) -> torch.Tensor:
    S = x.shape[1]
    q, k, v = _qkv(cfg, p, x)
    pos = torch.arange(S, device=x.device)
    cos, sin = rope_tables(pos, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = shard(q, "batch", None, "model", None)
    k = shard(k, "batch", None, "model", None)
    use_flash = (ops.use_kernel(x, backend)
                 and (window is None or isinstance(window, int)))
    # either route is priced as the flash kernel's work, so that a cost
    # count reads the same on both (repro_torch.launch.analysis)
    with ops.attention_cost(q, k, window):
        if use_flash:
            if k.shape[2] % axis_extent("model"):
                # added site: the KV heads repeated up to the query heads,
                # so that each rank's query heads find theirs locally
                k = _repeat_heads(k, q.shape[2] // k.shape[2])
                v = _repeat_heads(v, q.shape[2] // v.shape[2])
            v = shard(v, "batch", None, "model", None)

            def flash(q, k, v):
                return ops.flash_attention(
                    q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                    v.transpose(1, 2).contiguous(), causal=True, window=window,
                    backend=backend,
                ).transpose(1, 2)

            # added site: the kernel on each rank's (batch, head) shards
            out = on_shards(flash, q, shard(k, "batch", None, "model", None), v)
        else:
            out = _masked_softmax_attn(q, k, v, pos, pos, window,
                                       f32_math=cfg.attn_f32)
    out = shard(out, "batch", None, "model", None)
    return linear(merge_heads(out), p["wo"])


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
    q, k_new, v_new = _qkv(cfg, p, x)
    pos_t = decode_position(pos, x.device)
    cos, sin = rope_tables(pos_t, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k_new = apply_rope(k_new, cos[None], sin[None])

    C = cache["k"].shape[1]
    slot = pos_t % C if window is not None else pos_t
    index_copy_(cache["k"], 1, slot, k_new)
    index_copy_(cache["v"], 1, slot, v_new)

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
    out = linear(merge_heads(out), p["wo"])
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
    k = shard(k, "batch", None, "model", None)
    v = shard(v, "batch", None, "model", None)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = torch.where(mask[:, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    if not f32_math:
        probs = probs.to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    out = shard(out, "batch", None, "model", None)
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
    out = linear(merge_heads(out), p["wo"])
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
    out = linear(merge_heads(out), p["wo"])
    return out, cache


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek): compressed KV cache + absorbed decode
# ---------------------------------------------------------------------------
def init_mla(cfg: ModelConfig, gen: torch.Generator) -> Params:
    mla = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    dt = cfg.torch_dtype
    return {
        "wq": _dense_init(gen, (D, H * qk), dt),
        "wdkv": _dense_init(gen, (D, mla.kv_lora_rank + mla.qk_rope_head_dim), dt),
        "wuk": _dense_init(gen, (mla.kv_lora_rank, H * mla.qk_nope_head_dim), dt),
        "wuv": _dense_init(gen, (mla.kv_lora_rank, H * mla.v_head_dim), dt),
        "wo": _dense_init(gen, (H * mla.v_head_dim, D), dt),
    }


def mla_attention_full(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Teacher-forced MLA: keys and values expanded from the compressed
    ``c_kv``, one rope head shared by every head.  The q/k head dim
    (nope + rope) differs from v's, so this runs the masked path, as the
    reference does."""
    mla = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope_d, vd, R = (mla.qk_nope_head_dim, mla.qk_rope_head_dim,
                           mla.v_head_dim, mla.kv_lora_rank)
    q = split_heads(linear(x, p["wq"]), H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    # added site: gathered for the split below, its gradient sliced back
    # to the product's shards (replicated, that weight gradient repeated)
    ckv_kr = reshard(linear(x, p["wdkv"]), "batch", None, None)
    c_kv, k_rope = ckv_kr[..., :R], ckv_kr[..., R:]          # (B,S,R), (B,S,rope_d)
    k_nope = split_heads(linear(c_kv, p["wuk"]), H, nope)
    v = split_heads(linear(c_kv, p["wuv"]), H, vd)

    pos = torch.arange(S, device=x.device)
    cos, sin = rope_tables(pos, rope_d, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)      # one shared head
    k_rope = k_rope.expand(B, S, H, rope_d)

    qfull = torch.cat([q_nope, q_rope], dim=-1)
    kfull = torch.cat([k_nope, k_rope], dim=-1)
    out = _masked_softmax_attn(qfull, kfull, v, pos, pos, None,
                               f32_math=cfg.attn_f32)
    return linear(merge_heads(out), p["wo"])


def _mla_absorbed(cfg: ModelConfig, p: Params, q_nope, q_rope, ckv, kr,
                  mask, out_dtype) -> torch.Tensor:
    """Attention over the compressed cache in float32: ``wuk`` folds into
    the query, ``wuv`` into the output.  q_nope (B, H, nope), q_rope
    (B, H, rope_d), ckv (B, C, R), kr (B, C, rope_d), mask (B or 1, C)."""
    mla = cfg.mla
    B, H = q_nope.shape[:2]
    nope, rope_d, vd, R = (mla.qk_nope_head_dim, mla.qk_rope_head_dim,
                           mla.v_head_dim, mla.kv_lora_rank)
    wuk = fsdp_gather(p["wuk"]).reshape(R, H, nope).float()
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope.float(), wuk)   # (B, H, R)
    scale = 1.0 / math.sqrt(nope + rope_d)
    ckv = ckv.float()
    logits = (torch.einsum("bhr,bcr->bhc", q_abs, ckv)
              + torch.einsum("bhd,bcd->bhc", q_rope.float(), kr.float())) * scale
    logits = torch.where(mask[:, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhc,bcr->bhr", probs, ckv)              # (B, H, R)
    wuv = fsdp_gather(p["wuv"]).reshape(R, H, vd).float()
    out = torch.einsum("bhr,rhv->bhv", ctx, wuv)
    out = out.reshape(B, 1, H * vd).to(out_dtype)
    return linear(out, p["wo"])


def _mla_new(cfg: ModelConfig, p: Params, x: torch.Tensor, cos, sin):
    """The decode token's query halves and its compressed cache row, the
    rope half rotated: q_nope (B, H, nope), q_rope (B, H, rope_d), c_new
    (B, R), kr_new (B, rope_d).  ``cos``/``sin`` broadcast as (B or 1,
    1, rope_d // 2)."""
    mla = cfg.mla
    H = cfg.n_heads
    nope, rope_d, R = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.kv_lora_rank
    q = split_heads(linear(x, p["wq"]), H, nope + rope_d)
    q_rope = apply_rope(q[..., nope:], cos, sin)
    ckv_kr = linear(x, p["wdkv"])
    c_new, kr_new = ckv_kr[..., :R], ckv_kr[..., R:]
    kr_new = apply_rope(kr_new[:, :, None, :], cos, sin)[:, :, 0]
    return q[:, 0, :, :nope], q_rope[:, 0], c_new[:, 0], kr_new[:, 0]


def mla_attention_decode(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                 # (B, 1, D)
    cache: dict[str, torch.Tensor],  # {"ckv": (B, C, R), "kr": (B, C, rope_d)}
    pos,                             # int | (1,) long tensor
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Absorbed-matrix MLA decode: attention runs directly over the
    compressed cache (DeepSeek-V2's serving form; the cache stays
    R + rope_d wide), written in place at the position."""
    pos_t = decode_position(pos, x.device)
    cos, sin = rope_tables(pos_t, cfg.mla.qk_rope_head_dim, cfg.rope_theta)
    q_nope, q_rope, c_new, kr_new = _mla_new(cfg, p, x, cos[None], sin[None])
    index_copy_(cache["ckv"], 1, pos_t, c_new[:, None])
    index_copy_(cache["kr"], 1, pos_t, kr_new[:, None])
    C = cache["ckv"].shape[1]
    valid = (torch.arange(C, device=x.device) <= pos_t)[None]
    out = _mla_absorbed(cfg, p, q_nope, q_rope, cache["ckv"], cache["kr"],
                        valid, x.dtype)
    return out, cache


def mla_attention_decode_paged(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                 # (B, 1, D)
    cache: dict[str, torch.Tensor],  # {"ckvp": (P+1, S, R), "krp": (P+1, S, rd)}
    pos: torch.Tensor,               # (B,) long
    tables: torch.Tensor,            # (B, T) long
    active: torch.Tensor,            # (B,) bool
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """:func:`mla_attention_decode` over a paged compressed cache: the
    ``(B, C, R)`` cache replaced by a shared page pool, per-slot
    positions, inactive rows attending to slot 0 only."""
    cos, sin = rope_tables(pos, cfg.mla.qk_rope_head_dim, cfg.rope_theta)
    q_nope, q_rope, c_new, kr_new = _mla_new(cfg, p, x, cos[:, None],
                                             sin[:, None])
    _paged_write(cache["ckvp"], c_new, pos, tables)
    _paged_write(cache["krp"], kr_new, pos, tables)
    ckv = _paged_read(cache["ckvp"], tables)           # (B, K, R)
    kr = _paged_read(cache["krp"], tables)             # (B, K, rope_d)
    idx = torch.arange(ckv.shape[1], device=x.device)[None, :]
    mask = idx <= pos[:, None]
    mask = torch.where(active[:, None], mask, idx == 0)
    out = _mla_absorbed(cfg, p, q_nope, q_rope, ckv, kr, mask, x.dtype)
    return out, cache


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU / GELU)
# ---------------------------------------------------------------------------
def init_ffn(cfg: ModelConfig, gen: torch.Generator, *, gelu: bool = False,
             d_ff: int | None = None) -> Params:
    """SwiGLU ``{w1, w3, w2}``, or with ``gelu`` the encoder–decoder
    family's two-matrix ``{w1, w2}``."""
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    if gelu:
        return {"w1": _dense_init(gen, (D, Fd), dt),
                "w2": _dense_init(gen, (Fd, D), dt)}
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
    return x * sigmoid(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, each op rounding to ``x.dtype``, as the
    reference's ``jax.nn.sigmoid`` computes it."""
    return 1.0 / (1.0 + torch.exp(-x))


_SQRT_2_OVER_PI = math.sqrt(2 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation
    ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3)))``, each op
    rounding to ``x.dtype`` and both constants rounded to it first, as the
    reference's weak-typed constants are.  ``F.gelu(approximate="tanh")``
    rounds once in bf16.  ``x**3`` is ``x * (x * x)``, the reference's
    ``integer_pow``."""
    c = torch.tensor(_SQRT_2_OVER_PI, dtype=torch.float64).to(x.dtype)
    k = torch.tensor(0.044715, dtype=torch.float64).to(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * (x * x))))))


def ffn(cfg: ModelConfig, p: Params, x: torch.Tensor, lut=None, *,
        backend: ops.Backend = "auto") -> torch.Tensor:
    """SwiGLU, or GELU when the dict has no ``w3``."""
    if "w3" in p:
        h = (silu(linear(x, p["w1"], lut, backend=backend))
             * linear(x, p["w3"], lut, backend=backend))
    else:
        h = gelu(linear(x, p["w1"], lut, backend=backend))
    h = shard(h, "batch", None, "model")
    return linear(h, p["w2"], lut, backend=backend)


# ---------------------------------------------------------------------------
# MoE FFN: sort-based blocked dispatch
# ---------------------------------------------------------------------------
def init_moe(cfg: ModelConfig, gen: torch.Generator) -> Params:
    mo = cfg.moe
    D, Fe, E = cfg.d_model, mo.d_ff_expert, mo.n_experts
    dt = cfg.torch_dtype
    p = {
        "router": _dense_init(gen, (D, E), torch.float32),
        "w1": _dense_init(gen, (E, D, Fe), dt, fan_in=D),
        "w3": _dense_init(gen, (E, D, Fe), dt, fan_in=D),
        "w2": _dense_init(gen, (E, Fe, D), dt, fan_in=Fe),
    }
    if mo.n_shared:
        p["shared"] = [init_ffn(cfg, gen, d_ff=Fe) for _ in range(mo.n_shared)]
    return p


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first on ties (a stable descending sort; ``torch.topk`` makes
    no promise about ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor, lut=None,
            dropless: bool = False, *,
            backend: ops.Backend = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, aux_loss), the Switch load-balancing loss.

    Blocked dispatch, as the reference's default: tokens sorted by expert
    (stably, so an expert keeps its earliest tokens) fill a block of
    ``C`` slots per expert, ``ceil(T·K/E · capacity_factor)``, or
    ``T·K`` when ``dropless`` (decode); tokens past a block are dropped.
    The experts run as batched products ``(E, C, D) x (E, D, F)``; only
    the shared experts route through ``lut``, as in the reference.  The
    ``ragged`` form computes the same sums dropless, so it runs as the
    dropless block here.

    Every shape is fixed by (T, K, E, C), nothing is read back to the
    host, and each token's K expert outputs are gathered back through the
    inverse permutation and summed in ascending expert order, the order
    the reference's scatter-add takes on the CPU: a decode step captures
    once and replays bit for bit.  The router runs in float32.

    Under a mesh the blocks are laid out as the reference's ``shard``
    calls name them (experts over ``expert`` when ``E`` divides it, else
    the slots over ``batch``), and no rank holds a whole block tensor or
    the picks: each gathers its own blocks' rows of the tokens
    (:func:`~repro_torch.parallel.api.gather_rows`), and the combine adds
    each rank's gated outputs into its tokens, summed and scattered back
    over ``batch`` (:func:`~repro_torch.parallel.api.scatter_rows`).
    """
    mo = cfg.moe
    B, S, D = x.shape
    T, K, E = B * S, mo.top_k, mo.n_experts
    # added site: the tokens over "batch", so that their gradient comes
    # back in a layout DTensor can unflatten to (B, S)
    flat = shard(x.reshape(T, D), "batch", None)
    dev = x.device

    logits = linear(flat.float(), p["router"])               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, K)                             # (T, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    # added site: the routing's integer bookkeeping replicated (T * K
    # indices), so that every index tensor derived from it agrees
    idx = shard(idx, None, None)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(dim=0)
    flat_e = idx.reshape(-1)                                  # (T*K,)
    ones = torch.ones((T * K,), dtype=torch.float32, device=dev)
    # the index sums and the scatter run out of place, which a DTensor
    # under a mesh needs (an in-place result keeps its input's layout)
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).index_add(
        0, flat_e, ones) / (T * K)
    aux = mo.aux_loss_weight * E * torch.sum(me * ce)

    order = torch.sort(flat_e, stable=True)[1]                # (T*K,)
    group_sizes = torch.zeros((E,), dtype=torch.long, device=dev).index_add(
        0, flat_e, torch.ones_like(flat_e))
    if dropless or mo.impl == "ragged":
        C = T * K
    else:
        C = max(1, math.ceil(T * K / E * mo.capacity_factor))
    starts = torch.cumsum(group_sizes, 0) - group_sizes      # (E,)
    slot_c = torch.arange(C, device=dev)[None, :]
    src = starts[:, None] + slot_c                            # (E, C) into order
    valid = slot_c < group_sizes[:, None]
    src = src.clamp(max=T * K - 1)
    pick = order[src]                                         # (E, C) into T*K
    rows = pick // K                                          # (E, C) token ids
    # expert parallelism when E divides the data axis (the classic MoE
    # all-to-all appears at the gather/scatter boundary); otherwise the
    # capacity axis stays data-parallel and expert weights stay FSDP
    ep = E % max(1, axis_extent("expert")) == 0 and axis_extent("expert") > 1
    blk = ("expert", None, None) if ep else (None, "batch", None)
    xs = gather_rows(flat, rows, *blk) * valid[..., None].to(flat.dtype)  # (E, C, D)
    xs = shard(xs, *blk)
    # the expert stacks gathered over FSDP, never over the expert axis
    w1, w3, w2 = (p[n] if ep else fsdp_gather(p[n]) for n in ("w1", "w3", "w2"))
    h1 = torch.bmm(xs, w1)
    h3 = torch.bmm(xs, w3)
    hs = shard(silu(h1) * h3, "expert" if ep else None, None if ep else "batch",
               "model")
    ys = torch.bmm(hs, w2)                                    # (E, C, D)
    if is_dtensor(ys):
        # each rank adds its own blocks' gated outputs into their tokens
        g_blk = torch.where(valid, gather_rows(gates.reshape(-1), pick, *blk[:2]), 0.0)
        vals = shard(ys, *blk).float() * g_blk[..., None]
        out = scatter_rows(vals, rows, T, "batch", None)
    else:
        # each (token, k) pick's place in its expert's block
        inv = torch.empty_like(order).scatter(
            0, order, torch.arange(T * K, device=dev))
        slot = inv - starts[flat_e]                           # (T*K,)
        kept = slot < C
        picked = ys[flat_e, slot.clamp(max=C - 1)].float()    # (T*K, D)
        contrib = torch.where(kept[:, None], picked * gates.reshape(-1, 1), 0.0)
        contrib = contrib.reshape(T, K, D).gather(
            1, idx.argsort(dim=-1)[..., None].expand(T, K, D))  # ascending expert
        out = contrib[:, 0]
        for k in range(1, K):
            out = out + contrib[:, k]

    out = out.reshape(B, S, D).to(x.dtype)
    for sp in p.get("shared", []):
        out = out + ffn(cfg, sp, x, lut, backend=backend)
    return out, aux


# ---------------------------------------------------------------------------
# RWKV6 time mix / channel mix (Finch: data-dependent decay)
# ---------------------------------------------------------------------------
def init_rwkv(cfg: ModelConfig, gen: torch.Generator) -> Params:
    rw = cfg.rwkv
    D = cfg.d_model
    hd = rw.head_dim
    H = D // hd
    dt = cfg.torch_dtype
    dev = gen.device

    def full(v, dtype=dt, shape=(D,)):
        return torch.full(shape, v, dtype=dtype, device=dev)

    p = {f"mix_{n}": full(0.5) for n in "rkvgw"}
    p.update({w: _dense_init(gen, (D, D), dt) for w in ("wr", "wk", "wv", "wg", "wo")})
    p.update({
        "w0": full(-6.0, torch.float32),
        "w_a": _dense_init(gen, (D, rw.decay_lora), dt),
        "w_b": _dense_init(gen, (rw.decay_lora, D), dt),
        "u": full(0.0, torch.float32, (H, hd)),
        "ln_x": full(0.0),
        # channel mix
        "cmix_k": full(0.5), "cmix_r": full(0.5),
        "ck": _dense_init(gen, (D, cfg.d_ff), dt),
        "cv": _dense_init(gen, (cfg.d_ff, D), dt),
        "cr": _dense_init(gen, (D, D), dt),
    })
    return p


def _rwkv_wkv_scan(r, k, v, w, u, state0):
    """r/k/v (B,S,H,hd) f32; w (B,S,H,hd) decay in (0,1); u (H,hd).

    state (B,H,hd,hd):  y_t = r_t · (state + u⊙k_t ⊗ v_t);
                        state' = w_t⊙state + k_t ⊗ v_t  (⊙ along the k-index)

    A loop over time in float32, as the reference's ``lax.scan``.
    """
    state = state0
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # (B,H,hd)
        kv = kt[..., :, None] * vt[..., None, :]              # (B,H,hd,hd)
        y = torch.matmul(rt[..., None, :], state + u[None, :, :, None] * kv)
        ys.append(y[..., 0, :])
        state = wt[..., None] * state + kv
    return torch.stack(ys, dim=1), state                      # (B,S,H,hd)


class _WKVScan(torch.autograd.Function):
    """:func:`_rwkv_wkv_scan` with a backward of its own, which keeps what
    the reference's ``lax.scan`` keeps: the inputs and one float32 state a
    step, where autograd over the loop keeps three (``kv``, ``state +
    u·kv`` and ``state``).  The forward runs the loop's ops in its order,
    so its values are the loop's bit for bit.  ``v`` and the states may
    hold a slice ``hv`` of the value columns: each column is independent.

    Backward, in reverse time, with ``g_t = r_t ⊗ dy_t`` and ``dS`` the
    gradient of the state after step ``t``::

        dr_t = (S_t + u⊙kv_t)·dy_t      dkv_t = dS + u⊙g_t  (-> dk_t, dv_t)
        dw_t = Σ_i dS⊙S_t               du   += Σ_{b,i} g_t⊙kv_t
        dS   <- w_t⊙dS + g_t
    """

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        B, S, H, hd = r.shape
        # one buffer each, written a step at a time: a list stacked at the
        # end would hold both at the peak
        states = state0.new_empty((B, S, H, hd, v.shape[-1]))
        ys = v.new_empty((B, S, H, v.shape[-1]))
        state = state0
        for t in range(S):
            states[:, t] = state
            rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
            kv = kt[..., :, None] * vt[..., None, :]
            y = torch.matmul(rt[..., None, :], state + u[None, :, :, None] * kv)
            ys[:, t] = y[..., 0, :]
            state = wt[..., None] * state + kv
        ctx.save_for_backward(r, k, v, w, u, states)
        return ys, state

    @staticmethod
    def backward(ctx, dy, d_state):
        r, k, v, w, u, states = ctx.saved_tensors
        dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, w))
        du = torch.zeros_like(u)
        uu = u[None, :, :, None]
        dS = d_state
        for t in reversed(range(r.shape[1])):
            st = states[:, t]
            rt, kt, vt, wt, dyt = r[:, t], k[:, t], v[:, t], w[:, t], dy[:, t]
            kv = kt[..., :, None] * vt[..., None, :]
            g = rt[..., :, None] * dyt[..., None, :]
            dr[:, t] = torch.matmul(st + uu * kv, dyt[..., :, None])[..., 0]
            dkv = dS + uu * g
            dk[:, t] = torch.matmul(dkv, vt[..., :, None])[..., 0]
            dv[:, t] = torch.matmul(kt[..., None, :], dkv)[..., 0, :]
            dw[:, t] = (dS * st).sum(-1)
            du += (g * kv).sum(-1).sum(0)
            dS = wt[..., None] * dS + g
        return dr, dk, dv, dw, du, dS


def wkv_scan(r, k, v, w, u, state0):
    """The WKV scan: :class:`_WKVScan` where autograd needs a gradient of
    it, else the plain loop, which holds no step's state (prefill, decode
    and the captured steps)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u, state0)):
        return _WKVScan.apply(r, k, v, w, u, state0)
    return _rwkv_wkv_scan(r, k, v, w, u, state0)


def _token_shift(x: torch.Tensor, x_last: torch.Tensor | None) -> torch.Tensor:
    """Each position's previous input: ``x_last`` (zeros if ``None``)
    for the first, then ``x`` shifted by one."""
    if x_last is None:
        x_last = torch.zeros_like(x[:, :1])
    return torch.cat([x_last, x[:, :-1]], dim=1)


def _rwkv_mix(p: Params, x: torch.Tensor, x_prev_last, H: int, hd: int):
    """The scan's inputs r, k, v and w (B, S, H, hd) float32 and the gate
    g: what the time mix builds before its scan, in a function of its own
    so that nothing else of it (the shifted input, the decay's low-rank
    product) outlives it.  The decay comes first: under a mesh its float32
    product is gathered whole, which then holds none of r, k and v beside
    it."""
    xprev = _token_shift(x, x_prev_last)

    def mixed(mu):
        return x + (xprev - x) * mu

    def heads(w):
        return split_heads(linear(mixed(p[f"mix_{w}"]), p[f"w{w}"]), H, hd).float()

    xw = mixed(p["mix_w"])
    dd = linear(torch.tanh(linear(xw, p["w_a"])), p["w_b"]).float()
    w = torch.exp(-torch.exp(p["w0"][None, None] + dd))      # (B,S,D) in (0,1)
    w = split_heads(w, H, hd)
    del xw, dd
    r, k, v = heads("r"), heads("k"), heads("v")
    g = silu(linear(mixed(p["mix_g"]), p["wg"]))
    return r, k, v, w, g


def rwkv_time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  state: tuple | None = None):
    """Returns (out, (x_last, wkv_state)).  ``state=None`` => zeros;
    decode passes the carried ``(x_tm, wkv)`` and S == 1."""
    rw = cfg.rwkv
    B, _, D = x.shape
    hd = rw.head_dim
    H = D // hd
    if state is None:
        x_prev_last = None
        wkv0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    else:
        x_prev_last, wkv0 = state
    r, k, v, w, g = _rwkv_mix(p, x, x_prev_last, H, hd)

    # added site: the scan's inputs with the time axis whole and the scan
    # run on each rank's shards, so that no step of the loop communicates:
    # by (batch, head) where ``model`` divides the heads, else by (batch,
    # value column) where it divides the head dim, with r, k, w and u
    # whole (each column of the state is independent), and the state laid
    # back out as the cache's wkv spec after
    m = axis_extent("model")
    if H % m and hd % m == 0:
        r, k, w = (shard(t, "batch", None, None, None) for t in (r, k, w))
        # its gradient whole again before it reaches the head split, whose
        # reshape some versions of DTensor refuse over a sharded last dim
        v = reshard(v, "batch", None, None, "model")
        wkv0 = shard(wkv0, "batch", None, None, "model")
        y, wkv = on_shards(wkv_scan, r, k, v, w, shard(p["u"], None, None), wkv0,
                           out_like=(v, wkv0))
        # the columns gathered once the scan's inputs are gone, in the
        # dtype the norm takes them in
        del r, k, v, w
        y = shard(y.to(x.dtype), "batch", None, None, None)
        wkv = shard(wkv, "batch", "model", None, None)
    else:
        r, k, v, w = (shard(t, "batch", None, "model", None) for t in (r, k, v, w))
        wkv0 = shard(wkv0, "batch", "model", None, None)
        y, wkv = on_shards(wkv_scan, r, k, v, w, shard(p["u"], "model", None),
                           wkv0, out_like=(r, wkv0))
    y = rmsnorm(merge_heads(y).to(x.dtype), p["ln_x"], cfg.norm_eps)
    out = linear(y * g, p["wo"])
    return out, (x[:, -1:], wkv)


def rwkv_channel_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     x_last: torch.Tensor | None = None):
    xprev = _token_shift(x, x_last)
    xk = x + (xprev - x) * p["cmix_k"]
    xr = x + (xprev - x) * p["cmix_r"]
    k = torch.relu(linear(xk, p["ck"]))
    out = sigmoid(linear(xr, p["cr"])) * linear(k * k, p["cv"])
    return out, x[:, -1:]


# ---------------------------------------------------------------------------
# SSM mixer (Mamba-style selective scan; hymba's parallel heads)
# ---------------------------------------------------------------------------
def init_ssm(cfg: ModelConfig, gen: torch.Generator) -> Params:
    sm = cfg.ssm
    D = cfg.d_model
    Di = sm.d_inner or D
    N = sm.state_dim
    dt = cfg.torch_dtype
    dev = gen.device
    return {
        "win": _dense_init(gen, (D, 2 * Di), dt),
        "wB": _dense_init(gen, (Di, N), dt),
        "wC": _dense_init(gen, (Di, N), dt),
        "wdt1": _dense_init(gen, (Di, sm.dt_rank), dt),
        "wdt2": _dense_init(gen, (sm.dt_rank, Di), dt),
        "A_log": torch.zeros((Di, N), dtype=torch.float32, device=dev),
        "Dskip": torch.ones((Di,), dtype=torch.float32, device=dev),
        "wout": _dense_init(gen, (Di, D), dt),
    }


def ssm_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
            state: torch.Tensor | None = None):
    """Selective scan, a loop over time in float32, as the reference's
    ``lax.scan``.  Returns (out, state); state (B, Di, N)."""
    sm = cfg.ssm
    B, S, D = x.shape
    Di = sm.d_inner or D
    N = sm.state_dim
    xz = linear(x, p["win"])
    xi, z = xz[..., :Di], xz[..., Di:]
    xi_f = xi.float()
    dt_ = linear(linear(xi, p["wdt1"]), p["wdt2"]).float()
    dt = torch.logaddexp(dt_, torch.zeros_like(dt_))           # softplus (B,S,Di)
    Bt = linear(xi, p["wB"]).float()                           # (B,S,N)
    Ct = linear(xi, p["wC"]).float()                           # (B,S,N)
    A = -torch.exp(p["A_log"])                                 # (Di,N)
    decay = torch.exp(dt[..., None] * A[None, None])           # (B,S,Di,N)
    contrib = (dt * xi_f)[..., None] * Bt[:, :, None, :]       # (B,S,Di,N)

    s = (torch.zeros((B, Di, N), dtype=torch.float32, device=x.device)
         if state is None else state)
    # added site: the scan's inputs with the time axis whole and the state
    # as the cache's ssm spec, so that no step of the loop communicates
    decay = shard(decay, "batch", None, "model", None)
    contrib = shard(contrib, "batch", None, "model", None)
    Ct = shard(Ct, "batch", None, None)
    s = shard(s, "batch", "model", None)
    ys = []
    for t in range(S):
        s = decay[:, t] * s + contrib[:, t]
        ys.append(torch.matmul(s, Ct[:, t, :, None])[..., 0])   # (B,Di)
    y = torch.stack(ys, dim=1) + p["Dskip"][None, None] * xi_f  # (B,S,Di)
    out = linear(y.to(x.dtype) * silu(z), p["wout"])
    return out, s
