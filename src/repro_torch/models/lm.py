"""Decoder-only language model of every family but the encoder–decoder
one (dense, MoE, MLA, VLM, hybrid attention + SSM, RWKV6): init,
teacher-forced forward and its loss, and one-token decode, fixed-batch
and paged.  The encoder–decoder family is :mod:`.encdec`.

Parameters are plain dicts of tensors with one dict per layer in
``params["layers"]`` (the reference stacks them on a leading axis for its
``lax.scan``; :func:`repro_torch.convert.params_from_jax` splits them).
The layer scan of the reference is a Python loop here.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from ..device import resolve_device
from ..kernels import ops
from ..parallel import fsdp_gather, shard
from ..precision.widths import width_from_lut
from . import layers as L
from .config import ModelConfig

Params = dict[str, Any]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r} is the encoder–decoder one; "
            "see repro_torch.models.encdec")


def window_schedule(cfg: ModelConfig) -> np.ndarray | int | None:
    """None = all-global; int = uniform window; array (L,) = per-layer
    (-1 marks a global layer)."""
    if cfg.local_global_every is not None:
        win = np.full((cfg.n_layers,), cfg.local_window, dtype=np.int32)
        win[cfg.local_global_every - 1 :: cfg.local_global_every] = -1
        return win
    if cfg.sliding_window is not None:
        return int(cfg.sliding_window)
    return None


def layer_window(win: np.ndarray | int | None, layer: int) -> int | None:
    """Layer ``layer``'s window from a :func:`window_schedule`: ``None``
    for a global layer, else an ``int``.  The reference's ``lax.scan``
    traces a per-layer window, so its local layers take the masked path;
    the port's loop knows each window on the host, so every layer of a
    schedule reaches the flash kernel, which masks as the masked path does
    (``k > q - window``)."""
    if isinstance(win, np.ndarray):
        return None if win[layer] < 0 else int(win[layer])
    return win


def init_lm(cfg: ModelConfig, seed: int = 0, *,
            device: str | torch.device = "cuda") -> Params:
    """Random weights from ``seed`` (a :class:`torch.Generator` on the
    target device), in ``cfg.dtype``; norms start at zero."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = cfg.torch_dtype

    layers = [_init_layer(cfg, gen) for _ in range(cfg.n_layers)]
    params: Params = {
        "embed": L._dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                               fan_in=cfg.d_model),
        "layers": layers,
        "ln_f": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    if cfg.vision is not None:
        params["vis_proj"] = L._dense_init(gen, (cfg.vision.d_vision, cfg.d_model), dt)
    return params


def _init_layer(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dt = cfg.torch_dtype
    p: Params = {"ln1": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
                 "ln2": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device)}
    if cfg.rwkv is not None:
        p["rwkv"] = L.init_rwkv(cfg, gen)
        return p
    p["attn"] = L.init_mla(cfg, gen) if cfg.mla is not None else L.init_attention(cfg, gen)
    if cfg.ssm is not None:
        p["ssm"] = L.init_ssm(cfg, gen)
    if cfg.moe is not None:
        p["moe"] = L.init_moe(cfg, gen)
    else:
        p["ffn"] = L.init_ffn(cfg, gen)
    return p


def _mlp(cfg: ModelConfig, lp: Params, h, lut, backend, *, dropless=False):
    """The layer's MLP: the MoE FFN (returning its aux loss; dropless in
    decode) or the dense one (aux 0)."""
    if cfg.moe is not None:
        return L.moe_ffn(cfg, lp["moe"], h, lut, dropless, backend=backend)
    return L.ffn(cfg, lp["ffn"], h, lut, backend=backend), None


def _block_full(cfg: ModelConfig, lp: Params, x, window, lut, backend):
    if cfg.rwkv is not None:
        h, _ = L.rwkv_time_mix(cfg, lp["rwkv"], L.rmsnorm(x, lp["ln1"], cfg.norm_eps))
        x = shard(x + h, "batch", None, None)
        h, _ = L.rwkv_channel_mix(cfg, lp["rwkv"], L.rmsnorm(x, lp["ln2"], cfg.norm_eps))
        return x + h, None

    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        attn_out = L.mla_attention_full(cfg, lp["attn"], h)
    else:
        attn_out = L.attention_full(cfg, lp["attn"], h, window, backend=backend)
    if cfg.ssm is not None:  # hybrid: a parallel SSM head fused with attention
        ssm_out, _ = L.ssm_mix(cfg, lp["ssm"], h)
        attn_out = 0.5 * (attn_out + ssm_out)
    # added site: the residual stream replicated over "model" between the
    # mixer and the MLP (GSPMD all-reduces the row-parallel product there;
    # DTensor would reduce-scatter it and then gather every MLP weight)
    x = shard(x + attn_out, "batch", None, None)
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    mlp_out, aux = _mlp(cfg, lp, h, lut, backend)
    return x + mlp_out, aux


def _head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, fsdp_gather(head)).float()


def check_device(params: Params, dev: torch.device) -> None:
    """Raise unless the parameters lie on ``dev``."""
    have = params["embed"].device
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"params lie on {have}, not on {dev}")


def to_device_luts(luts, device: torch.device):
    """A table, stack or mixed-width dict of them (numpy or tensor) as
    int32 tensors on ``device``."""
    if isinstance(luts, dict):
        return {int(b): to_device_luts(a, device) for b, a in luts.items()}
    return torch.as_tensor(luts, dtype=torch.int32, device=device)


def lut_depth(cfg: ModelConfig) -> int:
    """The deepest contraction a LUT routes in this model: an FFN's
    ``w2`` (K = d_ff) or its ``w1``/``w3`` (K = d_model); for MoE the
    shared experts' (the routed ones run exact); 0 for RWKV, which routes
    none."""
    if cfg.rwkv is not None:
        return 0
    if cfg.moe is not None:
        return max(cfg.d_model, cfg.moe.d_ff_expert) if cfg.moe.n_shared else 0
    return max(cfg.d_model, cfg.d_ff)


def check_lut_depth(cfg: ModelConfig, luts, *, backend: ops.Backend = "auto") -> None:
    """Refuse, before any launch, a table bound for the kernel whose
    width's int32 accumulator cannot hold this model's deepest
    LUT-routed product (``WidthSpec.max_k``: 29,140 at W8A8, so
    command-r-plus-104b's ``w2`` at K = 33,792 is refused there).  The
    kernel wrapper refuses such a call too, but only when it comes: a
    forward would have launched the layer's ``w1`` and ``w3`` first."""
    depth = lut_depth(cfg)
    leaves = luts.values() if isinstance(luts, dict) else (luts,)
    for t in leaves:
        if t is None or not ops.use_kernel(t, backend):
            continue
        spec = width_from_lut(t)
        if depth > spec.max_k:
            raise ValueError(
                f"{cfg.name}: a LUT-routed product of depth K = {depth} exceeds "
                f"the overflow-free int32 depth {spec.max_k} at width "
                f"{spec.bits}; the kernel route refuses it")


# aten ops whose outputs "dots" keeps: products without batch dimensions
# (a (..., K) x (K, N) matmul folds its leading axes into one mm), as
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable keeps; the
# attention's batched einsums (bmm) are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_layer(fn, remat: str):
    """``fn`` as a layer of the forward under a rematerialisation policy:
    ``"none"`` keeps every activation for the backward; ``"full"``
    recomputes the layer in the backward (``torch.utils.checkpoint``),
    as ``jax.checkpoint`` with ``nothing_saveable``; ``"dots"`` keeps the
    matmul outputs without batch dimensions and recomputes the rest.  No
    policy changes a value: the recomputation runs the same ops on the
    same inputs."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            _ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat {remat!r}; 'none', 'full' or 'dots'")


def forward_lm(
    cfg: ModelConfig,
    params: Params,
    batch: dict,
    *,
    lut=None,
    backend: ops.Backend = "auto",
    remat: str = "none",
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward.  Returns (logits (B, S_total, V) float32,
    aux), aux the MoE load-balancing loss summed over the layers (0 for
    the other families).

    ``batch['tokens']``: (B, S) integer tokens (numpy or tensor).  VLM
    batches add ``'patches'`` (B, P, d_vision), projected and prepended,
    so S_total = P + S.
    ``lut``: optional approximate-multiplier table — one (side, side)
    table shared by every layer, or a per-layer (n_layers, side, side)
    stack; side = 16 (W4A4) or 256 (W8A8).  A (256, 256) table bound
    for the kernel is read once per call to decide its kernel (W8A8 where
    it is composed from a tile, else the direct lookup,
    :func:`repro_torch.kernels.ops.route_luts`), and each layer carries
    its table's form to the launch.
    ``remat``: ``"none"``, ``"full"`` or ``"dots"``, applied to each layer
    (:func:`remat_layer`).
    """
    _check_family(cfg)
    block = remat_layer(_block_full, remat)
    dev = resolve_device(device)
    check_device(params, dev)
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    x = L.embed(params["embed"], tokens).to(cfg.torch_dtype)
    if cfg.vision is not None:
        # the projection accumulates in float32 and rounds once, as the
        # reference's einsum does (the CPU's bf16 matmul rounds otherwise)
        patches = torch.as_tensor(batch["patches"], device=dev).to(cfg.torch_dtype)
        pv = torch.matmul(patches.float(), fsdp_gather(params["vis_proj"]).float())
        x = torch.cat([pv.to(cfg.torch_dtype), x], dim=1)
    x = shard(x, "batch", None, None)

    win = window_schedule(cfg)
    lut_ = None
    if cfg.approx_mlp and lut is not None:
        lut_ = to_device_luts(lut, dev)
        check_lut_depth(cfg, lut_, backend=backend)
        lut_ = ops.route_luts(lut_, backend=backend)

    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for i, lp in enumerate(params["layers"]):
        lut_i = _layer_lut(lut_, i)
        x, aux_i = block(cfg, lp, x, layer_window(win, i), lut_i, backend)
        x = shard(x, "batch", None, None)
        if aux_i is not None:
            aux = aux + aux_i
    return shard(_head(cfg, params, x), "batch", None, "model"), aux


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits[:, t]`` (B, S, V) against
    ``tokens[:, t + 1]``."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    tgt = tokens[:, 1:].long()
    return -logp.gather(-1, tgt[..., None])[..., 0].mean()


def lm_loss(cfg: ModelConfig, params: Params, batch: dict, *, lut=None,
            backend: ops.Backend = "auto", remat: str = "none",
            device: str | torch.device = "cuda") -> torch.Tensor:
    """Next-token cross-entropy over the text positions (a VLM's patch
    prefix is left out), plus the MoE load-balancing loss."""
    logits, aux = forward_lm(cfg, params, batch, lut=lut, backend=backend,
                             remat=remat, device=device)
    n_prefix = cfg.vision.n_patches if cfg.vision is not None else 0
    tokens = torch.as_tensor(batch["tokens"], device=logits.device)
    return next_token_nll(logits[:, n_prefix:], tokens) + aux


# ---------------------------------------------------------------------------
# decode: per-layer caches, Python loop over layers
# ---------------------------------------------------------------------------
def init_decode_caches(cfg: ModelConfig, batch: int, seq_len: int, *,
                       device: str | torch.device = "cuda") -> list[Params]:
    """One cache per layer, sized by that layer's kind: ``{"k", "v"}``
    sized by its attention window, ``{"ckv", "kr"}`` for MLA's compressed
    cache, ``{"x_tm", "x_cm", "wkv"}`` for RWKV's recurrent state, and an
    ``"ssm"`` state beside attention for the hybrid family."""
    _check_family(cfg)
    dev = resolve_device(device)
    win = window_schedule(cfg)
    dt = cfg.torch_dtype

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    caches: list[Params] = []
    for layer in range(cfg.n_layers):
        if cfg.rwkv is not None:
            rw = cfg.rwkv
            H = cfg.d_model // rw.head_dim
            caches.append({"x_tm": zeros(batch, 1, cfg.d_model),
                           "x_cm": zeros(batch, 1, cfg.d_model),
                           "wkv": zeros(batch, H, rw.head_dim, rw.head_dim,
                                        dtype=torch.float32)})
            continue
        if cfg.mla is not None:
            c = {"ckv": zeros(batch, seq_len, cfg.mla.kv_lora_rank),
                 "kr": zeros(batch, seq_len, cfg.mla.qk_rope_head_dim)}
        else:
            w = layer_window(win, layer)
            slots = seq_len if w is None else min(w, seq_len)
            c = {"k": zeros(batch, slots, cfg.n_kv_heads, cfg.hd),
                 "v": zeros(batch, slots, cfg.n_kv_heads, cfg.hd)}
        if cfg.ssm is not None:
            c["ssm"] = zeros(batch, cfg.ssm.d_inner or cfg.d_model,
                             cfg.ssm.state_dim, dtype=torch.float32)
        caches.append(c)
    return caches


def _block_decode(cfg: ModelConfig, lp: Params, x, cache: Params, pos, window,
                  lut=None, backend: ops.Backend = "auto"):
    if cfg.rwkv is not None:
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        out, (x_tm, wkv) = L.rwkv_time_mix(cfg, lp["rwkv"], h,
                                            state=(cache["x_tm"], cache["wkv"]))
        x = shard(x + out, "batch", None, None)
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        out, x_cm = L.rwkv_channel_mix(cfg, lp["rwkv"], h, x_last=cache["x_cm"])
        # the carried state, written in place once every read of it is done
        cache["x_tm"].copy_(x_tm)
        cache["wkv"].copy_(wkv)
        cache["x_cm"].copy_(x_cm)
        return x + out

    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        attn_out, _ = L.mla_attention_decode(cfg, lp["attn"], h, cache, pos)
    else:
        attn_out, _ = L.attention_decode(cfg, lp["attn"], h, cache, pos, window)
    if cfg.ssm is not None:
        ssm_out, s = L.ssm_mix(cfg, lp["ssm"], h, state=cache["ssm"])
        cache["ssm"].copy_(s)
        attn_out = 0.5 * (attn_out + ssm_out)
    x = shard(x + attn_out, "batch", None, None)     # as in _block_full
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + _mlp(cfg, lp, h, lut, backend, dropless=True)[0]


def decode_step(
    cfg: ModelConfig,
    params: Params,
    caches: list[Params],
    tokens: torch.Tensor,   # (B, 1) int — the newest token
    pos,                    # its absolute position: int or (1,) tensor
    *,
    luts: torch.Tensor | dict[int, torch.Tensor] | None = None,
    width_map: tuple[int, ...] | None = None,
    backend: ops.Backend = "auto",
) -> tuple[torch.Tensor, list[Params]]:
    """One serving step: append the token at ``pos`` (caches are written
    in place) and return next-token logits (B, V) in float32.

    ``pos``: a Python ``int``, or a 0-d or one-element integer tensor on
    the model's device.  With a tensor no value on the host depends on
    the position, so the step can be captured once as a CUDA graph and
    replayed at every position (:class:`repro_torch.serving.engine.ServingEngine`
    does); both give the same logits bit for bit.

    ``luts``: a per-layer (L, side, side) stack, one (side, side) table
    shared by every layer, or a mixed-width dict ``{bits: (n_group, side,
    side)}`` with a ``width_map`` naming each layer's width: layer ``i``
    reads ``luts[width_map[i]]`` at its position among the layers of that
    width.  The tables must be tensors on the params' device, adopted by
    the caller (:func:`repro_torch.kernels.ops.route_luts`, which carries
    each (256, 256) table's kernel with it, so that no step reads a table
    back), as :class:`repro_torch.serving.engine.ServingEngine` does once
    per stack.
    """
    layers = _decode_layers(cfg, luts, width_map, "decode_step")
    pos = L.decode_position(pos, params["embed"].device)
    x = L.embed(params["embed"], tokens.long()).to(cfg.torch_dtype)
    x = shard(x, "batch", None, None)
    for (w, lut_i), lp, cache in zip(layers, params["layers"], caches):
        # added site: the residual replicated over "model" after each layer,
        # as the forward's is; left sharded, the next layer's products and
        # the logits' ran whole on every rank
        x = shard(_block_decode(cfg, lp, x, cache, pos, w, lut_i, backend),
                  "batch", None, None)
    return _head(cfg, params, x)[:, 0], caches


def _layer_lut(luts, i: int):
    """Layer ``i``'s table from a stack or a shared table, with its form
    where ``luts`` carries one (:class:`repro_torch.kernels.ops.RoutedLut`)."""
    if isinstance(luts, ops.RoutedLut):
        return luts.layer(i)
    return luts if luts is None or luts.ndim == 2 else luts[i]


def _decode_layers(cfg: ModelConfig, luts, width_map, caller: str) -> list:
    """Each layer's ``(window, table)`` for a decode step: the window is
    ``None`` (global) or an int, the table the layer's own from a stack, a
    shared table or a mixed-width dict (layer ``i`` reads
    ``luts[width_map[i]]`` at its position among the layers of that
    width), with its form where the stack carries one, or ``None``
    without an approximate MLP."""
    _check_family(cfg)
    win = window_schedule(cfg)
    luts_ = luts if cfg.approx_mlp else None
    leaves = luts_.values() if isinstance(luts_, dict) else (luts_,)
    if any(v is not None and not isinstance(v, (torch.Tensor, ops.RoutedLut))
           for v in leaves):
        raise TypeError(f"{caller} luts must be tensors on the model's "
                        "device; the engine moves a stack there once")
    if isinstance(luts_, dict) and (width_map is None
                                    or len(width_map) != cfg.n_layers):
        raise ValueError(
            f"a mixed-width luts dict needs a width_map with one entry "
            f"per layer (got {width_map!r} for {cfg.n_layers} layers)")
    out = []
    for i in range(cfg.n_layers):
        w = layer_window(win, i)
        if isinstance(luts_, dict):
            bits = width_map[i]
            lut_i = _layer_lut(luts_[bits], width_map[:i].count(bits))
        else:
            lut_i = _layer_lut(luts_, i)
        out.append((w, lut_i))
    return out


# ---------------------------------------------------------------------------
# paged decode: per-slot positions, shared page pools (continuous batching)
# ---------------------------------------------------------------------------
def init_paged_caches(cfg: ModelConfig, batch: int, n_pages: int,
                      page_size: int, max_len: int, *,
                      device: str | torch.device = "cuda") -> list[Params]:
    """Decode caches for continuous batching: global-attention layers
    share one ``(n_pages + 1, page_size, Hkv, hd)`` page pool each
    (``"kp"``, ``"vp"``; physical page 0 is the allocator's scratch page),
    MLA layers a pool of their compressed cache (``"ckvp"``: ``(n_pages +
    1, page_size, R)``, ``"krp"``: ``(..., rope_d)``), sliding-window
    layers a small per-slot ring (``"k"``, ``"v"``: ``(batch, min(window,
    max_len), Hkv, hd)``; their cache is already bounded by the window).
    Recurrent state (RWKV, SSM) cannot be paged or resumed from KV alone,
    so those families are refused, with the reference's words."""
    _check_family(cfg)
    if cfg.rwkv is not None or cfg.ssm is not None:
        raise ValueError(
            f"{cfg.name}: continuous batching pages KV caches; recurrent "
            f"state (rwkv/ssm) has no positional cache to page — use the "
            f"fixed-batch engine for this family")
    dev = resolve_device(device)
    win = window_schedule(cfg)
    dt = cfg.torch_dtype
    caches: list[Params] = []
    for layer in range(cfg.n_layers):
        if cfg.mla is not None:
            mla = cfg.mla
            caches.append({
                "ckvp": torch.zeros((n_pages + 1, page_size, mla.kv_lora_rank),
                                    dtype=dt, device=dev),
                "krp": torch.zeros((n_pages + 1, page_size, mla.qk_rope_head_dim),
                                   dtype=dt, device=dev)})
            continue
        w = layer_window(win, layer)
        if w is not None:
            shape = (batch, min(w, max_len), cfg.n_kv_heads, cfg.hd)
            caches.append({"k": torch.zeros(shape, dtype=dt, device=dev),
                           "v": torch.zeros(shape, dtype=dt, device=dev)})
        else:
            shape = (n_pages + 1, page_size, cfg.n_kv_heads, cfg.hd)
            caches.append({"kp": torch.zeros(shape, dtype=dt, device=dev),
                           "vp": torch.zeros(shape, dtype=dt, device=dev)})
    return caches


def _block_decode_paged(cfg: ModelConfig, lp: Params, x, cache: Params, pos,
                        tables, active, window, lut=None,
                        backend: ops.Backend = "auto"):
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        attn_out, _ = L.mla_attention_decode_paged(cfg, lp["attn"], h, cache,
                                                   pos, tables, active)
    elif "kp" in cache:
        attn_out, _ = L.attention_decode_paged(cfg, lp["attn"], h, cache, pos,
                                               tables, active)
    else:
        attn_out, _ = L.attention_decode_ring(cfg, lp["attn"], h, cache, pos,
                                              active, window)
    x = x + attn_out
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + _mlp(cfg, lp, h, lut, backend, dropless=True)[0]


def decode_step_paged(
    cfg: ModelConfig,
    params: Params,
    caches: list[Params],
    tokens: torch.Tensor,   # (B, 1) int -- each slot's newest token
    pos: torch.Tensor,      # (B,) long -- per-slot absolute positions
    active: torch.Tensor,   # (B,) bool -- which slots hold a live request
    tables: torch.Tensor,   # (B, T) long -- per-slot physical page tables
    *,
    luts: torch.Tensor | dict[int, torch.Tensor] | None = None,
    width_map: tuple[int, ...] | None = None,
    backend: ops.Backend = "auto",
) -> tuple[torch.Tensor, list[Params]]:
    """One continuous-batching step: every active slot advances one token
    at its own position; inactive slots compute padding rows whose cache
    writes land on the scratch page (page 0) and whose logits the host
    discards.  Caches are written in place; returns (logits (B, V)
    float32, caches).

    This is :func:`decode_step` with the batch-shared position replaced
    by per-slot tensors and the dense global-attention caches by page
    pools (:func:`init_paged_caches`).  ``pos``, ``active`` and ``tables``
    are tensors on the model's device, and no value on the host depends
    on them, so the step is captured once as a CUDA graph and replayed
    while requests join, leave and are preempted
    (:class:`repro_torch.serving.engine.PagedStaticStep`).  ``luts`` and
    ``width_map`` are :func:`decode_step`'s.
    """
    layers = _decode_layers(cfg, luts, width_map, "decode_step_paged")
    pos, tables = pos.long(), tables.long()
    x = L.embed(params["embed"], tokens.long()).to(cfg.torch_dtype)
    x = shard(x, "batch", None, None)
    for (w, lut_i), lp, cache in zip(layers, params["layers"], caches):
        x = _block_decode_paged(cfg, lp, x, cache, pos, tables, active, w,
                                lut_i, backend)
    return _head(cfg, params, x)[:, 0], caches
