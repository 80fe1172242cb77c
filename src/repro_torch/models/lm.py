"""Decoder-only language model of the dense family: init, teacher-forced
forward and one-token decode.

Parameters are plain dicts of tensors with one dict per layer in
``params["layers"]`` (the reference stacks them on a leading axis for its
``lax.scan``; :func:`repro_torch.convert.params_from_jax` splits them).
The layer scan of the reference is a Python loop here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from . import layers as L
from .config import ModelConfig

Params = dict[str, Any]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet")


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

    def zeros():
        return torch.zeros((cfg.d_model,), dtype=dt, device=dev)

    layers = [{"ln1": zeros(), "ln2": zeros(),
               "attn": L.init_attention(cfg, gen),
               "ffn": L.init_ffn(cfg, gen)} for _ in range(cfg.n_layers)]
    params: Params = {
        "embed": L._dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                               fan_in=cfg.d_model),
        "layers": layers,
        "ln_f": zeros(),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    return params


def _block_full(cfg: ModelConfig, lp: Params, x, window, lut, backend):
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    x = x + L.attention_full(cfg, lp["attn"], h, window, backend=backend)
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + L.ffn(cfg, lp["ffn"], h, lut, backend=backend)


def _head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, head).float()


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


def forward_lm(
    cfg: ModelConfig,
    params: Params,
    batch: dict,
    *,
    lut=None,
    backend: ops.Backend = "auto",
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward.  Returns (logits (B, S, V) float32, aux),
    with aux always 0 for the dense family.

    ``batch['tokens']``: (B, S) integer tokens (numpy or tensor).
    ``lut``: optional approximate-multiplier table — one (side, side)
    table shared by every layer, or a per-layer (n_layers, side, side)
    stack; side = 16 (W4A4) or 256 (W8A8).  A table bound for the kernel
    is checked once per call to hold non-negative entries (a W8A8 one
    through its tile, and to be composed).
    """
    _check_family(cfg)
    dev = resolve_device(device)
    check_device(params, dev)
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    x = params["embed"][tokens].to(cfg.torch_dtype)

    win = window_schedule(cfg)
    lut_ = None
    if cfg.approx_mlp and lut is not None:
        lut_ = to_device_luts(lut, dev)
        ops.check_luts(lut_, backend=backend)
    per_layer_lut = lut_ is not None and lut_.ndim == 3

    for i, lp in enumerate(params["layers"]):
        lut_i = lut_[i] if per_layer_lut else lut_
        x = _block_full(cfg, lp, x, layer_window(win, i), lut_i, backend)
    return _head(cfg, params, x), torch.zeros((), device=dev)


# ---------------------------------------------------------------------------
# decode: per-layer caches, Python loop over layers
# ---------------------------------------------------------------------------
def init_decode_caches(cfg: ModelConfig, batch: int, seq_len: int, *,
                       device: str | torch.device = "cuda") -> list[Params]:
    """One ``{"k", "v"}`` cache per layer, sized by its attention window."""
    _check_family(cfg)
    dev = resolve_device(device)
    win = window_schedule(cfg)
    caches: list[Params] = []
    for layer in range(cfg.n_layers):
        if isinstance(win, np.ndarray):
            w = int(win[layer])
            slots = seq_len if w < 0 else min(w, seq_len)
        elif isinstance(win, int):
            slots = min(win, seq_len)
        else:
            slots = seq_len
        shape = (batch, slots, cfg.n_kv_heads, cfg.hd)
        caches.append({"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
                       "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)})
    return caches


def _block_decode(cfg: ModelConfig, lp: Params, x, cache: Params, pos, window,
                  lut=None, backend: ops.Backend = "auto"):
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    attn_out, _ = L.attention_decode(cfg, lp["attn"], h, cache, pos, window)
    x = x + attn_out
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + L.ffn(cfg, lp["ffn"], h, lut, backend=backend)


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
    width.  The tables must be tensors on the params' device, adopted (and
    a W8A8 stack checked for composition) by the caller, as
    :class:`repro_torch.serving.engine.ServingEngine` does once per stack.
    """
    layers = _decode_layers(cfg, luts, width_map, "decode_step")
    pos = L.decode_position(pos, params["embed"].device)
    x = params["embed"][tokens.long()].to(cfg.torch_dtype)
    for (w, lut_i), lp, cache in zip(layers, params["layers"], caches):
        x = _block_decode(cfg, lp, x, cache, pos, w, lut_i, backend)
    return _head(cfg, params, x)[:, 0], caches


def _decode_layers(cfg: ModelConfig, luts, width_map, caller: str) -> list:
    """Each layer's ``(window, table)`` for a decode step: the window is
    ``None`` (global) or an int, the table the layer's own from a stack, a
    shared table or a mixed-width dict (layer ``i`` reads
    ``luts[width_map[i]]`` at its position among the layers of that
    width), or ``None`` without an approximate MLP."""
    _check_family(cfg)
    win = window_schedule(cfg)
    luts_ = luts if cfg.approx_mlp else None
    leaves = luts_.values() if isinstance(luts_, dict) else (luts_,)
    if any(v is not None and not isinstance(v, torch.Tensor) for v in leaves):
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
            lut_i = luts_[width_map[i]][width_map[:i].count(width_map[i])]
        elif luts_ is not None:
            lut_i = luts_[i] if luts_.ndim == 3 else luts_
        else:
            lut_i = None
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
    sliding-window layers keep a small per-slot ring (``"k"``, ``"v"``:
    ``(batch, min(window, max_len), Hkv, hd)``; their cache is already
    bounded by the window).  Families other than the dense one are
    refused, as the reference refuses recurrent state, which has no
    positional cache to page."""
    if cfg.family != "dense":
        raise ValueError(
            f"{cfg.name}: continuous batching pages the KV caches of the "
            f"dense family; family {cfg.family!r} is not ported")
    dev = resolve_device(device)
    win = window_schedule(cfg)
    dt = cfg.torch_dtype
    caches: list[Params] = []
    for layer in range(cfg.n_layers):
        w = (int(win[layer]) if isinstance(win, np.ndarray)
             else win if isinstance(win, int) else -1)
        if w > 0:
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
    if "kp" in cache:
        attn_out, _ = L.attention_decode_paged(cfg, lp["attn"], h, cache, pos,
                                               tables, active)
    else:
        attn_out, _ = L.attention_decode_ring(cfg, lp["attn"], h, cache, pos,
                                              active, window)
    x = x + attn_out
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + L.ffn(cfg, lp["ffn"], h, lut, backend=backend)


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
    x = params["embed"][tokens.long()].to(cfg.torch_dtype)
    for (w, lut_i), lp, cache in zip(layers, params["layers"], caches):
        x = _block_decode_paged(cfg, lp, x, cache, pos, tables, active, w,
                                lut_i, backend)
    return _head(cfg, params, x)[:, 0], caches
