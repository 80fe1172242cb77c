"""Parameter / optimizer / batch / cache partition specs over the port's
trees.  Own copy of ``repro.parallel.specs``.

Weight sharding follows the 2-D scheme: the TP dimension (heads / ffn /
vocab) shards over ``model``; the other large dimension shards over
``data`` (FSDP / ZeRO-3: weights are gathered in the forward and their
gradients reduce-scattered in the backward).  Optimizer moments inherit
the parameter specs.  Every rule passes through the divisibility guard of
:class:`repro_torch.parallel.api.ShardingContext`.

The port keeps one dict per layer where the reference stacks the layers
on a leading axis (``params["layers"]``, ``"enc_layers"``,
``"dec_layers"``), so a layer's leaf gets the reference's spec without its
leading ``None``; MoE's ``shared`` list and the MLA, SSM and RWKV leaves
take the reference's rules by leaf name.
"""

from __future__ import annotations

from typing import Any

from ..models.config import ModelConfig, ShapeConfig
from .api import P, ShardingContext, mesh_axes, placements

# leaf-name -> logical axes, by array rank.
_IN_OUT = ("fsdp", "model")    # (d_in, d_out) projections
_OUT_IN = ("model", "fsdp")    # (d_out, d_in) / second projections
_BY_NAME: dict[str, tuple[str | None, ...]] = {
    "embed": ("model", "fsdp"),       # (vocab, d_model)
    "lm_head": _IN_OUT,               # (d_model, vocab)
    "wq": _IN_OUT, "wk": _IN_OUT, "wv": _IN_OUT, "wg": _IN_OUT,
    "wr": _IN_OUT, "ck": _IN_OUT, "cr": _IN_OUT, "win": _IN_OUT,
    "wdkv": _IN_OUT, "wuk": _IN_OUT, "wuv": _IN_OUT,
    "w1": _IN_OUT, "w3": _IN_OUT, "w_a": _IN_OUT, "wdt1": _IN_OUT,
    "wB": _IN_OUT, "wC": _IN_OUT,
    "wo": _OUT_IN, "w2": _OUT_IN, "cv": _OUT_IN, "wout": _OUT_IN,
    "w_b": _OUT_IN, "wdt2": _OUT_IN,
    "router": ("fsdp", None),
    "vis_proj": (None, "fsdp"),
}
# MoE expert stacks: expert-parallel (E over data) when E divides the data
# extent; otherwise FSDP over the d_model dim.
_MOE_3D_EP = {"w1": ("expert_fsdp", None, "model"),
              "w3": ("expert_fsdp", None, "model"),
              "w2": ("expert_fsdp", "model", None)}
_MOE_3D = {"w1": (None, "fsdp", "model"), "w3": (None, "fsdp", "model"),
           "w2": (None, "model", "fsdp")}
_LAYERS = ("layers", "enc_layers", "dec_layers")


def tree_map_with_names(fn, tree, names: tuple[str, ...] = ()):
    """Map ``fn(names, leaf)`` over a tree of dicts and lists; ``names``
    are the dict keys on the path (list indices are not names)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_names(fn, v, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_names(fn, v, names) for v in tree]
    return fn(names, tree)


def _leaf_spec(ctx: ShardingContext, names: tuple[str, ...], shape) -> P:
    name = names[-1] if names else ""
    core = tuple(shape)
    # a layer leaf is one row of the reference's stacked leaf: its rank
    # test counts the stacked axis, its spec drops the leading None
    stacked = any(n in _LAYERS for n in names)
    if len(core) + stacked < 2:
        return P()
    if len(core) == 3 and name in _MOE_3D:
        have = mesh_axes(ctx.mesh)
        ep_extent = 1
        for a in ctx.rules.get("expert_fsdp", ()):
            ep_extent *= have.get(a, 1)
        ep = ep_extent > 1 and core[0] % ep_extent == 0
        axes = (_MOE_3D_EP if ep else _MOE_3D)[name]
    elif name in _BY_NAME and len(core) == len(_BY_NAME[name]):
        axes = _BY_NAME[name]
    elif len(core) >= 2:
        axes = ("fsdp", "model") + (None,) * (len(core) - 2)
    else:
        axes = (None,) * len(core)
    return ctx.resolve(core, axes)


def param_specs(ctx: ShardingContext, params: Any) -> Any:
    """Parameter tree (tensors, fake tensors or anything with ``.shape``)
    -> :class:`P` tree of the same structure."""
    return tree_map_with_names(
        lambda names, leaf: _leaf_spec(ctx, names, leaf.shape), params)


def opt_specs(p_specs: Any) -> dict:
    """Optimizer state mirrors the parameter specs (f32 moments)."""
    return {"mu": p_specs, "nu": p_specs, "step": P()}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, ctx: ShardingContext) -> dict:
    dp = "batch"
    out: dict[str, P] = {}
    if shape.kind == "decode":
        out["tokens"] = ctx.resolve((shape.global_batch, 1), (dp, None))
    else:
        out["tokens"] = ctx.resolve((shape.global_batch, shape.seq_len), (dp, None))
    if cfg.family == "audio" and shape.kind != "decode":
        out["frames"] = ctx.resolve(
            (shape.global_batch, cfg.encoder.n_frames, cfg.d_model), (dp, None, None))
    if cfg.family == "vlm" and shape.kind != "decode":
        out["patches"] = ctx.resolve(
            (shape.global_batch, cfg.vision.n_patches, cfg.vision.d_vision),
            (dp, None, None))
    return out


def cache_specs(cfg: ModelConfig, caches: list, ctx: ShardingContext) -> list:
    """Decode-cache specs: batch over data when divisible; otherwise the
    cache sequence axis goes context-parallel over data (long_500k, B=1)."""

    def one(cache: dict) -> dict:
        specs = {}
        for k, leaf in cache.items():
            shape = tuple(leaf.shape)
            batch_div = ctx.resolve((shape[0],), ("batch",))[0] is not None
            seq_name = None if batch_div else "cache_seq"
            if k in ("k", "v", "xk", "xv"):
                specs[k] = ctx.resolve(shape, ("batch", seq_name, "model", None))
            elif k == "ckv":
                specs[k] = ctx.resolve(shape, ("batch", seq_name, "model"))
            elif k == "kr":
                specs[k] = ctx.resolve(shape, ("batch", seq_name, None))
            elif k == "ssm":
                specs[k] = ctx.resolve(shape, ("batch", "model", None))
            elif k == "wkv":
                specs[k] = ctx.resolve(shape, ("batch", "model", None, None))
            else:  # x_tm / x_cm and other small states
                specs[k] = ctx.resolve(shape, ("batch",) + (None,) * (len(shape) - 1))
        return specs

    return [one(c) for c in caches]


def named(mesh, spec_tree: Any) -> Any:
    """A :class:`P` tree -> a tree of DTensor placement lists on ``mesh``."""
    if isinstance(spec_tree, P):
        return placements(spec_tree, mesh)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    return [named(mesh, v) for v in spec_tree]
