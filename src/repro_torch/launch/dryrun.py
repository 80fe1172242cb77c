"""Multi-pod dry-run: prove every (arch x shape x mesh) cell partitions on
the production mesh and price its roofline, on any host, with no card.

Own counterpart of ``repro.launch.dryrun``, which forces 512 host devices
and lowers and compiles each cell with XLA.  Here "lower and compile" is
one run of the step on a fake world of ``mesh.size`` ranks in this
process (:func:`repro_torch.launch.mesh.fake_world`):

- tensors: every input is a meta tensor at full width (shape and dtype,
  no storage), so the dry-run never allocates and never touches a card.
  This is its design, not a retreat from the device.  Meta rather than
  ``FakeTensorMode``: DTensor's sharding propagation computes with small
  real tensors, which a fake mode turns fake and then cannot read;
- sharding: parameters, optimizer state, batch and caches are DTensors
  laid out by :func:`~repro_torch.parallel.specs.param_specs`,
  ``opt_specs``, ``batch_specs`` and ``cache_specs``; the model's
  ``shard`` annotations redistribute activations, and DTensor issues the
  collectives GSPMD would;
- the step: ``make_train_step(..., backend="ref")``,
  ``make_prefill_step(backend="ref")`` or ``make_decode_step``, run once
  under a :class:`~repro_torch.launch.analysis.CostCounter`, which counts
  per-device FLOPs, bytes and collectives (no kernel launches: the step
  runs the plain route, as the reference lowers ``backend="ref"``).

A record carries the reference's keys: status, the cell's meta, the
:class:`~repro_torch.launch.analysis.Roofline` terms, and a
``memory_analysis`` a device with ``argument_size_in_bytes`` (the local
shard bytes of every input), ``output_size_in_bytes`` (of every output,
arguments updated in place included, as XLA counts donated outputs) and
``temp_size_in_bytes``: the peak of the local bytes the step allocates
and holds at once, arguments and outputs left out
(:meth:`~repro_torch.launch.analysis.CostCounter.temp_bytes`; a meta
tensor has a storage with a size, which lives and dies as on a card).
XLA's ``generated_code_size_in_bytes`` has no counterpart: an eager step
generates no code.  A depth-extrapolated cell adds ``memory_depths``, the
depths of the runs its memory comes from (:func:`memory_depths`).
``lower_s`` is the time to lay out the inputs, ``compile_s`` the step's
run, and ``wall_s`` the cell's whole time.  A failing cell is recorded
as ``status: error`` with its traceback and counted, never swallowed.

The hill-climb's knobs are the reference's: ``attn_bf16`` runs attention
in the model's dtype (``attn_f32=False``), ``rules_override`` replaces
logical-axis rules after the decode rule, ``remat`` and
``microbatches`` pass to the train step, and ``run_cell``'s ``tag``
suffixes the record's file name (``__<tag>``).

Run: ``PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b
--shape decode_32k`` (``--all`` for every cell, ``--multi-pod`` for
2x16x16).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import functools
from contextlib import contextmanager, nullcontext

import numpy as np
import torch
import torch.distributed as dist

from .. import parallel
from ..configs import ARCH_IDS, get_config
from ..models import init_caches, init_model
from ..models.config import SHAPES, ModelConfig, ShapeConfig
from ..parallel.api import P
from ..parallel.specs import batch_specs, cache_specs, named, opt_specs, param_specs
from ..train import OptimizerConfig, init_opt_state
from ..train.optim import tree_leaves, tree_map
from ..train.step import make_decode_step, make_prefill_step, make_train_step
from . import analysis
from .mesh import fake_world, make_production_mesh, production_shape

def replace_layers(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """Same config with a different depth (encoder scales along for
    enc-dec).  Used by the depth extrapolation."""
    kw: dict = {"n_layers": n_layers}
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=n_layers)
    return dataclasses.replace(cfg, **kw)


def cell_is_skipped(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    """Returns a skip reason or None.  long_500k needs sub-quadratic
    attention (bounded KV state): run for SSM / hybrid / windowed archs,
    skip for pure full-attention archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "long_500k skipped: pure full-attention arch (dense 500k KV)"
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_structs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((B, S), torch.int32)}
    if cfg.family == "audio":
        out["frames"] = _meta((B, cfg.encoder.n_frames, cfg.d_model), torch.float32)
    if cfg.family == "vlm":
        out["patches"] = _meta((B, cfg.vision.n_patches, cfg.vision.d_vision),
                               torch.float32)
    return out


def _as_meta(tree):
    return tree_map(lambda t: _meta(t.shape, t.dtype), tree)


def input_specs(arch: str, shape_name: str, cfg: ModelConfig | None = None,
                shape: ShapeConfig | None = None) -> dict:
    """Meta-tensor stand-ins for every model input of this cell: the
    port's own ``init_model`` / ``init_caches`` run under a fake mode, so
    nothing is allocated at any width."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    with FakeTensorMode():
        params = init_model(cfg, 0, device="cpu")
        caches = (init_caches(cfg, shape.global_batch, shape.seq_len, device="cpu")
                  if shape.kind == "decode" else None)
    params = _as_meta(params)
    if shape.kind == "train":
        return {"params": params, "opt": _as_meta(init_opt_state(params)),
                "batch": batch_structs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": params, "batch": batch_structs(cfg, shape)}
    return {"params": params, "caches": _as_meta(caches),
            "tokens": _meta((shape.global_batch, 1), torch.int32),
            "pos": _meta((), torch.int32)}


def _distribute(tree, layout, mesh):
    """A tree of meta tensors as DTensors with the placements of ``layout``
    (a tree of placement lists, :func:`~repro_torch.parallel.specs.named`)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: _distribute(v, layout[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_distribute(v, p, mesh) for v, p in zip(tree, layout)]
    return distribute_tensor(tree, mesh, layout)


@contextmanager
def _greedy_plans():
    """Redistributions planned greedily.  Where a layout has strided
    shards or a non-default shard order DTensor plans with a shortest-path
    search over mesh states, for every candidate strategy it prices; on a
    three-axis mesh that search takes minutes an op.  The greedy plan is
    DTensor's own default elsewhere; a spec it cannot decode goes back to
    the search."""
    from torch.distributed.tensor import _redistribute as R

    search = R._gen_transform_infos

    @functools.cache
    def plan(src, dst, use_graph_based_transform=None):
        try:
            return R.get_redistribute_planner(
                src.device_mesh, src.tensor_meta).generate_greedy_transform_infos(src, dst)
        except Exception:
            return search(src, dst, use_graph_based_transform)

    R._gen_transform_infos = plan
    try:
        yield
    finally:
        R._gen_transform_infos = search


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               remat: str = "full", microbatches: int = 1,
               cfg: ModelConfig | None = None, shape: ShapeConfig | None = None,
               mesh_dims: tuple[int, ...] | None = None, run: bool = True,
               log_ops: bool = False, attn_bf16: bool = False,
               rules_override: dict | None = None):
    """Lay out the cell's inputs on the mesh and, with ``run``, run its
    step once under a cost counter.  Returns (counter or None, meta dict).

    ``mesh_dims`` replaces the production mesh's extents (same axis
    names), for small worlds in tests.  The fake world of the mesh's size
    is started here unless a process group of that size is active."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = cfg if cfg is not None else get_config(arch)
    if attn_bf16:
        cfg = dataclasses.replace(cfg, attn_f32=False)
    shape = shape if shape is not None else SHAPES[shape_name]
    dims, _ = production_shape(multi_pod, mesh_dims)
    chips = int(np.prod(dims))
    specs = input_specs(arch, shape_name, cfg, shape)

    # decode wants weights replicated across `data` and sharded over
    # `model` only (TP): FSDP all-gathers per token are pure overhead.
    # Keep FSDP only when a TP-only shard won't fit a card (104B).
    rules: dict[str, tuple[str, ...]] = {}
    pbytes = _nbytes(specs["params"])
    if shape.kind == "decode" and pbytes / dims[-1] <= 10e9:
        rules["fsdp"] = ()
        rules["expert_fsdp"] = ()
    if rules_override:
        rules.update(rules_override)

    world = (nullcontext() if dist.is_initialized() else fake_world(chips))
    planner = _greedy_plans() if len(dims) == 3 else nullcontext()
    # each cell starts with DTensor's sharding-propagation cache empty: an
    # entry another cell left with the same shapes gets compared with this
    # one's, and some versions compare vocab-parallel placements by their
    # mask tensors, which meta tensors cannot do
    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
    counter = None
    with world, planner:
        mesh = make_production_mesh(multi_pod=multi_pod, dims=mesh_dims)
        with parallel.activate(mesh, rules) as ctx:
            t0 = time.perf_counter()
            p_specs = param_specs(ctx, specs["params"])
            params = _distribute(specs["params"], named(mesh, p_specs), mesh)
            B = shape.global_batch
            if shape.kind == "train":
                o_specs = opt_specs(p_specs)
                args = (params, _distribute(specs["opt"], named(mesh, o_specs), mesh),
                        _distribute(specs["batch"],
                                    named(mesh, batch_specs(cfg, shape, ctx)), mesh))
                step = make_train_step(cfg, OptimizerConfig(), remat=remat,
                                       microbatches=microbatches, backend="ref")
                model_flops = analysis.model_flops_train(
                    cfg.n_active_params(), B * shape.seq_len)
            elif shape.kind == "prefill":
                args = (params, _distribute(specs["batch"],
                                            named(mesh, batch_specs(cfg, shape, ctx)),
                                            mesh))
                step = make_prefill_step(cfg, backend="ref")
                model_flops = analysis.model_flops_decode(
                    cfg.n_active_params(), B * shape.seq_len)
            else:  # decode
                c_specs = cache_specs(cfg, specs["caches"], ctx)
                tok_spec = ctx.resolve((B, 1), ("batch", None))
                args = (params,
                        _distribute(specs["caches"], named(mesh, c_specs), mesh),
                        _distribute(specs["tokens"], named(mesh, tok_spec), mesh),
                        _distribute(specs["pos"], named(mesh, P()), mesh))
                step = make_decode_step(cfg)
                model_flops = analysis.model_flops_decode(cfg.n_active_params(), B)
            arg_bytes = analysis.local_bytes(args)
            t_lower = time.perf_counter() - t0
            t0 = time.perf_counter()
            out_bytes = temp_bytes = None
            if run:
                counter = analysis.CostCounter(log_ops=log_ops)
                with implicit_replication(), counter:
                    out = step(*args)
                    if shape.kind != "train":
                        # the reference's out_shardings for the logits
                        logits = out if shape.kind == "prefill" else out[0]
                        logits = parallel.shard(logits, "batch", "model")
                        out = logits if shape.kind == "prefill" else (logits, out[1])
                out_bytes = analysis.local_bytes(out)
                temp_bytes = counter.temp_bytes(out)
            t_run = time.perf_counter() - t0

    param_bytes = _nbytes(specs["params"])
    if shape.kind == "decode":
        # minimum HBM traffic per decode step: weights once + cache once
        model_bytes = 2.0 * cfg.n_active_params() + _nbytes(specs["caches"])
    elif shape.kind == "train":
        # params fwd+bwd (bf16), f32 grads r/w, two f32 moments r/w, param upd
        model_bytes = 30.0 * cfg.n_params()
    else:  # prefill
        model_bytes = 2.0 * cfg.n_active_params()
    meta = {
        "arch": arch, "shape": shape.name, "mesh": "x".join(map(str, dims)),
        "chips": chips, "lower_s": round(t_lower, 1), "compile_s": round(t_run, 1),
        "model_flops": model_flops, "model_bytes": model_bytes,
        "param_bytes": param_bytes,
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": temp_bytes,
    }
    return counter, meta


def _raw_stats(counter) -> tuple[float, float, float, dict]:
    return (counter.flops, counter.bytes, counter.collectives.wire_bytes_total,
            dict(counter.collectives.counts))


_MEMORY = ("output_size_in_bytes", "temp_size_in_bytes")


def scan_corrected_stats(arch: str, shape_name: str, *, multi_pod: bool,
                         remat: str, microbatches: int,
                         cfg: ModelConfig | None = None,
                         shape: ShapeConfig | None = None,
                         mesh_dims: tuple[int, ...] | None = None,
                         attn_bf16: bool = False,
                         rules_override: dict | None = None,
                         ) -> tuple[float, float, float, dict, dict]:
    """Run the cell at depths 1 and 2, take the per-layer delta and
    extrapolate to the full depth, as the reference does.  The reference
    needs it because XLA counts a rolled layer scan once; eager PyTorch
    has no rolled scan, and here the extrapolation bounds the dry-run's
    time: a full-depth train step on DTensor takes minutes, the time
    scans of RWKV6 and the hybrid SSM far longer.  Every layer of a model
    runs the same ops (local and global layers differ in mask values
    only), so one delta holds for all.  Collective counts are those of
    the depth-2 run.

    The last item holds the output and temporary bytes, as
    ``memory_analysis`` keys, from the depths :func:`memory_depths`
    names.  Output bytes grow by a layer's parameters at every depth.
    The temporary peak is a maximum over the step's timeline, and where
    it lies can move with depth: command-r-plus-104b's ``train_4k`` with
    4 microbatches peaks in the embedding's backward at depths 1 to 3
    and in the saved activations from depth 4 on, so depths 1 and 2
    would miss most of its peak at 64 layers.  So the memory comes from a
    run at the full depth, seconds to a minute on meta tensors, except
    where a layer loops over time steps."""
    cfg = cfg if cfg is not None else get_config(arch)
    L = cfg.n_layers

    def stats_at(depth: int):
        c, meta = lower_cell(arch, shape_name, multi_pod=multi_pod, remat=remat,
                             microbatches=microbatches, cfg=replace_layers(cfg, depth),
                             shape=shape, mesh_dims=mesh_dims, attn_bf16=attn_bf16,
                             rules_override=rules_override)
        flops, byts, wire, counts = _raw_stats(c)
        return [flops, byts, wire, *(meta[k] for k in _MEMORY)], counts

    (s1, _), (s2, counts) = stats_at(1), stats_at(2)
    f1, f2 = np.array(s1, dtype=float), np.array(s2, dtype=float)
    per_layer = np.maximum(f2 - f1, 0.0)
    total = np.maximum(f2 + (L - 2) * per_layer, 0.0)
    mem = {k: int(round(v)) for k, v in zip(_MEMORY, total[3:])}
    if memory_depths(cfg) == [L] and L > 2:
        _, meta = lower_cell(arch, shape_name, multi_pod=multi_pod, remat=remat,
                             microbatches=microbatches, cfg=cfg, shape=shape,
                             mesh_dims=mesh_dims, attn_bf16=attn_bf16,
                             rules_override=rules_override)
        mem = {k: meta[k] for k in _MEMORY}
    return float(total[0]), float(total[1]), float(total[2]), counts, mem


def memory_depths(cfg: ModelConfig) -> list[int]:
    """The depths whose runs give an extrapolated cell's memory: the full
    depth, or 1 and 2 (extrapolated) where a layer runs a Python loop
    over time steps (RWKV6, the hybrid SSM), whose full-depth train and
    prefill steps take hours on meta tensors."""
    return [1, 2] if cfg.rwkv is not None or cfg.ssm is not None else [cfg.n_layers]


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
             save_hlo: bool = False, remat: str = "full",
             microbatches: int = 1, roofline: bool = True,
             attn_bf16: bool = False, rules_override: dict | None = None,
             tag: str = "",
             cfg: ModelConfig | None = None,
             shape: ShapeConfig | None = None,
             mesh_dims: tuple[int, ...] | None = None) -> dict:
    """One cell -> its record, also written to ``out_dir`` (with ``tag``,
    under a file name suffixed ``__<tag>``).  Train and prefill cells
    with ``roofline`` lay their full-depth inputs out and run at depths 1
    and 2 (:func:`scan_corrected_stats`); the others run once at full
    depth."""
    t_cell = time.perf_counter()
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    mesh_name = "x".join(map(str, production_shape(multi_pod, mesh_dims)[0]))
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}{suffix}.json")

    reason = cell_is_skipped(cfg, shape)
    if reason:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "reason": reason}
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    kw = dict(multi_pod=multi_pod, remat=remat, microbatches=microbatches,
              cfg=cfg, shape=shape, mesh_dims=mesh_dims, attn_bf16=attn_bf16,
              rules_override=rules_override)
    try:
        extrapolate = shape.kind in ("train", "prefill") and roofline
        counter, meta = lower_cell(arch, shape_name, run=not extrapolate,
                                   log_ops=save_hlo, **kw)
        mem = {"argument_size_in_bytes": meta.pop("argument_size_in_bytes")}
        mem.update((k, meta.pop(k)) for k in _MEMORY)
        if extrapolate:
            flops, byts, wire, counts, full = scan_corrected_stats(arch, shape_name, **kw)
            mem.update(full)
            meta["compile_s"] = None
            meta["memory_depths"] = memory_depths(cfg)
        else:
            flops, byts, wire, counts = _raw_stats(counter)
        roof = analysis.Roofline(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=meta["chips"],
            hlo_flops=flops, hlo_bytes=byts, wire_bytes=wire,
            model_flops=meta["model_flops"], bytes_per_device=None,
            collectives=counts, model_bytes=meta["model_bytes"],
        )
        rec = {"status": "ok", **meta, **roof.as_dict(), "memory_analysis": mem}
        if save_hlo and counter is not None:
            with open(out_path.replace(".json", ".ops.txt"), "w") as f:
                f.write("\n".join(counter.log))
    except Exception as e:  # a failing cell is a bug — record and surface it
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    rec["wall_s"] = round(time.perf_counter() - t_cell, 1)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write the op log the cost counter saw (.ops.txt)")
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-roofline", action="store_true",
                    help="one full-depth run, no depth extrapolation (the "
                         "multi-pod sweep; the roofline table is single-pod)")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str, bool]] = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                cells.append((arch, shape, args.multi_pod))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells.append((args.arch, args.shape, args.multi_pod))

    failures = 0
    for arch, shape, mp in cells:
        rec = run_cell(arch, shape, multi_pod=mp, out_dir=args.out,
                       save_hlo=args.save_hlo, remat=args.remat,
                       microbatches=args.microbatches,
                       roofline=not args.no_roofline)
        status = rec["status"]
        msg = ""
        if status == "ok":
            msg = (f"flops={rec['hlo_flops']:.3e} wire={rec['wire_bytes']:.3e} "
                   f"bottleneck={rec['bottleneck']} "
                   f"roofline={rec['roofline_fraction']:.3f}")
        elif status == "error":
            failures += 1
            msg = rec["error"][:160]
        else:
            msg = rec["reason"]
        print(f"[{status:7s}] {arch:24s} {shape:12s} "
              f"{'2x16x16' if mp else '16x16':8s} ({rec.get('wall_s', 0.0):5.1f}s) {msg}",
              flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
