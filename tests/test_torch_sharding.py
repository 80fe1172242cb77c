"""PyTorch port: logical-axis sharding (``repro_torch.parallel``), the
meshes of ``repro_torch.launch.mesh`` and the roofline half of
``repro_torch.launch.analysis``, against the JAX package's.

Spec resolution runs on the same stand-in mesh in both packages.  The
parameter, batch and cache specs of every reference config are compared
at full width, leaf for leaf (the port keeps one dict a layer where the
reference stacks the layers, so a layer leaf holds the reference's spec
without its leading ``None``), on both production meshes and under both
rule sets the dry-run uses.  The port's trees come from its own
``init_model`` / ``init_caches`` under a fake mode, the reference's from
``jax.eval_shape``: nothing is allocated.

The cost counter is held to hand counts on a fake world of 4 x 4 ranks
(``fake_world``, started and destroyed in each test), and the smoke mesh
to bit-equality on a gloo world of one.
"""

import dataclasses
import functools
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import analysis as jax_analysis  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro.models import init_caches as jax_init_caches  # noqa: E402
from repro.models import init_model as jax_init  # noqa: E402
from repro.models.config import SHAPES as JAX_SHAPES  # noqa: E402
from repro.parallel import specs as jax_specs  # noqa: E402
from repro.parallel.api import DEFAULT_RULES as JAX_RULES  # noqa: E402
from repro.parallel.api import ShardingContext as JaxContext  # noqa: E402
from repro.train import OptimizerConfig as JaxOpt  # noqa: E402
from repro.train import init_opt_state as jax_opt_state  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro_torch import parallel  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import analysis, mesh  # noqa: E402
from repro_torch.models import init_caches, init_model  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.parallel import specs  # noqa: E402
from repro_torch.parallel.api import DEFAULT_RULES, P, ShardingContext  # noqa: E402
from repro_torch.train import OptimizerConfig, make_train_step  # noqa: E402
from repro_torch.train.optim import tree_leaves  # noqa: E402


class _FakeMesh:
    """Minimal mesh stand-in for spec resolution (both packages)."""

    def __init__(self, shape: dict):
        self._shape = dict(shape)

    @property
    def axis_names(self):
        return tuple(self._shape)

    @property
    def shape(self):
        return self._shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULES = {"default": {}, "decode": {"fsdp": (), "expert_fsdp": ()},
         # the hill-climb's rules_override (experiments/hillclimb.py)
         "hillclimb": {"expert_fsdp": ()}}


def contexts(mesh_name: str, rules: str):
    m = _FakeMesh(MESHES[mesh_name])
    return (ShardingContext(m, {**DEFAULT_RULES, **RULES[rules]}),
            JaxContext(m, {**JAX_RULES, **RULES[rules]}))


@pytest.mark.parametrize("mesh_shape,shape,axes,want", [
    ({"data": 16, "model": 16}, (256, 4096), ("batch", None), ("data", None)),
    ({"data": 16, "model": 16}, (4096, 8192), ("fsdp", "model"), ("data", "model")),
    ({"data": 16, "model": 16}, (51865, 384), ("model", "fsdp"), (None, "data")),
    ({"data": 16, "model": 16}, (1, 1), ("batch", None), (None, None)),
    ({"pod": 2, "data": 16, "model": 16}, (256, 10), ("batch", None),
     (("pod", "data"), None)),
])
def test_resolve_matches_reference(mesh_shape, shape, axes, want):
    m = _FakeMesh(mesh_shape)
    got = ShardingContext(m).resolve(shape, axes)
    ref = JaxContext(m).resolve(shape, axes)
    assert isinstance(got, P)
    assert tuple(got) == tuple(ref) == want


def test_annotations_are_no_ops_outside_a_context():
    x = torch.arange(12.0).reshape(3, 4)
    assert parallel.current() is None
    assert parallel.shard(x, "batch", "model") is x
    assert parallel.fsdp_gather(x) is x
    assert parallel.axis_extent("model") == 1
    assert parallel.spec_for_logical((3, 4), ("batch", None)) == P()
    with parallel.activate(_FakeMesh(MESHES["16x16"]), {"fsdp": ()}) as ctx:
        assert parallel.current() is ctx and ctx.rules["fsdp"] == ()
        assert parallel.axis_extent("batch") == 16
        assert parallel.spec_for_logical((32, 3), ("batch", None)) == P("data", None)
    assert parallel.current() is None


# ---------------------------------------------------------------------------
# param / batch / cache specs at full width
# ---------------------------------------------------------------------------
def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


@functools.lru_cache(maxsize=None)
def port_params(arch: str):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = init_model(get_config(arch), 0, device="cpu")
    return _meta(params)


@functools.lru_cache(maxsize=None)
def ref_params(arch: str):
    cfg = jax_config(arch)
    return jax.eval_shape(functools.partial(jax_init, cfg), jax.random.PRNGKey(0))


def compare_trees(port, ref, stacked=False, path="") -> int:
    """Leaf-for-leaf equality of a port spec tree and the reference's;
    the port's layer lists hold the reference's stacked entries.  Returns
    the number of leaves compared."""
    if isinstance(port, P):
        want = tuple(ref)[1:] if stacked else tuple(ref)
        assert tuple(port) == want, (path, port, ref)
        return 1
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        return sum(compare_trees(port[k], ref[k], stacked or k in specs._LAYERS,
                                 f"{path}/{k}") for k in port)
    if isinstance(ref, dict):        # a layer list against the stacked dict
        return sum(compare_trees(p, ref, stacked, f"{path}[{i}]")
                   for i, p in enumerate(port))
    assert len(port) == len(ref), path
    return sum(compare_trees(p, r, stacked, f"{path}[{i}]")
               for i, (p, r) in enumerate(zip(port, ref)))


def test_every_reference_arch_is_ported():
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh_name, rules):
    ctx, jctx = contexts(mesh_name, rules)
    got = specs.param_specs(ctx, port_params(arch))
    want = jax_specs.param_specs(jctx, ref_params(arch))
    assert compare_trees(got, want) == len(tree_leaves(port_params(arch)))
    # the optimizer moments mirror the parameters
    o = specs.opt_specs(got)
    assert o["mu"] is got and o["nu"] is got and o["step"] == P()


@functools.lru_cache(maxsize=None)
def port_caches(arch: str, shape_name: str):
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape = SHAPES[shape_name]
    with FakeTensorMode():
        caches = init_caches(get_config(arch), shape.global_batch, shape.seq_len,
                             device="cpu")
    return _meta(caches)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch, shape_name, mesh_name):
    ctx, jctx = contexts(mesh_name, "decode")
    cfg, jcfg = get_config(arch), jax_config(arch)
    shape, jshape = SHAPES[shape_name], JAX_SHAPES[shape_name]
    assert ({k: tuple(v) for k, v in specs.batch_specs(cfg, shape, ctx).items()}
            == {k: tuple(v) for k, v in jax_specs.batch_specs(jcfg, jshape, jctx).items()})
    ref = jax.eval_shape(functools.partial(
        jax_init_caches, jcfg, jshape.global_batch, jshape.seq_len))
    got = specs.cache_specs(cfg, port_caches(arch, shape_name), ctx)
    want = jax_specs.cache_specs(jcfg, ref, jctx)
    assert compare_trees(got, want) == len(jax.tree.leaves(ref))
    if shape.global_batch == 1 and arch != "rwkv6-3b":   # context-parallel caches
        assert any("data" in tuple(s) for c in got for s in c.values())


def test_train_and_prefill_batch_specs_match_reference():
    for arch in ARCH_IDS:
        for shape_name in ("train_4k", "prefill_32k"):
            ctx, jctx = contexts("2x16x16", "default")
            got = specs.batch_specs(get_config(arch), SHAPES[shape_name], ctx)
            want = jax_specs.batch_specs(jax_config(arch), JAX_SHAPES[shape_name], jctx)
            assert {k: tuple(v) for k, v in got.items()} == {
                k: tuple(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# meshes and worlds
# ---------------------------------------------------------------------------
def test_production_mesh_needs_its_world():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="256 ranks"):
        mesh.make_production_mesh()
    with mesh.fake_world(512):
        with pytest.raises(RuntimeError, match="256 ranks, found 512"):
            mesh.make_production_mesh()
        m = mesh.make_production_mesh(multi_pod=True)
        assert m.mesh_dim_names == ("pod", "data", "model")
        assert tuple(m.shape) == (2, 16, 16)
    assert not dist.is_initialized()
    with mesh.fake_world(256):
        m = mesh.make_production_mesh()
        assert parallel.api.mesh_axes(m) == {"data": 16, "model": 16}
    assert not dist.is_initialized()


def test_smoke_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_smoke_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with mesh.local_world():
            pass


def test_h100_constants_not_the_tpu_ones():
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.LINK_BW) == (989e12, 3.35e12, 450e9)


def test_smoke_mesh_train_step_is_bit_equal():
    """The counterpart of the reference's train step under its smoke mesh:
    a reduced qwen3-4b train step under ``parallel.activate(make_smoke_mesh
    ("cpu"))`` on a gloo world of one gives the loss, gradient norm and
    updated parameters of the same step outside any context, bit for bit,
    on the reference's weights converted."""
    jcfg = jax_config("qwen3-4b", reduced=True)
    cfg = get_config("qwen3-4b", reduced=True)
    jparams = jax.jit(jax_init, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    jopt = jax_opt_state(jparams)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    np_params = jax.tree.map(np.asarray, jparams)
    np_opt = jax.tree.map(np.asarray, jopt)
    step = make_train_step(cfg, OptimizerConfig(), remat="none")

    def run():
        params = params_from_jax(np_params, device="cpu")
        opt = opt_state_from_jax(np_opt, device="cpu")
        return step(params, opt, {"tokens": torch.from_numpy(tokens)})

    p0, _, m0 = run()
    with mesh.local_world("cpu"):
        with parallel.activate(mesh.make_smoke_mesh("cpu")):
            assert parallel.axis_extent("model") == 1
            p1, _, m1 = run()
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)
    # and the reference's own step on the same batch agrees closely
    _, _, jm = jax.jit(jax_train_step(jcfg, JaxOpt(), remat="none"))(
        jparams, jopt, {"tokens": jnp.asarray(tokens)})
    assert abs(float(jm["loss"]) - float(m0["loss"])) < 1e-2


def product_flops(cfg) -> int:
    """The weights of every product a token runs through, counted from the
    config alone: each layer's q, k, v and output projections and its
    three SwiGLU matrices, and the (tied or untied) vocabulary head."""
    D, H, Hkv, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    return cfg.n_layers * (D * H * hd + 2 * D * Hkv * hd + H * hd * D + 3 * D * F) \
        + cfg.vocab_size * D


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


@pytest.mark.parametrize("step", ["forward", "decode_w4a4", "train"])
def test_replicated_params_on_the_smoke_mesh(step):
    """Parameters (and caches, optimizer state) as replicated DTensors on
    the smoke mesh of a gloo world of one, so that ``shard``,
    ``fsdp_gather``, ``on_shards`` and ``on_matmul_shards`` all run: the
    step's output equals the plain step's bit for bit, and its counted
    FLOPs equal both the plain step's count and an independent count, 2
    FLOP a product weight a token (6 in a train step) plus attention: 4 hd
    a (query, key) pair the causal mask leaves in a forward, 4 hd a cache
    slot in decode (the masked einsum reads every slot), and the plain
    route's backward over all S^2 pairs (two products, each differentiated
    twice)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import decode_fn, forward_fn
    from repro_torch.train import DataState, init_opt_state, synth_batch
    from repro_torch.train.optim import tree_map

    cfg = get_config("qwen3-4b", reduced=True)
    L, H, hd = cfg.n_layers, cfg.n_heads, cfg.hd
    params = init_model(cfg, 0, device="cpu")
    B, S, C, pos = 2, 16, 32, 7
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int64))
    cfg4 = cfg.with_approx_mlp(4)
    lut = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (16, 16)).astype(np.int32))
    train = make_train_step(cfg, OptimizerConfig(), remat="none")

    def run(params, state):
        if step == "forward":
            return forward_fn(cfg)(cfg, params, {"tokens": tokens}, backend="ref",
                                   device="cpu")[0]
        if step == "decode_w4a4":
            return decode_fn(cfg4)(cfg4, params, state, tokens[:, :1], pos, luts=lut,
                                   backend="ref")[0]
        return train(params, state, synth_batch(cfg, B, S, DataState(0, 0), device="cpu"))

    def state():
        if step == "decode_w4a4":
            return init_caches(cfg4, B, C, device="cpu")
        return init_opt_state(params) if step == "train" else None

    want = {"forward": 2 * B * S * product_flops(cfg) + L * 4 * hd * B * H * causal_pairs(S),
            "decode_w4a4": 2 * B * product_flops(cfg) + L * 4 * hd * B * H * C,
            "train": 6 * B * S * product_flops(cfg)
            + L * hd * B * H * (4 * causal_pairs(S) + 8 * S * S)}[step]
    with torch.no_grad() if step != "train" else torch.enable_grad():
        with analysis.CostCounter() as plain_count:
            plain = run(tree_map(torch.clone, params), state())
        with mesh.local_world("cpu"):
            smoke = mesh.make_smoke_mesh("cpu")

            def rep(t):
                return distribute_tensor(t.clone(), smoke, [Replicate(), Replicate()])

            st = state()
            with parallel.activate(smoke), implicit_replication():
                with analysis.CostCounter() as count:
                    got = run(tree_map(rep, params), None if st is None else tree_map(rep, st))
            # read back while the world stands: the updated parameters and
            # the loss of a train step, else the logits
            got = tree_map(lambda t: t.to_local(),
                           [got[0], got[2]["loss"]] if step == "train" else got)
    assert plain_count.flops == count.flops == want
    if step == "train":
        (p0, _, m0), (p1, loss) = plain, got
        assert torch.equal(m0["loss"], loss)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p0), tree_leaves(p1)))
    else:
        assert torch.equal(plain, got)


@pytest.mark.parametrize("x_place,w_place,out_place,local", [
    (("S0", "R"), ("R", "S1"), ("S0", "S1"), (8, 12)),     # rows and columns
    (("S0", "S1"), ("R", "S0"), ("S0", "R"), (8, 48)),     # K gathered on both
    (("R", "R"), ("S1", "S1"), ("S1", "S1"), (32, 3)),     # columns over both
])
def test_kernel_products_run_on_local_shards(world4x4, x_place, w_place, out_place,
                                             local):
    """``on_matmul_shards`` runs a kernel's product on local shards with K
    whole: the product is sharded as its rows and columns were, and the
    counter prices each rank's local product, 2 M K N at local M and N."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    place = {"S0": Shard(0), "S1": Shard(1), "R": Replicate()}
    M, K, N = 32, 64, 48
    a = _dt((M, K), world4x4, [place[p] for p in x_place], torch.int32)
    b = _dt((K, N), world4x4, [place[p] for p in w_place], torch.int32)
    lut = torch.zeros(16, 16, dtype=torch.int32, device="meta")
    with parallel.activate(world4x4), implicit_replication(), analysis.CostCounter() as c:
        out = parallel.api.on_matmul_shards(
            lambda a, b: ops.approx_matmul(a, b, lut, backend="ref"), a, b)
    assert list(out.placements) == [place[p] for p in out_place]
    assert tuple(out.to_local().shape) == local and tuple(out.shape) == (M, N)
    assert c.flops == 2.0 * local[0] * K * local[1]


def _gloo_rank(rank: int, store_path: str, results: str) -> None:
    """One rank of a four-rank gloo world: W4A4 products through
    ``approx_linear`` on DTensors in several layouts, each held to the
    plain product of the full tensors."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.quant.int4 import approx_linear

    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4), rank=rank,
                            world_size=4)
    try:
        m = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(8, 3, 32, generator=gen)
        w = torch.randn(32, 24, generator=gen)
        lut = torch.randint(0, 64, (16, 16), generator=gen, dtype=torch.int32)
        want = approx_linear(x, w, lut, backend="ref")
        ok = []
        for xp, wp in [((Shard(0), Replicate()), (Replicate(), Shard(1))),
                       ((Shard(0), Shard(2)), (Replicate(), Shard(0))),
                       ((Replicate(), Replicate()), (Shard(1), Shard(1)))]:
            xd = distribute_tensor(x, m, list(xp))
            wd = distribute_tensor(w, m, list(wp))
            with parallel.activate(m), implicit_replication():
                got = approx_linear(xd, wd, lut, backend="ref").full_tensor()
            ok.append(bool(torch.equal(got, want)))
        with open(f"{results}.{rank}", "w") as f:
            f.write(json.dumps(ok))
    finally:
        dist.destroy_process_group()


def test_kernel_products_on_four_gloo_ranks_match_the_plain_product(tmp_path):
    """The numbers: four processes, a (2, 2) mesh over gloo, and the W4A4
    product of DTensors laid out by rows and columns, with K split, and
    with columns over both mesh dims, bit-equal to the plain product of
    the full tensors on every rank."""
    import torch.multiprocessing as mp

    mp.start_processes(_gloo_rank, args=(str(tmp_path / "store"), str(tmp_path / "ok")),
                       nprocs=4, join=True, start_method="spawn")
    for rank in range(4):
        assert json.loads((tmp_path / f"ok.{rank}").read_text()) == [True] * 3


# the MoE dispatch's layouts on a real world: experts over data (E divides
# it), the slots over batch (the expert rules emptied), and the tokens over
# pod x data with the experts over data alone
# (arch, mesh extents, axes, rules, the sharded step's remat)
MOE_GLOO = [
    ("deepseek-v2-lite-16b", (2, 2), ("data", "model"), {}, "none"),
    ("mixtral-8x7b", (2, 2), ("data", "model"), {"expert": (), "expert_fsdp": ()}, "none"),
    ("deepseek-v2-lite-16b", (2, 2, 1), ("pod", "data", "model"), {}, "none"),
    # "dots" keeps the all-reduces' outputs: real collectives, recomputed around them
    ("mixtral-8x7b", (2, 2), ("data", "model"), {}, "dots"),
]
MOE_GLOO_ATOL = 2e-6     # float32: the sharded sums run in another order


def _moe_gloo_rank(rank: int, store_path: str, results: str) -> None:
    """One rank of a four-rank gloo world: each ``MOE_GLOO`` case's
    reduced train loss and its gradients on DTensors laid out by the
    dry-run's specs, against the same step without a mesh (and without
    rematerialisation: no policy changes a value)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import _distribute
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optim import tree_map

    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4), rank=rank,
                            world_size=4)
    try:
        shape = ShapeConfig("tiny_train", 16, 8, "train")
        got = []
        for arch, ext, axes, rules, remat in MOE_GLOO:
            cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
            params = init_model(cfg, 0, device="cpu")
            tokens = torch.as_tensor(np.random.default_rng(0).integers(
                0, cfg.vocab_size, (shape.global_batch, shape.seq_len)), dtype=torch.int32)

            def loss_and_grads(p, batch, remat="none"):
                live = tree_map(lambda t: t.detach().requires_grad_(True), p)
                loss = lm.lm_loss(cfg, live, batch, backend="ref", device="cpu",
                                  remat=remat)
                return loss, torch.autograd.grad(loss, tree_leaves(live))

            want, want_grads = loss_and_grads(params, {"tokens": tokens})
            m = init_device_mesh("cpu", ext, mesh_dim_names=axes)
            with parallel.activate(m, rules) as ctx, implicit_replication():
                p_d = _distribute(params, specs.named(m, specs.param_specs(ctx, params)), m)
                b_spec = specs.batch_specs(cfg, shape, ctx)["tokens"]
                t_d = distribute_tensor(tokens, m, parallel.api.placements(b_spec, m))
                loss, grads = loss_and_grads(p_d, {"tokens": t_d}, remat)
                loss = loss.full_tensor()
                grads = [g.full_tensor() for g in grads]
            got.append({"loss": float((loss - want).abs()),
                        "grad": max(float((g - w).abs().max())
                                    for g, w in zip(grads, want_grads)),
                        "scale": max(float(w.abs().max()) for w in want_grads)})
        with open(f"{results}.{rank}", "w") as f:
            f.write(json.dumps(got))
    finally:
        dist.destroy_process_group()


def test_moe_train_step_on_four_gloo_ranks_matches_the_plain_step(tmp_path):
    """The repaired dispatch's numbers: the reduced MoE train loss and
    every gradient on a four-rank gloo world, in each layout of
    ``MOE_GLOO``, equal the step without a mesh within ``MOE_GLOO_ATOL``
    (float32; each rank gathers its own blocks' rows and scatters its
    gated outputs back, :func:`repro_torch.parallel.api.gather_rows`)."""
    import torch.multiprocessing as mp

    mp.start_processes(_moe_gloo_rank,
                       args=(str(tmp_path / "store"), str(tmp_path / "moe")),
                       nprocs=4, join=True, start_method="spawn")
    for rank in range(4):
        got = json.loads((tmp_path / f"moe.{rank}").read_text())
        assert len(got) == len(MOE_GLOO)
        for case, g in zip(MOE_GLOO, got):
            assert g["loss"] <= MOE_GLOO_ATOL, (case, g)
            assert g["grad"] <= MOE_GLOO_ATOL, (case, g)
            assert g["scale"] > 1e-3, (case, g)     # the gradients are not all zero


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x7b"])
def test_moe_layer_temp_bytes_fall_as_data_grows(arch):
    """No rank holds the dispatch's blocks or picks whole: in the MoE
    layer's forward and backward at 16 x 256 tokens, on fake (2, 2) and
    (4, 2) worlds, no local tensor has the shape of a whole ``(E, C, D)``
    block or of the ``(T * K, D)`` picks (the replicated gathers of
    the former ``parallel.api.take`` made both), and the temporary bytes a rank fall
    as ``data`` grows."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import _distribute
    from repro_torch.models import layers

    class Shapes(TorchDispatchMode):
        """The shapes of the local tensors the ops return, outside the
        global-shape runs of DTensor's sharding propagation (where the
        counter is quiet)."""

        def __init__(self, counter):
            super().__init__()
            self.counter, self.seen = counter, set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t.__name__ == "DTensor" for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if not self.counter._quiet:
                self.seen.update(tuple(t.shape) for t in torch.utils._pytree.tree_leaves(out)
                                 if isinstance(t, torch.Tensor))
            return out

    cfg = get_config(arch, reduced=True)
    mo, T = cfg.moe, 16 * 256
    C = math.ceil(T * mo.top_k / mo.n_experts * mo.capacity_factor)
    whole = {(mo.n_experts, C, cfg.d_model), (T * mo.top_k, cfg.d_model)}
    params = _meta(init_model(cfg, 0, device="cpu")["layers"][0]["moe"])
    temp = {}
    for data in (2, 4):
        with mesh.fake_world(data * 2):
            m = init_device_mesh("cpu", (data, 2), mesh_dim_names=("data", "model"))
            with parallel.activate(m) as ctx, implicit_replication():
                p = _distribute(params, specs.named(m, specs.param_specs(ctx, params)), m)
                p = {k: (v.requires_grad_(True) if not isinstance(v, list) else v)
                     for k, v in p.items()}
                x = _dt((16, 256, cfg.d_model), m, [Shard(0), Replicate()],
                        cfg.torch_dtype).requires_grad_(True)
                c = analysis.CostCounter()
                with c, Shapes(c) as shapes:
                    out, aux = layers.moe_ffn(cfg, p, x, backend="ref")
                    torch.autograd.grad(out.sum() + aux, [x, p["w1"], p["router"]])
                temp[data] = c.temp_bytes()
            assert not shapes.seen & whole, (data, shapes.seen & whole)
    assert temp[4] < temp[2], temp


# ---------------------------------------------------------------------------
# the roofline half of launch/analysis
# ---------------------------------------------------------------------------
OPS = ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute", "send"]


@pytest.mark.parametrize("group", [1, 2, 16])
@pytest.mark.parametrize("op", OPS)
def test_wire_bytes_match_reference(op, group):
    for payload in (0, 4096, 12_345_678):
        assert analysis._wire_bytes(op, payload, group) == jax_analysis._wire_bytes(
            op, payload, group)


ROOFS = [  # (hlo_flops, hlo_bytes, wire_bytes, model_flops, model_bytes, chips)
    (5.9e14, 6.5e12, 7.9e11, 2.8e16, 1.3e11, 256),     # memory-bound train
    (1.0e15, 1.0e11, 1.0e9, 2.0e17, 2.0e9, 256),       # compute-bound
    (1.0e12, 1.0e9, 5.0e12, 1.0e14, 1.0e12, 512),      # collective-bound
    (0.0, 0.0, 0.0, 0.0, 0.0, 1),                      # an empty step
]


@pytest.mark.parametrize("case", ROOFS)
def test_roofline_matches_reference_with_h100_constants(case, monkeypatch):
    """The reference's ``Roofline`` with its TPU constants replaced by the
    H100's (in the test only) prices every case as the port's does."""
    monkeypatch.setattr(jax_mesh, "PEAK_FLOPS_BF16", mesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jax_mesh, "HBM_BW", mesh.HBM_BW)
    monkeypatch.setattr(jax_mesh, "ICI_BW_PER_LINK", mesh.LINK_BW)
    f, b, w, mf, mb, chips = case
    kw = dict(arch="a", shape="s", mesh="m", chips=chips, hlo_flops=f,
              hlo_bytes=b, wire_bytes=w, model_flops=mf, bytes_per_device=None,
              collectives={"all-gather": 1}, model_bytes=mb)
    got = analysis.Roofline(**kw).as_dict()
    want = jax_analysis.Roofline(**kw).as_dict()
    assert got == want
    assert analysis.model_flops_train(123, 7) == jax_analysis.model_flops_train(123, 7)
    assert analysis.model_flops_decode(123, 7) == jax_analysis.model_flops_decode(123, 7)


# ---------------------------------------------------------------------------
# per-device counts on a fake world
# ---------------------------------------------------------------------------
@pytest.fixture
def world4x4():
    from torch.distributed.device_mesh import init_device_mesh

    with mesh.fake_world(16):
        yield init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))


def _dt(shape, m, placements, dtype=torch.float32):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"), m,
                             placements)


def test_counter_prices_a_sharded_mlp_per_device(world4x4):
    """A Megatron MLP over (data 4, model 4): tokens over data, w1 column-
    and w2 row-parallel.  Each rank does a sixteenth of the products, and
    the row-parallel output is all-reduced over model."""
    from torch.distributed.tensor import Replicate, Shard

    T, D, F = 64, 32, 128
    x = _dt((T, D), world4x4, [Shard(0), Replicate()])
    w1 = _dt((D, F), world4x4, [Replicate(), Shard(1)])
    w2 = _dt((F, D), world4x4, [Replicate(), Shard(0)])
    with analysis.CostCounter() as c:
        y = (x @ w1) @ w2
        y = y.redistribute(world4x4, [Shard(0), Replicate()])
    assert c.flops == (2 * T * D * F + 2 * T * F * D) / 16
    local = (T // 4) * D * 4
    assert c.collectives.counts == {"all-reduce": 1}
    assert c.collectives.wire_bytes_total == 2 * 3 / 4 * local
    # bytes: each product's local operands and result, f32
    assert c.bytes == 4 * ((T // 4) * D + D * (F // 4) + (T // 4) * (F // 4)) * 2


@pytest.mark.parametrize("op,src,dst,payload", [
    ("all-gather", "S0", "R", 64 * 32 * 4),
    ("all-reduce", "P", "R", 64 * 32 * 4),
    ("reduce-scatter", "P", "S0", 16 * 32 * 4),
    ("all-to-all", "S0", "S1", 16 * 32 * 4),
])
def test_counter_prices_each_collective(world4x4, op, src, dst, payload):
    """One redistribution over ``model`` (4 ranks) of a (64, 32) float32
    tensor: one collective at its local payload and the ring wire bytes;
    the all-to-all is counted as DTensor asks for it, though the CPU group
    runs it as a gather."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    place = {"S0": Shard(0), "S1": Shard(1), "R": Replicate(), "P": Partial()}
    x = _dt((64, 32), world4x4, [Replicate(), place[src]])
    with analysis.CostCounter() as c:
        x.redistribute(world4x4, [Replicate(), place[dst]])
    assert c.collectives.counts == {op: 1}
    assert c.collectives.payload_bytes == {op: payload}
    assert c.collectives.wire_bytes_total == jax_analysis._wire_bytes(op, payload, 4)
    assert c.flops == 0


def test_kernel_hook_counts_a_plain_route_call_once():
    """``ops.approx_matmul`` on the plain route reports 2MKN and the bytes
    its bound uses, and none of the gathers inside it; outside a counter
    nothing is reported."""
    M, K, N = 8, 64, 48
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(0, 16, (M, K), generator=gen, dtype=torch.int32)
    b = torch.randint(0, 16, (K, N), generator=gen, dtype=torch.int32)
    lut = torch.randint(0, 64, (16, 16), generator=gen, dtype=torch.int32)
    assert ops.COUNTER is None
    with analysis.CostCounter() as c:
        got = ops.approx_matmul(a, b, lut, backend="ref")
        assert ops.COUNTER is c
    assert ops.COUNTER is None
    assert c.flops == 2.0 * M * K * N
    assert c.bytes == 4 * (M * K + K * N + M * N) + 4 * 16 * 16
    assert torch.equal(got, ops.approx_matmul(a, b, lut, backend="ref"))
    # at W8A8 twice the products
    lut8 = torch.randint(0, 64, (256, 256), generator=gen, dtype=torch.int32)
    with analysis.CostCounter() as c8:
        ops.approx_matmul(a, b, lut8, backend="ref")
    assert c8.flops == 4.0 * M * K * N


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5), (False, None)])
def test_flash_wrapper_prices_its_own_call(causal, window):
    """``ops.flash_attention`` called directly under a counter, in its own
    layout (q (B, H, Lq, D), k and v (B, Hkv, Lk, D)): 4 D a (query, key)
    pair the mask leaves a query head, queries aligned to the end of the
    keys; q and the output at H heads, k and v at Hkv, each moved once."""
    B, H, Hkv, Lq, Lk, D = 2, 4, 2, 6, 24, 8
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(B, H, Lq, D, generator=gen)
    k = torch.randn(B, Hkv, Lk, D, generator=gen)
    v = torch.randn(B, Hkv, Lk, D, generator=gen)
    with analysis.CostCounter() as c:
        got = ops.flash_attention(q, k, v, causal=causal, window=window, backend="ref")
    pos = np.arange(Lq) + Lk - Lq
    seen = [sum(1 for j in range(Lk) if (not causal or j <= p)
                and (window is None or j > p - window)) for p in pos]
    assert c.flops == 4.0 * D * B * H * sum(seen)
    assert c.bytes == 4 * (2 * B * H * Lq * D + 2 * B * Hkv * Lk * D)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal, window=window,
                                                backend="ref"))


@pytest.mark.parametrize("window", [None, 3])
def test_attention_is_priced_at_the_pairs_its_mask_leaves(window):
    """A forward's attention counts 4 D a (query, key) pair the mask
    leaves, on the plain route, as the flash kernel would report it; the
    projections count 2MKN each."""
    cfg = dataclasses.replace(get_config("qwen3-4b", reduced=True), dtype="float32",
                              n_layers=1, sliding_window=window)
    params = init_model(cfg, 0, device="cpu")
    B, S = 2, 8
    x = torch.randn(B, S, cfg.d_model)
    from repro_torch.models import layers as L

    with analysis.CostCounter() as c:
        L.attention_full(cfg, params["layers"][0]["attn"], x, window)
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pairs = ops.attention_pairs(S, S, True, window)
    assert pairs == sum(min(i + 1, window or S) for i in range(S))
    proj = 2 * B * S * D * (H * hd + 2 * Hkv * hd) + 2 * B * S * H * hd * D
    assert c.flops == proj + 4 * B * H * hd * pairs


@pytest.mark.parametrize("batch", [8, 1])
def test_named_cache_specs_lay_caches_out_on_a_mesh(world4x4, batch):
    """``named(cache_specs)`` as the dry-run distributes decode caches:
    batch over data, or the sequence over data when the batch is 1; each
    tensor's placements name the mesh dims its spec names."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import lm

    cfg = get_config("hymba-1.5b", reduced=True)
    caches = [{k: torch.empty(t.shape, dtype=t.dtype, device="meta")
               for k, t in c.items()}
              for c in lm.init_decode_caches(cfg, batch, 16, device="cpu")]
    with parallel.activate(world4x4) as ctx:
        c_specs = specs.cache_specs(cfg, caches, ctx)
        layout = specs.named(world4x4, c_specs)
        got = [{k: distribute_tensor(t, world4x4, layout[i][k]) for k, t in c.items()}
               for i, c in enumerate(caches)]
    k_spec = c_specs[0]["k"]
    assert k_spec[:2] == (("data", None) if batch == 8 else (None, "data"))
    assert list(got[0]["k"].placements) == [Shard(0 if batch == 8 else 1), Replicate()]
    for g, s_ in zip(got, c_specs):
        for k, t in g.items():
            assert t.to_local().numel() * int(np.prod(
                [4 for e in s_[k] if e is not None])) == t.numel()
    # a spec that names one mesh axis twice is refused, not half applied
    with pytest.raises(ValueError, match="named twice"):
        parallel.api.placements(P("data", "data"), world4x4)
