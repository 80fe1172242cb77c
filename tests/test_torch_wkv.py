"""PyTorch port: RWKV6's WKV scan (``repro_torch.models.layers``), its
autograd function and its layout under a mesh, against the JAX package's
``_rwkv_wkv_scan`` (a ``lax.scan``).

``_WKVScan`` keeps the scan's inputs and one float32 state a step for its
own backward, where autograd over the plain loop keeps three tensors a
step.  Its forward is the loop's bit for bit; its gradients are held to a
float64 ``gradcheck``, to ``jax.grad`` of the reference's scan in float32,
and, through the reduced rwkv6 model, to the loop's under every remat.
The bytes it holds are counted by the dry-run's ``CostCounter``.  On four
gloo ranks, a reduced rwkv6 train step whose head count ``model`` does
not divide runs the scan split by value columns, and its loss and every
gradient equal the step without a mesh.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import analysis  # noqa: E402
from repro_torch.models import init_model, layers, lm  # noqa: E402
from repro_torch.train.optim import tree_leaves, tree_map  # noqa: E402

F32_RTOL, F32_ATOL = 2e-5, 1e-6       # the roadmap's float32 tolerance


def scan_inputs(B, S, H, hd, seed=0, dtype=np.float32):
    """r, k, v (normal), w (decay in (0.5, 0.99)), u (H, hd) and a state
    (B, H, hd, hd), as numpy arrays from ``seed``."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(dtype) for _ in range(3))
    w = rng.uniform(0.5, 0.99, (B, S, H, hd)).astype(dtype)
    u = rng.standard_normal((H, hd)).astype(dtype)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(dtype)
    return r, k, v, w, u, s0


def as_torch(arrays, grad=False):
    return [torch.tensor(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("B,S,H,hd", [(2, 16, 3, 8), (1, 5, 2, 16)])
def test_function_forward_is_bit_equal_to_the_loop(B, S, H, hd, grad):
    """Float32 on the CPU: the function's outputs and ``wkv_scan``'s are
    the loop's bit for bit, with grad enabled (the function) and without
    (the loop itself)."""
    arrays = scan_inputs(B, S, H, hd)
    want_y, want_s = layers._rwkv_wkv_scan(*as_torch(arrays))
    with torch.set_grad_enabled(grad):
        for fn in (layers._WKVScan.apply, layers.wkv_scan):
            y, s = fn(*as_torch(arrays, grad))
            assert y.requires_grad == grad
            assert torch.equal(y, want_y) and torch.equal(s, want_s)


def test_function_passes_gradcheck_in_float64():
    inputs = as_torch(scan_inputs(2, 6, 2, 3, seed=1, dtype=np.float64), grad=True)
    assert torch.autograd.gradcheck(layers._WKVScan.apply, inputs)


# (dtype, scale of r, k and v, rtol, atol).  In float32 the reference's own
# gradients lie up to 2.4e-6 from float64's at unit-normal r, k and v (a
# dot product of hd terms near 10 that cancels to near 0), above the f32
# atol; at half that scale the rounding of either side is below it.  The
# float64 case holds the arithmetic itself at unit scale.
JAX_GRAD = [pytest.param(np.float32, 0.5, F32_RTOL, F32_ATOL, id="f32"),
            pytest.param(np.float64, 1.0, 1e-12, 1e-12, id="f64")]


@pytest.mark.parametrize("dtype,scale,rtol,atol", JAX_GRAD)
@pytest.mark.parametrize("hv", [16, 4], ids=["whole", "value_columns"])
def test_function_gradients_match_jax_grad_of_the_reference_scan(hv, dtype, scale,
                                                                  rtol, atol):
    """S = 16: every input's gradient of ``<y, gy> + <state, gs>`` (random
    cotangents from the seed) equals ``jax.vjp`` of the reference's
    ``_rwkv_wkv_scan`` on the same inputs.  With ``hv`` < hd the function
    takes a slice of the value columns, as each rank does under a mesh,
    and its gradients of r, k, w and u are that slice's share: the shares
    of the slices add up to the reference's."""
    B, S, H, hd = 2, 16, 3, 16
    r, k, v, w, u, s0 = scan_inputs(B, S, H, hd, seed=2, dtype=dtype)
    arrays = (r * scale, k * scale, v * scale, w, u, s0)
    rng = np.random.default_rng(3)
    gy = rng.standard_normal((B, S, H, hd)).astype(dtype)
    gs = rng.standard_normal((B, H, hd, hd)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        _, vjp = jax.vjp(jax_layers._rwkv_wkv_scan, *(jnp.asarray(a) for a in arrays))
        want = [np.asarray(g) for g in vjp((jnp.asarray(gy), jnp.asarray(gs)))]
    assert all(g.dtype == dtype for g in want)

    got = [np.zeros_like(a) for a in arrays]
    for c in range(0, hd, hv):
        cols = slice(c, c + hv)
        r, k, v, w, u, s0 = as_torch(arrays, grad=True)
        vs = v[..., cols].detach().requires_grad_(True)
        s0s = s0[..., cols].detach().requires_grad_(True)
        y, s = layers._WKVScan.apply(r, k, vs, w, u, s0s)
        loss = (y * torch.tensor(gy[..., cols])).sum() + (s * torch.tensor(gs[..., cols])).sum()
        grads = torch.autograd.grad(loss, [r, k, vs, w, u, s0s])
        for i, g in enumerate(grads):
            if i in (2, 5):
                got[i][..., cols] = g.numpy()
            else:
                got[i] += g.numpy()
    for name, g, want_g in zip("r k v w u state0".split(), got, want):
        np.testing.assert_allclose(g, want_g, rtol=rtol, atol=atol, err_msg=name)


def live_bytes(counter) -> int:
    """Bytes of the storages the counted ops allocated that are alive."""
    mem = counter.memory
    alive = set(mem.live.values())
    return sum(n for tok, n in mem.events if n > 0 and tok in alive)


def test_function_holds_one_state_a_step_under_the_cost_counter():
    """Outside a mesh, at the end of the forward with grad the function
    holds exactly S·B·H·hd²·4 bytes of state beside ``y`` and the last
    state (its inputs were allocated before: it saves them, copies
    nothing); autograd over the loop holds three times the states.  With
    no grad, ``wkv_scan`` is the loop and holds no step's state: its peak
    stays below one state a step."""
    B, S, H, hd = 2, 16, 3, 8
    arrays = scan_inputs(B, S, H, hd)
    states = S * B * H * hd * hd * 4
    y_bytes, last = B * S * H * hd * 4, B * H * hd * hd * 4

    inputs = as_torch(arrays, grad=True)
    with analysis.CostCounter() as c:
        out = layers.wkv_scan(*inputs)
        held = live_bytes(c)
    assert out[0].grad_fn is not None
    assert held == states + y_bytes + last

    with analysis.CostCounter() as c:
        out = layers._rwkv_wkv_scan(*inputs)
        loop_held = live_bytes(c)
    assert loop_held >= 3 * states

    with torch.no_grad(), analysis.CostCounter() as c:
        out = layers.wkv_scan(*as_torch(arrays))
        held = live_bytes(c)
        peak = c.temp_bytes()
    assert out[0].grad_fn is None
    assert held == y_bytes + last
    assert peak < states


def rwkv_cfg(n_heads: int = 3):
    """Reduced rwkv6 in float32 with ``n_heads`` heads of 16."""
    cfg = get_config("rwkv6-3b", reduced=True)
    return dataclasses.replace(cfg, d_model=16 * n_heads, n_heads=n_heads,
                               n_kv_heads=n_heads, dtype="float32")


def rwkv_params(cfg, seed=0):
    """``init_model``'s parameters with a random ``u`` (it starts at 0,
    which would leave its term out of the scan)."""
    params = init_model(cfg, seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for lp in params["layers"]:
        lp["rwkv"]["u"] = torch.randn(lp["rwkv"]["u"].shape, generator=gen)
    return params


def loss_and_grads(cfg, params, batch, remat="none"):
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = lm.lm_loss(cfg, live, batch, backend="ref", device="cpu", remat=remat)
    return loss, torch.autograd.grad(loss, tree_leaves(live))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_train_step_through_the_function_matches_the_loop(remat, monkeypatch):
    """The reduced rwkv6 loss and gradients through the function equal
    those through autograd over the loop: the loss bit for bit, every
    gradient within float32 tolerance, under each remat policy."""
    cfg = rwkv_cfg()
    params = rwkv_params(cfg)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 12)), dtype=torch.int32)
    loss, grads = loss_and_grads(cfg, params, {"tokens": tokens}, remat)
    monkeypatch.setattr(layers, "wkv_scan", layers._rwkv_wkv_scan)
    want, want_grads = loss_and_grads(cfg, params, {"tokens": tokens}, "none")
    assert torch.equal(loss, want)
    scale = max(float(g.abs().max()) for g in want_grads)
    assert scale > 1e-3
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, rtol=F32_RTOL, atol=F32_ATOL * scale)


# (mesh extents over ("data", "model"), heads of 16): where "model" does
# not divide the heads (it divides 16) the scan splits value columns;
# where it does, heads.  Either way u is whole on "data", which splits
# the batch, so its gradient is a partial sum there too
WKV_GLOO = [((1, 4), 3), ((2, 2), 3), ((2, 2), 4)]
WKV_GLOO_ATOL = 2e-6     # float32: the sharded sums run in another order


def _wkv_gloo_rank(rank: int, store_path: str, results: str) -> None:
    """One rank of a four-rank gloo world: each ``WKV_GLOO`` case's
    reduced rwkv6 train loss and its gradients on DTensors laid out by the
    dry-run's specs, against the same step without a mesh, and the value
    columns each rank's scan took."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import parallel
    from repro_torch.launch.dryrun import _distribute
    from repro_torch.models.config import ShapeConfig
    from repro_torch.parallel import specs

    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4), rank=rank,
                            world_size=4)
    columns = []
    scan = layers.wkv_scan

    def spy(r, k, v, w, u, state0):
        columns.append(v.shape[-1])
        return scan(r, k, v, w, u, state0)

    try:
        shape = ShapeConfig("tiny_train", 8, 8, "train")
        got = []
        for ext, n_heads in WKV_GLOO:
            cfg = rwkv_cfg(n_heads)
            params = rwkv_params(cfg)
            tokens = torch.as_tensor(np.random.default_rng(0).integers(
                0, cfg.vocab_size, (shape.global_batch, shape.seq_len)), dtype=torch.int32)
            want, want_grads = loss_and_grads(cfg, params, {"tokens": tokens})
            m = init_device_mesh("cpu", ext, mesh_dim_names=("data", "model"))
            columns.clear()
            layers.wkv_scan = spy
            try:
                with parallel.activate(m) as ctx, implicit_replication():
                    p_d = _distribute(params, specs.named(m, specs.param_specs(ctx, params)), m)
                    b_spec = specs.batch_specs(cfg, shape, ctx)["tokens"]
                    t_d = distribute_tensor(tokens, m, parallel.api.placements(b_spec, m))
                    loss, grads = loss_and_grads(cfg, p_d, {"tokens": t_d})
                    loss = loss.full_tensor()
                    grads = [g.full_tensor() for g in grads]
            finally:
                layers.wkv_scan = scan
            got.append({"loss": float((loss - want).abs()),
                        "grad": max(float((g - w).abs().max())
                                    for g, w in zip(grads, want_grads)),
                        "scale": max(float(w.abs().max()) for w in want_grads),
                        "columns": sorted(set(columns))})
        with open(f"{results}.{rank}", "w") as f:
            f.write(json.dumps(got))
    finally:
        dist.destroy_process_group()


def test_rwkv_train_step_on_four_gloo_ranks_matches_the_plain_step(tmp_path):
    """The scan's layouts' numbers: on a four-rank gloo world, in each
    layout of ``WKV_GLOO``, every rank's scan takes 16 / ``model`` value
    columns where ``model`` does not divide the heads, and the reduced
    rwkv6 train loss and every gradient equal the step without a mesh
    within ``WKV_GLOO_ATOL``.  The gradients of the scan's whole inputs
    are partial sums over the mesh dims that split the others (r, k, w
    over ``model`` with value columns, u over ``data`` in both):
    ``parallel.api.on_shards`` hands them back so."""
    import torch.multiprocessing as mp

    mp.start_processes(_wkv_gloo_rank,
                       args=(str(tmp_path / "store"), str(tmp_path / "wkv")),
                       nprocs=4, join=True, start_method="spawn")
    for rank in range(4):
        got = json.loads((tmp_path / f"wkv.{rank}").read_text())
        assert len(got) == len(WKV_GLOO)
        for (ext, n_heads), g in zip(WKV_GLOO, got):
            split = n_heads % ext[1] != 0
            assert g["columns"] == [16 // ext[1] if split else 16], (ext, g)
            assert g["loss"] <= WKV_GLOO_ATOL, (ext, g)
            assert g["grad"] <= WKV_GLOO_ATOL, (ext, g)
            assert g["scale"] > 1e-3, (ext, g)
