"""PyTorch port: grouped GQA where ``model`` splits no head
(``repro_torch.models.layers._grouped_attention_core``).

Under a mesh whose ``model`` extent divides neither the query nor the KV
head count, the query heads are folded as (Hkv, rep) against the KV
heads, never repeated: within 2e-5 in float32 and 2e-2 in bf16 (the
reference's attention tolerances) of the repeat route and of the
reference's ``_masked_softmax_attn`` on the same numpy inputs, and on
four gloo ranks (``model`` = 2 over 9 query and 3 KV heads) in value and
gradients.  Outside a mesh the repeat route runs as before.  At full
width, hymba-1.5b's ``decode_32k`` on 16x16 holds no repeated key or
value and at most the reference's temporary bytes a device.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
B, SQ, SK, H, HKV, HD = 2, 12, 12, 9, 3, 16
# (name, Sq, window, k_valid, f32_math): prefill causal, a sliding window,
# a decode row over a partly filled cache, and bf16 probabilities
CASES = [("causal", SQ, None, False, True), ("window", SQ, 5, False, True),
         ("decode", 1, None, True, True), ("probs_in_v_dtype", SQ, None, False, False)]
# the reference's full-width figure, tools/dryrun_memory.py --reference
HYMBA_DECODE_REFERENCE_TEMP = 4_558_231_104


def inputs(dtype: str, sq: int, k_valid: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, SK, HKV, HD)).astype(np.float32)
    v = rng.standard_normal((B, SK, HKV, HD)).astype(np.float32)
    q_pos = np.arange(SK - sq, SK)
    k_pos = np.arange(SK)
    valid = (k_pos <= 8) if k_valid else None
    return q, k, v, q_pos, k_pos, valid


def port(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,sq,window,k_valid,f32_math", CASES,
                         ids=[c[0] for c in CASES])
def test_grouped_equals_the_repeat_route_and_the_reference(dtype, name, sq, window,
                                                          k_valid, f32_math):
    q, k, v, q_pos, k_pos, valid = inputs(dtype, sq, k_valid)
    args = (port(q, dtype), port(k, dtype), port(v, dtype), torch.from_numpy(q_pos),
            torch.from_numpy(k_pos), window,
            None if valid is None else torch.from_numpy(valid), f32_math)
    got = L._grouped_attention_core(*args).float()
    repeat = L._masked_softmax_attn(*args[:6], args[6], f32_math=f32_math).float()
    ref = JL._masked_softmax_attn(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        jnp.asarray(q_pos), jnp.asarray(k_pos), window,
        None if valid is None else jnp.asarray(valid), f32_math=f32_math)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert got.shape == repeat.shape == (B, sq, H, HD)
    assert float((got - repeat).abs().max()) <= TOL[dtype]
    assert float((got - ref).abs().max()) <= TOL[dtype]


def test_outside_a_mesh_the_repeat_route_runs(monkeypatch):
    """No mesh: ``_masked_softmax_attn`` never takes the grouped route, so
    every bit-exact test of the models holds as it did."""
    monkeypatch.setattr(L, "_grouped_attention_core",
                        lambda *a: pytest.fail("grouped route outside a mesh"))
    q, k, v, q_pos, k_pos, _ = inputs("float32", SQ, False)
    out = L._masked_softmax_attn(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(q_pos),
                                 torch.from_numpy(k_pos), None)
    assert out.shape == (B, SQ, H, HD)


def _gloo_rank(rank: int, store_path: str, results: str) -> None:
    """One rank of a four-rank gloo world on a (2, 2) ("data", "model")
    mesh: attention of 9 query over 3 KV heads with the batch split over
    ``data`` and ``model`` dividing neither head count, its value and the
    gradients of q, k and v against the same attention without a mesh, in
    float32 and bf16, and which route ran."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import parallel

    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4), rank=rank,
                            world_size=4)
    grouped = []
    core = L._grouped_attention_core

    def spy(*a):
        grouped.append(a[0].shape)
        return core(*a)

    def attend(q, k, v, q_pos, k_pos, window, w):
        out = L._masked_softmax_attn(q, k, v, q_pos, k_pos, window)
        loss = (out.float() * w).sum()
        return out, torch.autograd.grad(loss, (q, k, v))

    try:
        got = []
        m = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        for dtype in ("float32", "bfloat16"):
            q, k, v, q_pos, k_pos, _ = inputs(dtype, SQ, False, seed=3)
            w = torch.from_numpy(np.random.default_rng(4).standard_normal(
                (B, SQ, H, HD)).astype(np.float32))
            plain = [port(x, dtype).requires_grad_(True) for x in (q, k, v)]
            want, want_grads = attend(*plain, torch.from_numpy(q_pos),
                                      torch.from_numpy(k_pos), 5, w)
            L._grouped_attention_core = spy
            try:
                with parallel.activate(m):
                    lay = [Shard(0), Replicate()]
                    dts = [distribute_tensor(port(x, dtype), m, lay).requires_grad_(True)
                           for x in (q, k, v)]
                    out, grads = attend(*dts, torch.from_numpy(q_pos),
                                        torch.from_numpy(k_pos), 5,
                                        distribute_tensor(w, m, lay))
                    out = out.full_tensor()
                    grads = [g.full_tensor() for g in grads]
            finally:
                L._grouped_attention_core = core
            got.append({"dtype": dtype,
                        "out": float((out.float() - want.float()).abs().max()),
                        "grad": max(float((g.float() - x.float()).abs().max())
                                    for g, x in zip(grads, want_grads)),
                        "scale": max(float(x.float().abs().max()) for x in want_grads),
                        "grouped": [list(s) for s in grouped]})
            grouped.clear()
        with open(f"{results}.{rank}", "w") as f:
            f.write(json.dumps(got))
    finally:
        dist.destroy_process_group()


def test_grouped_route_on_four_gloo_ranks_matches_the_plain_attention(tmp_path):
    """Each rank runs the grouped route on its batch shard (one of two
    rows, all 9 heads), and the attention's value and the gradients of q,
    k and v equal the plain route's within the attention tolerances."""
    import torch.multiprocessing as mp

    mp.start_processes(_gloo_rank, args=(str(tmp_path / "store"), str(tmp_path / "g")),
                       nprocs=4, join=True, start_method="spawn")
    for rank in range(4):
        for g in json.loads((tmp_path / f"g.{rank}").read_text()):
            assert g["grouped"] == [[1, SQ, H, HD]], g
            assert g["out"] <= TOL[g["dtype"]], g
            # a gradient is a sum of many products: held relative to its scale
            assert g["grad"] <= TOL[g["dtype"]] * max(1.0, g["scale"]), g
            assert g["scale"] > 1e-3, g


@pytest.fixture(scope="module")
def hymba_decode():
    """hymba-1.5b ``decode_32k`` at full width on a fake 16x16 world, under
    ``tools/dryrun_peak.py``'s counter: (counter, record)."""
    from test_torch_memory import counted_cell

    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES

    return counted_cell("hymba-1.5b", SHAPES["decode_32k"], get_config("hymba-1.5b"),
                        mesh_dims=(16, 16))


def test_hymba_decode_holds_at_most_the_reference_temporary_bytes(hymba_decode):
    """5,086,059,784 bytes a device with the repeat; 388,490,504 grouped,
    against the reference's 4,558,231,104."""
    _, meta = hymba_decode
    assert meta["temp_size_in_bytes"] <= HYMBA_DECODE_REFERENCE_TEMP
    assert meta["temp_size_in_bytes"] == 388_490_504


def test_hymba_decode_builds_no_repeated_keys_or_values(hymba_decode):
    """No op builds the cache's keys or values at 25 heads, repeated or
    upcast: (8, 32768, 25, 64) or (8, 32768, 5, 5, 64); each is upcast
    once, at 5 heads, heads first: (8, 5, 32768, 64) in float32."""
    c, _ = hymba_decode
    shapes = {(shape, dtype) for _, shape, dtype in c.what.values()}
    assert not {s for s, _ in shapes} & {(8, 32768, 25, 64), (8, 32768, 5, 5, 64),
                                         (8, 25, 32768, 64)}
    assert ((8, 5, 32768, 64), "torch.float32") in shapes
    assert ((8, 32768, 5, 64), "torch.float32") not in shapes
