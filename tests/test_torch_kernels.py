"""PyTorch port: the kernels' plain versions against the JAX oracles and the
Pallas kernels (interpret mode), the W8A8 tile helpers and the dispatch.
tests/test_torch_kernels_cuda.py holds the hand-written kernels against
these plain versions on a card.

Integers must be bit-equal; attention floats within 2e-5 in f32 and 2e-2
in bf16 (the tolerances of tests/test_kernels_flash_attention.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.precision import compose as jcompose  # noqa: E402
from repro_torch.kernels import approx_matmul as am  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.precision import compose  # noqa: E402

FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _codes(rng, shape, side):
    return rng.integers(0, side, size=shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a_f32: np.ndarray):
    """The same bf16 values on both sides."""
    j = jnp.asarray(a_f32, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# approx_matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,K,N", [
    (8, 16, 8), (37, 53, 29), (128, 128, 128), (130, 257, 64),
    (1, 96, 40), (4, 96, 40), (16, 96, 40), (64, 96, 40),
])
def test_approx_matmul_w4_matches_jax(M, K, N, rng):
    lut = _codes(rng, (16, 16), 226)
    a, b = _codes(rng, (M, K), 16), _codes(rng, (K, N), 16)
    want = np.asarray(jref.approx_matmul(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(lut)))
    got = ref.approx_matmul(_t(a), _t(b), _t(lut))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("M,K,N", [(37, 53, 29), (4, 96, 40)])
def test_approx_matmul_w4_matches_pallas_interpret(M, K, N, rng):
    lut = _codes(rng, (16, 16), 256)
    a, b = _codes(rng, (M, K), 16), _codes(rng, (K, N), 16)
    want = np.asarray(jops.approx_matmul(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(lut),
                                         backend="pallas_interpret"))
    assert np.array_equal(ref.approx_matmul(_t(a), _t(b), _t(lut)).numpy(), want)


@pytest.mark.parametrize("M,K,N", [(8, 16, 8), (37, 53, 29), (1, 64, 24),
                                   (64, 40, 24)])
def test_approx_matmul_w8_composed_matches_jax(M, K, N, rng):
    tile = _codes(rng, (16, 16), 256)
    lut8 = compose.tile_to_width(tile).astype(np.int32)
    a, b = _codes(rng, (M, K), 256), _codes(rng, (K, N), 256)
    want = np.asarray(jref.approx_matmul(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(lut8)))
    assert np.array_equal(ref.approx_matmul(_t(a), _t(b), _t(lut8)).numpy(), want)
    two = ref.approx_matmul_two_level(_t(a), _t(b), _t(tile))
    want2 = np.asarray(jref.approx_matmul_two_level(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(tile)))
    assert np.array_equal(two.numpy(), want2)
    assert np.array_equal(two.numpy(), want)


def test_approx_matmul_w8_matches_pallas_interpret(rng):
    tile = _codes(rng, (16, 16), 256)
    lut8 = compose.tile_to_width(tile).astype(np.int32)
    a, b = _codes(rng, (37, 53), 256), _codes(rng, (53, 29), 256)
    want = np.asarray(jops.approx_matmul(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(lut8),
                                         backend="pallas_interpret"))
    assert np.array_equal(ref.approx_matmul(_t(a), _t(b), _t(lut8)).numpy(), want)


def test_approx_matmul_chunked_gather_sums_the_same(rng, monkeypatch):
    """Row chunks of one row each give the same sums as one gather."""
    lut = _codes(rng, (16, 16), 256)
    a, b = _codes(rng, (9, 33), 16), _codes(rng, (33, 17), 16)
    whole = ref.approx_matmul(_t(a), _t(b), _t(lut))
    monkeypatch.setattr(ref, "_GATHER_BYTES", 1)
    assert torch.equal(ref.approx_matmul(_t(a), _t(b), _t(lut)), whole)


# ---------------------------------------------------------------------------
# W8A8 tile helpers: numpy copies and the kernel wrapper's torch twins
# ---------------------------------------------------------------------------
def test_extract_tile_and_is_composed_match_jax(rng):
    tile = rng.integers(-40, 256, size=(16, 16))
    lut8 = compose.tile_to_width(tile)
    assert np.array_equal(lut8, jcompose.tile_to_width(tile))
    assert np.array_equal(compose.extract_tile(lut8), jcompose.extract_tile(lut8))
    assert np.array_equal(compose.extract_tile(lut8), tile)
    bad = lut8.copy()
    bad[200, 3] += 1
    for table in (lut8, bad):
        assert compose.is_composed(table) == jcompose.is_composed(table)
    assert compose.is_composed(lut8) and not compose.is_composed(bad)


def test_torch_tile_twins_and_composition_check(rng):
    tiles = rng.integers(-40, 256, size=(3, 16, 16))
    stack = np.stack([compose.tile_to_width(t) for t in tiles]).astype(np.int32)
    st = _t(stack)
    assert np.array_equal(am.extract_tile(st).numpy(), tiles)
    assert np.array_equal(am.tile_to_width(_t(tiles.astype(np.int32))).numpy(), stack)
    am.check_composed(st)
    st[1, 17, 200] += 1
    with pytest.raises(ValueError, match="not composed"):
        am.check_composed(st)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
FLASH_SHAPES = [
    (1, 2, 2, 128, 128, 64),     # MHA square
    (2, 4, 2, 64, 64, 32),       # GQA 2:1
    (1, 8, 1, 64, 64, 128),      # MQA
    (1, 2, 2, 64, 192, 64),      # kv prefix (prefill continuation)
]


@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_jax(B, H, Hkv, Lq, Lk, D, dtype, rng):
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D))]
    if dtype == "bfloat16":
        pairs = [_bf16(a) for a in arrs]
    else:
        pairs = [(jnp.asarray(a), _t(a)) for a in arrs]
    want = np.asarray(jref.flash_attention(*[p[0] for p in pairs]).astype(jnp.float32))
    got = ref.flash_attention(*[p[1] for p in pairs])
    assert got.dtype == pairs[0][1].dtype
    assert np.abs(got.float().numpy() - want).max() < FLASH_TOL[dtype]


@pytest.mark.parametrize("window", [64, 128, 200])
def test_flash_ref_sliding_window(window, rng):
    q, k, v = (rng.standard_normal((1, 2, 256, 64)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), window=window))
    got = ref.flash_attention(_t(q), _t(k), _t(v), window=window)
    assert np.abs(got.numpy() - want).max() < 2e-5


def test_flash_ref_noncausal(rng):
    q, k, v = (rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), causal=False))
    got = ref.flash_attention(_t(q), _t(k), _t(v), causal=False)
    assert np.abs(got.numpy() - want).max() < 2e-5


@pytest.mark.parametrize("window", [None, 64])
def test_flash_ref_matches_pallas_interpret(window, rng):
    q = rng.standard_normal((1, 4, 128, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 256, 64)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        backend="pallas_interpret"))
    got = ref.flash_attention(_t(q), _t(k), _t(v), window=window)
    assert np.abs(got.numpy() - want).max() < 2e-5


# ---------------------------------------------------------------------------
# dispatch and wrapper checks (CPU)
# ---------------------------------------------------------------------------
def test_dispatch_runs_plain_version_on_cpu(rng):
    lut = _codes(rng, (16, 16), 256)
    a, b = _codes(rng, (5, 7), 16), _codes(rng, (7, 3), 16)
    got = ops.approx_matmul(_t(a), _t(b), _t(lut))
    assert torch.equal(got, ref.approx_matmul(_t(a), _t(b), _t(lut)))
    assert torch.equal(ops.approx_matmul(_t(a), _t(b), _t(lut), backend="ref"), got)
    with pytest.raises(ValueError, match="backend"):
        ops.approx_matmul(_t(a), _t(b), _t(lut), backend="pallas")


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    """A wrapper launches its kernel or raises: it never computes a CPU
    tensor itself."""
    a = torch.zeros((4, 8), dtype=torch.int32)
    b = torch.zeros((8, 4), dtype=torch.int32)
    lut = torch.zeros((16, 16), dtype=torch.int32)
    before = (am.approx_matmul_w4.launches, fa.flash_attention.launches)
    with pytest.raises(ValueError, match="CUDA"):
        am.approx_matmul_w4(a, b, lut)
    q = torch.zeros((1, 2, 4, 128))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    assert (am.approx_matmul_w4.launches, fa.flash_attention.launches) == before


def test_width_specs_match_jax():
    from repro.precision import widths as jw
    from repro_torch.precision import widths as tw

    for bits in (4, 8):
        t, j = tw.get_width(bits), jw.get_width(bits)
        assert (t.side, t.bias, t.qmax, t.max_k) == (j.side, j.bias, j.qmax, j.max_k)
        assert np.array_equal(tw.exact_table("mul", bits), jw.exact_table("mul", bits))
    stack = np.zeros((3, 256, 256), np.int32)
    assert tw.width_from_stack(stack).bits == jw.width_from_stack(stack).bits == 8
    with pytest.raises(KeyError):
        tw.get_width(5)
