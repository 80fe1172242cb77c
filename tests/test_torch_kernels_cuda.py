"""PyTorch port on a card: the hand-written kernels against their plain
versions (bit-equal LUT matmuls; flash attention within 2e-5 in f32 and
2e-2 in bf16).  Imports no JAX, so it runs where only the port is
installed: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
Skips without a CUDA device."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import approx_matmul as am  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.precision import compose  # noqa: E402

FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")


def _codes(rng, shape, side):
    return rng.integers(0, side, size=shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1, 64, 40), (4, 2560, 384), (37, 53, 29),
                                   (130, 257, 64), (257, 300, 129)])
@pytest.mark.parametrize("side", [16, 256])
def test_approx_matmul_kernel_on_card(cuda, M, K, N, side, rng):
    if side == 16:
        table = _codes(rng, (16, 16), 256)
    else:
        table = compose.tile_to_width(_codes(rng, (16, 16), 256)).astype(np.int32)
    a, b = _codes(rng, (M, K), side), _codes(rng, (K, N), side)
    args = [_t(x).to(cuda) for x in (a, b, table)]
    before = (am.approx_matmul_w4.launches, am.approx_matmul_w8.launches)
    got = ops.approx_matmul(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.approx_matmul(_t(a), _t(b), _t(table)))
    after = (am.approx_matmul_w4.launches, am.approx_matmul_w8.launches)
    assert sum(after) == sum(before) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Lq,Lk", [(1, 4, 2, 128, 128), (1, 4, 4, 100, 300),
                                           (2, 8, 1, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 50])
def test_flash_kernel_on_card(cuda, B, H, Hkv, Lq, Lk, dtype, window, rng):
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q = _t(rng.standard_normal((B, H, Lq, 128)).astype(np.float32)).to(cuda, dt)
    k = _t(rng.standard_normal((B, Hkv, Lk, 128)).astype(np.float32)).to(cuda, dt)
    v = _t(rng.standard_normal((B, Hkv, Lk, 128)).astype(np.float32)).to(cuda, dt)
    got = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention(q, k, v, window=window)
    assert got.dtype == dt
    assert float((got.float() - want.float()).abs().max()) < FLASH_TOL[dtype]
