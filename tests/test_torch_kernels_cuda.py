"""PyTorch port on a card: the hand-written kernels against their plain
versions (bit-equal LUT matmuls and template_eval; flash attention within
2e-5 in f32 and 2e-2 in bf16), and the tensor search through the kernel
against the same search through the plain version.  Imports no JAX, so it runs where only the port is
installed: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
Skips without a CUDA device."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import arith, engine  # noqa: E402
from repro_torch.core.circuits import input_truth_tables  # noqa: E402
from repro_torch.kernels import approx_matmul as am  # noqa: E402
from repro_torch.kernels import template_eval as te  # noqa: E402
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


@pytest.mark.cuda
@pytest.mark.parametrize("bench,T,P", [
    ("adder_i4", 4, 16), ("adder_i6", 8, 64), ("mul_i4", 6, 33),
    ("mul_i6", 10, 128), ("mul_i8", 12, 16), ("adder_i4", 4, 256),
    ("adder_i4", 4, 257), ("mul_i8", 16, 4096), ("mul_i4", 8, 512),
    ("mul_i10", 12, 70),     # m = 10 outputs, W = 32 words
    ("adder_i12", 9, 45),    # W = 128 words: each thread loops over 4
])
def test_template_eval_kernel_on_card(cuda, bench, T, P, rng):
    exact = arith.benchmark(bench)
    n, m = exact.n_inputs, exact.n_outputs
    lits = rng.integers(0, 3, size=(P, T, n)).astype(np.int32)
    sel = (rng.random((P, m, T)) < 0.4).astype(np.int32)
    words = ref.word_bits_int32(_t(input_truth_tables(n)))
    args = [_t(lits), _t(sel), words, _t(exact.eval_words().astype(np.int32))]
    before = te.template_eval.launches
    wce, esum = ops.template_eval(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert te.template_eval.launches == before + 1
    want = ref.template_eval(*args)
    assert torch.equal(wce.cpu(), want[0]) and torch.equal(esum.cpu(), want[1])


@pytest.mark.cuda
def test_template_eval_kernel_takes_only_int32_words(cuda, rng):
    """The wrapper takes the packed words as int32 with their bits, as the
    search converts them once; other word forms are refused, not converted."""
    exact = arith.benchmark("mul_i4")
    lits = _t(rng.integers(0, 3, size=(8, 6, 4)).astype(np.int32)).to(cuda)
    sel = _t((rng.random((8, 4, 6)) < 0.4).astype(np.int32)).to(cuda)
    ev = _t(exact.eval_words().astype(np.int32)).to(cuda)
    words = _t(input_truth_tables(4).astype(np.int64)).to(cuda)
    before = te.template_eval.launches
    with pytest.raises(ValueError, match="in_tt"):
        te.template_eval(lits, sel, words, ev)
    assert te.template_eval.launches == before
    wce, esum = te.template_eval(lits, sel, ref.word_bits_int32(words), ev)
    want = ref.template_eval(lits.cpu(), sel.cpu(), words.cpu(), ev.cpu())
    assert torch.equal(wce.cpu(), want[0]) and torch.equal(esum.cpu(), want[1])


@pytest.mark.cuda
def test_tensor_search_through_the_kernel_equals_the_plain_path(cuda):
    job = engine.SearchJob("adder", 2, et=2, engine="tensor", budget_s=600)

    def run(backend):
        out = engine.get_engine("tensor", population=1024, generations=24,
                                backend=backend).run(job)
        return ([(c.area, c.proxies, c.meta, c.params.lits.tobytes(),
                  c.params.sel.tobytes()) for c in out.results], out.stats)

    before = te.template_eval.launches
    got = run("auto")
    assert te.template_eval.launches == before + 25
    assert got == run("ref")
    assert got[0], "the search must find sound results for the check to bite"
