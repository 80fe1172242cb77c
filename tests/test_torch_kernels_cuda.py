"""PyTorch port on a card: the hand-written kernels against their plain
versions (bit-equal LUT matmuls, at tile edges, extreme tables, tables
past a byte and the W8A8 overflow edge, the direct kernel on any
(256, 256) table, and template_eval; flash attention
within 2e-5 in f32 and 2e-2 in bf16 at head dims 64, 128 and 256, causal
or not, with windows, kv prefixes, ragged lengths and rows that see no
key), and the tensor search through the kernel against the same search
through the plain version.  Imports no JAX, so it runs where only the port
is installed: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kernels_cuda.py``.  Skips without a CUDA device."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import arith, engine  # noqa: E402
from repro_torch.core.circuits import input_truth_tables  # noqa: E402
from repro_torch.kernels import approx_matmul as am  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
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
    got = ops.approx_matmul(*args, direct=ops.check_luts(args[2]))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.approx_matmul(_t(a), _t(b), _t(table)))
    after = (am.approx_matmul_w4.launches, am.approx_matmul_w8.launches)
    assert sum(after) == sum(before) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 2048])
@pytest.mark.parametrize("K,N", [(1152, 6912), (6912, 1152)])
@pytest.mark.parametrize("side", [16, 256])
def test_approx_matmul_kernel_at_gemma3_shapes(cuda, M, K, N, side, rng):
    """gemma3-1b's MLP matmuls (d_model 1152, d_ff 6912) at a decode batch
    of 4 and a B=2 S=1024 prefill, the plain version on the card too."""
    if side == 16:
        table = _codes(rng, (16, 16), 256)
    else:
        table = compose.tile_to_width(_codes(rng, (16, 16), 256)).astype(np.int32)
    args = [_t(x).to(cuda) for x in (_codes(rng, (M, K), side),
                                      _codes(rng, (K, N), side), table)]
    got = ops.approx_matmul(*args, direct=ops.check_luts(args[2]))
    torch.cuda.synchronize()
    assert torch.equal(got, ref.approx_matmul(*args))


def _table(rng, side, kind="random"):
    """A W4A4 table, or a W8A8 table composed from a tile: of bytes, or
    wider ("375", "70000": one entry that large, two and three byte
    planes; "int32": any int32 entry, four planes)."""
    if kind == "random":
        tile = _codes(rng, (16, 16), 256)
    elif kind in ("375", "70000"):
        tile = _codes(rng, (16, 16), 376)
        tile[15, 15] = int(kind)
    elif kind == "int32":
        tile = rng.integers(-2**31, 2**31, size=(16, 16)).astype(np.int32)
    else:
        tile = np.full((16, 16), {"zeros": 0, "255": 255}[kind], np.int32)
    return tile if side == 16 else compose.tile_to_width(tile).astype(np.int32)


def _check_on_card(cuda, a, b, table):
    args = [_t(x).to(cuda) for x in (a, b, table)]
    got = ops.approx_matmul(*args, direct=ops.check_luts(args[2]))
    torch.cuda.synchronize()
    want = ref.approx_matmul(_t(a), _t(b), _t(table))
    assert torch.equal(got.cpu(), want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 8, 9, 63, 64, 65, 256, 1024])
@pytest.mark.parametrize("K,N", [(300, 200),   # K past the 16-deep stage, N past 128
                                 (53, 129)])   # unaligned rows: 4-byte copies
@pytest.mark.parametrize("side", [16, 256])
def test_approx_matmul_kernel_tile_edges(cuda, M, K, N, side, rng):
    """Row counts on both sides of the 8-, 64- and 128-row activation
    tiles, depths that end inside a stage, columns that end inside a
    block."""
    a, b = _codes(rng, (M, K), side), _codes(rng, (K, N), side)
    _check_on_card(cuda, a, b, _table(rng, side))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["zeros", "255", "random"])
@pytest.mark.parametrize("M,K,N", [(4, 2560, 384), (130, 257, 64)])
@pytest.mark.parametrize("side", [16, 256])
def test_approx_matmul_kernel_extreme_tables(cuda, kind, M, K, N, side, rng):
    a, b = _codes(rng, (M, K), side), _codes(rng, (K, N), side)
    _check_on_card(cuda, a, b, _table(rng, side, kind))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,side", [("375", 16), ("70000", 16), ("int32", 16),
                                       ("375", 256), ("70000", 256)])
@pytest.mark.parametrize("M,K,N", [(4, 2560, 384), (130, 257, 64), (257, 300, 129)])
def test_approx_matmul_kernel_tables_past_a_byte(cuda, kind, side, M, K, N, rng):
    """Entries past 255 take a pass over K a byte; the sum stays exact
    (modulo 2^32 for any int32 table, as the plain version's)."""
    a, b = _codes(rng, (M, K), side), _codes(rng, (K, N), side)
    _check_on_card(cuda, a, b, _table(rng, side, kind))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 300])
def test_approx_linear_takes_a_table_past_a_byte(cuda, M, rng):
    """A 16x16 table holding 375 (as composed 2-bit blocks do) passes
    check_luts and gives, through the kernel, what the plain path gives."""
    from repro_torch.quant.int4 import approx_linear

    lut = _t(_table(rng, 16, "375")).to(cuda)
    ops.check_luts(lut)
    x = torch.from_numpy(rng.standard_normal((M, 512)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal((512, 640)).astype(np.float32)).to(cuda)
    before = am.approx_matmul_w4.launches
    got = approx_linear(x, w, lut)
    assert am.approx_matmul_w4.launches == before + 1
    want = approx_linear(x, w, lut, backend="ref")
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M,N", [(3, 70), (70, 3)])
def test_approx_matmul_w8_overflow_edge(cuda, M, N):
    """Every code and tile entry 255 at K = max_k: each entry is
    255 * 289 * 29,140 = 2,147,472,300, just below 2^31, so no partial
    sum saturates."""
    from repro_torch.precision.widths import get_width

    K = get_width(8).max_k
    a = np.full((M, K), 255, np.int32)
    b = np.full((K, N), 255, np.int32)
    got = _check_on_card(cuda, a, b, _table(None, 256, "255"))
    assert bool((got == 2_147_472_300).all())


@pytest.mark.cuda
def test_approx_matmul_w8_enqueues_only_its_output(cuda, rng):
    """Per call the W8A8 wrapper allocates its output and launches the
    kernel on the composed table itself: no PyTorch op recovers the tile."""
    from torch.profiler import ProfilerActivity, profile

    a, b = (_t(_codes(rng, s, 256)).to(cuda) for s in ((4, 256), (256, 128)))
    lut = _t(_table(rng, 256)).to(cuda)
    am.approx_matmul_w8(a, b, lut)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        am.approx_matmul_w8(a, b, lut)
    ops_run = {e.key for e in prof.key_averages() if e.key.startswith("aten::")}
    assert ops_run <= {"aten::empty"}, ops_run


def _direct_table(rng, kind):
    """A (256, 256) table for the direct kernel: the profiler's 8-bit
    probe, random u16 entries, negative int32 ones (one plane: a span
    below 65,536; two: any int32), or a composed one."""
    from repro_torch.precision.widths import exact_table

    if kind == "probe":
        return ((exact_table("mul", 8) >> 8) << 8).astype(np.int32)
    if kind == "u16":
        return rng.integers(0, 65536, size=(256, 256)).astype(np.int32)
    if kind == "negative":
        return rng.integers(-30_000, 30_000, size=(256, 256)).astype(np.int32)
    if kind == "int32":
        return rng.integers(-2**31, 2**31, size=(256, 256)).astype(np.int32)
    return _table(rng, 256)


DIRECT_SHAPES = [(128, 2560, 9728), (128, 9728, 2560), (4, 2560, 9728),
                 (1, 64, 40), (8, 300, 200), (9, 53, 129), (37, 53, 29),
                 (130, 257, 64), (257, 300, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["probe", "u16", "negative", "int32", "composed"])
@pytest.mark.parametrize("M,K,N", DIRECT_SHAPES)
def test_approx_matmul_direct_kernel_on_card(cuda, kind, M, K, N, rng):
    """The direct kernel bit-equal to the plain version (on the card) for
    any (256, 256) table, at the profiler's shapes (B=4 x S=32 rows of
    qwen3-4b's w1/w3 and w2), decode's and ragged ones on both sides of
    its 8- and 32-row tiles; the route reaches it for every table but a
    composed one, and counts one launch."""
    table = _direct_table(rng, kind)
    args = [_t(x).to(cuda) for x in (_codes(rng, (M, K), 256),
                                      _codes(rng, (K, N), 256), table)]
    want = ref.approx_matmul(*args)
    got = am.approx_matmul_w8_direct(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    direct = ops.check_luts(args[2])
    assert direct is (kind != "composed")
    before = (am.approx_matmul_w8.launches, am.approx_matmul_w8_direct.launches)
    got = ops.approx_matmul(*args, direct=direct)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    after = (am.approx_matmul_w8.launches, am.approx_matmul_w8_direct.launches)
    assert after == (before[0] + (not direct), before[1] + direct)


@pytest.mark.cuda
def test_approx_matmul_direct_kernel_refuses_past_max_k(cuda, rng):
    """The direct kernel keeps W8A8's overflow-free depth, as the
    wrapper's check for every width does: refused before a launch."""
    from repro_torch.precision.widths import get_width

    K = get_width(8).max_k + 1
    a, b = (_t(_codes(rng, s, 256)).to(cuda) for s in ((2, K), (K, 3)))
    before = am.approx_matmul_w8_direct.launches
    with pytest.raises(ValueError, match="overflow-free"):
        am.approx_matmul_w8_direct(a, b, _t(_direct_table(rng, "probe")).to(cuda))
    assert am.approx_matmul_w8_direct.launches == before


# (B, H, Hkv, Lq, Lk, D, causal, window)
FLASH_CASES = [
    (1, 4, 2, 128, 128, 128, True, None), (1, 4, 2, 128, 128, 128, True, 50),
    (1, 4, 4, 100, 300, 128, True, None), (1, 4, 4, 100, 300, 128, True, 50),
    (2, 8, 1, 64, 64, 128, True, None), (2, 8, 1, 64, 64, 128, True, 50),
    (1, 4, 2, 128, 128, 64, True, None),      # head dims 64 and 256
    (1, 4, 2, 128, 128, 256, True, None),
    (1, 4, 2, 200, 200, 128, False, None),    # non-causal, ragged
    (1, 2, 1, 200, 90, 64, False, 30),        # non-causal with a window
    (1, 4, 2, 256, 256, 128, True, 64),       # windows
    (1, 4, 2, 256, 256, 128, True, 128),
    (1, 4, 2, 256, 256, 128, True, 200),
    (1, 2, 2, 320, 320, 256, True, 200),
    (1, 4, 2, 128, 384, 128, True, None),     # kv prefix
    (1, 2, 1, 77, 131, 256, True, None),      # ragged Lq and Lk
    (2, 4, 2, 130, 150, 64, True, None),
    (1, 4, 2, 300, 100, 128, True, None),     # Lk < Lq: 200 rows see no key
]


def _flash_qkv(rng, cuda, dt, B, H, Hkv, Lq, Lk, D):
    return [_t(rng.standard_normal(s).astype(np.float32)).to(cuda, dt)
            for s in ((B, H, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,D,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_on_card(cuda, B, H, Hkv, Lq, Lk, D, causal, window, dtype, rng):
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, k, v = _flash_qkv(rng, cuda, dt, B, H, Hkv, Lq, Lk, D)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == dt
    assert float((got.float() - want.float()).abs().max()) < FLASH_TOL[dtype]
    if causal and Lk < Lq:  # rows that see no key
        assert not got[:, :, :Lq - Lk].any()


@pytest.mark.cuda
@pytest.mark.parametrize("window", [512, None], ids=["local", "global"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_at_gemma3_shapes(cuda, window, dtype, rng):
    """gemma3-1b's prefill at B=2, S=1024: 4 heads on one KV head of dim
    256, its local layers at window 512 and its global ones."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, k, v = _flash_qkv(rng, cuda, dt, 2, 4, 1, 1024, 1024, 256)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention(q, k, v, causal=True, window=window)
    assert float((got.float() - want.float()).abs().max()) < FLASH_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("D,window", [(16, None), (32, None), (32, 16), (48, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_pads_small_head_dims(cuda, D, window, dtype, rng):
    """The reduced models' head dims (16, 32) run the D = 64 kernel on
    zero-padded q, k and v, once a call, within the tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, k, v = _flash_qkv(rng, cuda, dt, 2, 4, 2, 40, 40, D)
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.is_contiguous()
    want = ref.flash_attention(q, k, v, causal=True, window=window)
    assert float((got.float() - want.float()).abs().max()) < FLASH_TOL[dtype]


@pytest.mark.cuda
def test_gemma3_forward_launches_flash_on_every_layer(cuda):
    """Reduced gemma3-1b on the card: its local layer (window 16) and its
    global one each launch the flash kernel once a forward, and the
    logits match the plain route's within the bf16 flash tolerance's
    reach on a two-layer model."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward_fn, init_model

    cfg = get_config("gemma3-1b", reduced=True)
    params = init_model(cfg, seed=0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    before = fa.flash_attention.launches
    got, _ = forward_fn(cfg)(cfg, params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + cfg.n_layers
    want, _ = forward_fn(cfg)(cfg, params, {"tokens": tokens}, backend="ref")
    assert torch.equal(got[:, 0], want[:, 0])
    assert float((got - want).abs().max()) < 0.25


@pytest.mark.cuda
def test_flash_kernel_launches_once_a_call(cuda, rng):
    q, k, v = _flash_qkv(rng, cuda, torch.bfloat16, 1, 4, 2, 64, 64, 128)
    before = fa.flash_attention.launches
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["head dim 96", "head dim 36", "mixed dtypes",
                                 "unaligned"])
def test_flash_kernel_refuses_without_launching(cuda, bad, rng):
    D = {"head dim 96": 96, "head dim 36": 36}.get(bad, 128)
    q, k, v = _flash_qkv(rng, cuda, torch.bfloat16, 1, 4, 2, 64, 64, D)
    if bad == "mixed dtypes":
        k = k.float()
    elif bad == "unaligned":
        q = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    assert fa.head_dims() == (64, 128, 256)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before


# template_eval edge cases, held on the CPU by test_torch_kernels.py
# (the bit-sliced model against both plain versions) and here on the card:
# (benchmark, or "n<inputs>m<outputs>" for a made-up function on the full
# truth tables, or "n<inputs>m<outputs>w<words>" on that many random
# packed words, T, P, literals, selections, exact values).  T None is the
# template's 2m.
TE_EDGES = [
    *[(b, None, 40, "012", "01", "exact") for b in arith.BENCHMARKS],
    ("mul_i10", 12, 20, "012", "01", "exact"),     # m = 10, W = 32 words
    ("adder_i12", 9, 10, "012", "01", "exact"),    # W = 128: four chunks
    ("n5m5", 6, 30, "012", "01", "S=20"),          # 20 lanes of one word
    ("n7m6", 8, 30, "012", "01", "S=50"),          # two of four words empty
    ("mul_i8", 16, 1, "012", "01", "exact"),
    ("mul_i8", 16, 255, "012", "01", "exact"),
    ("mul_i8", 16, 257, "012", "01", "exact"),
    ("mul_i6", 10, 64, "odd", "odd", "exact"),     # lits past 2, sel past 1
    ("mul_i4", 8, 64, "012", "01", "negative"),
    ("mul_i4", 8, 64, "012", "01", "wide"),        # past m bits: 32 planes
    ("mul_i6", 12, 64, "odd", "01", "extremes"),   # INT_MIN, INT_MAX, ...
    ("adder_i4", 4, 16, "012", "01", "INT_MIN"),   # |0 - INT_MIN| = INT_MIN
    ("n5m31", 8, 24, "012", "01", "extremes"),     # m = 31
    ("n6m12", 12, 24, "odd", "odd", "negative"),
    ("n8m9", 10, 24, "012", "01", "wide"),         # m = 9: 32 output registers
    ("n17m5", 6, 12, "012", "01", "exact"),        # two key words, W = 4096
    ("n20m6w40", 8, 12, "odd", "01", "negative"),  # 16-byte literal reads past 16
    ("n40m7w3", 8, 20, "012", "odd", "S=90"),      # three key words
    ("n133m9w2", 6, 9, "odd", "01", "wide"),       # nine key words: a 2-word chunk
]


def te_id(case) -> str:
    return "-".join(str(x) for x in case)


def te_inputs(rng, case):
    """numpy lits (P, T, n), sel (P, m, T), packed words (n, W) uint32 and
    exact values (S,) int32 of one TE_EDGES case."""
    name, T, P, lit_kind, sel_kind, ev_kind = case
    tt = None
    if name.startswith("n"):
        n, m, *w = (int(x) for x in name[1:].replace("w", "m").split("m"))
        if w:
            tt = rng.integers(0, 1 << 32, size=(n, w[0]), dtype=np.uint64).astype(np.uint32)
        ev = rng.integers(0, 1 << m, size=1 << n if tt is None else 32 * w[0])
    else:
        exact = arith.benchmark(name)
        n, m = exact.n_inputs, exact.n_outputs
        ev = exact.eval_words().astype(np.int64)
    T = 2 * m if T is None else T
    lits = (rng.integers(0, 3, size=(P, T, n)) if lit_kind == "012"
            else rng.integers(-3, 7, size=(P, T, n)))
    sel = ((rng.random((P, m, T)) < 0.4) if sel_kind == "01"
           else rng.integers(-2, 4, size=(P, m, T)))
    if ev_kind == "negative":
        ev = rng.integers(-300, 300, size=ev.shape)
    elif ev_kind == "wide":
        ev = rng.integers(0, 1 << 20, size=ev.shape)
    elif ev_kind == "extremes":
        ev = rng.choice(np.array([-2**31, 2**31 - 1, 0, -1, 1, 2**30]), size=ev.shape)
    elif ev_kind == "INT_MIN":
        ev = np.full(ev.shape, -2**31)
    elif ev_kind.startswith("S="):
        ev = ev[:int(ev_kind[2:])]
    return (lits.astype(np.int32), sel.astype(np.int32),
            input_truth_tables(n) if tt is None else tt, ev.astype(np.int32))


def _te_on_card(cuda, lits, sel, tt, ev):
    args = [_t(lits), _t(sel), ref.word_bits_int32(_t(tt)), _t(ev)]
    before = te.template_eval.launches
    wce, esum = ops.template_eval(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert te.template_eval.launches == before + 1
    want = ref.template_eval(*args)
    assert torch.equal(wce.cpu(), want[0]) and torch.equal(esum.cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    *[(b, T, P, "012", "01", "exact") for b, T, P in [
        ("adder_i4", 4, 16), ("adder_i6", 8, 64), ("mul_i4", 6, 33),
        ("mul_i6", 10, 128), ("mul_i8", 12, 16), ("adder_i4", 4, 256),
        ("adder_i4", 4, 257), ("mul_i8", 16, 4096), ("mul_i4", 8, 512),
        ("mul_i10", 12, 70), ("adder_i12", 9, 45)]],
    *TE_EDGES], ids=te_id)
def test_template_eval_kernel_on_card(cuda, case, rng):
    _te_on_card(cuda, *te_inputs(rng, case))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["wave-1", "wave", "wave+1", "2wave+17", "65537"])
def test_template_eval_kernel_at_slab_edges(cuda, where, rng):
    """mul_i8 populations at the persistent loop's edges: one candidate
    short of, at and past a full wave of full slabs (blocks x slab), a
    ragged third pass, and 65,537 (the large population plus one)."""
    full = te.plan(65536, 16, 8, 8, 8, 256)
    wave = full["blocks"] * full["slab"]
    P = {"wave-1": wave - 1, "wave": wave, "wave+1": wave + 1,
         "2wave+17": 2 * wave + 17, "65537": 65537}[where]
    _te_on_card(cuda, *te_inputs(rng, ("mul_i8", 16, P, "012", "01", "exact")))


@pytest.mark.cuda
def test_template_eval_kernel_launches_once_a_call(cuda, rng):
    lits, sel, tt, ev = te_inputs(rng, ("mul_i8", 16, 65537, "012", "01", "exact"))
    args = [_t(lits).to(cuda), _t(sel).to(cuda),
            ref.word_bits_int32(_t(tt)).to(cuda), _t(ev).to(cuda)]
    assert te.plan(65537, 16, 8, 8, 8, 256)["slabs"] > 2 * te.plan(
        65537, 16, 8, 8, 8, 256)["blocks"]   # each block walks several slabs
    before = te.template_eval.launches
    te.template_eval(*args)
    assert te.template_eval.launches == before + 1
    wce, esum = te.template_eval(args[0][:0], args[1][:0], args[2], args[3])
    assert wce.shape == esum.shape == (0,)
    assert te.template_eval.launches == before + 1   # nothing to launch for P = 0


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["513 inputs", "32 outputs", "S past the words",
                                 "sel of another T", "strided lits", "exact on the CPU"])
def test_template_eval_kernel_refuses_without_launching(cuda, bad, rng):
    lits, sel, tt, ev = te_inputs(rng, ("mul_i4", 8, 33, "012", "01", "exact"))
    lits, sel, ev = _t(lits).to(cuda), _t(sel).to(cuda), _t(ev).to(cuda)
    words = ref.word_bits_int32(_t(tt)).to(cuda)
    if bad == "513 inputs":
        lits = torch.zeros((33, 8, 513), dtype=torch.int32, device=cuda)
        words = torch.zeros((513, 4), dtype=torch.int32, device=cuda)
    elif bad == "32 outputs":
        sel = torch.zeros((33, 32, 8), dtype=torch.int32, device=cuda)
    elif bad == "S past the words":
        ev = torch.zeros(33, dtype=torch.int32, device=cuda)
    elif bad == "sel of another T":
        sel = sel[:, :, :7].contiguous()
    elif bad == "strided lits":
        lits = lits.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        ev = ev.cpu()
    before = te.template_eval.launches
    with pytest.raises(ValueError):
        te.template_eval(lits, sel, words, ev)
    assert te.template_eval.launches == before


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
