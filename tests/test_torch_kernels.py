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
from repro_torch.kernels import template_eval as te  # noqa: E402
from repro_torch.precision import compose  # noqa: E402
from test_torch_kernels_cuda import TE_EDGES, te_id, te_inputs  # noqa: E402

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
# the LUT matmul kernels' tensor-core form (csrc/approx_matmul.cu), in
# integers on the CPU: one u8 operand one-hot, the other the table's rows
# ---------------------------------------------------------------------------
def _onehot(codes, weights):
    """(..., 16) planes: sum of w * [nibble = i] over (nibble, w) pairs."""
    i = np.arange(16)
    return sum(w * (nib[..., None] == i) for nib, w in zip(codes, weights))


def _tensor_core_form(a, b, table, bits, one_hot_side):
    """``sum_k LUT[a, b]`` as u8 products of contraction depth 16 K.

    W4A4 (16x16 ``table``): one side is ``[code = i]``, the other the
    table's 16 entries at the code.  W8A8 (``table`` the 16x16 tile):
    the one-hot side weighs the nibbles ``[lo = i] + 16 [hi = i]``, the
    other side has a plane per nibble, combined with weights 1 and 16.
    A table wider than a byte is taken a byte plane at a time (its
    32-bit two's-complement bytes), combined by Horner's rule modulo
    2^32, as the int32 sum.  ``one_hot_side`` "b" is the kernel's
    orientation, "a" its mirror.  Returns the sum and every operand."""
    M, K = a.shape
    N = b.shape[1]
    oh, ex = (b.T, a) if one_hot_side == "b" else (a, b.T)   # (rows, K) codes
    if bits == 8:
        hot = _onehot((oh & 15, oh >> 4), (1, 16))
    else:
        hot = _onehot((oh,), (1,))
    hot_t = torch.from_numpy(hot.reshape(hot.shape[0], 16 * K).astype(np.int64))
    word = table.astype(np.int64) & 0xFFFFFFFF
    n_bytes = max(1, (int(word.max()).bit_length() + 7) // 8)
    total, operands = 0, [hot]
    for byte in reversed(range(n_bytes)):
        tb = (word >> (8 * byte)) & 255
        rows = tb if one_hot_side == "b" else tb.T           # expanded: T[x, i] or T[i, y]
        planes = [rows[ex & 15], rows[ex >> 4]] if bits == 8 else [rows[ex]]
        sums = [torch.from_numpy(p.reshape(p.shape[0], 16 * K).astype(np.int64)) @ hot_t.T
                for p in planes]
        total = 256 * total + (sums[0] if len(sums) == 1 else sums[0] + 16 * sums[1])
        operands += planes
    total = (total + 2**31) % 2**32 - 2**31                  # the int32 wrap
    if one_hot_side == "a":
        total = total.T
    assert total.shape == (M, N)
    return total, operands


@pytest.mark.parametrize("one_hot_side", ["b", "a"])
@pytest.mark.parametrize("M,K,N", [(37, 53, 29), (4, 96, 40), (1, 64, 24)])
@pytest.mark.parametrize("table_kind", ["w4 random", "w4 zeros", "w4 255",
                                        "w8 random", "w8 255", "w4 375",
                                        "w8 375", "w4 int32", "w8 int32"])
def test_tensor_core_form_matches_ref(table_kind, M, K, N, one_hot_side, rng):
    width, kind = table_kind.split()
    side = 16 if width == "w4" else 256
    table = {"random": _codes(rng, (16, 16), 256),
             "zeros": np.zeros((16, 16), np.int32),
             "255": np.full((16, 16), 255, np.int32),
             # two byte planes: composed 2-bit blocks reach 375
             "375": _codes(rng, (16, 16), 376),
             # four byte planes, negative entries too: exact modulo 2^32
             "int32": rng.integers(-2**31, 2**31, size=(16, 16)).astype(np.int32),
             }[kind]
    if kind == "375":
        table[15, 15] = 375
    lut = table if side == 16 else compose.tile_to_width(table).astype(np.int32)
    a, b = _codes(rng, (M, K), side), _codes(rng, (K, N), side)
    a[0, 0], b[0, 0] = side - 1, side - 1     # the top code on both sides
    got, operands = _tensor_core_form(a, b, table, 4 if side == 16 else 8,
                                      one_hot_side)
    for op in operands:
        assert op.min() >= 0 and op.max() <= 255
    want = ref.approx_matmul(_t(a), _t(b), _t(lut))
    assert torch.equal(got, want.long())
    want_jax = np.asarray(jref.approx_matmul(jnp.asarray(a), jnp.asarray(b),
                                             jnp.asarray(lut)))
    assert np.array_equal(got.numpy(), want_jax)


def test_tensor_core_form_overflow_edge():
    """At W8A8's max_k with every code and tile entry 255, each plane's s32
    sum stays below 2^31 and the shift-add gives 255 * 289 * K exactly."""
    from repro_torch.precision.widths import get_width

    max_k = get_width(8).max_k
    assert max_k == 29_140 and 255 * 289 * max_k == 2_147_472_300
    assert 17 * 255 * max_k < 2**31
    K = 40
    a = np.full((2, K), 255, np.int32)
    b = np.full((K, 3), 255, np.int32)
    tile = np.full((16, 16), 255, np.int32)
    got, (hot, lo, hi) = _tensor_core_form(a, b, tile, 8, "b")
    plane = torch.from_numpy(lo.reshape(2, 16 * K).astype(np.int64)) @ \
        torch.from_numpy(hot.reshape(3, 16 * K).astype(np.int64)).T
    assert bool((plane == 17 * 255 * K).all())
    assert bool((got == 255 * 289 * K).all())


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
    assert am.is_composed(st).tolist() == [True, True, True]
    assert am.check_tables(st) == (False, False, False)
    st[1, 17, 200] += 1
    assert am.is_composed(st).tolist() == [True, False, True]
    # the uncomposed table goes to the direct kernel, the others stay
    assert am.check_tables(st) == (False, True, False)
    assert am.check_tables(st[1]) is True and am.check_tables(st[0]) is False
    assert am.check_tables(_t(tiles.astype(np.int32))) is None
    with pytest.raises(ValueError, match="256, 256"):
        am.is_composed(_t(tiles.astype(np.int32)))


def _table_with(rng, side, entry):
    tile = _codes(rng, (16, 16), 256)
    tile[3, 5] = entry
    return tile if side == 16 else compose.tile_to_width(tile).astype(np.int32)


def _ref_equals_oracle(rng, side, lut):
    a, b = _codes(rng, (5, 9), side), _codes(rng, (9, 4), side)
    a[0, :], b[:, 0] = 3 if side == 16 else 0x53, 5 if side == 16 else 0x35
    want = np.asarray(jref.approx_matmul(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(lut)))
    assert np.array_equal(ops.approx_matmul(_t(a), _t(b), _t(lut),
                                            backend="ref").numpy(), want)


def _spy_kernels(monkeypatch):
    """Send int32 operands down the kernel route as CUDA tensors would,
    and record which kernel wrapper each LUT matmul reaches: each spy
    computes what its kernel computes (the tensor-core form for the two
    tile kernels, the direct form's algebra for the direct one) and
    launches nothing.  The plain version raises if the route reaches it."""
    calls = []

    def spy(name, form):
        def kernel(a, b, lut):
            calls.append(name)
            if form == "direct":
                return torch.from_numpy(_direct_form(a.numpy(), b.numpy(), lut.numpy(), 16))
            table = lut.numpy() if lut.shape[-1] == 16 else am.extract_tile(lut).numpy()
            got, _ = _tensor_core_form(a.numpy(), b.numpy(), table,
                                       4 if lut.shape[-1] == 16 else 8, "b")
            return got.to(torch.int32)
        return kernel

    def plain(*args, **kw):
        raise AssertionError("the kernel route reached the plain version")

    monkeypatch.setattr(ops, "use_kernel",
                        lambda x, backend: backend == "auto" and x.dtype == torch.int32)
    for name, form in (("approx_matmul_w4", "tile"), ("approx_matmul_w8", "tile"),
                       ("approx_matmul_w8_direct", "direct")):
        monkeypatch.setattr(am, name, spy(name, form))
    monkeypatch.setattr(ops.ref, "approx_matmul", plain)
    return calls


@pytest.mark.parametrize("bad", [-1, -300])
@pytest.mark.parametrize("side", [16, 256])
def test_kernel_route_refuses_negative_tables(bad, side, rng, monkeypatch):
    """The kernels are exact modulo 2^32 for any int32 table, so the
    kernel route refuses no negative entry: check_luts passes it (a
    composed W8A8 table stays on the W8A8 kernel), the route's kernel
    computes what the JAX oracle does, and backend='ref' does too."""
    lut = _table_with(rng, side, bad)
    stack = _t(np.stack([lut, lut]))
    want_form = None if side == 16 else (False, False)
    assert am.check_tables(stack) == want_form
    _ref_equals_oracle(rng, side, lut)
    calls = _spy_kernels(monkeypatch)
    assert ops.check_luts(stack) == want_form
    assert ops.check_luts(stack, backend="ref") is None
    a, b = _codes(rng, (5, 9), side), _codes(rng, (9, 4), side)
    a[0, :], b[:, 0] = 3 if side == 16 else 0x53, 5 if side == 16 else 0x35
    want = np.asarray(jref.approx_matmul(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(lut)))
    got = ops.approx_matmul(_t(a), _t(b), _t(lut),
                            direct=None if side == 16 else want_form[0])
    assert np.array_equal(got.numpy(), want)
    assert calls == ["approx_matmul_w4" if side == 16 else "approx_matmul_w8"]


# ---------------------------------------------------------------------------
# the direct kernel's algebra (csrc/approx_matmul.cu, lut_direct_kernel), in
# integers on the CPU: offsets from the table's least entry in u16 planes
# ---------------------------------------------------------------------------
def _direct_form(a, b, table, chunk):
    """``sum_k LUT[a, b]`` as the direct kernel computes it: K split into
    ranges of ``chunk`` codes (a multiple of the 16-deep stage), each
    padded with zero codes to whole stages; per range, one pass a u16
    plane of ``LUT - lo`` (two where the entries span 65,536 or more,
    taken by Horner's rule), each pass's padding taking back its
    plane[0], then ``live * lo``; the ranges added, every step modulo
    2^32.  Returns int32."""
    M, K = a.shape
    N = b.shape[1]
    lo = int(table.min())
    off = (table.astype(np.int64) - lo) & 0xFFFFFFFF
    n_planes = 2 if int(off.max()) > 0xFFFF else 1
    out = np.zeros((M, N), np.uint64)
    for kb in range(0, K, chunk):
        ke = min(K, kb + chunk)
        padded = -(-(ke - kb) // 16) * 16
        ap = np.zeros((M, padded), np.int64)
        bp = np.zeros((padded, N), np.int64)
        ap[:, :ke - kb], bp[:ke - kb] = a[:, kb:ke], b[kb:ke]
        acc = np.zeros((M, N), np.uint64)
        for p in reversed(range(n_planes)):
            plane = (off >> (16 * p)) & 0xFFFF
            acc = (acc << np.uint64(16)) & np.uint64(0xFFFFFFFF)
            sums = plane[ap[:, :, None], bp[None, :, :]].sum(axis=1).astype(np.uint64)
            dead = np.uint64((padded - (ke - kb)) * int(plane[0, 0]))
            acc = (acc + sums - dead) & np.uint64(0xFFFFFFFF)
        base = np.uint64(((ke - kb) * lo) & 0xFFFFFFFF)
        out = (out + acc + base) & np.uint64(0xFFFFFFFF)
    return out.astype(np.uint32).view(np.int32)


def _direct_table(rng, kind):
    from repro_torch.precision.widths import exact_table

    if kind == "probe":                    # the profiler's 8-bit probe
        return ((exact_table("mul", 8) >> 8) << 8).astype(np.int32)
    if kind == "exact":
        return exact_table("mul", 8).astype(np.int32)
    if kind == "composed":
        return compose.tile_to_width(_codes(rng, (16, 16), 256)).astype(np.int32)
    if kind == "u16":
        return rng.integers(0, 65536, size=(256, 256)).astype(np.int32)
    if kind == "span 65536":               # the least span that takes two planes
        t = rng.integers(0, 65536, size=(256, 256)).astype(np.int32)
        t[0, 0], t[255, 255] = -7, 65529
        return t
    if kind == "negative":
        return rng.integers(-40_000, 20_000, size=(256, 256)).astype(np.int32)
    return rng.integers(-2**31, 2**31, size=(256, 256)).astype(np.int32)  # int32


@pytest.mark.parametrize("kind", ["probe", "exact", "composed", "u16",
                                  "span 65536", "negative", "int32"])
@pytest.mark.parametrize("M,K,N,chunk", [(37, 53, 29, 16), (37, 53, 29, 64),
                                         (4, 96, 40, 32), (1, 64, 24, 64),
                                         (9, 33, 17, 16)])
def test_direct_form_matches_ref(kind, M, K, N, chunk, rng):
    """The direct kernel's algebra, at ragged shapes and K split into
    ranges or whole, gives the JAX oracle's int32 sum for any table:
    random int32 and negative entries, the probe, composed tables."""
    table = _direct_table(rng, kind)
    a, b = _codes(rng, (M, K), 256), _codes(rng, (K, N), 256)
    a[0, 0], b[0, 0] = 255, 255
    got = _direct_form(a, b, table, chunk)
    want = np.asarray(jref.approx_matmul(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(table)))
    assert np.array_equal(got, want)
    assert torch.equal(torch.from_numpy(got), ref.approx_matmul(_t(a), _t(b), _t(table)))


@pytest.mark.parametrize("kind", ["probe", "u16", "negative", "int32", "composed"])
def test_route_sends_each_table_to_its_kernel(kind, rng, monkeypatch):
    """check_luts names the direct kernel for every table that is not
    composed; ops.approx_matmul with that form reaches it, never the
    plain version, and gives the oracle's sum; without a form it reads
    no table and raises before any kernel."""
    table = _direct_table(rng, kind)
    direct = kind != "composed"
    calls = _spy_kernels(monkeypatch)
    assert ops.check_luts(_t(table)) is direct
    a, b = _codes(rng, (6, 40), 256), _codes(rng, (40, 7), 256)
    want = np.asarray(jref.approx_matmul(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(table)))
    got = ops.approx_matmul(_t(a), _t(b), _t(table), direct=direct)
    assert np.array_equal(got.numpy(), want)
    monkeypatch.setattr(am, "is_composed", None)
    with pytest.raises(ValueError, match="needs its form"):
        ops.approx_matmul(_t(a), _t(b), _t(table))
    assert calls == ["approx_matmul_w8_direct" if direct else "approx_matmul_w8"]


@pytest.mark.parametrize("wide", [256, 375, 70_000])
@pytest.mark.parametrize("side", [16, 256])
def test_kernel_route_takes_tables_past_a_byte(wide, side, rng, monkeypatch):
    """Entries past 255 (composed 2-bit blocks reach 375) stay on the
    kernel route: the kernel adds a pass over K for each further byte."""
    lut = _table_with(rng, side, wide)
    stack = _t(np.stack([lut, lut]))
    am.check_tables(stack)
    monkeypatch.setattr(ops, "use_kernel", lambda x, backend: backend == "auto")
    ops.check_luts(stack)
    _ref_equals_oracle(rng, side, lut)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
FLASH_SHAPES = [
    (1, 2, 2, 128, 128, 64),     # MHA square
    (2, 4, 2, 64, 64, 32),       # GQA 2:1
    (1, 8, 1, 64, 64, 128),      # MQA
    (1, 2, 2, 64, 192, 64),      # kv prefix (prefill continuation)
    (1, 2, 1, 128, 128, 256),    # head dim 256 (gemma3)
    (1, 8, 2, 128, 128, 128),    # the main path's group ratio (qwen3-4b 32/8)
]


def _flash_inputs(rng, B, H, Hkv, Lq, Lk, D, dtype):
    """(jax, torch) pairs of q, k, v holding the same values."""
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D))]
    if dtype == "bfloat16":
        return [_bf16(a) for a in arrs]
    return [(jnp.asarray(a), _t(a)) for a in arrs]


@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_jax(B, H, Hkv, Lq, Lk, D, dtype, rng):
    pairs = _flash_inputs(rng, B, H, Hkv, Lq, Lk, D, dtype)
    want = np.asarray(jref.flash_attention(*[p[0] for p in pairs]).astype(jnp.float32))
    got = ref.flash_attention(*[p[1] for p in pairs])
    assert got.dtype == pairs[0][1].dtype
    assert np.abs(got.float().numpy() - want).max() < FLASH_TOL[dtype]


@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_pallas_interpret_shapes(B, H, Hkv, Lq, Lk, D, dtype, rng):
    """64-row blocks, so every shape divides and the kernel walks
    several kv blocks."""
    from repro.kernels.flash_attention import flash_attention_pallas

    pairs = _flash_inputs(rng, B, H, Hkv, Lq, Lk, D, dtype)
    want = np.asarray(flash_attention_pallas(
        *[p[0] for p in pairs], block_q=64, block_k=64,
        interpret=True).astype(jnp.float32))
    got = ref.flash_attention(*[p[1] for p in pairs])
    assert np.abs(got.float().numpy() - want).max() < FLASH_TOL[dtype]


def test_flash_ref_rows_without_a_key_give_zero(rng):
    """Causal with Lk < Lq: the first Lq - Lk rows see no key and give 0
    (the kernel's guarded zero denominator); the rest match the oracle."""
    q = rng.standard_normal((1, 4, 96, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 40, 64)).astype(np.float32)
            for _ in range(2))
    got = ref.flash_attention(_t(q), _t(k), _t(v)).numpy()
    assert not got[:, :, :56].any()
    want = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v)))
    assert np.abs(got[:, :, 56:] - want[:, :, 56:]).max() < 2e-5


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
        assert t.benchmark_name == j.benchmark_name
        assert np.array_equal(tw.exact_table("mul", bits), jw.exact_table("mul", bits))
    stack = np.zeros((3, 256, 256), np.int32)
    assert tw.width_from_stack(stack).bits == jw.width_from_stack(stack).bits == 8
    with pytest.raises(KeyError):
        tw.get_width(5)


# ---------------------------------------------------------------------------
# template_eval
# ---------------------------------------------------------------------------
# the cases of tests/test_kernels_template_eval.py, plus the population at
# and just past the Pallas block of 256
TEMPLATE_CASES = [("adder_i4", 4, 16), ("adder_i6", 8, 64), ("mul_i4", 6, 33),
                  ("mul_i6", 10, 128), ("mul_i8", 12, 16),
                  ("adder_i4", 4, 256), ("adder_i4", 4, 257)]


def _population(rng, bench, T, P):
    from repro.core.arith import benchmark
    from repro.core.circuits import input_truth_tables

    exact = benchmark(bench)
    n, m = exact.n_inputs, exact.n_outputs
    lits = rng.integers(0, 3, size=(P, T, n)).astype(np.int32)
    sel = (rng.random((P, m, T)) < 0.4).astype(np.int32)
    return exact, lits, sel, input_truth_tables(n), exact.eval_words().astype(np.int32)


@pytest.mark.parametrize("bench,T,P", TEMPLATE_CASES)
def test_template_eval_matches_jax_and_numpy(bench, T, P, rng):
    from repro.core.miter import values_from_tables
    from repro.core.templates import SharedTemplate, TemplateParams

    exact, lits, sel, tt, ev = _population(rng, bench, T, P)
    jargs = [jnp.asarray(x) for x in (lits, sel, tt, ev)]
    w_ref, s_ref = jops.template_eval(*jargs, backend="ref")
    w_pal, s_pal = jops.template_eval(*jargs, backend="pallas_interpret")
    wce, esum = ops.template_eval(_t(lits), _t(sel), _t(tt), _t(ev))
    assert wce.dtype == esum.dtype == torch.int32 and wce.shape == (P,)
    for got, want in ((wce, w_ref), (wce, w_pal), (esum, s_ref), (esum, s_pal)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    tpl = SharedTemplate(exact.n_inputs, exact.n_outputs, pit=T)
    ev64 = ev.astype(np.int64)
    for p in range(0, P, max(1, P // 9)):
        tp = TemplateParams(lits[p].astype(np.int8), sel[p].astype(bool))
        vals = values_from_tables(tpl.eval_outputs(tp), exact.n_inputs)
        err = np.abs(vals.astype(np.int64) - ev64)
        assert (int(err.max()), int(err.sum())) == (int(wce[p]), int(esum[p]))


def test_template_eval_word_forms_agree(rng):
    """uint32 words, int32 words with the same bits (the kernel's view) and
    int64 words give the same result; the int32 view keeps every bit."""
    _, lits, sel, tt, ev = _population(rng, "mul_i8", 16, 40)
    want = ref.template_eval(_t(lits), _t(sel), _t(tt), _t(ev))
    as_i32 = ref.word_bits_int32(_t(tt))
    assert as_i32.dtype == torch.int32
    assert np.array_equal(as_i32.numpy().view(np.uint32), tt)
    for words in (as_i32, _t(tt.astype(np.int64))):
        got = ref.template_eval(_t(lits), _t(sel), words, _t(ev))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ref.words64(_t(tt)).max() == 0xFFFFFFFF


def test_template_eval_dispatch_and_wrapper_refusal(rng):
    _, lits, sel, tt, ev = _population(rng, "mul_i4", 6, 9)
    args = [_t(x) for x in (lits, sel, tt, ev)]
    got = ops.template_eval(*args, backend="ref")
    assert all(torch.equal(g, w) for g, w in zip(got, ops.template_eval(*args)))
    with pytest.raises(ValueError, match="backend"):
        ops.template_eval(*args, backend="pallas")
    before = te.template_eval.launches
    with pytest.raises(ValueError, match="CUDA"):
        te.template_eval(*args)
    assert te.template_eval.launches == before


@pytest.mark.parametrize("case", TE_EDGES, ids=te_id)
def test_template_eval_bitsliced_matches_ref_and_jax(case, rng):
    """The kernel's arithmetic (ref.template_eval_bitsliced: mask
    compression, group tables, borrow-ripple subtract, conditional negate,
    top-down max scan, popcount sum) bit-equal to the port's plain version
    and to the JAX package's reference, at every edge case the card tests
    hold the kernel to."""
    lits, sel, tt, ev = te_inputs(rng, case)
    got = ref.template_eval_bitsliced(_t(lits), _t(sel), ref.word_bits_int32(_t(tt)), _t(ev))
    want = ref.template_eval(_t(lits), _t(sel), _t(tt), _t(ev))
    w_jax, s_jax = jref.template_eval(*[jnp.asarray(x) for x in (lits, sel, tt, ev)])
    assert got[0].dtype == got[1].dtype == torch.int32
    for g, w, j in zip(got, want, (w_jax, s_jax)):
        assert torch.equal(g, w)
        assert np.array_equal(g.numpy(), np.asarray(j))
