"""PyTorch port: quant/int4 against the jitted JAX reference.

The serving engine runs the reference jitted, where XLA multiplies by the
float32 reciprocal of ``qmax`` instead of dividing; the port follows that
(see ``repro_torch.quant.int4.quantize_intb``).  Codes must be bit-equal
at both widths in f32 and bf16; the ``approx_linear`` output within 1e-6
relative in f32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.quant import int4 as jint4  # noqa: E402
from repro.precision.compose import tile_to_width  # noqa: E402
from repro_torch.quant import int4  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    j = jnp.asarray(x, DTYPES[dtype][0])
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32)).copy()).to(DTYPES[dtype][1])
    return j, t


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_codes_bit_equal_to_jit(bits, dtype, axis, rng):
    x = rng.standard_normal((512, 96)).astype(np.float32) * 3
    x[7] = 0.0  # an all-zero row takes the scale-1 branch
    xj, xt = _pair(x, dtype)
    cj, sj = jax.jit(jint4.quantize_intb, static_argnums=(1, 2))(xj, bits, axis)
    ct, st = int4.quantize_intb(xt, bits, axis=axis)
    assert ct.dtype == torch.int32 and st.dtype == xt.dtype
    assert np.array_equal(ct.numpy(), np.asarray(cj))
    assert np.array_equal(st.float().numpy(), np.asarray(sj.astype(jnp.float32)))


def test_quantize_int4_and_dequantize(rng):
    x = rng.standard_normal((64, 32)).astype(np.float32)
    xj, xt = _pair(x, "float32")
    cj, sj = jax.jit(jint4.quantize_int4)(xj)
    ct, st = int4.quantize_int4(xt)
    assert np.array_equal(ct.numpy(), np.asarray(cj))
    dj = np.asarray(jax.jit(jint4.dequantize)(cj, sj))
    assert np.array_equal(int4.dequantize(ct, st).numpy(), dj)


def _tables():
    ex = np.arange(16)[:, None] * np.arange(16)[None, :]
    trunc = ex & ~3
    return {"w4-exact": ex, "w4-trunc": trunc,
            "w8-exact": tile_to_width(ex), "w8-trunc": tile_to_width(trunc)}


@pytest.mark.parametrize("table", list(_tables()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_approx_linear_matches_jit(table, dtype, rng):
    lut = _tables()[table].astype(np.int32)
    x = rng.standard_normal((2, 5, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) / 10).astype(np.float32)
    (xj, xt), (wj, wt) = _pair(x, dtype), _pair(w, dtype)
    want = np.asarray(jax.jit(jint4.approx_linear)(xj, wj, jnp.asarray(lut))
                      .astype(jnp.float32))
    got = int4.approx_linear(xt, wt, torch.from_numpy(lut))
    assert got.shape == (2, 5, 40) and got.dtype == xt.dtype
    got = got.float().numpy()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:  # same codes, same f32 correction, one rounding to bf16
        assert np.array_equal(got, want)
