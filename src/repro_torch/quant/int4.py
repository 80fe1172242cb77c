"""Symmetric integer quantization and approximate-multiplier linear layers.

Signed b-bit activations and weights run on an *unsigned* b x b
approximate multiplier through the exact shift decomposition
(``c = 2**(b-1)``)::

    (a' - c)(b' - c) = a'b' - c a' - c b' + c²,   a', b' in [0, 2**b)

Only ``a'b'`` goes through the (approximate) table; the correction terms
are exact sums.  W4A4 uses ``c = 8`` with a 16x16 table, W8A8 ``c = 128``
with a composed 256x256 table; :func:`approx_linear` reads the width from
the table it is handed.
"""

from __future__ import annotations

import torch

from ..kernels import ops
from ..parallel.api import on_matmul_shards
from ..precision.widths import NATIVE_BLOCK_BITS, get_width, width_from_lut


def quantize_intb(x: torch.Tensor, bits: int, axis: int = -1
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slice b-bit quantization: returns (int32 codes in
    ``[0, 2**bits)``, scale in ``x.dtype``) with
    ``x ≈ (codes - 2**(bits-1)) * scale``.

    The scale is ``amax * f32(1/qmax)``, not ``amax / qmax``: the JAX
    reference runs jitted, and XLA rewrites the division by a constant as a
    multiplication by its float32 reciprocal (eager JAX divides).  In f32
    the two differ by one ulp in about 60% of rows, so the port follows
    the jitted reference, computing the product in float32 and rounding
    once to ``x.dtype``.
    """
    w = get_width(bits)
    amax = x.abs().amax(dim=axis, keepdim=True)
    recip = torch.tensor(1.0 / w.qmax, dtype=torch.float32)
    scale = torch.where(amax > 0, (amax.float() * recip).to(x.dtype), 1.0)
    q = torch.clamp(torch.round(x / scale), -w.qmax, w.qmax).to(torch.int32)
    return q + w.bias, scale


def quantize_int4(x: torch.Tensor, axis: int = -1
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The 4-bit entry point."""
    return quantize_intb(x, NATIVE_BLOCK_BITS, axis=axis)


def dequantize(codes: torch.Tensor, scale: torch.Tensor,
               bits: int = NATIVE_BLOCK_BITS) -> torch.Tensor:
    bias = get_width(bits).bias
    return (codes.float() - float(bias)) * scale


def approx_linear(
    x: torch.Tensor,     # (..., K) float
    w: torch.Tensor,     # (K, N) float
    lut,                 # (side, side) int32 table, or an ops.RoutedLut
    *,
    backend: ops.Backend = "auto",
) -> torch.Tensor:
    """``x @ w`` through the approximate b-bit multiplier at the width the
    table implies (16x16 -> W4A4, 256x256 -> W8A8), with per-row
    activation scales and per-column weight scales.

    The weight is quantized on every call, as in the reference.  Under a
    mesh the table product runs on local shards
    (:func:`repro_torch.parallel.api.on_matmul_shards`).  A
    :class:`~repro_torch.kernels.ops.RoutedLut` carries the table's form
    on the kernel route to the launch (a (256, 256) table needs one).
    """
    direct = None
    if isinstance(lut, ops.RoutedLut):
        lut, direct = lut
    spec = width_from_lut(lut)
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    xq, sx = quantize_intb(x2, spec.bits, axis=-1)    # (M, K), (M, 1)
    wq, sw = quantize_intb(w, spec.bits, axis=0)      # (K, N), (1, N)

    raw = on_matmul_shards(
        lambda a, b: ops.approx_matmul(a, b, lut, direct=direct, backend=backend),
        xq, wq).float()
    # exact correction of the biased-unsigned decomposition
    c = float(spec.bias)
    sum_a = xq.sum(dim=1, keepdim=True).float()   # (M, 1)
    sum_b = wq.sum(dim=0, keepdim=True).float()   # (1, N)
    corrected = raw - c * sum_a - c * sum_b + c * c * K
    out = corrected * sx * sw
    return out.reshape(*lead, w.shape[1]).to(x.dtype)
