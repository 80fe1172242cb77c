"""LUT construction: a two-operand netlist -> its behaviour table.

Own copy of ``repro.quant.lut``: whatever circuit the search produced,
its full behaviour over b-bit operands is a ``(2**b, 2**b)`` table, which
the LUT matmul kernels apply bit-exactly inside model matmuls.
"""

from __future__ import annotations

import numpy as np

from ..core.circuits import Circuit

__all__ = ["build_lut", "exact_mul_lut"]


def build_lut(mult_circuit: Circuit) -> np.ndarray:
    """Evaluate a b-bit two-operand circuit into a (2**b, 2**b) int32 LUT.

    Inputs are ``[a0.., b0..]`` LSB-first, so assignment index =
    ``a + 2**b * b'``.
    """
    assert mult_circuit.n_inputs % 2 == 0, "expects a two-operand circuit"
    bits = mult_circuit.n_inputs // 2
    side = 1 << bits
    vals = mult_circuit.eval_words().astype(np.int32)  # (2**(2b),)
    a = np.arange(side)
    return vals[a[:, None] + side * a[None, :]]


def exact_mul_lut() -> np.ndarray:
    """The exact 4-bit product table."""
    a = np.arange(16, dtype=np.int32)
    return a[:, None] * a[None, :]
