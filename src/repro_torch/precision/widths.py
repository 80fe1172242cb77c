"""Width registry: the facts that depend on the operand bit-width.

Own copy of ``repro.precision.widths`` (``WidthSpec`` and the lookups the
inference path reads).  ``side`` gives the code range and table side the
LUT kernels take, ``bias``/``qmax`` the biased-unsigned
code decomposition of :func:`repro_torch.quant.int4.quantize_intb`, and
``max_k`` the deepest contraction whose int32 accumulation cannot
overflow.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# the widest operand the template searches cover; wider targets compose
NATIVE_BLOCK_BITS = 4


@dataclass(frozen=True)
class WidthSpec:
    """Everything width-dependent about one operand bit-width."""

    bits: int

    @property
    def side(self) -> int:
        """Code range: codes live in ``[0, side)``."""
        return 1 << self.bits

    @property
    def bias(self) -> int:
        """Signed-code bias: ``x ≈ (code - bias) * scale``."""
        return 1 << (self.bits - 1)

    @property
    def qmax(self) -> int:
        """Largest quantized magnitude (symmetric range, code 0 unused)."""
        return self.bias - 1

    @property
    def max_k(self) -> int:
        """Largest contraction depth with overflow-free int32 accumulation:
        a 4-bit table entry is at most 255, an 8-bit composed entry at
        most ``255 * 289`` (shift weights ``1 + 2*16 + 256``)."""
        bound = 255 if self.bits <= NATIVE_BLOCK_BITS else 255 * 289
        return (2**31 - 1) // bound

    @property
    def benchmark_name(self) -> str:
        """The exact reference circuit of this width's multiplier."""
        return f"mul_i{2 * self.bits}"


WIDTHS: dict[int, WidthSpec] = {4: WidthSpec(4), 8: WidthSpec(8)}
SUPPORTED_WIDTHS: tuple[int, ...] = tuple(sorted(WIDTHS))


def get_width(bits: int) -> WidthSpec:
    try:
        return WIDTHS[int(bits)]
    except KeyError:
        raise KeyError(
            f"unsupported target width {bits}; supported: {SUPPORTED_WIDTHS}"
        ) from None


def width_from_side(side: int) -> WidthSpec:
    """Width spec from a LUT side length (16 -> 4-bit, 256 -> 8-bit)."""
    bits = int(side).bit_length() - 1
    if (1 << bits) != side:
        raise ValueError(f"LUT side {side} is not a power of two")
    return get_width(bits)


def width_from_lut(lut) -> WidthSpec:
    """The operating width of a behaviour table (numpy or torch), read
    from its shape."""
    if lut.ndim < 2 or lut.shape[-1] != lut.shape[-2]:
        raise ValueError(f"not a square LUT: shape {tuple(lut.shape)}")
    return width_from_side(lut.shape[-1])


def width_from_stack(stack) -> WidthSpec:
    """The width of a per-layer ``(L, side, side)`` LUT stack."""
    if stack.ndim != 3:
        raise ValueError(
            f"expected a (L, side, side) stack, got shape {tuple(stack.shape)}"
        )
    return width_from_lut(stack)


def exact_table(op_kind: str, bits: int) -> np.ndarray:
    """Exact ``(2**bits, 2**bits)`` reference semantics at any width."""
    a = np.arange(1 << bits, dtype=np.int64)
    if op_kind == "mul":
        return a[:, None] * a[None, :]
    if op_kind == "adder":
        return a[:, None] + a[None, :]
    raise ValueError(f"unknown op_kind {op_kind!r}")
