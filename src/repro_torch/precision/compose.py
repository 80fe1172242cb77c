"""The two-level 8-bit table form the W8A8 kernel consumes.

Own copy of the part of ``repro.precision.compose`` the inference path
needs.  A composed ``(256, 256)`` product table is the exact shift-add of
one ``(16, 16)`` tile over operand nibbles::

    LUT8[a, b] = T[al, bl] + (T[al, bh] + T[ah, bl]) << 4 + T[ah, bh] << 8

and the tile is recovered from the table by integer inversion
(:func:`extract_tile`).  ``extract_tile(tile_to_width(T)) == T`` for any
integer tile.
"""

from __future__ import annotations

import numpy as np

from .widths import NATIVE_BLOCK_BITS


def chunk_codes(x: np.ndarray, block_bits: int, total_bits: int
                ) -> list[np.ndarray]:
    """Split ``total_bits``-bit codes into ``ceil(total/block)`` b-bit
    chunks, LSB-first: ``sum_i chunks[i] << (block_bits * i) == x``."""
    mask = (1 << block_bits) - 1
    n = -(-total_bits // block_bits)
    return [(x >> (block_bits * i)) & mask for i in range(n)]


def tile_mul(base: np.ndarray, block_bits: int,
             target_bits: int = NATIVE_BLOCK_BITS) -> np.ndarray:
    """Compose a ``target``-bit multiplier table from a b-bit block: the
    sum of the shifted chunk products ``M[a_i, b_j] << b(i+j)``."""
    side = 1 << target_bits
    ai = chunk_codes(np.arange(side), block_bits, target_bits)
    bj = chunk_codes(np.arange(side), block_bits, target_bits)
    out = np.zeros((side, side), dtype=np.int64)
    for i, ac in enumerate(ai):
        for j, bc in enumerate(bj):
            out += base[ac[:, None], bc[None, :]] << (block_bits * (i + j))
    return out


def tile_to_width(tile: np.ndarray, target_bits: int = 8) -> np.ndarray:
    """Shift-add a ``(16, 16)`` tile over 4-bit operand chunks into the
    ``(2**t, 2**t)`` table."""
    if tile.shape != (16, 16):
        raise ValueError(f"expected a 16x16 tile, got {tile.shape}")
    if target_bits % NATIVE_BLOCK_BITS or target_bits <= 0:
        raise ValueError(f"target width {target_bits} is not a multiple of 4")
    return tile_mul(np.asarray(tile, dtype=np.int64), NATIVE_BLOCK_BITS,
                    target_bits)


def extract_tile(lut: np.ndarray) -> np.ndarray:
    """Exact inverse of :func:`tile_to_width` for an 8-bit composed table::

        T[0, 0] = LUT[0, 0] // 289                        (289 = 1+2*16+256)
        T[x, 0] = (LUT[x, 0] - 272 * T[0, 0]) // 17       (272 = 16+256)
        T[0, y] = (LUT[0, y] - 272 * T[0, 0]) // 17
        T[x, y] =  LUT[x, y] - 16 * (T[x, 0] + T[0, y]) - 256 * T[0, 0]

    ``//`` floors; the torch twin in :mod:`repro_torch.kernels.approx_matmul`
    is line-for-line the same.
    """
    if lut.shape != (256, 256):
        raise ValueError(f"expected a 256x256 table, got {lut.shape}")
    lo = lut[:16, :16]
    t00 = lut[0, 0] // 289
    tx0 = (lut[:16, 0] - 272 * t00) // 17
    t0y = (lut[0, :16] - 272 * t00) // 17
    return lo - 16 * (tx0[:, None] + t0y[None, :]) - 256 * t00


def is_composed(lut: np.ndarray) -> bool:
    """Whether an 8-bit table is exactly a :func:`tile_to_width` image —
    the precondition of the W8A8 kernel."""
    lut = np.asarray(lut, dtype=np.int64)
    return bool(np.array_equal(tile_to_width(extract_tile(lut)), lut))
