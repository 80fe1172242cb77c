"""Operator composition: small approximate blocks -> wide behaviour tables.

Own copy of ``repro.precision.compose``.  A ``target``-bit multiplier
table is the shift-add of b-bit block products over operand chunks
(:func:`tile_mul`); an adder table carry-ripples b-bit adder blocks
(:func:`chain_add`).  Wider than the native 4 bits, composition is
two-stage: a block first tiles up to the ``(16, 16)`` tile, then the tile
shift-adds to the target (:func:`tile_to_width`) -- the two-level form the
W8A8 kernel consumes::

    LUT8[a, b] = T[al, bl] + (T[al, bh] + T[ah, bl]) << 4 + T[ah, bh] << 8

and the tile is recovered from the table by integer inversion
(:func:`extract_tile`).  ``extract_tile(tile_to_width(T)) == T`` for any
integer tile.

The first composition at each ``(op_kind, block_bits, target_bits)``
checks that composing the *exact* block reproduces the *exact* target
table (:func:`verify_exactness`) and raises :class:`CompositionError`
otherwise.
"""

from __future__ import annotations

import numpy as np

from .widths import NATIVE_BLOCK_BITS, exact_table


class CompositionError(AssertionError):
    """A composition exactness identity failed (build-time self-check)."""


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


def chain_add(base: np.ndarray, block_bits: int,
              target_bits: int = NATIVE_BLOCK_BITS) -> np.ndarray:
    """Compose a ``target``-bit adder table by carry-rippling b-bit blocks.

    Each chunk sum goes through the approximate adder block; the carry is
    folded in with a second block application, and chunk results
    concatenate.  The final carry sits one chunk above the last block.
    """
    mask = (1 << block_bits) - 1
    side = 1 << target_bits
    ai = chunk_codes(np.arange(side), block_bits, target_bits)
    bj = chunk_codes(np.arange(side), block_bits, target_bits)
    carry = np.zeros((side, side), dtype=np.int64)
    out = np.zeros((side, side), dtype=np.int64)
    for i, (ac, bc) in enumerate(zip(ai, bj)):
        t = base[ac[:, None], bc[None, :]]
        if i == 0:
            s, carry = t & mask, t >> block_bits
        else:
            t2 = base[t & mask, carry]
            s = t2 & mask
            carry = np.minimum(1, (t >> block_bits) + (t2 >> block_bits))
        out += s << (block_bits * i)
    return out + (carry << (block_bits * len(ai)))


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


# ---------------------------------------------------------------------------
# build-time exactness identities
# ---------------------------------------------------------------------------
_VERIFIED: set[tuple[str, int, int]] = set()


def verify_exactness(op_kind: str, block_bits: int, target_bits: int) -> None:
    """Check (once per combination) that composing the *exact* block
    reproduces the *exact* target table; raises :class:`CompositionError`
    on any mismatch."""
    key = (op_kind, block_bits, target_bits)
    if key in _VERIFIED:
        return
    exact_block = exact_table(op_kind, block_bits)
    got = compose_table(exact_block, op_kind, block_bits, target_bits,
                        _verify=False)
    want = exact_table(op_kind, target_bits)
    if not np.array_equal(got, want):
        bad = int(np.abs(got - want).max())
        raise CompositionError(
            f"exactness identity failed for {op_kind} {block_bits}b -> "
            f"{target_bits}b: exact blocks composed with max deviation {bad}"
        )
    if op_kind == "mul" and target_bits > NATIVE_BLOCK_BITS:
        # the kernel contract: composed tables must invert to their tile
        tile = (exact_block if block_bits == NATIVE_BLOCK_BITS
                else tile_mul(exact_block, block_bits))
        if not np.array_equal(extract_tile(got), tile):
            raise CompositionError(
                f"tile round-trip failed for mul {block_bits}b -> "
                f"{target_bits}b (extract_tile is not inverting tile_to_width)"
            )
    _VERIFIED.add(key)


def compose_table(base: np.ndarray, op_kind: str, block_bits: int,
                  target_bits: int, *, _verify: bool = True) -> np.ndarray:
    """One b-bit block's behaviour map -> the target-width table.

    Multipliers wider than the native block width go through the
    two-stage (tile, then shift-add) form so the result is always
    kernel-consumable; adders carry-chain directly at the target width.
    """
    base = np.asarray(base, dtype=np.int64)
    if base.shape != (1 << block_bits, 1 << block_bits):
        raise ValueError(f"block table shape {base.shape} does not match "
                         f"{block_bits}-bit codes")
    if _verify:
        verify_exactness(op_kind, block_bits, target_bits)
    if op_kind == "adder":
        if block_bits == target_bits:
            return base.copy()
        return chain_add(base, block_bits, target_bits)
    if op_kind != "mul":
        raise ValueError(f"unknown op_kind {op_kind!r}")
    if block_bits == target_bits:
        return base.copy()
    tile = (base if block_bits == NATIVE_BLOCK_BITS
            else tile_mul(base, block_bits, min(target_bits,
                                                NATIVE_BLOCK_BITS)))
    if target_bits <= NATIVE_BLOCK_BITS:
        return tile
    return tile_to_width(tile, target_bits)


def compose_blocks(block_bits: int, target_bits: int) -> int:
    """How many block instances the composed operator spends: the area
    model of composition, a lower bound (the adder glue between partial
    products is left out; :func:`compose_glue_bits` bounds it from above).

    Two-stage for wide multipliers: ``ceil(4/b)**2`` blocks per 16x16
    tile, ``(target/4)**2`` tiles.
    """
    if target_bits <= NATIVE_BLOCK_BITS:
        n = -(-target_bits // block_bits)
        return n * n
    per_tile = (-(-NATIVE_BLOCK_BITS // block_bits)) ** 2
    n_tiles = (target_bits // NATIVE_BLOCK_BITS) ** 2
    return per_tile * n_tiles


def compose_glue_bits(block_bits: int, target_bits: int) -> int:
    """Upper bound on the full-adder *bit positions* the shift-add glue of
    a composed multiplier spends: every stage that sums ``P`` partial
    products needs ``P - 1`` two-input additions, each bounded at the
    stage's full product width ``2 * stage bits``."""
    b, t = int(block_bits), int(target_bits)
    if t <= b:
        return 0
    if t <= NATIVE_BLOCK_BITS:
        n = (-(-t // b)) ** 2
        return (n - 1) * 2 * t
    # two-level form: every 16x16 tile is itself a b->4 composition (its
    # glue repeats per tile instance), then the tile products are summed
    # at the full target width
    per_tile = compose_glue_bits(b, NATIVE_BLOCK_BITS)
    n_tiles = (t // NATIVE_BLOCK_BITS) ** 2
    return n_tiles * per_tile + (n_tiles - 1) * 2 * t
