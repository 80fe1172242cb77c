"""Lower stored operators to the LUTs the LUT matmul kernels serve.

Own copy of ``repro.library.compile``.  The kernels consume dense
behaviour tables over unsigned codes: ``(16, 16)`` for the native 4-bit
regime, ``(256, 256)`` for the composed W8A8 regime.  Any stored 1-4-bit
operator lowers to a supported *target width* through
:mod:`repro_torch.precision.compose`: direct evaluation when the block is
the target, shift-add tiling of b-bit chunk products for a narrower
multiplier, carry-ripple chaining for an adder.  Compiled tables are
cached in memory, keyed by ``(record content key, op_kind, bits,
target_bits)``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..core.circuits import Circuit
from ..precision import compose
from ..precision.widths import NATIVE_BLOCK_BITS, exact_table, get_width
from ..quant.lut import build_lut
from .store import OperatorRecord

__all__ = [
    "CompiledLut",
    "base_table",
    "compile_circuit",
    "compile_record",
    "load_mul_frontier",
    "clear_compile_cache",
    "compile_cache_stats",
]


def base_table(circuit: Circuit, bits: int) -> np.ndarray:
    """The operator's ``(2**bits, 2**bits)`` behaviour map: a checked,
    widened view of :func:`repro_torch.quant.lut.build_lut` (composition
    shifts need int64 headroom)."""
    assert circuit.n_inputs == 2 * bits, (
        f"expected {2 * bits} inputs for a {bits}-bit operator, "
        f"got {circuit.n_inputs}"
    )
    return build_lut(circuit).astype(np.int64)


@dataclass(frozen=True)
class CompiledLut:
    """A behaviour table at its compiled *target width*, plus its error
    metrics at that level (composition amplifies block errors).

    ``wce16`` / ``mae16`` keep the JAX package's names but are measured
    against the exact table of ``target_bits``; :attr:`wce` / :attr:`mae`
    are the width-neutral spellings.  ``tile`` holds the 16x16 generator
    tile of a wide multiplier table.  ``area_lo``/``area_hi`` bracket the
    operator's area at the compiled width (:func:`load_mul_frontier`
    fills them): block-count scaling below, plus a ripple-carry ceiling
    on the glue adders above; native tables collapse the bracket.
    """

    lut: np.ndarray          # (side, side) int32 at the target width
    op_kind: str
    bits: int                # the *block* width the operator was searched at
    wce16: int               # worst |err| of the compiled table vs exact
    mae16: float             # mean |err| of the compiled table vs exact
    target_bits: int = NATIVE_BLOCK_BITS
    tile: np.ndarray | None = None   # 16x16 generator (wide mul targets only)
    area_lo: float | None = None     # composed-area lower bound (µm²)
    area_hi: float | None = None     # lower bound + glue-adder ceiling

    @property
    def wce(self) -> int:
        return self.wce16

    @property
    def mae(self) -> float:
        return self.mae16

    @property
    def side(self) -> int:
        return self.lut.shape[-1]


def compile_circuit(circuit: Circuit, op_kind: str, bits: int,
                    target_bits: int = NATIVE_BLOCK_BITS) -> CompiledLut:
    """Lower a b-bit block netlist to its ``target_bits`` behaviour table."""
    get_width(target_bits)   # reject unsupported targets early
    base = base_table(circuit, bits)
    tile = None
    if op_kind == "mul" and target_bits > NATIVE_BLOCK_BITS:
        tile = (base if bits == NATIVE_BLOCK_BITS
                else compose.compose_table(base, "mul", bits,
                                           NATIVE_BLOCK_BITS))
        tile = tile.astype(np.int32)
    lut = compose.compose_table(base, op_kind, bits, target_bits)
    err = np.abs(lut - exact_table(op_kind, target_bits))
    return CompiledLut(
        lut=lut.astype(np.int32),
        op_kind=op_kind,
        bits=bits,
        wce16=int(err.max()),
        mae16=float(err.mean()),
        target_bits=target_bits,
        tile=tile,
    )


def load_mul_frontier(
    library, target_bits: int | None = None
) -> tuple[list[tuple[OperatorRecord, "CompiledLut"]], float, int]:
    """Open a store, build the multiplier frontier, compile every frontier
    record, and return ``(compiled, exact_area, bits)``.

    ``target_bits=None`` is the native path: the widest-operand block
    frontier, compiled to the 16x16 LUT, with the store's own per-record
    areas (third element = the block width).

    With an explicit ``target_bits`` (W8A8 is ``8``), *every* stored
    multiplier block is composed up to the target, its area scaled by the
    block count the composition spends (a lower bound), and the frontier
    is re-taken over ``(composed area, composed wce)``.  ``exact_area`` is
    the exact ``target_bits`` array multiplier's.

    Raises :class:`LookupError` when the store holds no multipliers.
    """
    from ..core.arith import benchmark
    from ..core.synth import area
    from .pareto import ParetoFrontier, pareto_front
    from .store import OperatorStore

    store = OperatorStore(library)
    sigs = [s for s in store.signatures() if s.op_kind == "mul"]
    if not sigs:
        raise LookupError(
            f"no multiplier operators in library {library}; fill it with: "
            f"python -m repro_torch.fleet --library {library} --sweep smoke"
        )
    if target_bits is None:
        bits = max(s.bits for s in sigs)
        frontier = ParetoFrontier.from_store(store, "mul", bits)
        compiled = [(rec, dataclasses.replace(compile_record(rec),
                                              area_lo=rec.area,
                                              area_hi=rec.area))
                    for rec in frontier.front]
        exact_area = area(benchmark(f"mul_i{2 * bits}"))
        return compiled, exact_area, bits

    width = get_width(target_bits)
    # glue-adder ceiling: ripple-carry cell area per bit position, taken
    # from the exact 4-bit benchmark adder (adder_i8 = two 4-bit operands)
    adder_bit_area = area(benchmark("adder_i8")) / 4.0
    pairs: list[tuple[OperatorRecord, CompiledLut]] = []
    for rec in store.query("mul"):
        comp = compile_record(rec, target_bits=width.bits)
        lo = rec.area * compose.compose_blocks(rec.signature.bits,
                                               width.bits)
        hi = lo + adder_bit_area * compose.compose_glue_bits(
            rec.signature.bits, width.bits)
        comp = dataclasses.replace(comp, area_lo=lo, area_hi=hi)
        scaled = dataclasses.replace(rec, area=lo)
        pairs.append((scaled, comp))
    front = pareto_front(pairs, (lambda p: p[0].area,
                                 lambda p: float(p[1].wce16)))
    exact_area = area(benchmark(width.benchmark_name))
    return front, exact_area, width.bits


# ---------------------------------------------------------------------------
# in-memory compile cache
# ---------------------------------------------------------------------------
_CACHE: dict[tuple[str, str, int, int], CompiledLut] = {}
_STATS = {"hits": 0, "misses": 0}


def compile_record(record: OperatorRecord,
                   target_bits: int = NATIVE_BLOCK_BITS) -> CompiledLut:
    """Compile a stored operator, memoized by (content key, target width)."""
    key = (record.key or record.content_key(), record.signature.op_kind,
           record.signature.bits, target_bits)
    hit = _CACHE.get(key)
    if hit is not None:
        _STATS["hits"] += 1
        return hit
    _STATS["misses"] += 1
    out = compile_circuit(record.circuit, record.signature.op_kind,
                          record.signature.bits, target_bits)
    _CACHE[key] = out
    return out


def clear_compile_cache() -> None:
    _CACHE.clear()
    _STATS.update(hits=0, misses=0)


def compile_cache_stats() -> dict[str, int]:
    return dict(_STATS, size=len(_CACHE))
