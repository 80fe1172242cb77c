"""Exact arithmetic circuit generators -- the paper's benchmark set.

Own copy of ``repro.core.arith``.  Benchmarks are named by *total input
count*: ``i4`` (2-bit operands), ``i6`` (3-bit), ``i8`` (4-bit): a
ripple-carry adder (half adder + chain of full adders) and an array
multiplier (AND partial products + ripple reduction rows), both as
:class:`~repro_torch.core.circuits.Circuit` DAGs.  Input layout is
``[a_0..a_{b-1}, b_0..b_{b-1}]`` LSB-first; outputs LSB-first (``b+1``
sum bits for adders, ``2b`` product bits for multipliers).
"""

from __future__ import annotations

from .circuits import Circuit, Op

__all__ = [
    "ripple_carry_adder",
    "array_multiplier",
    "benchmark",
    "parse_benchmark_name",
    "BENCHMARKS",
]


def _half_adder(c: Circuit, a: int, b: int) -> tuple[int, int]:
    """Returns (sum, carry)."""
    s = c.add(Op.XOR, a, b)
    cy = c.add(Op.AND, a, b)
    return s, cy


def _full_adder(c: Circuit, a: int, b: int, cin: int) -> tuple[int, int]:
    """Returns (sum, carry) — the standard 2-XOR 2-AND 1-OR decomposition."""
    axb = c.add(Op.XOR, a, b)
    s = c.add(Op.XOR, axb, cin)
    t1 = c.add(Op.AND, axb, cin)
    t2 = c.add(Op.AND, a, b)
    cy = c.add(Op.OR, t1, t2)
    return s, cy


def ripple_carry_adder(bits: int) -> Circuit:
    """``bits``-bit + ``bits``-bit -> ``bits+1``-bit ripple-carry adder."""
    c = Circuit.empty(2 * bits, name=f"adder_i{2 * bits}")
    a = list(range(bits))
    b = list(range(bits, 2 * bits))
    s, carry = _half_adder(c, a[0], b[0])
    c.mark_output(s)
    for k in range(1, bits):
        s, carry = _full_adder(c, a[k], b[k], carry)
        c.mark_output(s)
    c.mark_output(carry)
    return c


def array_multiplier(bits: int) -> Circuit:
    """``bits``x``bits`` -> ``2*bits``-bit array multiplier.

    Row-by-row carry-save style reduction: partial-product row ``r`` is
    added into the running sum with a ripple of half/full adders — the
    classic array multiplier a synthesis flow would start from.
    """
    c = Circuit.empty(2 * bits, name=f"mul_i{2 * bits}")
    a = list(range(bits))
    b = list(range(bits, 2 * bits))

    # partial products pp[r][j] = a_j AND b_r
    pp = [[c.add(Op.AND, a[j], b[r]) for j in range(bits)] for r in range(bits)]

    # running sum starts as row 0 (weight offset 0)
    acc: list[int] = list(pp[0])  # acc[k] has weight 2**k
    c.mark_output(acc[0])  # out bit 0 is final
    acc = acc[1:]  # weights 2**1 .. 2**(bits-1)

    for r in range(1, bits):
        row = pp[r]  # weights 2**r .. 2**(r+bits-1); acc holds 2**r ..
        new_acc: list[int] = []
        carry: int | None = None
        for j in range(bits):
            have_acc = j < len(acc)
            terms = [row[j]]
            if have_acc:
                terms.append(acc[j])
            if carry is not None:
                terms.append(carry)
            if len(terms) == 1:
                s, carry = terms[0], None
            elif len(terms) == 2:
                s, carry = _half_adder(c, terms[0], terms[1])
            else:
                s, carry = _full_adder(c, terms[0], terms[1], terms[2])
            new_acc.append(s)
        if carry is not None:
            new_acc.append(carry)
        # lowest bit of new_acc has weight 2**r -> it is final output bit r
        c.mark_output(new_acc[0])
        acc = new_acc[1:]

    for s in acc:  # remaining high bits
        c.mark_output(s)
    assert c.n_outputs == 2 * bits, (c.n_outputs, bits)
    return c


def parse_benchmark_name(name: str) -> tuple[str, int]:
    """``"mul_i8" -> ("mul", 4)``: benchmark name to (kind, operand bits).

    The single parser for every consumer, so the circuit searched and the
    signature it is stored under never diverge.
    """
    try:
        kind, size = name.split("_i")
        bits = int(size) // 2
    except ValueError:
        raise KeyError(name) from None
    if kind not in ("adder", "mul") or bits < 1:
        raise KeyError(name)
    return kind, bits


def benchmark(name: str) -> Circuit:
    """Fetch a paper benchmark by name, e.g. ``adder_i4`` or ``mul_i8``."""
    kind, bits = parse_benchmark_name(name)
    if kind == "adder":
        return ripple_carry_adder(bits)
    return array_multiplier(bits)


BENCHMARKS = ["adder_i4", "adder_i6", "adder_i8", "mul_i4", "mul_i6", "mul_i8"]
