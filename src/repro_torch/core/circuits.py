"""Gate-level combinational circuit IR.

Own copy of ``repro.core.circuits`` (numpy only), trimmed to what the
search path runs.  A :class:`Circuit` is a DAG of boolean gates over ``n``
primary inputs with ``m`` primary outputs.  The circuits are small (2--4
bit arithmetic operators, n <= 8), so the whole input space is enumerable
and nodes are evaluated as **bit-packed truth tables**: one ``uint32``
lane holds 32 input assignments, a full truth table for ``n`` inputs is
``ceil(2**n / 32)`` lanes -- the representation the ``template_eval``
kernel scores populations in.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "Op",
    "Gate",
    "Circuit",
    "input_truth_tables",
    "packed_words",
    "pack_bits",
    "unpack_bits",
    "ALL_ONES",
]

ALL_ONES = np.uint32(0xFFFFFFFF)


class Op(enum.Enum):
    """Gate operators.  AND/OR are n-ary at IR level (binarized in synth)."""

    INPUT = "input"
    CONST0 = "const0"
    CONST1 = "const1"
    BUF = "buf"
    NOT = "not"
    AND = "and"
    OR = "or"
    XOR = "xor"
    NAND = "nand"
    NOR = "nor"
    XNOR = "xnor"


@dataclass(frozen=True)
class Gate:
    """A single node: an operator applied to previously-defined node ids."""

    op: Op
    args: tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if self.op is Op.INPUT or self.op in (Op.CONST0, Op.CONST1):
            assert not self.args, f"{self.op} takes no args"
        elif self.op in (Op.NOT, Op.BUF):
            assert len(self.args) == 1, f"{self.op} takes 1 arg"
        elif self.op in (Op.XOR, Op.XNOR):
            assert len(self.args) == 2, f"{self.op} takes 2 args"
        else:
            assert len(self.args) >= 1, f"{self.op} takes >=1 args"


def packed_words(n_inputs: int) -> int:
    """Number of uint32 lanes needed for a full truth table of n inputs."""
    return max(1, (1 << n_inputs) + 31 >> 5)


def input_truth_tables(n_inputs: int) -> np.ndarray:
    """Packed truth tables of the primary inputs, shape ``(n, W)`` uint32.

    Assignment index ``i``'s bit for input ``j`` is ``(i >> j) & 1`` --
    input 0 toggles fastest (LSB of the assignment index).
    """
    size = 1 << n_inputs
    idx = np.arange(size, dtype=np.uint64)
    bits = ((idx[None, :] >> np.arange(n_inputs, dtype=np.uint64)[:, None]) & 1).astype(bool)
    return pack_bits(bits)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a boolean array (..., S) into uint32 lanes (..., ceil(S/32)).

    Bit ``k`` of lane ``w`` is assignment ``32*w + k``.
    """
    *lead, size = bits.shape
    w = (size + 31) // 32
    padded = np.zeros((*lead, w * 32), dtype=bool)
    padded[..., :size] = bits
    lanes = padded.reshape(*lead, w, 32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    return (lanes.astype(np.uint32) * weights).sum(axis=-1, dtype=np.uint32)


def unpack_bits(words: np.ndarray, size: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`: (..., W) uint32 -> (..., size) bool."""
    *lead, w = words.shape
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((words[..., :, None] >> shifts) & np.uint32(1)).astype(bool)
    return bits.reshape(*lead, w * 32)[..., :size]


@dataclass
class Circuit:
    """A combinational circuit: gates in topological order, outputs by id.

    ``nodes[0:n_inputs]`` are always the INPUT gates, in input order.
    """

    n_inputs: int
    nodes: list[Gate] = field(default_factory=list)
    outputs: list[int] = field(default_factory=list)
    name: str = "circuit"

    @classmethod
    def empty(cls, n_inputs: int, name: str = "circuit") -> "Circuit":
        c = cls(n_inputs=n_inputs, name=name)
        c.nodes = [Gate(Op.INPUT) for _ in range(n_inputs)]
        return c

    def add(self, op: Op, *args: int) -> int:
        """Append a gate; returns its node id."""
        for a in args:
            assert 0 <= a < len(self.nodes), f"arg {a} out of range"
        self.nodes.append(Gate(op, tuple(args)))
        return len(self.nodes) - 1

    def const(self, value: bool) -> int:
        return self.add(Op.CONST1 if value else Op.CONST0)

    def mark_output(self, node_id: int) -> None:
        self.outputs.append(node_id)

    @property
    def n_outputs(self) -> int:
        return len(self.outputs)

    def node_tables(self, in_tables: np.ndarray | None = None) -> np.ndarray:
        """Packed truth tables for every node, shape ``(len(nodes), W)``:
        one topological sweep of word-wide bitwise ops."""
        if in_tables is None:
            in_tables = input_truth_tables(self.n_inputs)
        n, w = in_tables.shape
        assert n == self.n_inputs
        out = np.zeros((len(self.nodes), w), dtype=np.uint32)
        n_seen = 0
        for i, g in enumerate(self.nodes):
            if g.op is Op.INPUT:
                out[i] = in_tables[n_seen]
                n_seen += 1
            elif g.op is Op.CONST0:
                out[i] = 0
            elif g.op is Op.CONST1:
                out[i] = ALL_ONES
            elif g.op is Op.BUF:
                out[i] = out[g.args[0]]
            elif g.op is Op.NOT:
                out[i] = ~out[g.args[0]]
            elif g.op in (Op.AND, Op.NAND):
                acc = out[g.args[0]].copy()
                for a in g.args[1:]:
                    acc &= out[a]
                out[i] = acc if g.op is Op.AND else ~acc
            elif g.op in (Op.OR, Op.NOR):
                acc = out[g.args[0]].copy()
                for a in g.args[1:]:
                    acc |= out[a]
                out[i] = acc if g.op is Op.OR else ~acc
            elif g.op is Op.XOR:
                out[i] = out[g.args[0]] ^ out[g.args[1]]
            elif g.op is Op.XNOR:
                out[i] = ~(out[g.args[0]] ^ out[g.args[1]])
            else:  # pragma: no cover - exhaustive
                raise ValueError(f"unknown op {g.op}")
        return out

    def output_tables(self, in_tables: np.ndarray | None = None) -> np.ndarray:
        """Packed truth tables of the outputs only, shape ``(m, W)``."""
        tables = self.node_tables(in_tables)
        return tables[np.asarray(self.outputs, dtype=np.int64)]

    def eval_words(self) -> np.ndarray:
        """Output *values* per assignment: ``(2**n,)`` uint64, outputs read
        as an unsigned integer with output 0 as the LSB."""
        bits = unpack_bits(self.output_tables(), 1 << self.n_inputs)  # (m, S)
        weights = np.uint64(1) << np.arange(self.n_outputs, dtype=np.uint64)
        return (bits.astype(np.uint64) * weights[:, None]).sum(axis=0)

    def fanout_counts(self) -> np.ndarray:
        counts = np.zeros(len(self.nodes), dtype=np.int64)
        for g in self.nodes:
            for a in g.args:
                counts[a] += 1
        for o in self.outputs:
            counts[o] += 1
        return counts

    def live_nodes(self) -> np.ndarray:
        """Boolean mask of nodes reachable from the outputs (or inputs)."""
        live = np.zeros(len(self.nodes), dtype=bool)
        stack = list(self.outputs)
        while stack:
            i = stack.pop()
            if live[i]:
                continue
            live[i] = True
            stack.extend(self.nodes[i].args)
        live[: self.n_inputs] = True  # inputs are part of the interface
        return live
