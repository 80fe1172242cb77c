"""The work a model needs, counted from its configuration's shapes,
whatever implements it: model FLOPs a token, the LUT products a step
and each product's bound on a device.

A configuration file gives the published keys (``hidden_size``,
``num_attention_heads``, ...).  A product of an (M, K) by a (K, N) matrix
counts ``2 M K N`` operations.  Only matrix products count toward a
model's FLOPs (norms, rotary and softmax are left out); attention counts
its score and value products over the keys a query may see, however many
positions the program reads; a token's keys and values are made once, at
its own step.

A LUT product (a layer's three MLP products) counts its ``2 M K N``
operations, and its bytes at their nominal widths: the codes of both
operands at the table's bits, the table's entries at the bytes that hold
them, and the int32 output once.  A later change that caches weight
codes or packs them otherwise does not move this yardstick.  The
arithmetic of the LUT MACs follows ``repro_torch/obs/costs.py``
(``mlp_macs_per_layer``).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Dims:
    D: int
    H: int
    Hkv: int
    hd: int
    F: int              # FFN width
    V: int
    L: int


def dims(cfg: dict) -> Dims:
    D, H = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    return Dims(D=D, H=H, Hkv=int(cfg.get("num_key_value_heads", H)),
                hd=int(cfg.get("head_dim") or D // H),
                F=int(cfg["intermediate_size"]), V=int(cfg["vocab_size"]),
                L=int(cfg["num_hidden_layers"]))


def attention_flops(d: Dims, keys: int) -> int:
    """One query token's attention block over ``keys`` visible keys."""
    proj = 2 * d.D * d.H * d.hd + 4 * d.D * d.Hkv * d.hd + 2 * d.H * d.hd * d.D
    return proj + 4 * d.H * d.hd * keys


def mlp_flops(d: Dims) -> int:
    return 6 * d.D * d.F


def token_flops(d: Dims, keys: int) -> int:
    """Model FLOPs of one token that sees ``keys`` keys (its own
    included), the head's product included."""
    return d.L * (attention_flops(d, keys) + mlp_flops(d)) + 2 * d.D * d.V


def step_flops(d: Dims, positions) -> int:
    """Model FLOPs of one decode step whose rows sit at ``positions``
    (a row at position p sees p + 1 keys)."""
    n = len(positions)
    keys = sum(int(p) + 1 for p in positions)
    return n * token_flops(d, 0) + d.L * 4 * d.H * d.hd * keys


def lut_products(d: Dims, rows: int) -> list[tuple[int, int, int]]:
    """The (M, K, N) of every LUT product one step of ``rows`` rows
    launches, in layer order."""
    return [(rows, d.D, d.F), (rows, d.D, d.F), (rows, d.F, d.D)] * d.L


def lut_work(M: int, K: int, N: int, bits: int) -> tuple[int, int]:
    """Operations and bytes of one LUT product at ``bits``-bit codes: the
    codes at ``bits`` bits, the table's entries as the bytes that hold
    the widest exact product (1 at 4 bits, 2 at 8), the int32 output."""
    side = 1 << bits
    ops = 2 * M * K * N
    nbytes = (M * K + K * N) * bits // 8 + side * side * (bits // 4) + 4 * M * N
    return ops, nbytes


def bound_s(ops: float, nbytes: float, peak_ops: float, peak_bytes: float) -> float:
    """The least time a device could take: the larger of operations over
    its peak rate and bytes over its memory bandwidth."""
    return max(ops / peak_ops, nbytes / peak_bytes)


def lut_step_bound_s(d: Dims, rows: int, peaks: dict, bits: int) -> float:
    """Sum of the bounds of one step's LUT products."""
    return sum(bound_s(*lut_work(*mkn, bits), peaks["int8_op_s"], peaks["hbm_byte_s"])
               for mkn in lut_products(d, rows))
