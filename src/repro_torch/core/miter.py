"""The error miter, exhaustive backend: ``∀i : dist(i, p) <= ET``.

Own copy of the numpy half of ``repro.core.miter``.  ``map`` reads a
circuit's output bits as an unsigned integer (LSB = output 0); ``dist``
is the absolute difference between the exact and approximate circuits'
mapped outputs.  For the paper's operator sizes (n <= 8, 256
assignments) the whole input space is enumerable, and this backend is
the ground truth every search result is re-verified against.  The Z3
backend (``MiterZ3``) is not ported: z3 is not installed where the port
runs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .circuits import Circuit, unpack_bits
from .templates import SharedTemplate, TemplateParams

__all__ = [
    "ErrorStats",
    "ERROR_METRICS",
    "measure_error",
    "worst_case_error",
    "values_from_tables",
    "params_sound",
]

ERROR_METRICS = ("wce", "mae", "mse")


class ErrorStats(NamedTuple):
    """Exhaustive error statistics of a candidate vs the exact outputs."""

    wce: int     # worst |err| over all assignments
    mae: float   # mean |err|
    mse: float   # mean squared err

    def value(self, metric: str) -> float:
        """The statistic a named error metric bounds."""
        if metric not in ERROR_METRICS:
            raise KeyError(
                f"unknown error metric {metric!r}; known: {ERROR_METRICS}")
        return getattr(self, metric)


def values_from_tables(tables: np.ndarray, n_inputs: int) -> np.ndarray:
    """Packed output tables ``(m, W)`` -> per-assignment values ``(2**n,)``."""
    bits = unpack_bits(tables, 1 << n_inputs)  # (m, S)
    weights = np.uint64(1) << np.arange(tables.shape[0], dtype=np.uint64)
    return (bits.astype(np.uint64) * weights[:, None]).sum(axis=0)


def measure_error(circuit: Circuit, exact_values: np.ndarray) -> ErrorStats:
    """Exhaustive :class:`ErrorStats` of a candidate against the exact
    outputs: the one measurement engine harvests and store writes share."""
    err = np.abs(circuit.eval_words().astype(np.int64)
                 - exact_values.astype(np.int64))
    return ErrorStats(wce=int(err.max()), mae=float(err.mean()),
                      mse=float((err.astype(np.float64) ** 2).mean()))


def worst_case_error(exact: Circuit, approx: Circuit) -> int:
    """Exhaustive worst-case |exact - approx| over all assignments."""
    assert exact.n_inputs == approx.n_inputs
    return measure_error(approx, exact.eval_words()).wce


def params_sound(template: SharedTemplate, params: TemplateParams,
                 exact_values: np.ndarray, et: int) -> bool:
    """Exhaustive soundness check of a parameter assignment."""
    vals = values_from_tables(template.eval_outputs(params), template.n_inputs)
    return bool(np.abs(vals.astype(np.int64) - exact_values.astype(np.int64)).max() <= et)
