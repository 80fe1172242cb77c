"""The search-engine API the port runs: jobs, candidates, outcomes, the
shared harvest, and the tensor engine.

Own copy of ``repro.core.engine``, trimmed to the tensor path:

* :class:`SearchJob` -- what to search, content-hashable
  (:meth:`SearchJob.key`, the same key as the JAX package's);
* :class:`SearchOutcome` -- a list of exhaustively re-verified
  :class:`Candidate` netlists plus engine stats;
* :func:`harvest` -- instantiate -> synthesize -> exhaustive re-verify; an
  unsound model raises :class:`UnsoundResultError`;
* :func:`get_engine` -- ``"tensor"`` gives :class:`TensorEngine`, the
  population search on the ``template_eval`` kernel.  The other engines
  of the registry (the SMT engines ``shared``/``xpat``, ``anneal``,
  ``muscat``/``mecals``) are not ported yet and raise
  :class:`NotImplementedError`; ROADMAP.md §1 queues them.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from .arith import benchmark as _benchmark
from .circuits import Circuit
from .miter import ERROR_METRICS, measure_error
from .synth import area, synthesize
from .templates import TemplateParams

__all__ = [
    "SearchJob",
    "SearchOutcome",
    "Candidate",
    "UnsoundResultError",
    "harvest",
    "verify_circuit",
    "TensorEngine",
    "get_engine",
    "available_engines",
    "ENGINE_NAMES",
]


class UnsoundResultError(RuntimeError):
    """A search result failed exhaustive re-verification."""


@dataclass(frozen=True)
class SearchJob:
    """One unit of search work, addressable by content.

    ``benchmark`` is the operator *kind* (``"mul"`` / ``"adder"``); with
    ``bits`` it names the exact circuit (``mul_i4`` = 2-bit multiplier).
    """

    benchmark: str            # operator kind: "mul" | "adder"
    bits: int                 # operand bit width (paper: 2, 3, 4)
    et: int                   # error threshold under ``error_metric``
    engine: str               # registry name, see ENGINE_NAMES
    error_metric: str = "wce"
    budget_s: float = 60.0
    seed: int = 0

    @property
    def benchmark_name(self) -> str:
        return f"{self.benchmark}_i{2 * self.bits}"

    def exact(self) -> Circuit:
        """The exact reference circuit this job approximates."""
        return _benchmark(self.benchmark_name)

    def signature(self):
        """The :class:`~repro_torch.library.store.OperatorSignature`
        results of this job are stored under."""
        from ..library.store import OperatorSignature

        return OperatorSignature(self.benchmark, self.bits,
                                 self.error_metric, self.et)

    def key(self) -> str:
        """Stable content key (the same as the JAX package's)."""
        blob = "|".join(
            str(v) for v in (self.benchmark, self.bits, self.et, self.engine,
                             self.error_metric, self.budget_s, self.seed)
        )
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def describe(self) -> str:
        return (f"{self.benchmark_name} {self.error_metric}<={self.et} "
                f"[{self.engine}] budget={self.budget_s:g}s seed={self.seed}")


@dataclass
class Candidate:
    """One sound, exhaustively re-verified approximation."""

    circuit: Circuit              # synthesized netlist
    area: float                   # synthesized area, µm²
    params: TemplateParams | None = None
    proxies: dict = field(default_factory=dict)
    wall_s: float = 0.0
    meta: dict = field(default_factory=dict)   # fitness, ...


@dataclass
class SearchOutcome:
    """The search report."""

    engine: str
    benchmark: str
    et: int | None = None
    results: list = field(default_factory=list)
    stats: dict = field(default_factory=dict)  # generations, evaluations
    wall_s: float = 0.0
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def best(self):
        """Smallest-area candidate, or ``None``."""
        if not self.results:
            return None
        return min(self.results, key=lambda r: r.area)


def verify_circuit(circuit: Circuit, exact_values: np.ndarray, et: float,
                   *, metric: str = "wce", context: str = "") -> float:
    """Exhaustive error of ``circuit`` vs the exact values under the
    chosen metric; raises :class:`UnsoundResultError` above ``et``."""
    val = measure_error(circuit, exact_values).value(metric)
    if val > et:
        raise UnsoundResultError(
            f"search result failed exhaustive re-verification"
            f"{f' ({context})' if context else ''}: measured {metric} "
            f"{val:g} > ET {et:g} on {circuit.name!r} "
            f"({circuit.n_inputs} inputs)"
        )
    return val


def harvest(template, params: TemplateParams, exact_values: np.ndarray,
            et: float, *, engine: str, metric: str = "wce",
            name: str = "approx", wall_s: float = 0.0,
            meta: dict | None = None) -> Candidate:
    """Turn a raw parameter assignment into a verified :class:`Candidate`:
    the path every engine's winners go through."""
    circuit = synthesize(template.instantiate(params, name=name))
    verify_circuit(circuit, exact_values, et, metric=metric,
                   context=f"engine={engine}, proxies={template.proxies(params)}")
    return Candidate(
        circuit=circuit,
        area=area(circuit, presynthesized=True),
        params=params,
        proxies=template.proxies(params),
        wall_s=wall_s,
        meta=dict(meta or {}),
    )


def _check_metric(job: SearchJob, engine: str,
                  supported: tuple[str, ...]) -> None:
    """Reject metric/engine combinations that cannot be made sound: the
    tensor search guides by worst-case error, which bounds ``mae``
    pointwise but not ``mse``."""
    if job.error_metric not in ERROR_METRICS:
        raise KeyError(f"unknown error metric {job.error_metric!r}; "
                       f"known: {ERROR_METRICS}")
    if job.error_metric not in supported:
        raise ValueError(
            f"engine {engine!r} cannot bound metric {job.error_metric!r} "
            f"(supports {supported}); use the anneal engine"
        )


class TensorEngine:
    """Tensorized population search on one device.  ``search_kw`` go to
    :func:`repro_torch.core.tensor_search.tensor_search` (``population``,
    ``generations``, ``device``, ``backend``, ...)."""

    name = "tensor"

    def __init__(self, **search_kw):
        self.search_kw = search_kw

    def run(self, job: SearchJob) -> SearchOutcome:
        from .tensor_search import tensor_search

        _check_metric(job, self.name, ("wce", "mae"))
        return tensor_search(job.exact(), et=job.et, seed=job.seed,
                             wall_budget_s=job.budget_s, **self.search_kw)


ENGINE_NAMES = ("shared", "xpat", "tensor", "anneal", "muscat", "mecals")

# where ROADMAP.md queues each engine the port does not run yet
_NOT_PORTED = {
    "shared": "§1 item 8c (the SMT engines and MiterZ3; needs z3)",
    "xpat": "§1 item 8c (the SMT engines and MiterZ3; needs z3)",
    "anneal": "§1 item 8b (the CPU engines of core/baselines)",
    "muscat": "§1 item 8b (the CPU engines of core/baselines)",
    "mecals": "§1 item 8b (the CPU engines of core/baselines)",
}


def get_engine(name: str, **opts) -> TensorEngine:
    """Engine instance by registry name; ``opts`` are engine-specific
    constructor knobs (``population=``, ``device=``, ``backend=``, ...)."""
    if name == "tensor":
        return TensorEngine(**opts)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported to PyTorch yet; ROADMAP.md "
            f"{_NOT_PORTED[name]}")
    raise KeyError(f"unknown engine {name!r}; known: {ENGINE_NAMES}")


def available_engines() -> tuple[str, ...]:
    """Engines the port runs."""
    return ("tensor",)
