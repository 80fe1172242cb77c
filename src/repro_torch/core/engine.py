"""The search-engine API the port runs: jobs, candidates, outcomes, the
shared harvest, and the engines that need no SMT solver.

Own copy of ``repro.core.engine``:

* :class:`SearchJob` -- what to search, content-hashable
  (:meth:`SearchJob.key`, the same key as the JAX package's);
* :class:`SearchOutcome` -- a list of exhaustively re-verified
  :class:`Candidate` netlists plus engine stats;
* :func:`harvest` -- instantiate -> synthesize -> exhaustive re-verify; an
  unsound model raises :class:`UnsoundResultError`;
* :func:`get_engine` -- ``"tensor"`` gives :class:`TensorEngine`, the
  population search on the ``template_eval`` kernel; ``"anneal"``
  :class:`AnnealEngine` and ``"muscat"``/``"mecals"``
  :class:`RewriteEngine`, host numpy as in the reference.  The SMT
  engines ``shared``/``xpat`` need z3 and raise
  :class:`NotImplementedError` (ROADMAP.md, "Not queued, on purpose"), so
  :func:`available_engines` gives what the reference gives without z3.

The reference wraps every engine in ``InstrumentedEngine`` (metrics and
trace spans); the port returns the engine itself.
"""

from __future__ import annotations

import hashlib
import math
import time
from dataclasses import dataclass, field

import numpy as np

from .arith import benchmark as _benchmark
from .circuits import Circuit
from .miter import ERROR_METRICS, ErrorStats, measure_error, values_from_tables
from .synth import area, synthesize
from .templates import IGNORE, SharedTemplate, TemplateParams

__all__ = [
    "SearchJob",
    "SearchOutcome",
    "Candidate",
    "UnsoundResultError",
    "harvest",
    "verify_circuit",
    "TensorEngine",
    "AnnealEngine",
    "RewriteEngine",
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


class AnnealEngine:
    """Simulated annealing over shared-template parameters (host numpy).

    An accept-if-better loop with a temperature schedule and restarts:
    propose one literal/selector mutation, score by the same proxy-area
    energy the tensor search uses (unsound candidates ranked by
    violation), accept per Metropolis.  Needs no z3 and no device.
    """

    name = "anneal"

    def __init__(self, *, steps: int = 4000, restarts: int = 3,
                 start_temp: float = 6.0, cooling: float = 0.999,
                 keep: int = 8, pit: int | None = None):
        self.steps = steps
        self.restarts = restarts
        self.start_temp = start_temp
        self.cooling = cooling
        self.keep = keep
        self.pit = pit

    def _energy(self, tpl: SharedTemplate, p: TemplateParams,
                exact_vals: np.ndarray, et: float, metric: str
                ) -> tuple[float, float]:
        """Energy + the candidate's error under the job's chosen metric
        — the one engine that *scores* mae/mse natively instead of
        bounding them through wce."""
        vals = values_from_tables(tpl.eval_outputs(p), tpl.n_inputs)
        err = np.abs(vals.astype(np.int64) - exact_vals)
        stats = ErrorStats(wce=int(err.max()), mae=float(err.mean()),
                           mse=float((err.astype(np.float64) ** 2).mean()))
        val = stats.value(metric)
        if val > et:
            return 1e6 + 100.0 * val + float(err.sum()) / err.size, val
        used = p.sel.any(axis=0)
        lit_cnt = int(((p.lits != IGNORE) & used[:, None]).sum())
        prox = tpl.proxies(p)
        return 10.0 * prox["PIT"] + 2.0 * lit_cnt + 3.0 * prox["ITS"], val

    def run(self, job: SearchJob) -> SearchOutcome:
        exact = job.exact()
        n, m = exact.n_inputs, exact.n_outputs
        T = self.pit if self.pit is not None else 2 * m
        tpl = SharedTemplate(n, m, pit=T)
        exact_vals = exact.eval_words().astype(np.int64)
        rng = np.random.default_rng(job.seed)
        t0 = time.time()
        outcome = SearchOutcome(engine=self.name, benchmark=exact.name,
                                et=job.et, stats={"steps": 0, "accepted": 0,
                                                  "restarts": 0})
        # distinct sound assignments seen, fingerprint -> (energy, params)
        pool: dict[bytes, tuple[float, TemplateParams]] = {}

        def propose(p: TemplateParams) -> TemplateParams:
            q = p.copy()
            slot = int(rng.integers(T * n + m * T))
            if slot < T * n:
                q.lits[slot // n, slot % n] = rng.integers(0, 3)
            else:
                slot -= T * n
                q.sel[slot // T, slot % T] ^= True
            return q

        for _ in range(self.restarts):
            if time.time() - t0 > job.budget_s:
                break
            outcome.stats["restarts"] += 1
            u = rng.random((T, n))
            p = TemplateParams(
                np.select([u < 0.25, u < 0.5], [0, 1], default=IGNORE).astype(np.int8),
                rng.random((m, T)) < 0.3,
            )
            e, val = self._energy(tpl, p, exact_vals, job.et,
                                  job.error_metric)
            temp = self.start_temp
            for _step in range(self.steps):
                if time.time() - t0 > job.budget_s:
                    break
                q = propose(p)
                e2, val2 = self._energy(tpl, q, exact_vals, job.et,
                                        job.error_metric)
                outcome.stats["steps"] += 1
                if e2 <= e or rng.random() < math.exp(-(e2 - e) / max(temp, 1e-9)):
                    p, e, val = q, e2, val2
                    outcome.stats["accepted"] += 1
                    if val <= job.et:
                        fp = p.lits.tobytes() + p.sel.tobytes()
                        if fp not in pool:
                            pool[fp] = (e, p.copy())
                            if len(pool) > 4 * self.keep:  # bound memory
                                for k in sorted(pool, key=lambda k: pool[k][0])[self.keep:]:
                                    del pool[k]
                temp *= self.cooling

        for _e, p in sorted(pool.values(), key=lambda ep: ep[0])[: self.keep]:
            outcome.results.append(
                harvest(tpl, p, exact_vals, job.et, engine=self.name,
                        metric=job.error_metric,
                        name=f"{exact.name}_anneal", wall_s=time.time() - t0)
            )
        outcome.wall_s = time.time() - t0
        return outcome


class RewriteEngine:
    """Wraps the circuit-rewrite baselines (MUSCAT- / MECALS-like) as
    engines: single-candidate outcomes, re-verified like everything else."""

    def __init__(self, name: str):
        if name not in ("muscat", "mecals"):
            raise ValueError(f"unknown rewrite engine {name!r}")
        self.name = name

    def run(self, job: SearchJob) -> SearchOutcome:
        from .baselines import mecals_like, muscat_like

        fn = muscat_like if self.name == "muscat" else mecals_like
        _check_metric(job, self.name, ("wce", "mae"))
        exact = job.exact()
        t0 = time.time()
        res = fn(exact, et=job.et, seed=job.seed, wall_budget_s=job.budget_s)
        outcome = SearchOutcome(engine=self.name, benchmark=exact.name,
                                et=job.et)
        verify_circuit(res.circuit, exact.eval_words(), job.et,
                       metric=job.error_metric, context=f"engine={self.name}")
        outcome.results.append(
            Candidate(circuit=res.circuit, area=res.area, wall_s=res.wall_s)
        )
        outcome.wall_s = time.time() - t0
        return outcome


ENGINE_NAMES = ("shared", "xpat", "tensor", "anneal", "muscat", "mecals")

# the SMT engines need z3, which the port's machines do not have
_NEEDS_Z3 = ("shared", "xpat")


def get_engine(name: str, **opts):
    """Engine instance by registry name; ``opts`` are engine-specific
    constructor knobs (``population=``, ``device=``, ``backend=`` for
    tensor, ``steps=`` for anneal; the rewrite engines take none)."""
    if name == "tensor":
        return TensorEngine(**opts)
    if name == "anneal":
        return AnnealEngine(**opts)
    if name in ("muscat", "mecals"):
        if opts:
            raise TypeError(f"{name} engine takes no options, got {opts}")
        return RewriteEngine(name)
    if name in _NEEDS_Z3:
        raise NotImplementedError(
            f"engine {name!r} is not ported to PyTorch: the SMT engines need "
            f"z3; ROADMAP.md, \"Not queued, on purpose\"")
    raise KeyError(f"unknown engine {name!r}; known: {ENGINE_NAMES}")


def available_engines() -> tuple[str, ...]:
    """Engines the port runs: the reference's registry without z3."""
    return tuple(n for n in ENGINE_NAMES if n not in _NEEDS_Z3)
