"""Sweep-spec expansion: one spec in, a deterministic job list out.

Own copy of ``repro.fleet.plan``: the same presets, seeds and job order,
so a sweep plans the same jobs in either package.

The planner is pure bookkeeping — no search code runs here — so a plan
can be printed, diffed and re-derived bit-identically on any machine:
job ordering follows the spec's field order, and each job's seed is an
SHA-256 derivation of ``(spec.seed, kind, bits, et, engine)``, so adding
a benchmark to a sweep never reshuffles the seeds of existing jobs.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field, replace
from pathlib import Path

from ..core.engine import ENGINE_NAMES, SearchJob

__all__ = ["SweepSpec", "SWEEPS", "load_spec", "plan_jobs", "ets_for"]


@dataclass(frozen=True)
class SweepSpec:
    """Declarative description of a fleet sweep (see the package docstring
    for the on-disk JSON format)."""

    name: str
    benchmarks: tuple[str, ...]          # operator kinds: "mul" / "adder"
    bits: tuple[int, ...]                # operand bit widths
    engines: tuple[str, ...]             # engine registry names
    ets: tuple[int, ...] = ()            # absolute error thresholds
    et_fracs: tuple[float, ...] = ()     # and/or fractions of max output
    budget_s: float = 30.0               # wall budget per job
    seed: int = 0
    engine_opts: dict = field(default_factory=dict)
    # one-off jobs appended after the grid: dicts with benchmark/bits/et/
    # engine and optionally error_metric / budget_s.  This is how a sweep
    # mixes error metrics (an mae miter job riding along a wce grid)
    # without multiplying the whole grid by every metric.
    extra_jobs: tuple[dict, ...] = ()

    def __post_init__(self) -> None:
        extra_engines = tuple(j["engine"] for j in self.extra_jobs)
        for eng in self.engines + extra_engines:
            if eng not in ENGINE_NAMES:
                raise ValueError(f"unknown engine {eng!r} in sweep "
                                 f"{self.name!r}; known: {ENGINE_NAMES}")
        if not (self.ets or self.et_fracs or self.extra_jobs):
            raise ValueError(f"sweep {self.name!r} has neither ets nor et_fracs")


# Named presets.  ``smoke`` is the CI / acceptance sweep: 2-bit only, no
# z3 needed, engines bounded by step/generation counts (not wall time) so
# a re-run reproduces the exact same netlists.
SWEEPS: dict[str, SweepSpec] = {
    "smoke": SweepSpec(
        name="smoke",
        benchmarks=("adder", "mul"),
        bits=(2,),
        ets=(1, 2),
        engines=("anneal", "tensor"),
        budget_s=60.0,  # safety net only; step/generation counts bound work
        engine_opts={
            "tensor": {"population": 512, "generations": 24, "elites": 64,
                       "keep": 4},
            "anneal": {"steps": 8000, "restarts": 4, "keep": 4},
        },
        # one mean-metric job rides along: an mae-bounded 2-bit multiplier
        # search (the anneal engine scores mae natively; the store
        # validates the mae signature at write time)
        extra_jobs=(
            {"benchmark": "mul", "bits": 2, "et": 1, "engine": "anneal",
             "error_metric": "mae"},
        ),
    ),
    # densify the *composed W8A8* frontier: every stored mul block lowers
    # to a 256x256 table via repro_torch.precision.compose, so what matters for
    # 8-bit serving is tight block error (nibble shift-add amplifies a
    # block's wce by up to 289x) at both searched widths.  The template
    # engines carry the 2-bit blocks; the rewrite baselines are what
    # reliably crack the 4-bit multiplier under bounded CPU budgets.
    # Everything is z3-free and step-bounded so CI reproduces the sweep.
    "8bit": SweepSpec(
        name="8bit",
        benchmarks=("mul",),
        bits=(2, 4),
        ets=(1, 2, 4, 8),
        engines=("anneal", "tensor", "muscat", "mecals"),
        budget_s=25.0,  # safety net; step/generation counts bound the work
        engine_opts={
            "tensor": {"population": 256, "generations": 16, "elites": 32,
                       "keep": 3},
            "anneal": {"steps": 6000, "restarts": 3, "keep": 3},
        },
    ),
    "nightly": SweepSpec(
        name="nightly",
        benchmarks=("adder", "mul"),
        bits=(2, 3, 4),
        et_fracs=(1 / 32, 1 / 16, 1 / 8, 1 / 4),
        engines=("shared", "xpat", "tensor", "anneal", "muscat", "mecals"),
        budget_s=600.0,
    ),
}


def ets_for(spec: SweepSpec, kind: str, bits: int) -> tuple[int, ...]:
    """The sweep's ET grid for one (kind, bits): absolute ``ets`` plus
    ``et_fracs`` scaled by the exact operator's maximum output value."""
    ets = set(spec.ets)
    if spec.et_fracs:
        top = (1 << bits) - 1
        max_val = top * top if kind == "mul" else 2 * top
        ets.update(max(1, round(f * max_val)) for f in spec.et_fracs)
    return tuple(sorted(ets))


def job_seed(base_seed: int, kind: str, bits: int, et: int, engine: str,
             error_metric: str = "wce") -> int:
    """Stable per-job seed: independent of job ordering within the sweep.

    Non-default metrics extend the blob; the default leaves it unchanged
    so every pre-metric sweep keeps its exact historical seeds (and thus
    its reproducible netlists).
    """
    blob = f"{base_seed}|{kind}|{bits}|{et}|{engine}"
    if error_metric != "wce":
        blob += f"|{error_metric}"
    return int.from_bytes(hashlib.sha256(blob.encode()).digest()[:4], "big")


def plan_jobs(spec: SweepSpec) -> list[SearchJob]:
    """Expand a sweep spec into its full, deterministic job list (the
    grid first, then the spec's ``extra_jobs`` in declaration order)."""
    jobs: list[SearchJob] = []
    for kind in spec.benchmarks:
        for bits in spec.bits:
            for et in ets_for(spec, kind, bits):
                for engine in spec.engines:
                    jobs.append(SearchJob(
                        benchmark=kind, bits=bits, et=et, engine=engine,
                        budget_s=spec.budget_s,
                        seed=job_seed(spec.seed, kind, bits, et, engine),
                    ))
    for extra in spec.extra_jobs:
        kind, bits = extra["benchmark"], int(extra["bits"])
        et, engine = int(extra["et"]), extra["engine"]
        metric = extra.get("error_metric", "wce")
        jobs.append(SearchJob(
            benchmark=kind, bits=bits, et=et, engine=engine,
            error_metric=metric,
            budget_s=float(extra.get("budget_s", spec.budget_s)),
            seed=job_seed(spec.seed, kind, bits, et, engine, metric),
        ))
    return jobs


def load_spec(name_or_path: str, **overrides) -> SweepSpec:
    """Resolve ``--sweep``: a preset name or a JSON spec file path."""
    if name_or_path in SWEEPS:
        spec = SWEEPS[name_or_path]
    else:
        path = Path(name_or_path)
        if not path.is_file():
            raise FileNotFoundError(
                f"--sweep {name_or_path!r} is neither a preset "
                f"({', '.join(SWEEPS)}) nor a spec file"
            )
        doc = json.loads(path.read_text())
        spec = SweepSpec(
            name=doc.get("name", path.stem),
            benchmarks=tuple(doc["benchmarks"]),
            bits=tuple(int(b) for b in doc["bits"]),
            engines=tuple(doc["engines"]),
            ets=tuple(int(e) for e in doc.get("ets", ())),
            et_fracs=tuple(float(f) for f in doc.get("et_fracs", ())),
            budget_s=float(doc.get("budget_s", 30.0)),
            seed=int(doc.get("seed", 0)),
            engine_opts=dict(doc.get("engine_opts", {})),
            extra_jobs=tuple(dict(j) for j in doc.get("extra_jobs", ())),
        )
    overrides = {k: v for k, v in overrides.items() if v is not None}
    return replace(spec, **overrides) if overrides else spec
