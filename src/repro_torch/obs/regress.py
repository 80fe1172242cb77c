"""Bench regression sentinel: BENCH_*.json vs baselines.

Own copy of ``repro.obs.regress``.  A bench JSON is compared with a
baseline run of the same bench:

* a **baseline dir** holds one JSON per bench, plus an optional
  ``tolerances.json`` whose ordered rules override the defaults.  The
  port's baselines are its own runs on the card: the JAX package's
  committed ``benchmarks/baselines`` are CPU times of another path;
* :func:`compare_bench` flattens both documents to dotted paths
  (``classes.gold.p95_ms_per_step``) and judges each metric under the
  first matching rule — **direction-aware**, because a faster tok/s is
  not a regression and neither is a lower ms/step;
* a **history dir** accumulates every compared run (seq-numbered atomic
  copies) and is uploaded as a CI artifact, so the trajectory is
  reconstructable even though runners are shared and noisy;
* ``python -m repro_torch.obs diff`` is the CLI/CI gate: exit 1 on any
  regression, with a ``--json`` report for machines.

Default tolerances are deliberately loose on timing (shared CI runners
jitter hugely) and exact on structure: ``trace_count`` drifting from 1
to 2 is a contract break at any speed.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from fnmatch import fnmatchcase
from pathlib import Path

from .trace import atomic_write_json

__all__ = [
    "Rule",
    "DEFAULT_RULES",
    "load_rules",
    "flatten",
    "compare_bench",
    "record_history",
]


@dataclass(frozen=True)
class Rule:
    """How one family of metrics (dotted-path glob) is judged.

    ``direction``: ``"higher"`` — higher is better, only a drop beyond
    tolerance regresses; ``"lower"`` — lower is better; ``"both"`` — any
    drift beyond tolerance regresses; ``"exact"`` — any change at all;
    ``"ignore"`` — never compared (run-local noise like wall time).
    Tolerance is ``max(abs_tol, rel_tol * |baseline|)``.
    """

    pattern: str
    direction: str = "both"
    rel_tol: float = 0.25
    abs_tol: float = 0.0

    def __post_init__(self) -> None:
        if self.direction not in ("higher", "lower", "both", "exact",
                                  "ignore"):
            raise ValueError(f"bad direction {self.direction!r} "
                             f"for pattern {self.pattern!r}")
        if self.rel_tol < 0 or self.abs_tol < 0:
            raise ValueError(f"negative tolerance on {self.pattern!r}")

    def matches(self, path: str) -> bool:
        return fnmatchcase(path, self.pattern)

    def judge(self, baseline, current) -> str | None:
        """``"regression"`` / ``"improvement"`` / ``None`` (within
        tolerance).  Non-numeric values only support exact rules."""
        if self.direction == "ignore":
            return None
        if self.direction == "exact" or not (
                isinstance(baseline, (int, float))
                and isinstance(current, (int, float))
                and not isinstance(baseline, bool)
                and not isinstance(current, bool)):
            return None if current == baseline else "regression"
        tol = max(self.abs_tol, self.rel_tol * abs(float(baseline)))
        delta = float(current) - float(baseline)
        if abs(delta) <= tol:
            return None
        if self.direction == "both":
            return "regression"
        worse = delta < 0 if self.direction == "higher" else delta > 0
        return "regression" if worse else "improvement"


# ordered: first match wins.  Structure exact, throughput/latency
# direction-aware and CI-noise tolerant, run-local identifiers ignored.
DEFAULT_RULES: tuple[Rule, ...] = (
    Rule("*trace_count*", "exact"),
    Rule("*wall_s*", "ignore"),
    Rule("*unix_time*", "ignore"),
    Rule("*plan*", "ignore"),          # plan ids are content hashes
    Rule("*tok_s*", "higher", rel_tol=0.5),
    Rule("*ms*", "lower", rel_tol=1.0),
    Rule("*drift*", "lower", rel_tol=1.0, abs_tol=1e-6),
    Rule("*area*", "lower", rel_tol=0.25),
    Rule("*", "ignore"),               # unmatched: counts, labels, noise
)


def load_rules(path: str | os.PathLike | None) -> tuple[Rule, ...]:
    """Rules from a committed ``tolerances.json`` (a list of rule docs
    under ``"rules"``), falling back to :data:`DEFAULT_RULES`; loaded
    rules take precedence but the defaults still backstop them."""
    if path is None or not Path(path).exists():
        return DEFAULT_RULES
    doc = json.loads(Path(path).read_text())
    rules = tuple(Rule(**r) for r in doc.get("rules", []))
    return rules + DEFAULT_RULES


def flatten(doc, prefix: str = "") -> dict:
    """Flatten nested dicts/lists to ``{"a.b.0.c": scalar}``."""
    out: dict = {}
    if isinstance(doc, dict):
        items = doc.items()
    elif isinstance(doc, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(doc))
    else:
        return {prefix: doc}
    for k, v in items:
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def _rule_for(path: str, rules: tuple[Rule, ...]) -> Rule | None:
    for rule in rules:
        if rule.matches(path):
            return rule
    return None


def compare_bench(current: dict, baseline: dict,
                  rules: tuple[Rule, ...] = DEFAULT_RULES) -> dict:
    """Judge one bench run against its baseline.

    Returns ``{"regressions": [...], "improvements": [...],
    "compared": n}`` where each finding carries the dotted metric path,
    both values, and the matching rule's pattern.  A metric present in
    the baseline but *missing* from the current run is a regression
    unless its rule is ``ignore`` (a renamed field must move its
    baseline, not silently vanish)."""
    cur = flatten(current)
    base = flatten(baseline)
    regressions: list[dict] = []
    improvements: list[dict] = []
    compared = 0
    for path in sorted(base):
        rule = _rule_for(path, rules)
        if rule is None or rule.direction == "ignore":
            continue
        if path not in cur:
            regressions.append({"metric": path, "baseline": base[path],
                                "current": None, "rule": rule.pattern,
                                "kind": "missing"})
            continue
        compared += 1
        verdict = rule.judge(base[path], cur[path])
        finding = {"metric": path, "baseline": base[path],
                   "current": cur[path], "rule": rule.pattern}
        if verdict == "regression":
            regressions.append({**finding, "kind": "regression"})
        elif verdict == "improvement":
            improvements.append({**finding, "kind": "improvement"})
    return {"regressions": regressions, "improvements": improvements,
            "compared": compared}


def record_history(history_dir: str | os.PathLike, name: str,
                   doc: dict) -> Path:
    """Append one run's bench doc to the history dir as
    ``<name>-<seq>.json`` (atomic, never overwrites an earlier run)."""
    d = Path(history_dir)
    d.mkdir(parents=True, exist_ok=True)
    stem = Path(name).stem
    seq = 0
    while (path := d / f"{stem}-{seq:04d}.json").exists():
        seq += 1
    atomic_write_json(path, doc)
    return path
