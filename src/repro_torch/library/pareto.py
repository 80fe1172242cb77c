"""Pareto-front management over stored operators.

Own copy of ``repro.library.pareto``.  Dominance is in the minimization
sense over a tuple of objectives (for operators: synthesized area and
measured error).  :func:`pareto_front` is
generic, while :class:`ParetoFrontier` wraps the operator-specific
area-vs-error queries.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, TypeVar

from .store import OperatorRecord, OperatorStore

T = TypeVar("T")

__all__ = ["dominates", "pareto_front", "ParetoFrontier", "frontier_sizes"]


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """``a`` dominates ``b``: no objective worse, at least one strictly better."""
    assert len(a) == len(b)
    return all(x <= y for x, y in zip(a, b)) and any(x < y for x, y in zip(a, b))


def pareto_front(
    items: Iterable[T],
    objectives: Sequence[Callable[[T], float]],
) -> list[T]:
    """Non-dominated subset of ``items``, minimizing every objective.

    Duplicated objective vectors keep their first representative.  The
    result is sorted by the first objective (ascending).
    """
    pts = [(tuple(f(it) for f in objectives), it) for it in items]
    pts.sort(key=lambda p: p[0])
    front: list[tuple[tuple, T]] = []
    seen: set[tuple] = set()
    for vec, it in pts:
        if vec in seen:
            continue
        if any(dominates(fvec, vec) for fvec, _ in front):
            continue
        front[:] = [(fvec, fit) for fvec, fit in front if not dominates(vec, fvec)]
        front.append((vec, it))
        seen.add(vec)
    front.sort(key=lambda p: p[0])
    return [it for _, it in front]


class ParetoFrontier:
    """Area-vs-error frontier over a set of :class:`OperatorRecord`s.

    Error is the *measured* worst-case error (``wce``), not the search
    threshold: a search run under ET=8 that happened to land at wce=3 sits
    at 3 on the frontier.
    """

    def __init__(self, records: Iterable[OperatorRecord]) -> None:
        self.records = list(records)
        self.front: list[OperatorRecord] = pareto_front(
            self.records, (lambda r: r.area, lambda r: float(r.wce))
        )

    @classmethod
    def from_store(
        cls,
        store: OperatorStore,
        op_kind: str | None = None,
        bits: int | None = None,
        **query_kw,
    ) -> "ParetoFrontier":
        return cls(store.query(op_kind, bits, **query_kw))

    def __len__(self) -> int:
        return len(self.front)

    def query(
        self, *, max_error: float | None = None, max_area: float | None = None
    ) -> list[OperatorRecord]:
        """Frontier operators satisfying the bounds, cheapest-area first."""
        out = self.front
        if max_error is not None:
            out = [r for r in out if r.wce <= max_error]
        if max_area is not None:
            out = [r for r in out if r.area <= max_area]
        return out

    def most_accurate(self) -> OperatorRecord | None:
        return min(self.front, key=lambda r: (r.wce, r.area)) if self.front else None

    def cheapest(self) -> OperatorRecord | None:
        return self.front[0] if self.front else None


def frontier_sizes(store: OperatorStore) -> dict[str, tuple[int, int]]:
    """Per-signature ``{dirname: (record_count, frontier_size)}``.

    Two snapshots, before and after a search, show what it bought.
    """
    out: dict[str, tuple[int, int]] = {}
    for sig in store.signatures():
        recs = store.records(sig)
        out[sig.dirname] = (len(recs), len(ParetoFrontier(recs)))
    return out
