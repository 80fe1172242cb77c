"""The spread of a cell's runs: for each metric of the result lines in
the given files (one JSON result line each, or a run's whole standard
output), the median, the quartiles as ``statistics.quantiles(n=4)``
gives them, and their distance as a share of the median.

    python3 portbench/spread.py <result file> ...
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict
from typing import Sequence


def spread(values: Sequence[float]) -> tuple[float, float]:
    """The median, and the distance between the first and the third
    quartile as a share of it, the quartiles as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med


def last_line(path: str) -> dict:
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def main(paths: list[str]) -> int:
    values: dict[str, list[float]] = defaultdict(list)
    for p in paths:
        for name, m in last_line(p)["metrics"].items():
            values[name].append(m["value"])
    for name, vs in sorted(values.items()):
        if len(vs) < 2:
            print(f"{name}: {vs}")
            continue
        med, sp = spread(vs)
        print(f"{name}: n {len(vs)} median {med:.6g} spread {sp:.4%} "
              f"min {min(vs):.6g} max {max(vs):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
