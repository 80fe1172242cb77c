#!/usr/bin/env python3
"""Time the health plane's cost on the host, for one or more checkouts in
turns, so that two versions of ``repro_torch.obs.anomaly`` can be
compared in one process start each:

    python3 tools/time_health.py path/to/checkout/src [path/to/other/src ...]

Each ``src`` directory is timed in its own process (one import each), in
the order given, repeated ``--rounds`` times (default 2).  Prints one JSON
line a run:

- ``detector_us``: one ``RobustDetector.observe`` (default window 64) over
  20,000 seeded noisy samples, best of five passes, in microseconds;
- ``plane_ms``: one ``HealthPlane.observe_step`` on the class book
  ``gold:0.02@8ms,batch:0.2`` over 2000 steps, each run on a fresh plane,
  best and median of seven runs, in milliseconds: the workload of
  ``tests/test_torch_health.py::test_health_plane_overhead_is_negligible``.

Runs on the CPU; the numbers are the host's, and move with its load.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

_RUN = r"""
import json, sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
from repro_torch.obs import anomaly, health
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.sensitivity.classes import ClassBook

xs = [float(v) for v in 10 + np.random.default_rng(0).standard_normal(20000)]
det = []
for _ in range(5):
    d = anomaly.RobustDetector("x")
    t0 = time.perf_counter()
    for i, v in enumerate(xs):
        d.observe(v, i)
    det.append(1e6 * (time.perf_counter() - t0) / len(xs))
plane = []
for _ in range(7):
    hp = health.HealthPlane(ClassBook.parse("gold:0.02@8ms,batch:0.2"),
                            registry=MetricRegistry())
    t0 = time.perf_counter()
    for i in range(2000):
        hp.observe_step(step=i, step_ms=10.0 + 0.1 * (i % 7),
                        classes={"gold": {}, "batch": {}}, drift=0.01,
                        backlog=i % 3, occupancy=0.5, preemptions=0,
                        plan_id="p", level=1)
    plane.append(1e3 * (time.perf_counter() - t0) / 2000)
print(json.dumps({"src": sys.argv[1], "detector_us": round(min(det), 3),
                  "plane_ms_best": round(min(plane), 4),
                  "plane_ms_median": round(sorted(plane)[3], 4)}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", nargs="+", help="a checkout's src directory")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    for _ in range(args.rounds):
        for src in args.src:
            out = subprocess.run([sys.executable, "-c", _RUN, src], check=True,
                                 capture_output=True, text=True)
            print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
