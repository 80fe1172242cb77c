"""``python -m repro_torch.fleet --library <dir> --sweep <spec>`` — run a
sweep and report how much denser the operator frontier got.

Own copy of ``repro.fleet.__main__`` with the reference's flags and
report, plus ``--device``: where the tensor jobs run (the card unless
``cpu``).

``--trace <dir>`` (or just ``--trace``, defaulting to
``<library>/_fleet/trace``) turns on the observability plane: every job
runs under a ``fleet.job`` span (engine search spans nested inside),
worker processes append to their own span files in the shared trace dir
and snapshot their metric registries there, and the end-of-run report
prints the five slowest jobs plus per-engine wall-time totals straight
from the merged trace.  ``python -m repro_torch.obs summary --trace <dir>``
re-reads the same directory later.

Exit status is non-zero when ``--min-new`` is set and the sweep added
fewer operators than that (CI smoke gate); resumed no-op runs pass with
``--min-new 0`` (the default).
"""

from __future__ import annotations

import argparse
import sys
import time

from pathlib import Path

from ..device import resolve_device
from ..library.pareto import frontier_sizes
from ..library.store import OperatorStore, atomic_write_json
from ..obs.export import dump_metrics
from ..obs.metrics import get_registry
from ..obs.trace import configure as configure_tracing
from ..obs.trace import read_trace
from .plan import SWEEPS, load_spec, plan_jobs
from .worker import RECEIPT_DIR, flag_outlier_jobs, run_sweep


def notify_store_update(store: OperatorStore, *, sweep: str,
                        added: int) -> None:
    """Store-change notification: stamp ``<library>/_fleet/last_update.json``
    with the post-sweep :meth:`~repro_torch.library.store.OperatorStore.version_token`.
    A serving-side :class:`repro_torch.serving.watcher.LibraryWatcher` detects the
    change through the token itself; the stamp is the human/ops-facing
    record of *which* sweep moved it and when."""
    atomic_write_json(Path(store.root) / RECEIPT_DIR / "last_update.json", {
        "sweep": sweep,
        "added": added,
        "version_token": store.version_token(),
        "finished_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    })


def trace_report(trace_dir: Path, job_keys: set[str], *,
                 limit: int = 5, out=print) -> None:
    """The end-of-run view of *this* sweep's trace: slowest jobs and
    per-engine wall-time, filtered to the run's job keys (the trace dir
    may hold spans from earlier resumed runs)."""
    jobs = [s for s in read_trace(trace_dir)
            if s["name"] == "fleet.job"
            and s.get("attrs", {}).get("key") in job_keys]
    if not jobs:
        return
    out(f"\ntrace ({trace_dir}):")
    out(f"  slowest {min(limit, len(jobs))} job(s):")
    for s in sorted(jobs, key=lambda s: -float(s.get("dur_s", 0.0)))[:limit]:
        a = s.get("attrs", {})
        out(f"    {float(s.get('dur_s', 0.0)):8.2f}s  {a.get('engine', '?'):8s}"
            f" {a.get('benchmark', '?'):10s} et={a.get('et', '?')} "
            f"status={a.get('status', '?')} "
            f"results={a.get('n_results', 0)}")
    by_engine: dict[str, list[float]] = {}
    for s in jobs:
        eng = str(s.get("attrs", {}).get("engine", "?"))
        by_engine.setdefault(eng, []).append(float(s.get("dur_s", 0.0)))
    out("  per-engine wall-time:")
    for eng in sorted(by_engine, key=lambda e: -sum(by_engine[e])):
        ds = by_engine[eng]
        out(f"    {eng:8s} {len(ds):3d} job(s) {sum(ds):8.2f}s total "
            f"{sum(ds) / len(ds):7.2f}s mean")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet",
        description="Fill the approximate-operator library with a job fleet.",
    )
    ap.add_argument("--library", required=True,
                    help="shared operator-store directory (created if missing)")
    ap.add_argument("--sweep", default="smoke",
                    help=f"preset ({', '.join(SWEEPS)}) or JSON spec path")
    ap.add_argument("--workers", type=int, default=None,
                    help="process-pool size for CPU engines "
                         "(default: min(4, cpu count); 0/1 = sequential)")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="override the spec's per-job wall budget")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the spec's base seed")
    ap.add_argument("--min-new", type=int, default=0,
                    help="fail unless at least this many operators were added")
    ap.add_argument("--trace", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="write an observability trace (spans + metric "
                         "snapshots); DIR defaults to <library>/_fleet/trace")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tensor jobs; cpu runs their "
                         "plain PyTorch path")
    args = ap.parse_args(argv)

    spec = load_spec(args.sweep, budget_s=args.budget_s, seed=args.seed)
    jobs = plan_jobs(spec)
    device = (resolve_device(args.device)
              if any(j.engine == "tensor" for j in jobs) else None)
    trace_dir = None
    if args.trace is not None:
        trace_dir = Path(args.trace) if args.trace \
            else Path(args.library) / RECEIPT_DIR / "trace"
        configure_tracing(trace_dir)   # exports REPRO_TRACE_DIR to workers
    workers = args.workers
    if workers is None:
        import os

        workers = min(4, os.cpu_count() or 1)

    store = OperatorStore(args.library)
    before = frontier_sizes(store)
    n_before = sum(n for n, _ in before.values())
    print(f"sweep {spec.name!r}: {len(jobs)} job(s) -> "
          f"{args.library} ({n_before} operator(s) already stored)")
    t0 = time.time()
    results = run_sweep(spec, args.library, workers=workers, device=device)
    after = frontier_sizes(store)

    # ---- frontier-densification report ------------------------------------
    n_after = sum(n for n, _ in after.values())
    added = n_after - n_before
    print(f"\nfrontier densification ({time.time() - t0:.1f}s wall):")
    print(f"  {'signature':18s} {'records':>15s} {'frontier':>15s}")
    for name in sorted(set(before) | set(after)):
        nb, fb = before.get(name, (0, 0))
        na, fa = after.get(name, (0, 0))
        print(f"  {name:18s} {nb:6d} -> {na:<6d} {fb:6d} -> {fa:<6d}")
    if added:
        notify_store_update(store, sweep=spec.name, added=added)
    n_ok = sum(r.status == "ok" for r in results)
    n_skip = sum(r.status == "skipped" for r in results)
    n_fail = sum(r.status == "failed" for r in results)
    print(f"jobs: {n_ok} ok, {n_skip} resumed/skipped, {n_fail} failed; "
          f"{added} operator(s) added under "
          f"{sum(1 for s in after if after[s][0] > before.get(s, (0, 0))[0])} "
          f"signature(s)")
    outliers = flag_outlier_jobs(results)
    for r, z in outliers:
        print(f"  OUTLIER {r.job.describe():58s} engine_s={r.engine_s:.2f} "
              f"(robust z={z:+.1f} among its signature's jobs)")
    if trace_dir is not None:
        # the parent's own registry (tensor jobs run in-process) joins the
        # workers' snapshots before the report reads the merged dir back
        dump_metrics(trace_dir, get_registry())
        trace_report(trace_dir, {j.key() for j in jobs})
    if added < args.min_new:
        print(f"FAIL: added {added} < --min-new {args.min_new}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
