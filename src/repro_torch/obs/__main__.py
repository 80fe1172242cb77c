"""``python -m repro_torch.obs <command>`` — inspect traces, gate health,
read post-mortems, and diff bench runs.  Own copy of ``repro.obs.__main__``:
the same subcommands, output and exit codes.

* ``summary --trace <dir>`` — span totals, slowest spans, per-engine
  fleet wall-time, per-class decode-latency table; ``--json`` emits the
  same facts machine-readably so CI gates parse fields instead of
  grepping formatted text.  ``--require-span`` /
  ``--require-class-latency`` turn it into a CI gate.
* ``slowest --trace <dir>`` / ``prom --trace <dir>`` — the slowest spans
  / merged metrics in Prometheus text format.
* ``health --bench BENCH.json [--max-state warn]`` — read the health
  section a ``--health`` serve wrote; exit 1 when the run's worst SLO
  state exceeds the allowed one (the CI health gate).
* ``postmortem --dir <dir>`` — list (or ``--json``-dump) the flight
  recorder's bundles; ``--require N`` gates on at least N bundles,
  ``--last`` prints the newest bundle whole.
* ``diff --bench BENCH.json ... --baseline-dir DIR`` — the bench
  regression sentinel: direction-aware per-metric comparison against
  baseline runs of the same bench on the card, optional ``--history-dir``
  accumulation, exit 1 on any regression.
* ``requests --trace <dir>`` — per-request lifecycle timelines
  reconstructed from the ``req.*`` event chains: slowest-first table
  with the queue/prefill/decode/suspension breakdown and the critical
  path; ``--require-complete`` exits 1 on any broken chain (the
  provenance-smoke CI gate), ``--rid`` narrows to one request.
* ``provenance --trace <dir>`` — audit the approximation-provenance
  ledger (``prov-*.jsonl``): which plan decoded which token ranges,
  with drift stats; exits 1 when any completed request has a gap,
  overlap, or dangling plan reference.
* ``costs --trace <dir>`` — the cost-accounting report: per-request /
  per-class / per-layer approx-MAC and area·MAC dividend attribution
  joined from the ledger; ``--require-reconciled`` exits 1 unless every
  attributed MAC tiles its request exactly (the costs-smoke CI gate).
* ``export --trace <dir> --format chrome [--out f.json]`` — convert the
  merged span trace to Chrome trace-event JSON for Perfetto /
  ``chrome://tracing``.

Every trace-reading command exits 2 with ``no trace at <dir>`` when the
directory is absent or holds no trace artifacts at all.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .costs import cost_report, render_report
from .export import METRICS_GLOB, prometheus_text, read_metrics
from .flight import read_postmortems
from .health import STATES, state_rank
from .metrics import Histogram, MetricRegistry
from .perfetto import export_chrome
from .provenance import audit, read_ledger
from .regress import compare_bench, load_rules, record_history
from .requests import build_timelines, critical_path
from .trace import read_trace

# the metric families the serving telemetry records (kept in one place so
# the inspector and repro_torch.serving.telemetry cannot drift apart)
MS_PER_STEP_METRIC = "serve_ms_per_step"
DECODE_TOK_S_METRIC = "serve_decode_tok_s"
ALL_CLASSES = "_all"   # the label the whole-run aggregate rides under

COMMANDS = ("summary", "slowest", "prom", "health", "postmortem", "diff",
            "requests", "provenance", "costs", "export")


def _trace_missing(trace_dir: Path) -> bool:
    """True when there is nothing to inspect: the dir is absent or holds
    none of the trace artifact families (spans, metric snapshots,
    provenance ledger)."""
    if not trace_dir.is_dir():
        return True
    return not any(
        any(trace_dir.glob(pattern))
        for pattern in ("spans-*.jsonl", METRICS_GLOB, "prov-*.jsonl"))


def _no_trace(trace_dir: Path) -> int:
    print(f"no trace at {trace_dir}", file=sys.stderr)
    return 2


def _fmt(v, width: int = 9, prec: int = 3) -> str:
    if v is None:
        return "-".rjust(width)
    return f"{v:{width}.{prec}f}"


def span_totals(spans: list[dict]) -> list[tuple[str, int, float]]:
    """``(name, count, total_s)`` rows, heaviest first."""
    agg: dict[str, list[float]] = {}
    for s in spans:
        agg.setdefault(s["name"], []).append(float(s.get("dur_s", 0.0)))
    return sorted(((name, len(ds), sum(ds)) for name, ds in agg.items()),
                  key=lambda r: -r[2])


def slowest_spans(spans: list[dict], n: int = 5) -> list[dict]:
    return sorted(spans, key=lambda s: -float(s.get("dur_s", 0.0)))[:n]


def engine_totals(spans: list[dict]) -> dict[str, dict]:
    """Per-engine wall-time over ``fleet.job`` spans."""
    agg: dict[str, dict] = {}
    for s in spans:
        if s["name"] != "fleet.job":
            continue
        eng = str(s.get("attrs", {}).get("engine", "?"))
        row = agg.setdefault(eng, {"jobs": 0, "wall_s": 0.0, "results": 0})
        row["jobs"] += 1
        row["wall_s"] += float(s.get("dur_s", 0.0))
        row["results"] += int(s.get("attrs", {}).get("n_results", 0) or 0)
    return agg


def class_latency_rows(metrics: MetricRegistry) -> dict[str, dict]:
    """Per-class decode latency percentiles from the merged snapshots."""
    rows: dict[str, dict] = {}
    for labels, hist in metrics.with_name(MS_PER_STEP_METRIC):
        if not isinstance(hist, Histogram) or hist.count == 0:
            continue
        cls = labels.get("class", ALL_CLASSES)
        rows[cls] = {
            "batches": hist.count,
            "mean": hist.mean,
            **hist.percentiles(),
        }
        tok = metrics.find(DECODE_TOK_S_METRIC, **labels)
        if isinstance(tok, Histogram) and tok.count:
            rows[cls]["tok_s_p50"] = tok.quantile(0.5)
    return rows


def _describe_span(s: dict) -> str:
    attrs = s.get("attrs", {})
    inner = " ".join(f"{k}={attrs[k]}" for k in sorted(attrs))
    return f"{s['name']}" + (f" [{inner}]" if inner else "")


def summarize(trace_dir: Path, *, limit: int = 5, out=print) -> dict:
    spans = read_trace(trace_dir)
    metrics = read_metrics(trace_dir)
    n_files = len(list(trace_dir.glob("spans-*.jsonl")))
    n_snaps = len(list(trace_dir.glob(METRICS_GLOB)))
    out(f"trace {trace_dir}: {len(spans)} span(s) from {n_files} file(s), "
        f"{n_snaps} metric snapshot(s)")

    totals = span_totals(spans)
    if totals:
        out("\nspan totals:")
        out(f"  {'name':24s} {'count':>6s} {'total_s':>9s} {'mean_s':>9s}")
        for name, count, total in totals:
            out(f"  {name:24s} {count:6d} {_fmt(total)} "
                f"{_fmt(total / count)}")

        out(f"\nslowest {limit} span(s):")
        for s in slowest_spans(spans, limit):
            out(f"  {_fmt(float(s.get('dur_s', 0.0)))}s  {_describe_span(s)}")

    engines = engine_totals(spans)
    if engines:
        out("\nfleet engines (job wall-time):")
        out(f"  {'engine':10s} {'jobs':>5s} {'wall_s':>9s} {'mean_s':>9s} "
            f"{'results':>8s}")
        for eng in sorted(engines, key=lambda e: -engines[e]["wall_s"]):
            row = engines[eng]
            out(f"  {eng:10s} {row['jobs']:5d} {_fmt(row['wall_s'])} "
                f"{_fmt(row['wall_s'] / row['jobs'])} {row['results']:8d}")

    classes = class_latency_rows(metrics)
    if classes:
        out("\nper-class decode latency (ms/step):")
        out(f"  {'class':10s} {'batches':>7s} {'p50':>9s} {'p95':>9s} "
            f"{'p99':>9s} {'mean':>9s}")
        for cls in sorted(classes):
            r = classes[cls]
            out(f"  {cls:10s} {r['batches']:7d} {_fmt(r['p50'])} "
                f"{_fmt(r['p95'])} {_fmt(r['p99'])} {_fmt(r['mean'])}")

    return {"spans": spans, "engines": engines, "classes": classes}


def summary_doc(trace_dir: Path, *, limit: int = 5) -> dict:
    """The ``summary --json`` document: the same facts the human summary
    prints, as structured fields CI can parse without grepping."""
    spans = read_trace(trace_dir)
    return {
        "trace_dir": str(trace_dir),
        "n_spans": len(spans),
        "n_span_files": len(list(trace_dir.glob("spans-*.jsonl"))),
        "n_metric_snapshots": len(list(trace_dir.glob(METRICS_GLOB))),
        "span_totals": {
            name: {"count": count, "total_s": round(total, 6)}
            for name, count, total in span_totals(spans)},
        "slowest": [
            {"name": s["name"], "dur_s": round(float(s.get("dur_s", 0)), 6),
             "id": s.get("id"), "attrs": s.get("attrs", {})}
            for s in slowest_spans(spans, limit)],
        "engines": engine_totals(spans),
        "classes": {
            cls: {k: (round(v, 6) if isinstance(v, float) else v)
                  for k, v in row.items()}
            for cls, row in class_latency_rows(
                read_metrics(trace_dir)).items()},
    }


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------
def cmd_summary(args) -> int:
    trace_dir = Path(args.trace)
    if _trace_missing(trace_dir):
        return _no_trace(trace_dir)
    if args.json:
        doc = summary_doc(trace_dir, limit=args.limit)
        print(json.dumps(doc, indent=1, sort_keys=True))
        by_name = {n: r["count"] for n, r in doc["span_totals"].items()}
        classes = doc["classes"]
    else:
        report = summarize(trace_dir, limit=args.limit)
        by_name = {}
        for s in report["spans"]:
            by_name[s["name"]] = by_name.get(s["name"], 0) + 1
        classes = report["classes"]

    rc = 0
    for req in args.require_span:
        name, _, n = req.partition("=")
        want = int(n) if n else 1
        got = by_name.get(name, 0)
        if got < want:
            print(f"FAIL: {got} span(s) named {name!r}, need >= {want}",
                  file=sys.stderr)
            rc = 1
    if args.require_class_latency:
        per_class = [c for c in classes if c != ALL_CLASSES]
        if not per_class:
            print("FAIL: no per-class latency histograms in trace metrics",
                  file=sys.stderr)
            rc = 1
        elif not args.json:
            print(f"\nper-class latency present for: {sorted(per_class)}")
    return rc


def cmd_slowest(args) -> int:
    trace_dir = Path(args.trace)
    if _trace_missing(trace_dir):
        return _no_trace(trace_dir)
    spans = read_trace(trace_dir)
    if args.name:
        spans = [s for s in spans if args.name in s["name"]]
    for s in slowest_spans(spans, args.limit):
        print(f"{_fmt(float(s.get('dur_s', 0.0)))}s  {_describe_span(s)}")
    return 0


def cmd_prom(args) -> int:
    trace_dir = Path(args.trace)
    if not trace_dir.is_dir():
        print(f"no such trace dir: {trace_dir}", file=sys.stderr)
        return 2
    sys.stdout.write(prometheus_text(read_metrics(trace_dir)))
    return 0


def cmd_health(args) -> int:
    """Gate on the health section of a ``--health`` serve's bench JSON
    (or a bare health-report JSON): exit 1 when the worst observed SLO
    state exceeds ``--max-state``."""
    path = Path(args.bench)
    if not path.exists():
        print(f"no such bench json: {path}", file=sys.stderr)
        return 2
    doc = json.loads(path.read_text())
    health = doc.get("health", doc)
    state = health.get("state")
    if state not in STATES:
        print(f"{path} has no health section (serve without --health?)",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(health, indent=1, sort_keys=True))
    else:
        print(f"health: {state}  (anomalies={health.get('anomalies_fired', 0)}"
              f" pages={health.get('pages', 0)}"
              f" dumps={health.get('dumps', 0)})")
        for cls, row in sorted(health.get("classes", {}).items()):
            parts = [f"{cls}: {row.get('state')}"]
            for kind in ("latency", "drift"):
                if kind in row:
                    b = row[kind]
                    parts.append(
                        f"{kind} burn {b.get('burn_short', 0):.2f}/"
                        f"{b.get('burn_long', 0):.2f} "
                        f"({b.get('violations', 0)}/"
                        f"{b.get('observations', 0)} bad)")
            print("  " + "  ".join(parts))
        for a in health.get("recent_anomalies", []):
            cause = a.get("cause")
            print(f"  anomaly {a['signal']}@{a['step']} z={a['zscore']:+.1f}"
                  + (f" <- {cause['event']}@{cause['step']}"
                     f" [{cause.get('event_id', '')}]" if cause else ""))
    if state_rank(state) > state_rank(args.max_state):
        print(f"FAIL: health state {state!r} exceeds allowed "
              f"{args.max_state!r}", file=sys.stderr)
        return 1
    return 0


def cmd_postmortem(args) -> int:
    d = Path(args.dir)
    bundles = read_postmortems(d) if d.is_dir() else []
    if args.json:
        print(json.dumps([{"path": str(p), **doc} for p, doc in bundles],
                         indent=1, sort_keys=True))
    else:
        print(f"{len(bundles)} post-mortem bundle(s) in {d}")
        for p, doc in bundles:
            ctx = doc.get("context", {})
            print(f"  {p.name}: {doc.get('reason')} — "
                  f"{doc.get('detail', '')[:100]} "
                  f"[{len(doc.get('frames', []))} frame(s), "
                  f"plan={ctx.get('plan_id')}, step={ctx.get('step')}]")
        if args.last and bundles:
            print(json.dumps(bundles[-1][1], indent=1, sort_keys=True))
    if len(bundles) < args.require:
        print(f"FAIL: {len(bundles)} bundle(s), need >= {args.require}",
              file=sys.stderr)
        return 1
    return 0


def cmd_diff(args) -> int:
    """Bench regression sentinel: each BENCH json vs its committed
    baseline (same filename under ``--baseline-dir``)."""
    rules = load_rules(args.tolerances)
    rc = 0
    report = []
    for bench in args.bench:
        bench = Path(bench)
        if not bench.exists():
            print(f"SKIP {bench.name}: no such file", file=sys.stderr)
            if args.require_baseline:
                rc = 1
            continue
        current = json.loads(bench.read_text())
        if args.history_dir:
            record_history(args.history_dir, bench.name, current)
        base_path = Path(args.baseline_dir) / bench.name
        if not base_path.exists():
            print(f"SKIP {bench.name}: no baseline at {base_path}"
                  + ("" if args.require_baseline
                     else " (commit one to enable the gate)"))
            if args.require_baseline:
                rc = 1
            continue
        res = compare_bench(current, json.loads(base_path.read_text()),
                            rules)
        report.append({"bench": bench.name, **res})
        status = "FAIL" if res["regressions"] else "ok"
        if res["regressions"]:
            rc = 1
        if not args.json:
            print(f"{status} {bench.name}: {res['compared']} metric(s) "
                  f"compared, {len(res['regressions'])} regression(s), "
                  f"{len(res['improvements'])} improvement(s)")
            for f in res["regressions"]:
                print(f"  REGRESSION {f['metric']}: "
                      f"{f['baseline']} -> {f['current']} "
                      f"(rule {f['rule']}, {f['kind']})")
            for f in res["improvements"]:
                print(f"  improved   {f['metric']}: "
                      f"{f['baseline']} -> {f['current']}")
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    return rc


def cmd_requests(args) -> int:
    """Per-request lifecycle timelines from the ``req.*`` trace chains."""
    trace_dir = Path(args.trace)
    if _trace_missing(trace_dir):
        return _no_trace(trace_dir)
    timelines = build_timelines(read_trace(trace_dir))
    if args.rid is not None:
        timelines = {rid: tl for rid, tl in timelines.items()
                     if rid == args.rid}
    if not timelines:
        print("no req.* lifecycle events in trace (serve without --trace, "
              "or wrong --rid?)", file=sys.stderr)
        return 2

    # slowest first; in-flight requests (no total yet) sink to the end
    order = sorted(timelines.values(),
                   key=lambda t: -(t.total_ms if t.total_ms is not None
                                   else -1.0))
    broken = [t for t in order if not t.complete]
    if args.json:
        print(json.dumps({
            "trace_dir": str(trace_dir),
            "n_requests": len(order),
            "n_complete": len(order) - len(broken),
            "requests": [{
                "rid": t.rid, "cls": t.cls, "replica": t.replica or None,
                "total_ms": t.total_ms, "steps": t.steps,
                "preempts": t.preempts, "resumes": t.resumes,
                "breakdown": t.breakdown,
                "critical_path": critical_path(t.breakdown),
                "events": [e["name"] for e in t.events],
                "complete": t.complete, "problems": t.problems,
            } for t in order],
        }, indent=1, sort_keys=True))
    else:
        print(f"{len(order)} request(s) in {trace_dir}, "
              f"{len(order) - len(broken)} complete chain(s)")
        print(f"  {'rid':>5s} {'class':8s} {'total':>9s} {'queue':>9s} "
              f"{'prefill':>9s} {'decode':>9s} {'susp':>9s} {'pre':>3s} "
              f"{'critical':9s} chain")
        for t in order[:args.limit]:
            b = t.breakdown
            crit = critical_path(b) or "-"
            state = "ok" if t.complete else "BROKEN"
            print(f"  {t.rid:5d} {t.cls:8s} {_fmt(t.total_ms)} "
                  f"{_fmt(b.get('queue_ms'))} {_fmt(b.get('prefill_ms'))} "
                  f"{_fmt(b.get('decode_ms'))} "
                  f"{_fmt(b.get('suspension_ms'))} {t.preempts:3d} "
                  f"{crit.removesuffix('_ms') if crit != '-' else '-':9s} "
                  f"{state}"
                  + (f" ({t.replica})" if t.replica else ""))
        for t in broken:
            for prob in t.problems:
                print(f"  rid {t.rid}: {prob}", file=sys.stderr)
    if args.require_complete and broken:
        print(f"FAIL: {len(broken)} request(s) with broken lifecycle "
              f"chains", file=sys.stderr)
        return 1
    return 0


def cmd_provenance(args) -> int:
    """Audit the approximation-provenance ledger next to the trace."""
    trace_dir = Path(args.trace)
    if _trace_missing(trace_dir):
        return _no_trace(trace_dir)
    records = read_ledger(trace_dir)
    if not records:
        print(f"no prov-*.jsonl records in {trace_dir} (serve without "
              "--trace, or a non-continuous engine?)", file=sys.stderr)
        return 2
    report = audit(records)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(f"{report['n_requests']} request(s), {report['n_done']} "
              f"done, {report['n_complete']} with gap-free provenance, "
              f"{report['n_failed']} failed; {len(report['plans'])} "
              f"plan(s) on record")
        for rid, rep in report["requests"].items():
            segs = " ".join(
                f"[{r['t0']},{r['t1']})@{r['plan'][:12]}"
                + (f"/L{r['level']}" if r.get("level") is not None else "")
                for r in rep["ranges"])
            drift = (f"  drift mean={rep['mean_drift']} "
                     f"max={rep['max_drift']}"
                     if "mean_drift" in rep else "")
            state = ("complete" if rep["complete"]
                     else "in-flight" if rep["problems"]
                     and rep["problems"][0].startswith("no done")
                     else "FAILED")
            print(f"  rid {rid} ({rep['cls']}): {rep['tokens_covered']} "
                  f"token(s) {state}  {segs}{drift}")
            for prob in rep["problems"]:
                if not prob.startswith("no done"):
                    print(f"    {prob}", file=sys.stderr)
    if report["n_failed"]:
        print(f"FAIL: {report['n_failed']} completed request(s) without "
              f"gap-free provenance", file=sys.stderr)
        return 1
    return 0


def cmd_costs(args) -> int:
    """Cost-accounting report/gate over the provenance ledger."""
    trace_dir = Path(args.trace)
    if _trace_missing(trace_dir):
        return _no_trace(trace_dir)
    records = read_ledger(trace_dir)
    if not records:
        print(f"no prov-*.jsonl records in {trace_dir} (serve without "
              "--trace, or a non-continuous engine?)", file=sys.stderr)
        return 2
    rep = cost_report(records)
    if args.json:
        print(json.dumps(rep, indent=1, sort_keys=True))
    else:
        print(render_report(rep))
    if args.require_reconciled and not rep["reconciled"]:
        print("FAIL: cost attribution did not reconcile — "
              + "; ".join(rep["problems"] or ["no completed requests"]),
              file=sys.stderr)
        return 1
    return 0


def cmd_export(args) -> int:
    """Convert the merged span trace to Chrome trace-event JSON."""
    trace_dir = Path(args.trace)
    if _trace_missing(trace_dir):
        return _no_trace(trace_dir)
    spans = read_trace(trace_dir)
    if not spans:
        print(f"no spans-*.jsonl span records in {trace_dir} (serve "
              "without --trace?)", file=sys.stderr)
        return 2
    doc = export_chrome(spans, args.out)
    if args.out:
        print(f"wrote {len(doc['traceEvents'])} trace event(s) "
              f"({doc['otherData']['spans']} span(s)) to {args.out}")
    else:
        print(json.dumps(doc))
    return 0


# ---------------------------------------------------------------------------
def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # historical form: `python -m repro_torch.obs --trace d` (command omitted)
    if not argv or argv[0] not in COMMANDS and argv[0] not in ("-h",
                                                               "--help"):
        argv.insert(0, "summary")

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Inspect traces, gate health, read post-mortems, "
                    "diff bench runs.",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    def trace_args(p):
        p.add_argument("--trace", required=True,
                       help="trace directory (spans-*.jsonl + "
                            "metrics-*.json)")
        p.add_argument("--limit", type=int, default=5,
                       help="how many slowest spans to show")

    p = sub.add_parser("summary", help="totals + slowest + engines + "
                                       "per-class latency")
    trace_args(p)
    p.add_argument("--json", action="store_true",
                   help="machine-readable summary document")
    p.add_argument("--require-span", action="append", default=[],
                   metavar="NAME[=N]",
                   help="exit 1 unless >= N (default 1) spans named NAME "
                        "are present (CI gate; repeatable)")
    p.add_argument("--require-class-latency", action="store_true",
                   help="exit 1 unless at least one per-class (non-"
                        f"{ALL_CLASSES!r}) latency histogram is present")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("slowest", help="just the slowest spans")
    trace_args(p)
    p.add_argument("--name", default=None,
                   help="filter spans to names containing this substring")
    p.set_defaults(fn=cmd_slowest)

    p = sub.add_parser("prom", help="merged metrics as Prometheus text")
    trace_args(p)
    p.set_defaults(fn=cmd_prom)

    p = sub.add_parser("health", help="gate on a serve's health section")
    p.add_argument("--bench", required=True,
                   help="bench JSON from a --health serve (or a bare "
                        "health report JSON)")
    p.add_argument("--max-state", default="warn", choices=STATES,
                   help="worst state that still exits 0 (default: warn — "
                        "only a page fails the gate)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_health)

    p = sub.add_parser("postmortem", help="list flight-recorder bundles")
    p.add_argument("--dir", required=True,
                   help="post-mortem dir (postmortem-*.json)")
    p.add_argument("--require", type=int, default=0, metavar="N",
                   help="exit 1 unless >= N bundles are present (CI gate)")
    p.add_argument("--last", action="store_true",
                   help="also print the newest bundle in full")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_postmortem)

    p = sub.add_parser("requests", help="per-request lifecycle timelines")
    p.add_argument("--trace", required=True,
                   help="trace directory with req.* lifecycle events")
    p.add_argument("--rid", type=int, default=None,
                   help="narrow to a single request id")
    p.add_argument("--limit", type=int, default=20,
                   help="table rows to print (slowest first)")
    p.add_argument("--require-complete", action="store_true",
                   help="exit 1 on any broken lifecycle chain (CI gate)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_requests)

    p = sub.add_parser("provenance",
                       help="audit the approximation-provenance ledger")
    p.add_argument("--trace", required=True,
                   help="trace directory holding prov-*.jsonl")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_provenance)

    p = sub.add_parser("costs",
                       help="per-request area/energy dividend attribution")
    p.add_argument("--trace", required=True,
                   help="trace directory holding prov-*.jsonl")
    p.add_argument("--require-reconciled", action="store_true",
                   help="exit 1 unless every attributed MAC tiles its "
                        "request exactly and every plan is priced "
                        "(CI gate)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_costs)

    p = sub.add_parser("export",
                       help="export the span trace for external viewers")
    p.add_argument("--trace", required=True,
                   help="trace directory holding spans-*.jsonl")
    p.add_argument("--format", default="chrome", choices=("chrome",),
                   help="output format (chrome = Perfetto-loadable "
                        "trace-event JSON)")
    p.add_argument("--out", default=None,
                   help="output file (default: print to stdout)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("diff", help="bench regression sentinel")
    p.add_argument("--bench", nargs="+", required=True,
                   help="current BENCH_*.json file(s)")
    p.add_argument("--baseline-dir", required=True,
                   help="committed baselines (same filenames)")
    p.add_argument("--tolerances", default=None,
                   help="tolerances.json overriding the default rules "
                        "(default: <baseline-dir>/tolerances.json if "
                        "present)")
    p.add_argument("--history-dir", default=None,
                   help="append each compared run here (CI artifact)")
    p.add_argument("--require-baseline", action="store_true",
                   help="exit 1 when a bench has no committed baseline")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_diff)

    args = ap.parse_args(argv)
    if args.command == "diff" and args.tolerances is None:
        cand = Path(args.baseline_dir) / "tolerances.json"
        args.tolerances = str(cand) if cand.exists() else None
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
