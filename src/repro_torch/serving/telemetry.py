"""Serving telemetry: a thin view over the observability metric core.

Own copy of ``repro.serving.telemetry``, whole, the continuous engine's
hooks included.

The engine has exactly one recording path: every per-batch measurement
lands in a :class:`repro_torch.obs.metrics.MetricRegistry` (counters for the
whole-run rates, per-class latency/throughput/drift *histograms* — so
``summary()`` can state per-class p50/p95/p99 ms-per-step, which a
mean-only row never could), and the bounded ring of raw per-batch events
is kept alongside for post-mortems — a long-running server never grows
the log without bound, while the registry aggregates stay exact across
ring wrap.  The *plan table* (plan id -> per-layer operator keys) and the
*swap log* are tiny and kept whole.

``summary()`` is the aggregate the bench trajectory ingests
(``BENCH_serve.json``); ``dump()`` writes the full document **atomically**
(parent dirs created, temp-file + ``os.replace``) so a mid-serve crash
never leaves a truncated JSON artifact.  The registry itself can be
snapshotted into a trace dir (``repro_torch.obs.export.dump_metrics``) where the reference's
``python -m repro.obs`` merges it with fleet-side metrics.
"""

from __future__ import annotations

import time
from collections import deque
from pathlib import Path

from ..obs.export import write_bench_json
from ..obs.metrics import LATENCY_MS_BUCKETS, MetricRegistry

__all__ = ["Telemetry", "ALL_CLASSES", "TOK_S_BUCKETS", "DRIFT_BUCKETS",
           "TTFT_MS_BUCKETS", "WAIT_MS_BUCKETS"]

# the label the whole-run aggregate rides under; per-QoS-class rows appear
# next to it as classes are actually served (a single-tier serve stays
# clean: only "_all" exists)
ALL_CLASSES = "_all"

TOK_S_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                 1000.0, 2500.0, 5000.0, 10_000.0, 25_000.0, 100_000.0)
DRIFT_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 0.01, 0.025, 0.05,
                 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# time-to-first-token spans queue wait + prefill, so it runs a couple of
# decades above per-step latency
TTFT_MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0, 2500.0, 5000.0, 10_000.0, 30_000.0, 60_000.0)
# queueing delay and preemption-induced suspension share the TTFT scale
# but need sub-ms resolution: a healthy pool admits in microseconds
WAIT_MS_BUCKETS = (0.01, 0.05, 0.1, 0.5) + TTFT_MS_BUCKETS


class Telemetry:
    def __init__(self, capacity: int = 4096,
                 registry: MetricRegistry | None = None) -> None:
        self.capacity = int(capacity)
        self.events: deque[dict] = deque(maxlen=self.capacity)
        self.plans: dict[str, dict] = {}
        self.swaps: list[dict] = []
        # own registry by default: two engines (or two tests) in one
        # process must not cross-contaminate each other's counters
        self.registry = registry if registry is not None else MetricRegistry()
        self._t0 = time.time()

    # --------------------------------------------------------------- helpers
    def _count(self, name: str, cls: str | None, n: float) -> None:
        self.registry.counter(name, **{"class": ALL_CLASSES}).inc(n)
        if cls is not None:
            self.registry.counter(name, **{"class": cls}).inc(n)

    def _observe(self, name: str, cls: str | None, v: float,
                 buckets) -> None:
        self.registry.histogram(name, buckets=buckets,
                                **{"class": ALL_CLASSES}).observe(v)
        if cls is not None:
            self.registry.histogram(name, buckets=buckets,
                                    **{"class": cls}).observe(v)

    def _counter_value(self, name: str, cls: str = ALL_CLASSES) -> float:
        c = self.registry.find(name, **{"class": cls})
        return c.value if c is not None else 0.0

    def _cost_block(self, cls: str = ALL_CLASSES) -> dict | None:
        macs = self._counter_value("mlp_macs", cls)
        if not macs:
            return None
        lo = self.registry.find("area_mac_saved",
                                **{"class": cls, "layer": ALL_CLASSES})
        hi = self.registry.find("area_mac_saved_hi",
                                **{"class": cls, "layer": ALL_CLASSES})
        return {
            "mlp_macs": int(macs),
            "approx_macs": int(self._counter_value("approx_macs", cls)),
            "area_mac_saved": [
                round(lo.value if lo is not None else 0.0, 4),
                round(hi.value if hi is not None else 0.0, 4)],
        }

    # ------------------------------------------------------------------ write
    def register_plan(self, plan) -> str:
        """Record a :class:`~repro_torch.library.qos.LayerPlan`'s identity once;
        batch events reference the short ``plan_id``."""
        pid = plan.plan_id
        if pid not in self.plans:
            self.plans[pid] = {
                "layers": [c.key or "exact" for c in plan.choices],
                "total_area": plan.total_area,
                "area_saving": plan.area_saving,
                "predicted_drift": plan.predicted_total,
                "budget": plan.budget,
            }
        return pid

    def record_batch(self, *, batch: int, tick: int, n_requests: int,
                     prefill_s: float, decode_s: float, prefill_tokens: int,
                     decode_tokens: int, decode_steps: int,
                     plan_id: str | None, drift: float | None = None,
                     backlog: int = 0, qos_class: str | None = None) -> None:
        self._count("serve_batches_total", qos_class, 1)
        self._count("serve_requests_total", qos_class, n_requests)
        self._count("serve_prefill_s_total", qos_class, prefill_s)
        self._count("serve_decode_s_total", qos_class, decode_s)
        self._count("serve_prefill_tokens_total", qos_class, prefill_tokens)
        self._count("serve_decode_tokens_total", qos_class, decode_tokens)
        self._count("serve_decode_steps_total", qos_class, decode_steps)
        ms_per_step = 1e3 * decode_s / max(1, decode_steps)
        self._observe("serve_ms_per_step", qos_class, ms_per_step,
                      LATENCY_MS_BUCKETS)
        if decode_s > 0:
            self._observe("serve_decode_tok_s", qos_class,
                          decode_tokens / decode_s, TOK_S_BUCKETS)
        if drift is not None:
            self._observe("serve_drift", qos_class, float(drift),
                          DRIFT_BUCKETS)
        self.events.append({
            "batch": batch,
            "tick": tick,
            "n_requests": n_requests,
            "prefill_s": round(prefill_s, 6),
            "decode_s": round(decode_s, 6),
            "prefill_tokens": prefill_tokens,
            "decode_tokens": decode_tokens,
            "prefill_tok_s": round(prefill_tokens / prefill_s, 2)
            if prefill_s > 0 else None,
            "decode_tok_s": round(decode_tokens / decode_s, 2)
            if decode_s > 0 else None,
            "ms_per_step": round(ms_per_step, 3),
            "plan": plan_id,
            "drift": None if drift is None else round(float(drift), 6),
            "backlog": backlog,
            "class": qos_class,
        })

    def record_step(self, *, step: int, tick: int, step_s: float,
                    by_class: dict, decode_tokens: int, prefill_tokens: int,
                    plan_id: str | None = None, drift: float | None = None,
                    backlog: int = 0, occupancy: float = 0.0) -> None:
        """One continuous-batching decode step.  ``by_class`` maps each
        QoS class with active rows to ``{"rows", "decode_tokens",
        "prefill_tokens"}``.  The full step time is attributed to *every*
        active class (it is the latency each one experienced) and to
        decode time in the aggregate — pessimistic for continuous mode,
        since prefill rows ride inside the same step, but that bias runs
        *against* the mode so a measured win is real."""
        step_ms = 1e3 * step_s
        self._count("serve_steps_total", None, 1)
        self._count("serve_decode_steps_total", None, 1)
        self._count("serve_decode_s_total", None, step_s)
        self._count("serve_decode_tokens_total", None, decode_tokens)
        self._count("serve_prefill_tokens_total", None, prefill_tokens)
        self._observe("serve_ms_per_step", None, step_ms, LATENCY_MS_BUCKETS)
        if decode_tokens and step_s > 0:
            self._observe("serve_decode_tok_s", None,
                          decode_tokens / step_s, TOK_S_BUCKETS)
        if drift is not None:
            self._observe("serve_drift", None, float(drift), DRIFT_BUCKETS)
        for cls, row in by_class.items():
            # class-label counters only — the ``_all`` aggregate was
            # counted once above; ``_count`` here would double it
            def inc(name: str, v: float) -> None:
                self.registry.counter(name, **{"class": cls}).inc(v)

            inc("serve_steps_total", 1)
            inc("serve_decode_steps_total", 1)
            inc("serve_decode_s_total", step_s)
            inc("serve_decode_tokens_total", row.get("decode_tokens", 0))
            inc("serve_prefill_tokens_total", row.get("prefill_tokens", 0))
            self.registry.histogram("serve_ms_per_step",
                                    buckets=LATENCY_MS_BUCKETS,
                                    **{"class": cls}).observe(step_ms)
            if drift is not None:
                self.registry.histogram("serve_drift",
                                        buckets=DRIFT_BUCKETS,
                                        **{"class": cls}).observe(float(drift))
        self.registry.gauge("serve_slot_occupancy",
                            **{"class": ALL_CLASSES}).set(occupancy)
        self.events.append({
            "step": step,
            "tick": tick,
            "step_ms": round(step_ms, 3),
            "active": {c: r.get("rows", 0) for c, r in by_class.items()},
            "decode_tokens": decode_tokens,
            "prefill_tokens": prefill_tokens,
            "plan": plan_id,
            "drift": None if drift is None else round(float(drift), 6),
            "backlog": backlog,
            "occupancy": round(occupancy, 3),
        })

    def record_costs(self, qos_class: str | None, tokens: int,
                     row: dict) -> None:
        """Attribute one step's decoded tokens to the live plan's cost
        row (the reference's ``repro.obs.costs.plan_cost_row``, cached per plan by
        the engine).  Exports the paper's dividend as counters:
        ``mlp_macs_total``/``approx_macs_total{class}`` and
        ``area_mac_saved_total{class,layer}`` (the guaranteed lower
        bound; ``area_mac_saved_hi_total`` carries the optimistic end of
        the bracket, see the reference's ``repro.obs.costs``)."""
        if not tokens or row is None:
            return
        self._count("mlp_macs", qos_class, tokens * row["macs"])
        self._count("approx_macs", qos_class, tokens * row["approx_macs"])

        def saved(cls: str) -> None:
            self.registry.counter(
                "area_mac_saved",
                **{"class": cls, "layer": ALL_CLASSES}).inc(
                    tokens * row["saved_lo"])
            self.registry.counter(
                "area_mac_saved_hi",
                **{"class": cls, "layer": ALL_CLASSES}).inc(
                    tokens * row["saved_hi"])
            for layer, v in row["layers"].items():
                self.registry.counter(
                    "area_mac_saved",
                    **{"class": cls, "layer": layer}).inc(tokens * v)

        saved(ALL_CLASSES)
        if qos_class is not None:
            saved(qos_class)

    def record_pages(self, *, used: int, total: int) -> None:
        """Page-pool occupancy gauges (continuous engine, per step) —
        these ride the registry so the Prometheus text and trace-dir
        snapshots carry KV pressure, not just slot occupancy."""
        self.registry.gauge("serve_page_pool_used").set(used)
        self.registry.gauge("serve_page_pool_pages").set(total)
        self.registry.gauge("serve_page_pool_occupancy").set(
            used / total if total else 0.0)

    def record_ttft(self, qos_class: str | None, ttft_s: float) -> None:
        """Time-to-first-token for one request: admission (entering the
        engine's queue) to the step that produced its first generated
        token — queue wait, any preemption-induced suspension, and
        prefill all included.  The SLO users actually feel."""
        self._observe("serve_ttft_ms", qos_class, 1e3 * float(ttft_s),
                      TTFT_MS_BUCKETS)

    def record_request_done(self, qos_class: str | None) -> None:
        """One request fully decoded (the continuous engine's analog of
        ``record_batch``'s per-batch request count)."""
        self._count("serve_requests_total", qos_class, 1)

    def record_preemption(self, *, step: int, victim_rid: int,
                          victim_class: str | None,
                          by_class: str | None) -> None:
        """A running slot was preempted (its request keeps its pages and
        resumes later).  Counted against the *victim's* class."""
        self._count("serve_preemptions_total", victim_class, 1)
        self.events.append({
            "step": step, "preempted_rid": victim_rid,
            "victim_class": victim_class, "by_class": by_class,
        })

    def record_swap(self, *, batch: int, reason: str, old: str | None,
                    new: str | None) -> None:
        self.registry.counter("serve_swaps_total", reason=reason).inc()
        self.swaps.append({"batch": batch, "reason": reason,
                           "from": old, "to": new})

    def record_queue(self, qos_class: str | None, depth: int,
                     wait_s=()) -> None:
        """Queue health at admission time: current depth (gauge) plus
        each drained request's time-in-queue — both the legacy seconds
        histogram and a per-class queueing-delay ms histogram on SLO-
        scale buckets (the Prometheus series request timelines read)."""
        cls = qos_class if qos_class is not None else ALL_CLASSES
        self.registry.gauge("serve_queue_depth",
                            **{"class": cls}).set(depth)
        for w in wait_s:
            self._observe("serve_queue_wait_s", qos_class, float(w), None)
            self._observe("serve_queue_delay_ms", qos_class,
                          1e3 * float(w), WAIT_MS_BUCKETS)

    def record_suspension(self, qos_class: str | None,
                          suspended_s: float) -> None:
        """One preempted request resumed after ``suspended_s`` out of a
        slot — the per-class suspension-time histogram, charged (like
        the preemption counter) to the victim's class."""
        self._count("serve_resumes_total", qos_class, 1)
        self._observe("serve_suspension_ms", qos_class,
                      1e3 * float(suspended_s), WAIT_MS_BUCKETS)

    # ------------------------------------------------------------------- read
    @property
    def n_batches(self) -> int:
        return int(self._counter_value("serve_batches_total"))

    @property
    def n_requests(self) -> int:
        return int(self._counter_value("serve_requests_total"))

    @property
    def swap_count(self) -> int:
        return len(self.swaps)

    @property
    def preemptions(self) -> int:
        return int(self._counter_value("serve_preemptions_total"))

    def _class_names(self) -> list[str]:
        # union of both recording paths: fixed-batch serves label
        # serve_batches_total, continuous serves label serve_ms_per_step
        # per step — a class served either way gets its summary row
        return sorted({labels["class"]
                       for name in ("serve_batches_total",
                                    "serve_ms_per_step")
                       for labels, _ in self.registry.with_name(name)
                       if labels["class"] != ALL_CLASSES})

    def _class_row(self, cls: str) -> dict:
        decode_s = self._counter_value("serve_decode_s_total", cls)
        steps = self._counter_value("serve_decode_steps_total", cls)
        tokens = self._counter_value("serve_decode_tokens_total", cls)
        lat = self.registry.find("serve_ms_per_step", **{"class": cls})
        drift = self.registry.find("serve_drift", **{"class": cls})
        row = {
            "batches": int(self._counter_value("serve_batches_total", cls)),
            "requests": int(self._counter_value("serve_requests_total", cls)),
            "decode_tok_s": round(tokens / decode_s, 2) if decode_s else 0.0,
            "ms_per_step": round(1e3 * decode_s / steps, 3) if steps else 0.0,
            "mean_drift": round(drift.mean, 6)
            if drift is not None and drift.count else None,
            "max_drift": round(drift.max, 6)
            if drift is not None and drift.count else None,
            "drift_samples": drift.count if drift is not None else 0,
        }
        # the SLO-facing numbers a mean can't express: per-class latency
        # percentiles over the run's per-batch ms/step observations
        if lat is not None and lat.count:
            for p, v in lat.percentiles().items():
                row[f"{p}_ms_per_step"] = round(v, 3)
        ttft = self.registry.find("serve_ttft_ms", **{"class": cls})
        if ttft is not None and ttft.count:
            for p, v in ttft.percentiles().items():
                row[f"{p}_ttft_ms"] = round(v, 3)
        pre = self._counter_value("serve_preemptions_total", cls)
        if pre:
            row["preemptions"] = int(pre)
        costs = self._cost_block(cls)
        if costs is not None:
            row["costs"] = costs
        return row

    def summary(self) -> dict:
        """The aggregates the CI bench row wants: throughput, latency
        (mean *and* p50/p95/p99), swap activity.  Rates come from the
        whole-run registry counters, not the ring, so they stay
        consistent with ``batches``/``requests`` even after the ring
        wraps on long serves."""
        reasons: dict[str, int] = {}
        for s in self.swaps:
            reasons[s["reason"]] = reasons.get(s["reason"], 0) + 1
        decode_s = self._counter_value("serve_decode_s_total")
        prefill_s = self._counter_value("serve_prefill_s_total")
        steps = self._counter_value("serve_decode_steps_total")
        lat = self.registry.find("serve_ms_per_step",
                                 **{"class": ALL_CLASSES})
        out = {
            "batches": self.n_batches,
            "requests": self.n_requests,
            "wall_s": round(time.time() - self._t0, 3),
            "decode_tok_s": round(
                self._counter_value("serve_decode_tokens_total") / decode_s,
                2) if decode_s else 0.0,
            "prefill_tok_s": round(
                self._counter_value("serve_prefill_tokens_total") / prefill_s,
                2) if prefill_s else 0.0,
            "ms_per_step": round(1e3 * decode_s / steps, 3) if steps else 0.0,
            "swaps": self.swap_count,
            "swaps_by_reason": reasons,
            "plans_used": len(self.plans),
        }
        if lat is not None and lat.count:
            out["latency_ms_per_step"] = {
                p: round(v, 3) for p, v in lat.percentiles().items()}
        tok = self.registry.find("serve_decode_tok_s",
                                 **{"class": ALL_CLASSES})
        if tok is not None and tok.count:
            # per-observation throughput percentiles: the totals-based
            # decode_tok_s above folds the one-off trace/compile step into
            # the rate; the median does not, so paired engine comparisons
            # read steady-state throughput here
            out["decode_tok_s_pct"] = {
                p: round(v, 2) for p, v in tok.percentiles().items()}
        steps = self._counter_value("serve_steps_total")
        if steps:
            out["steps"] = int(steps)
        if self.preemptions:
            out["preemptions"] = self.preemptions
        ttft = self.registry.find("serve_ttft_ms", **{"class": ALL_CLASSES})
        if ttft is not None and ttft.count:
            out["ttft_ms"] = {
                p: round(v, 3) for p, v in ttft.percentiles().items()}
        costs = self._cost_block()
        if costs is not None:
            out["costs"] = costs
        classes = {cls: self._class_row(cls) for cls in self._class_names()}
        if classes:
            out["classes"] = classes
        return out

    def dump(self, path: str | Path) -> dict:
        """Write the full telemetry document (summary + plan table + swap
        log + ring events) as JSON — atomically, creating parent dirs —
        and return it."""
        doc = {
            "summary": self.summary(),
            "plans": self.plans,
            "swaps": self.swaps,
            "events": list(self.events),
        }
        write_bench_json(Path(path), doc)
        return doc
