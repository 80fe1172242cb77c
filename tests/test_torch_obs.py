"""PyTorch port: the observability copies (``repro_torch.obs`` metrics,
trace and export, and ``repro_torch.serving.telemetry``) against the JAX
package's modules on the same inputs.

Each test drives the reference module and the port's copy with the same
values (drawn from a seeded numpy generator) and requires the same
result: quantiles and bucket counts, snapshots and their merge,
Prometheus text, span traces (ids, nesting, rotated segments, torn
lines), metric snapshots read back across the two, and
``Telemetry.summary()`` and its dump.  Files written by one are read by
the other, since both share the on-disk formats.
"""

import json

import numpy as np
import pytest

from repro.obs import export as ref_export
from repro.obs import metrics as ref_metrics
from repro.obs import trace as ref_trace
from repro.serving import telemetry as ref_telemetry
from repro_torch.obs import export as port_export
from repro_torch.obs import metrics as port_metrics
from repro_torch.obs import trace as port_trace
from repro_torch.serving import telemetry as port_telemetry

SIDES = {"ref": (ref_metrics, ref_trace, ref_export, ref_telemetry),
         "port": (port_metrics, port_trace, port_export, port_telemetry)}


@pytest.fixture(autouse=True)
def _isolate_obs_globals():
    """Every test gets pristine global tracers and registries, both sides."""
    prev = {}
    for name, (metrics, trace, _, _) in SIDES.items():
        trace.reset()
        prev[name] = metrics.set_registry(metrics.MetricRegistry())
    yield
    for name, (metrics, trace, _, _) in SIDES.items():
        trace.reset()
        metrics.set_registry(prev[name])


def _both(fn):
    """``fn(metrics, trace, export, telemetry)`` on each side."""
    return {name: fn(*mods) for name, mods in SIDES.items()}


def _fixed_clock():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    return clock


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_samples", [None, 4], ids=["exact", "wrapped"])
def test_histogram_quantiles_match_reference(max_samples):
    vals = np.random.default_rng(7).uniform(0.01, 12.0, size=500).tolist()

    def run(metrics, *_):
        kw = {} if max_samples is None else {"max_samples": max_samples}
        h = metrics.Histogram(buckets=(0.5, 1.0, 5.0, 10.0), **kw)
        for v in vals:
            h.observe(v)
        qs = [h.quantile(q) for q in (0.0, 0.1, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0)]
        return (h.exact, h.counts, h.count, h.mean, h.min, h.max, qs,
                h.percentiles())

    got = _both(run)
    assert got["port"] == got["ref"]
    exact, _, _, mean, lo, hi, qs, ps = got["port"]
    assert exact is (max_samples is None) and set(ps) == {"p50", "p95", "p99"}
    assert mean == pytest.approx(np.mean(vals))
    if exact:
        want = np.percentile(vals, [0, 10, 25, 50, 90, 95, 99, 100])
        assert qs == pytest.approx(want.tolist(), rel=1e-12)
    else:
        assert all(lo <= q <= hi for q in qs)


def test_histogram_empty_and_bad_quantile():
    h = port_metrics.Histogram(buckets=(1.0,))
    assert h.quantile(0.5) is None and h.mean == 0.0
    with pytest.raises(ValueError):
        h.quantile(1.5)
    with pytest.raises(ValueError):
        port_metrics.Histogram(buckets=())


def test_registry_kind_conflicts_and_find():
    reg = port_metrics.MetricRegistry()
    reg.counter("jobs", engine="anneal").inc(3)
    with pytest.raises(TypeError):
        reg.gauge("jobs", engine="anneal")
    assert reg.find("jobs", engine="anneal").value == 3
    assert reg.find("jobs", engine="tensor") is None
    assert reg.with_name("jobs")[0][0] == {"engine": "anneal"}
    with pytest.raises(ValueError):
        reg.counter("jobs", engine="anneal").inc(-1)


def _fill(metrics, n, depth, vals):
    reg = metrics.MetricRegistry()
    reg.counter("jobs").inc(n)
    reg.gauge("depth").set(depth)
    h = reg.histogram("lat", buckets=(1.0, 10.0))
    for v in vals:
        h.observe(v * n)
    return reg


def test_snapshot_and_merge_match_reference():
    rng = np.random.default_rng(3)
    vals = rng.uniform(0.1, 4.0, size=6).tolist()

    def run(metrics, *_):
        a, b = _fill(metrics, 2, 5, vals), _fill(metrics, 3, 9, vals)
        merged = metrics.MetricRegistry.from_snapshots([a.snapshot(), b.snapshot()])
        c = metrics.MetricRegistry()
        c.histogram("lat", buckets=(2.0, 20.0)).observe(1.0)
        with pytest.raises(ValueError):
            merged.merge(c.snapshot())
        return a.snapshot(), merged.snapshot()

    got = _both(run)
    assert json.dumps(got["port"], sort_keys=True) == \
        json.dumps(got["ref"], sort_keys=True)
    merged = port_metrics.MetricRegistry.from_snapshots([got["port"][1]])
    assert merged.find("jobs").value == 5 and merged.find("depth").value == 9
    assert merged.find("lat").count == 12
    # a snapshot of one side merges into a registry of the other
    cross = ref_metrics.MetricRegistry.from_snapshots([got["port"][0]])
    assert cross.snapshot() == got["ref"][0]


def test_prometheus_text_matches_reference():
    vals = np.random.default_rng(11).uniform(0.0, 10.0, size=9).tolist()

    def run(metrics, _, export, __):
        reg = metrics.MetricRegistry()
        reg.counter("fleet_jobs", engine='an"ne\\al\n').inc(2)
        reg.gauge("depth", **{"class": "gold"}).set(4)
        h = reg.histogram("lat_ms", buckets=(1.0, 5.0), **{"class": "gold"})
        for v in vals:
            h.observe(v)
        return export.prometheus_text(reg)

    got = _both(run)
    assert got["port"] == got["ref"]
    text = got["port"]
    assert "# TYPE fleet_jobs_total counter" in text
    assert 'engine="an\\"ne\\\\al\\n"' in text
    assert 'depth{class="gold"} 4' in text
    assert f'lat_ms_count{{class="gold"}} {len(vals)}' in text


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------
def test_span_nesting_and_ids_match_reference(tmp_path):
    def run(_, trace, *__):
        root = tmp_path / trace.__name__
        tr = trace.Tracer(root, clock=_fixed_clock(), process_tag="w0")
        with tr.span("serve.batch", n_requests=2) as outer:
            with tr.span("serve.prefill", tokens=8):
                pass
            with tr.span("serve.decode", steps=4):
                with tr.span("serve.shadow"):
                    pass
            outer.set(ms_per_step=1.5)
        tr.event("serve.swap", reason="qos-load")
        tr.close()
        return trace.read_trace(root), (root / "spans-w0.jsonl").read_bytes()

    got = _both(run)
    assert got["port"] == got["ref"]       # byte-identical trace files
    spans = got["port"][0]
    by = {s["name"]: s for s in spans}
    assert by["serve.prefill"]["parent"] == by["serve.batch"]["id"]
    assert by["serve.shadow"]["parent"] == by["serve.decode"]["id"]
    assert by["serve.swap"]["parent"] is None
    assert by["serve.batch"]["attrs"] == {"n_requests": 2, "ms_per_step": 1.5}
    assert len({s["id"] for s in spans}) == 5


def test_trace_merge_is_idempotent_and_skips_torn_lines(tmp_path):
    tr = port_trace.Tracer(tmp_path, clock=_fixed_clock(), process_tag="w0")
    for i in range(3):
        tr.event("tick", i=i)
    tr.close()
    spans = port_trace.read_trace(tmp_path)
    assert len(spans) == 3
    src = tmp_path / "spans-w0.jsonl"
    with open(src, "a") as f:
        f.write('{"name": "torn", "id": "zz')
    (tmp_path / "spans-w0-copy.jsonl").write_text(src.read_text())
    assert port_trace.read_trace(tmp_path) == spans
    assert ref_trace.read_trace(tmp_path) == spans


def test_trace_merge_spans_rotated_segments_across_tags(tmp_path):
    def run(_, trace, *__):
        root = tmp_path / trace.__name__
        clock = _fixed_clock()
        writers = {name: trace.Tracer(root, clock=clock, process_tag=name,
                                      max_segment_bytes=256)
                   for name in ("eng-a", "eng-b")}
        for i in range(30):
            writers["eng-a" if i % 2 == 0 else "eng-b"].event(
                "tick", i=i, pad="x" * 32)
        for tr in writers.values():
            tr.close()
        for name in writers:
            assert list(root.glob(f"spans-{name}.*.jsonl")), name
        spans = trace.read_trace(root)
        seg = sorted(root.glob("spans-eng-a.*.jsonl"))[0]
        (root / "spans-eng-a-restored.jsonl").write_text(seg.read_text())
        assert trace.read_trace(root) == spans
        return spans

    got = _both(run)
    assert got["port"] == got["ref"]
    assert [s["attrs"]["i"] for s in got["port"]] == list(range(30))


def test_global_tracer_configure_and_noop(tmp_path):
    import os

    assert not port_trace.tracing_enabled()
    with port_trace.span("x") as sp:
        sp.set(ok=True)
    port_trace.event("y")
    assert list(tmp_path.glob("spans-*.jsonl")) == []
    port_trace.configure(tmp_path, clock=_fixed_clock(), process_tag="t")
    assert os.environ[port_trace.TRACE_DIR_ENV] == str(tmp_path)
    with port_trace.span("job"):
        pass
    assert [s["name"] for s in port_trace.read_trace(tmp_path)] == ["job"]
    port_trace.reset()
    assert os.environ.get(port_trace.TRACE_DIR_ENV) is None


def test_metric_snapshots_roundtrip_across_packages(tmp_path):
    reg = port_metrics.MetricRegistry()
    reg.counter("jobs", engine="anneal").inc(4)
    port_export.dump_metrics(tmp_path, reg, tag="w0")
    reg2 = ref_metrics.MetricRegistry()
    reg2.counter("jobs", engine="anneal").inc(1)
    ref_export.dump_metrics(tmp_path, reg2, tag="w1")
    for export in (port_export, ref_export):
        assert export.read_metrics(tmp_path).find("jobs", engine="anneal").value == 5


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
class _Plan:
    """What ``Telemetry.register_plan`` reads of a LayerPlan."""

    class _Choice:
        def __init__(self, key):
            self.key = key

    def __init__(self, pid, keys):
        self.plan_id = pid
        self.choices = [self._Choice(k) for k in keys]
        self.total_area, self.area_saving = 10.0, 0.25
        self.predicted_total, self.budget = 0.5, 1.0


def _drive(tel, rng):
    """One serve's worth of records: batches over two classes, swaps,
    queue depths and waits, with values from ``rng``."""
    tel.register_plan(_Plan("p0", [None, "k1"]))
    tel.register_plan(_Plan("p1", ["k1", "k2"]))
    for b in range(12):
        cls = ("gold", "batch", None)[b % 3]
        tel.record_batch(batch=b, tick=b // 2, n_requests=int(rng.integers(1, 4)),
                         prefill_s=float(rng.uniform(0.05, 0.2)),
                         decode_s=float(rng.uniform(0.1, 0.9)),
                         prefill_tokens=8, decode_tokens=16, decode_steps=8,
                         plan_id="p0" if b < 6 else "p1",
                         drift=float(rng.uniform(0, 0.1)) if b % 2 else None,
                         backlog=int(rng.integers(0, 5)), qos_class=cls)
        tel.record_queue(cls, int(rng.integers(0, 5)),
                         rng.uniform(0, 0.01, size=2).tolist())
    tel.record_swap(batch=5, reason="qos-load", old="p0", new="p1")
    tel.record_swap(batch=9, reason="library", old="p1", new="p1")


def _without_wall(doc):
    doc = json.loads(json.dumps(doc))
    doc.get("summary", doc).pop("wall_s")
    return doc


def test_telemetry_summary_and_dump_match_reference(tmp_path):
    def run(*mods):
        telemetry = mods[3]
        tel = telemetry.Telemetry(capacity=5)
        _drive(tel, np.random.default_rng(5))
        doc = tel.dump(tmp_path / telemetry.__name__ / "deep" / "tel.json")
        return _without_wall(tel.summary()), _without_wall(doc)

    got = _both(run)
    assert got["port"] == got["ref"]
    s, doc = got["port"]
    assert s["batches"] == 12 and set(s["classes"]) == {"gold", "batch"}
    assert s["swaps_by_reason"] == {"qos-load": 1, "library": 1}
    assert len(doc["events"]) == 5 and s["plans_used"] == 2
    for row in s["classes"].values():
        assert {"p50_ms_per_step", "p95_ms_per_step", "p99_ms_per_step"} <= set(row)


def test_telemetry_ring_bounds_and_summary():
    tel = port_telemetry.Telemetry(capacity=4)
    tel.register_plan(_Plan("p", ["k"]))
    for b in range(10):
        tel.record_batch(batch=b, tick=b, n_requests=2, prefill_s=0.1,
                         decode_s=0.2, prefill_tokens=8, decode_tokens=16,
                         decode_steps=8, plan_id="p")
    tel.record_swap(batch=9, reason="qos-load", old=None, new="p")
    assert len(tel.events) == 4
    s = tel.summary()
    assert s["batches"] == 10 and s["requests"] == 20
    assert s["swaps"] == 1 and s["swaps_by_reason"] == {"qos-load": 1}
    assert s["decode_tok_s"] == pytest.approx(16 / 0.2, rel=1e-3)
    assert s["prefill_tok_s"] == pytest.approx(8 / 0.1, rel=1e-3)
    assert port_telemetry.Telemetry().summary()["batches"] == 0


def test_telemetry_continuous_hooks_match_reference():
    """The continuous engine's hooks, copied with the rest: steps, pages,
    preemptions, time to first token, suspensions."""
    def run(*mods):
        tel = mods[3].Telemetry()
        rng = np.random.default_rng(9)
        for step in range(6):
            tel.record_step(step=step, tick=step, step_s=float(rng.uniform(0.01, 0.1)),
                            by_class={"gold": {"rows": 1, "decode_tokens": 1},
                                      "batch": {"rows": 2, "prefill_tokens": 3}},
                            decode_tokens=3, prefill_tokens=3, plan_id="p",
                            drift=0.01 * step, backlog=step, occupancy=0.5)
            tel.record_pages(used=step, total=8)
            tel.record_ttft("gold", float(rng.uniform(0.01, 0.5)))
            tel.record_request_done("gold")
        tel.record_preemption(step=3, victim_rid=7, victim_class="batch",
                              by_class="gold")
        tel.record_suspension("batch", 0.02)
        return _without_wall(tel.summary()), list(tel.events)

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"][0]["preemptions"] == 1 and got["port"][0]["steps"] == 6
