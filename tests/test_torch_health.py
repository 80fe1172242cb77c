"""PyTorch port: the SLO health plane against the JAX package's.

``obs/{anomaly,health,flight}`` are own copies of the reference's
modules.  Each case of ``tests/test_health.py`` that needs no CLI, HTTP
endpoint, Perfetto export or regression sentinel runs here on both sides
with the same synthetic observations, and the two must report the same
states, burn rates, anomalies, attributions and bundles.  Then the port's
engines on the CPU: the fixed engine's ``serve(health=)`` observes every
batch and mirrors the same control events as the reference's, and a
continuous serve with an injected latency spike pages the SLO and pins
the anomaly to the swap before it.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serving as jax_serving  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.arith import benchmark  # noqa: E402
from repro.library.compile import load_mul_frontier as jax_load  # noqa: E402
from repro.models import init_model as jax_init  # noqa: E402
from repro.obs import anomaly as jax_anomaly  # noqa: E402
from repro.obs import flight as jax_flight  # noqa: E402
from repro.obs import health as jax_health  # noqa: E402
from repro.obs.metrics import MetricRegistry as JaxRegistry  # noqa: E402
from repro.sensitivity.classes import ClassBook as JaxBook  # noqa: E402
from repro_torch import serving as port_serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.library.compile import load_mul_frontier  # noqa: E402
from repro_torch.obs import anomaly as port_anomaly  # noqa: E402
from repro_torch.obs import flight as port_flight  # noqa: E402
from repro_torch.obs import health as port_health  # noqa: E402
from repro_torch.obs import trace as port_trace  # noqa: E402
from repro_torch.obs.metrics import MetricRegistry as PortRegistry  # noqa: E402
from repro_torch.sensitivity.classes import ClassBook as PortBook  # noqa: E402
from test_serving import fill_library, trunc_mul2, zero_mul2  # noqa: E402


class _Side:
    def __init__(self, anomaly, health, flight, registry, book):
        self.anomaly, self.health, self.flight = anomaly, health, flight
        self.Registry, self.Book = registry, book


SIDES = {"ref": _Side(jax_anomaly, jax_health, jax_flight, JaxRegistry, JaxBook),
         "port": _Side(port_anomaly, port_health, port_flight, PortRegistry,
                       PortBook)}

# alpha=1.0 turns the EWMA into the raw sample: hand-checkable detector math
DET = dict(window=32, warmup=8, threshold=6.0, alpha=1.0)


def _raises(fn):
    try:
        return ("ok", fn())
    except Exception as e:
        return (type(e).__name__, str(e))


def _docs(anomalies):
    return [None if a is None else a.to_doc() for a in anomalies]


# ---------------------------------------------------------------------------
# detectors, attribution, burn rates, monitors, flight recorder
# ---------------------------------------------------------------------------
def _zscores(s):
    z = s.anomaly.robust_zscores
    return [z([2.0, 4.0, 6.0]), z([1.0, 1.0, 1.0, 1.0, 9.0]), z([]), z([5.0])]


def _detector_shapes(s):
    out = []
    for name, series in (
            ("step", [1.0] * 20 + [5.0] * 40),
            ("spike", [2.0] * 15 + [50.0] + [2.0] * 25),
            ("ramp", [1.0] * 20 + [1.0 + 0.5 * k for k in range(1, 60)]),
            ("down", [100.0] * 15 + [20.0] * 15)):
        det = s.anomaly.RobustDetector(name, **DET)
        fired = [det.observe(v, i) for i, v in enumerate(series)]
        out.append((_docs([f for f in fired if f is not None]), det.fired))
    det = s.anomaly.RobustDetector("ms")
    rng = np.random.default_rng(0)
    noise = [det.observe(float(v), i)
             for i, v in enumerate(5.0 + 0.5 * rng.standard_normal(10_000))]
    out.append((sum(a is not None for a in noise), det.fired))
    for bad in (dict(alpha=0.0), dict(warmup=1), dict(window=4, warmup=8)):
        out.append(_raises(lambda bad=bad: s.anomaly.RobustDetector("x", **bad)))
    return out


def _attribution(s):
    log = s.anomaly.EventLog()
    log.note("serve.swap", 5, "e0")
    log.note("serve.refresh", 18, "e1")
    log.note("serve.control", 40, "e2")
    near = [getattr(log.nearest(k), "event_id", None) for k in (20, 18, 4, 100, 110)]
    small = s.anomaly.EventLog(capacity=2)
    for i in range(5):
        small.note("ev", i)
    out = [near, [e.step for e in small.events()]]
    for late in (("serve.swap", 18, "ev-swap", {"reason": "drill"}),
                 ("serve.resume", 19, "ev-res", {"rid": 7, "cls": "batch"}),
                 None):
        plane = s.anomaly.AnomalyPlane(configs={"ms": DET})
        if late is not None:
            plane.note_event("serve.swap", 2, "ev-old", reason="early")
        for i in range(20):
            if late is not None and i == late[1]:
                plane.note_event(late[0], late[1], late[2], **late[3])
            plane.observe("ms", 1.0, i)
        fired = plane.observe("ms", 9.0, 20)
        out.append((fired.to_doc(), fired.describe(), plane.fired_total,
                    plane.to_doc()))
    return out


def _burn_rates(s):
    br = s.health.BurnRate(budget=0.25, short_window=4, long_window=8,
                           warn_burn=1.0, page_burn=2.0, clear_patience=2,
                           min_count=2)
    seq = [(br.observe(bad), br.burn_short, br.burn_long)
           for bad in (False, True, False, False, False, False)]
    out = [seq, br.observations, br.violations, br.to_doc()]
    blip = s.health.BurnRate(budget=0.25, short_window=2, long_window=20,
                             min_count=1, clear_patience=1)
    out.append([blip.observe(i >= 18) for i in range(20)])
    cold = s.health.BurnRate(budget=0.5, short_window=8, long_window=8, min_count=4)
    out.append([cold.observe(True) for _ in range(4)])
    for bad in (dict(budget=0.0), dict(budget=1.5),
                dict(budget=0.1, short_window=8, long_window=4),
                dict(budget=0.1, warn_burn=2.0, page_burn=1.0)):
        out.append(_raises(lambda bad=bad: s.health.BurnRate(**bad)))
    return out


def _slo_monitor(s):
    mon = s.health.SLOMonitor(s.Book.parse("gold:0.02@8ms,batch:0.2"), min_count=1,
                              short_window=4, long_window=8)
    out = [bool(mon), sorted(mon.latency), sorted(mon.drift),
           mon.latency["gold"].budget, mon.slo_ms, mon.drift_budget,
           mon.observe_latency("gold", 20.0), mon.observe_latency("nope", 20.0),
           mon.observe_drift("batch", 0.5), mon.class_state("gold"), mon.classes,
           mon.to_doc(), bool(s.health.SLOMonitor(None)),
           s.health.state_rank("warn"), s.health.state_penalty("page")]
    return out


def _strip(doc):
    """A bundle or report without its wall-clock fields."""
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items()
                if k != "unix_time"}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _health_plane(s, tmp_path):
    reg = s.Registry()
    pm = tmp_path / "pm"
    hp = s.health.HealthPlane(
        s.Book.parse("gold:1e9@8ms"), registry=reg, postmortem_dir=pm, tag="t",
        monitor_config=dict(short_window=4, long_window=8, min_count=2,
                            clear_patience=1000),
        anomaly_config=dict(configs={"ms_per_step": DET}))
    calm = [hp.observe_step(step=i, step_ms=1.0, classes={"gold": {}})["state"]
            for i in range(20)]
    gauges = [reg.find("serve_slo_ok", **{"class": "gold"}).value]
    hp.note_event("serve.swap", step=19, event_id="ev-1", reason="drill")
    out = hp.observe_step(step=20, step_ms=50.0, classes={"gold": {}}, backlog=3,
                          occupancy=0.5, preemptions=1, plan_id="p0", level=1,
                          pages={"used": 3, "free": 5, "total": 8})
    gauges += [reg.find("serve_slo_ok", **{"class": "gold"}).value,
               reg.find("health_state", **{"class": "gold"}).value,
               reg.find("health_anomalies").value]
    bundles = [(p.name, _strip(doc)) for p, doc in s.flight.read_postmortems(pm)]
    crash = s.health.HealthPlane(None, registry=s.Registry(),
                                 postmortem_dir=tmp_path / "crash", tag="c")
    crash.observe_step(step=0, step_ms=5.0)
    crashed = crash.record_crash(RuntimeError("boom")) is not None
    crash_doc = _strip(s.flight.read_postmortems(tmp_path / "crash")[0][1])
    no_dir = s.health.HealthPlane(None, registry=s.Registry()).record_crash(
        RuntimeError("x"))
    return (calm, out["state"], out["transitions"], _docs(out["anomalies"]),
            len(out["dumps"]), hp.pages, hp.worst_state, hp.penalty, gauges,
            bundles, _strip(hp.report()), crashed, crash_doc, no_dir)


def _flight(s, tmp_path):
    rec = s.flight.FlightRecorder(capacity=4, tag="t")
    for i in range(10):
        rec.note("step", step=i)
    rec.set_context(plan_id="p", level=None)
    out = [[f["step"] for f in rec.frames], rec.context, rec.dump("x")]
    d = tmp_path / "fr"
    rec = s.flight.FlightRecorder(capacity=8, postmortem_dir=d, tag="t",
                                  max_bundles=2)
    rec.note("step", step=0)
    out += [getattr(rec.dump(r), "name", None) for r in ("one", "two", "three")]
    out += [rec.dumps, rec.dumps_suppressed]
    rec2 = s.flight.FlightRecorder(postmortem_dir=d, tag="t", max_bundles=2)
    out.append(rec2.dump("four").name)
    (d / "postmortem-t-9999.json").write_text("{torn")
    out.append([doc["reason"] for _, doc in s.flight.read_postmortems(d)])
    out.append(sorted(p.suffix for p in d.iterdir()))
    return out


CASES = [_zscores, _detector_shapes, _attribution, _burn_rates, _slo_monitor,
         _health_plane, _flight]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[1:] for c in CASES])
def test_health_modules_match_reference(case, tmp_path):
    args = ((tmp_path / "ref",), (tmp_path / "port",)) \
        if case in (_health_plane, _flight) else ((), ())
    ref, port = case(SIDES["ref"], *args[0]), case(SIDES["port"], *args[1])
    assert port == ref
    if case is _detector_shapes:
        assert [[a["step"] for a in docs] for docs, _ in port[:4]] == [[20], [15], [20], [15]]
        assert port[4] == (0, 0)
    if case is _health_plane:
        assert port[1] == "page" and port[4] == 2 and port[7] == 4.0
        assert {doc["reason"] for _, doc in port[9]} == {"slo_breach", "anomaly"}
    if case is _burn_rates:
        assert [st for st, _, _ in port[0]] == ["ok", "page", "page", "warn", "warn", "ok"]


def _long_series(seed: int, n: int = 6000) -> list[float]:
    """Seeded noise around level shifts, spikes, ramps, exact repeats
    (ties in the window) and runs of a constant (a zero MAD)."""
    rng = np.random.default_rng(seed)
    out, level = [], 10.0
    while len(out) < n:
        kind = rng.integers(0, 5)
        m = int(rng.integers(20, 160))
        if kind == 0:
            level *= float(rng.choice([0.3, 2.5, 4.0]))
            seg = level + 0.05 * level * rng.standard_normal(m)
        elif kind == 1:
            seg = level + 0.02 * level * rng.standard_normal(m)
            seg[m // 2] *= 20.0
        elif kind == 2:
            seg = level + level * np.linspace(0.0, 1.5, m)
        elif kind == 3:
            seg = np.round(level + rng.standard_normal(m), 1)
        else:
            seg = np.full(m, level)
        out.extend(float(v) for v in seg)
    return out[:n]


@pytest.mark.parametrize("det", [{}, dict(DET), dict(window=33, warmup=5, alpha=0.5)],
                         ids=["defaults", "alpha1-w32", "odd-window"])
@pytest.mark.parametrize("seed", [0, 1])
def test_detector_bit_equal_to_reference_over_a_long_series(det, seed):
    """The port's detector keeps a sorted copy of its window (and sorts
    the deviations once) where the reference calls ``statistics.median``
    twice.  Over a long series with many fires, every score, every fire
    and every window equal the reference's bit for bit: the median and
    MAD of each scored step, each anomaly's value, z-score and baseline,
    and the window (and its sorted copy) after each observation."""
    series = _long_series(seed)
    ref = jax_anomaly.RobustDetector("s", **det)
    port = port_anomaly.RobustDetector("s", **det)
    scored = 0
    for i, v in enumerate(series):
        if len(ref._baseline) >= ref.warmup and ref._refractory == 0:
            assert port._score(v) == ref._score(v)
            scored += 1
        a, b = ref.observe(v, i), port.observe(v, i)
        assert (a is None) == (b is None), i
        if a is not None:
            assert (b.value, b.zscore, b.baseline, b.direction, b.step) == \
                (a.value, a.zscore, a.baseline, a.direction, a.step)
        assert list(port._baseline) == list(ref._baseline)
        assert port._sorted == sorted(ref._baseline)
        assert port._ewma == ref._ewma
    assert port.fired == ref.fired >= 10
    assert scored > len(series) // 2


def test_health_plane_overhead_is_negligible():
    """At most 2% of a 10 ms decode step, as the reference's budget.  The
    cost is the best of five runs of 2000 steps, each on a fresh plane:
    a run slowed by other processes on the host says nothing of the
    plane's own cost."""
    n, runs = 2000, []
    for _ in range(5):
        hp = port_health.HealthPlane(PortBook.parse("gold:0.02@8ms,batch:0.2"),
                                     registry=PortRegistry())
        t0 = time.perf_counter()
        for i in range(n):
            hp.observe_step(step=i, step_ms=10.0 + 0.1 * (i % 7),
                            classes={"gold": {}, "batch": {}}, drift=0.01,
                            backlog=i % 3, occupancy=0.5, preemptions=0,
                            plan_id="p", level=1)
        runs.append(1e3 * (time.perf_counter() - t0) / n)
    per_call_ms = min(runs)
    assert per_call_ms < 0.2, f"health plane costs {per_call_ms:.3f} ms/step"


def test_router_sheds_load_from_degraded_replica():
    class _Eng:
        def __init__(self, load):
            self.load_score = load

    class _H:
        def __init__(self, state):
            self.state = state

        @property
        def penalty(self):
            return port_health.state_penalty(self.state)

    degraded = port_serving.Replica("degraded", _Eng(0.0), health=_H("page"))
    healthy = port_serving.Replica("healthy", _Eng(0.0))
    router = port_serving.ReplicaRouter([degraded, healthy])
    tok = np.arange(4, dtype=np.int32)
    homes = [router.route(port_serving.Request(i, tok)).name for i in range(16)]
    assert set(homes) == {"healthy"}
    assert degraded.routing_score == pytest.approx(4.0)
    healthy.engine.load_score = 10.0
    assert router.route(port_serving.Request(99, tok)).name == "degraded"
    degraded.health.state = "warn"
    assert degraded.routing_score == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# the engines with a health plane
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    root = tmp_path_factory.mktemp("healthlib")
    fill_library(root / "lib", [benchmark("mul_i4"), trunc_mul2(), zero_mul2()])
    return root / "lib"


def _models():
    cj = dataclasses.replace(jax_config("qwen3-4b", reduced=True),
                             dtype="float32").with_approx_mlp()
    ct = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                             dtype="float32").with_approx_mlp()
    params = jax_init(cj, jax.random.PRNGKey(0))
    return cj, ct, params, params_from_jax(jax.tree.map(np.asarray, params),
                                           device="cpu")


class _Recorder:
    """A health plane stand-in that records what the engine hands it."""

    def __init__(self):
        self.observed, self.noted = [], []

    def observe_step(self, **kw):
        self.observed.append((kw["step"], kw.get("plan_id"), kw.get("level"),
                              kw.get("backlog"), sorted(kw.get("classes") or {})))
        return {"state": "ok"}

    def note_event(self, name, **kw):
        self.noted.append((name, kw.get("step"),
                           {k: v for k, v in kw.items() if k not in ("event_id", "step")}))

    def record_crash(self, e):
        pass


def test_fixed_serve_with_health_matches_reference(lib):
    """The fixed engine's serve(health=) runs (it raised before): one
    observation a batch and a note for every swap and control move, the
    same as the reference's."""
    cj, ct, params, pt = _models()
    got = {}
    for side, serving, load in (("ref", jax_serving, jax_load),
                                ("port", port_serving, load_mul_frontier)):
        compiled, exact_area, _ = load(lib)
        ladder = serving.PlanLadder.build(compiled, ct.n_layers,
                                          exact_area=exact_area, levels=4)
        ctrl = serving.QoSController(ladder, serving.ControllerConfig(
            target_ms_per_step=1e-6, drift_budget=1e9, patience=1, cooldown=0,
            shadow_every=1, ewma_alpha=1.0))
        kw = dict(batch=2, prompt_len=4, gen_len=4, plan=ladder.plan(0),
                  compiled=compiled, exact_area=exact_area)
        eng = (serving.ServingEngine(ct, pt, device="cpu", **kw) if side == "port"
               else serving.ServingEngine(cj, params, **kw))
        rec = _Recorder()
        tel = eng.serve(serving.steady(4, 2, prompt_len=4, gen_len=4),
                        controller=ctrl, telemetry=serving.Telemetry(), health=rec)
        got[side] = (rec.observed, rec.noted, tel.swaps, eng.trace_count)
    assert got["port"] == got["ref"]
    observed, noted, swaps, traces = got["port"]
    assert len(observed) == 4 and traces == 1
    assert {n for n, _, _ in noted} == {"serve.control", "serve.swap"}
    assert sum(n == "serve.swap" for n, _, _ in noted) == len(swaps) >= 1


def test_fixed_serve_feeds_a_real_health_plane(lib, tmp_path):
    _, ct, _, pt = _models()
    eng = port_serving.ServingEngine(ct, pt, batch=2, prompt_len=4, gen_len=4,
                                     device="cpu")
    hp = port_health.HealthPlane(None, registry=PortRegistry(),
                                 postmortem_dir=tmp_path, tag="fixed")
    eng.serve(port_serving.steady(3, 2, prompt_len=4, gen_len=4), health=hp)
    steps = [f for f in hp.recorder.frames if f["kind"] == "step"]
    assert [f["step"] for f in steps] == [0, 1, 2]
    assert hp.report()["state"] == "ok" and eng.trace_count == 1


def test_e2e_drill_spike_pages_and_attributes_to_swap(lib, tmp_path):
    """A two-class continuous serve on the CPU with a latency spike
    injected through ``inject_step_delay`` pages the SLO, pins the anomaly
    to the exact swap event before it, and leaves post-mortem bundles,
    with the step built once."""
    _, ct, _, pt = _models()
    compiled, exact_area, _ = load_mul_frontier(lib)
    ladder = port_serving.PlanLadder.build(compiled, ct.n_layers,
                                           exact_area=exact_area, levels=4)
    trace_dir, pm_dir = tmp_path / "trace", tmp_path / "pm"
    port_trace.configure(trace_dir, process_tag="drill")
    from repro_torch.sensitivity.classes import ClassScheduler

    book = PortBook.parse("gold:1e9@50ms,batch:1e9@50ms")
    hp = port_health.HealthPlane(
        book, postmortem_dir=pm_dir, tag="drill",
        monitor_config=dict(short_window=6, long_window=12, min_count=3,
                            clear_patience=10_000),
        # alpha 1.0 scores the raw step; a 5 ms floor on the MAD scale sits
        # above the eager CPU step's jitter (a few ms on a 3-5 ms step, which
        # would otherwise fire and hold the detector refractory) and far
        # below the +1000 ms spike
        anomaly_config=dict(configs={
            "ms_per_step": dict(window=32, warmup=8, threshold=12.0, alpha=1.0,
                                min_scale=5.0)}))
    prof = port_serving.make_profile("steady", ticks=3, per_tick=2, prompt_len=8,
                                     gen_len=6,
                                     class_mix=(("gold", 0.5), ("batch", 0.5)))
    eng = port_serving.ContinuousServingEngine(
        ct, pt, max_slots=2, prompt_len=8, gen_len=6, page_size=4,
        plan=ladder.plan(0), compiled=compiled, exact_area=exact_area, device="cpu")
    inject_at = 14

    def chaos(e, step):
        if step == inject_at:
            e.swap_plan(ladder.plan(1), ladder.luts(1), reason="drill",
                        telemetry=e.telemetry, batch_idx=step)
            e.inject_step_delay = 1.0
        elif step == inject_at + 4:
            e.inject_step_delay = 0.0

    # one intra-op thread: the reduced model's tensors are tiny, and threads
    # that wait on cores the suite's other workers hold stall a step by
    # tens of ms, which fires the detector before the drill and holds it
    # refractory through the spike
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tel = eng.serve(prof, scheduler=ClassScheduler(book, ladder, shadow_every=4),
                        telemetry=port_serving.Telemetry(), seed=0, steps_per_tick=5,
                        health=hp, on_step_end=chaos)
    finally:
        torch.set_num_threads(threads)
        port_trace.reset(clear_env=True)
    assert eng.trace_count == 1 and len(eng.completions) == prof.total_requests
    assert eng._alloc.used_pages == 0
    assert tel.summary()["steps"] > inject_at + 3
    assert hp.worst_state == "page" and hp.pages >= 1
    assert sum(m.violations for m in hp.slo.latency.values()) >= 3
    spikes = [a for a in hp.anomaly.anomalies
              if a.signal == "ms_per_step" and a.step > inject_at]
    assert spikes, "induced latency spike never detected"
    cause = spikes[0].cause
    assert cause is not None and cause.name == "serve.swap"
    assert cause.attrs.get("reason") == "drill"
    swaps = [s for s in port_trace.read_trace(trace_dir)
             if s["name"] == "serve.swap" and s["attrs"].get("reason") == "drill"]
    assert len(swaps) == 1 and cause.event_id == swaps[0]["id"]
    bundles = port_flight.read_postmortems(pm_dir)
    assert "slo_breach" in {doc["reason"] for _, doc in bundles}
    assert {"step", "event"} <= {f["kind"] for f in bundles[-1][1]["frames"]}


def test_e2e_router_sheds_admissions_from_paged_replica(lib):
    _, ct, _, pt = _models()
    compiled, exact_area, _ = load_mul_frontier(lib)
    ladder = port_serving.PlanLadder.build(compiled, ct.n_layers,
                                           exact_area=exact_area, levels=4)

    def mk():
        return port_serving.ContinuousServingEngine(
            ct, pt, max_slots=2, prompt_len=8, gen_len=6, page_size=4,
            plan=ladder.plan(0), compiled=compiled, exact_area=exact_area,
            device="cpu")

    degraded_hp = port_health.HealthPlane(
        None, registry=PortRegistry(),
        monitor_config=dict(short_window=4, long_window=8, min_count=1,
                            clear_patience=10 ** 9))
    degraded_hp.slo.add_latency_slo("gold", 1.0, budget=0.05)
    for i in range(8):
        degraded_hp.observe_step(step=i, step_ms=999.0, classes={"gold": {}})
    assert degraded_hp.worst_state == "page"
    router = port_serving.ReplicaRouter([
        port_serving.Replica("degraded", mk(), health=degraded_hp),
        port_serving.Replica("healthy", mk(),
                             health=port_health.HealthPlane(None, registry=PortRegistry())),
    ])
    prof = port_serving.make_profile("steady", ticks=3, per_tick=4, prompt_len=8,
                                     gen_len=6)
    out = router.serve(prof, seed=0)
    assert out["requests"] == prof.total_requests
    assert router.routed["healthy"] > router.routed["degraded"], router.routed
    assert out["replicas"]["degraded"]["health"]["state"] == "page"
    assert all(r.engine.trace_count == 1 for r in router.replicas)
