"""PyTorch port: the serving control plane against the JAX package's.

The QoS controller, plan ladder, library watcher, QoS classes, class
scheduler and online sensitivity estimator are own copies of the
reference's modules; each test feeds the reference and the port the same
inputs (stores filled the same way, observation streams drawn from a
seeded numpy generator) and requires the same decisions.  The end-to-end
scenarios replay ``tests/test_serving.py::test_e2e_adaptive_serve_hot_swaps_without_retrace``
and ``tests/test_sensitivity.py::test_e2e_mixed_class_serve_single_trace``
(without its measured profile) on reduced qwen3-4b in f32 through both
engines: the same swap reasons and plan ids, the same per-batch classes,
plans and tokens, drift within 1e-4 relative, the same trace spans and
events, and one decode step captured (traced) once on each side.
"""

import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.arith import benchmark  # noqa: E402
from repro.core.synth import area  # noqa: E402
from repro.library import OperatorSignature, OperatorStore  # noqa: E402
from repro.library.compile import load_mul_frontier as jax_load_mul_frontier  # noqa: E402
from repro.models import init_model as jax_init  # noqa: E402
from repro.precision.plans import build_mixed_ladder as jax_build_mixed_ladder  # noqa: E402
from repro.precision.plans import choose_mixed_budget, select_width_map  # noqa: E402
from repro.precision.plans import load_mixed_frontier as jax_load_mixed_frontier  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro.obs.metrics import MetricRegistry as JaxRegistry  # noqa: E402
from repro import sensitivity as jax_sens  # noqa: E402
from repro import serving as jax_serving  # noqa: E402
from repro_torch import sensitivity as port_sens  # noqa: E402
from repro_torch import serving as port_serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.library.compile import load_mul_frontier  # noqa: E402
from repro_torch.obs import trace as port_trace  # noqa: E402
from repro_torch.obs.metrics import MetricRegistry as PortRegistry  # noqa: E402
from repro_torch.precision.plans import build_mixed_ladder, load_mixed_frontier  # noqa: E402
from test_serving import fill_library, trunc_mul2, zero_mul2  # noqa: E402
from test_serving import two_op_library  # noqa: E402,F401  (fixture)
from test_sensitivity import mixed_library  # noqa: E402,F401  (fixture)

SIDES = {"ref": (jax_serving, jax_sens, jax_load_mul_frontier),
         "port": (port_serving, port_sens, load_mul_frontier)}


def _both(fn):
    return {name: fn(*mods) for name, mods in SIDES.items()}


def _ladder(serving, load, library, n_layers=2, levels=4):
    compiled, exact_area, _ = load(library)
    return serving.PlanLadder.build(compiled, n_layers, exact_area=exact_area,
                                    levels=levels)


def _ids(ladder):
    return [p.plan_id for p in ladder.plans]


# ---------------------------------------------------------------------------
# controller and ladder
# ---------------------------------------------------------------------------
def test_effective_load_ms_matches_reference():
    rng = np.random.default_rng(0)
    for raw, backlog, cap in zip(rng.uniform(0, 100, 20), rng.integers(0, 9, 20),
                                 rng.integers(0, 5, 20)):
        for occ in (None, 0.0, 0.75):
            kw = dict(backlog=int(backlog), capacity=int(cap), occupancy=occ)
            assert port_serving.effective_load_ms(raw, **kw) == \
                jax_serving.effective_load_ms(raw, **kw)


# (name, config, start level, observation stream): the reference tests'
# scripted streams, and seeded random ones over the band and the budget
def _streams():
    rng = np.random.default_rng(42)
    rand = [(float(ms), float(d) if k else None) for ms, d, k in zip(
        rng.uniform(5, 120, 80), rng.uniform(0, 0.2, 80), rng.integers(0, 2, 80))]
    return [
        ("no-flap", dict(target_ms_per_step=50.0, drift_budget=1.0, patience=2,
                         cooldown=1, ewma_alpha=0.3), 0,
         [(80.0 if i % 2 else 20.0, None) for i in range(40)]
         + [(53.0 if i % 2 else 47.0, None) for i in range(40)]),
        ("walk-up-then-drift", dict(target_ms_per_step=10.0, drift_budget=0.1,
                                    patience=1, cooldown=0, ewma_alpha=1.0), 0,
         [(100.0, 0.0)] * 6 + [(100.0, 10.0)]),
        ("idle", dict(target_ms_per_step=50.0, drift_budget=1.0, patience=2,
                      cooldown=0, ewma_alpha=1.0), -1, [(10.0, None)] * 2),
        ("cooldown", dict(target_ms_per_step=10.0, drift_budget=1.0, patience=1,
                          cooldown=3, ewma_alpha=1.0), 0, [(100.0, None)] * 8),
        ("random", dict(target_ms_per_step=50.0, drift_budget=0.1, patience=2,
                        cooldown=1, ewma_alpha=0.4, shadow_every=3), 0, rand),
    ]


@pytest.mark.parametrize("name,conf,start,stream", _streams(),
                         ids=[s[0] for s in _streams()])
def test_controller_decisions_match_reference(two_op_library, name, conf, start,
                                              stream):
    def run(serving, _, load):
        ladder = _ladder(serving, load, two_op_library, levels=6)
        level = len(ladder) - 1 if start < 0 else start
        ctrl = serving.QoSController(ladder, serving.ControllerConfig(**conf),
                                     level=level)
        trail = [(ctrl.observe(ms, drift), ctrl.level, ctrl.last_reason,
                  ctrl.moves, round(ctrl.ewma_ms, 12), round(ctrl.ewma_drift, 12),
                  ctrl.wants_shadow(i), ctrl.plan.plan_id)
                 for i, (ms, drift) in enumerate(stream)]
        return _ids(ladder), trail

    got = _both(run)
    assert got["port"] == got["ref"]
    _, trail = got["port"]
    if name == "no-flap":
        assert all(t[0] is None for t in trail) and trail[-1][3] == 0
    if name == "walk-up-then-drift":
        assert trail[-1][2] == "drift" and trail[-2][1] == len(got["port"][0]) - 1
    if name == "idle":
        assert trail[-1][2] == "idle"
    if name == "cooldown":
        moved = [i for i, t in enumerate(trail) if t[0] is not None]
        assert all(b - a >= 4 for a, b in zip(moved, moved[1:])), moved


def test_ladder_refresh_and_controller_refresh_match_reference(tmp_path):
    def run(serving, _, load):
        root = tmp_path / serving.__name__
        store = fill_library(root, [benchmark("mul_i4"), trunc_mul2()])
        compiled, exact_area, _ = load(root)
        sparse = serving.PlanLadder.build(compiled[:1], 4, exact_area=exact_area,
                                          levels=6)
        ctrl = serving.QoSController(
            serving.PlanLadder.build(compiled, 4, exact_area=exact_area, levels=4),
            serving.ControllerConfig(), level=3)
        circ = zero_mul2()
        store.put_circuit(circ, OperatorSignature("mul", 2, "wce", 9),
                          area=area(circ), source="test")
        compiled2, exact_area2, _ = load(root)
        dense = sparse.refresh(compiled2, exact_area2)
        ctrl.refresh(compiled[:1], exact_area)     # frontier collapsed to 1 op
        stack = dense.luts(len(dense) - 1)
        return (_ids(sparse), _ids(dense), dense.requested_levels, ctrl.level,
                _ids(ctrl.ladder), stack.tolist())

    got = _both(run)
    assert got["port"] == got["ref"]
    sparse, dense, requested, level, ctrl_ids, _ = got["port"]
    assert len(dense) > len(sparse) and requested == 6
    assert level <= len(ctrl_ids) - 1


# ---------------------------------------------------------------------------
# watcher
# ---------------------------------------------------------------------------
def test_watcher_polls_and_frontier_match_reference(two_op_library):
    def run(serving, *_):
        return serving.LibraryWatcher(two_op_library, min_poll_s=0.0)

    watchers = _both(run)
    assert [w.poll() for w in watchers.values()] == [False, False]
    assert watchers["port"].token == watchers["ref"].token
    circ = zero_mul2()
    OperatorStore(two_op_library).put_circuit(
        circ, OperatorSignature("mul", 2, "wce", 9), area=area(circ), source="fleet")
    assert [w.poll() for w in watchers.values()] == [True, True]
    assert [w.poll() for w in watchers.values()] == [False, False]
    fr = {n: w.load_frontier() for n, w in watchers.items()}
    keys = {n: [r.key for r, _ in f[0]] for n, f in fr.items()}
    assert keys["port"] == keys["ref"] and fr["port"][1:] == fr["ref"][1:]
    assert fr["port"][2] == 2 and any(r.wce == 9 for r, _ in fr["port"][0])
    assert watchers["port"].refreshes == 1


def test_watcher_rate_limit(two_op_library):
    now = [0.0]
    watcher = port_serving.LibraryWatcher(two_op_library, min_poll_s=5.0,
                                          clock=lambda: now[0])
    circ = zero_mul2()
    OperatorStore(two_op_library).put_circuit(
        circ, OperatorSignature("mul", 2, "wce", 9), area=area(circ), source="fleet")
    now[0] = 1.0
    assert not watcher.poll()
    now[0] = 6.0
    assert watcher.poll()


# ---------------------------------------------------------------------------
# QoS classes and online sensitivity
# ---------------------------------------------------------------------------
def test_classbook_and_class_mix_match_reference():
    specs = ["gold:0.02,std:0.05,batch:0.2", "gold:0.02@8ms,batch:0.2",
             "gold:1.0,batch:1e9", "a:0.5@ 3.5ms ,b:1"]

    def run(_, sens, __):
        out = []
        for spec in specs:
            book = sens.ClassBook.parse(spec)
            out.append((book.names, [(c.name, c.drift_budget, c.priority, c.slo_ms)
                                     for c in book], book.route("nosuch"),
                        book.equal_mix(), book.drain_weights()))
        out.append(sens.parse_class_mix("gold:1,batch:3"))
        for bad in ("gold=0.02", "gold:-0.1", "gold:0.1,gold:0.2", "g:0.1@-2ms"):
            with pytest.raises(ValueError):
                sens.ClassBook.parse(bad)
        for bad in ("gold:-1,std:2", "gold:0,std:0", "x"):
            with pytest.raises(ValueError):
                sens.parse_class_mix(bad)
        return out

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"][-1] == (("gold", 0.25), ("batch", 0.75))


def _toy_ladder(preds):
    class P:
        def __init__(self, t):
            self.predicted_total = t

    class Ladder:
        def __init__(self):
            self.plans = [P(t) for t in preds]

        def __len__(self):
            return len(self.plans)
    return Ladder()


def test_class_scheduler_matches_reference():
    rng = np.random.default_rng(8)
    names = rng.choice(["gold", "std", "batch"], size=60).tolist()
    drifts = rng.exponential(0.05, size=60).tolist()
    glevels = rng.integers(0, 4, size=60).tolist()

    def run(_, sens, __):
        reg = (PortRegistry if sens is port_sens else JaxRegistry)()
        book = sens.ClassBook.parse("gold:0.02,std:0.05,batch:0.2")
        s = sens.ClassScheduler(book, _toy_ladder([0.0, 0.01, 0.1, 1.0]),
                                relax_patience=2, shadow_every=2, registry=reg)
        trail = []
        for name, d, g in zip(names, drifts, glevels):
            trail.append((s.wants_shadow(name), s.observe(name, d),
                          s.cap(name), s.level_for(name, g),
                          round(s.measured_drift(name), 12)))
        s.adopt(_toy_ladder([0.0, 0.5]))
        return trail, s.snapshot(2), s.caps, reg.snapshot()

    got = _both(run)
    assert got["port"] == got["ref"]


def test_class_budget_isolation():
    ladder = _toy_ladder([0.0, 0.01, 0.1, 1.0])
    CS, CB = port_sens.ClassScheduler, port_sens.ClassBook
    loose = CS(CB.parse("gold:0.05,batch:2.0"), ladder)
    tight = CS(CB.parse("gold:0.05,batch:0.005"), ladder)
    for g in range(4):
        assert loose.level_for("gold", g) == tight.level_for("gold", g)
    assert tight.cap("batch") < loose.cap("batch")
    before = loose.level_for("gold", 3)
    for _ in range(5):
        loose.observe("batch", 100.0)
    assert loose.level_for("gold", 3) == before and loose.cap("batch") < 3
    batch_cap = tight.cap("batch")
    tight.observe("gold", 1.0)
    assert tight.cap("batch") == batch_cap


def test_online_sensitivity_matches_reference():
    rng = np.random.default_rng(4)
    true = np.array([4.0, 1.0, 0.25])
    plans = [np.array([0.5, 0.0, 0.0]), np.array([0.0, 0.5, 0.0]),
             np.array([0.0, 0.0, 0.5]), np.array([0.5, 0.5, 0.5]),
             np.zeros(3)]
    samples = [(plans[i % 5], float((true * plans[i % 5]).sum())
                * float(rng.uniform(0.9, 1.1))) for i in range(60)]

    def run(_, sens, __):
        est = sens.OnlineSensitivity(3, alpha=0.5)
        trail = []
        for maes, drift in samples:
            est.update(maes, drift)
            trail.append(est.sensitivities().tolist())
        seeded = sens.OnlineSensitivity(3, init=[2.0, 0.5, 1.0])
        seeded.update(np.zeros(3), 123.0)            # all-exact: no signal
        return trail, est.n_updates, seeded.sensitivities().tolist(), seeded.n_updates

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"][1] == 48 and got["port"][3] == 0
    np.testing.assert_allclose(got["port"][0][-1], true, rtol=0.1)

    # seeded from a measured profile: per width, or per layer under a width
    # map (tests/test_sensitivity.py::test_online_ignores_exact_samples_and_seeds_from_profile)
    def seeded(_, sens, __):
        prof = sens.SensitivityProfile(model="m", n_layers=2,
                                       sens={4: np.array([2.0, 0.5]),
                                             8: np.array([1.0, 1.0])})
        est = sens.OnlineSensitivity.from_profile(prof, 4)
        est.update(np.zeros(2), 123.0)          # all-exact: no signal
        mixed = sens.OnlineSensitivity.from_profile(prof, None, width_map=(4, 8),
                                                    alpha=0.5)
        return (est.sensitivities().tolist(), est.n_updates,
                mixed.sensitivities().tolist(), mixed.alpha)

    got = _both(seeded)
    assert got["port"] == got["ref"] == ([2.0, 0.5], 0, [2.0, 1.0], 0.5)


# ---------------------------------------------------------------------------
# end to end: an adaptive serve with controller and watcher hot-swaps
# ---------------------------------------------------------------------------
def _models(bits=4):
    cj = dataclasses.replace(jax_config("qwen3-4b", reduced=True),
                             dtype="float32").with_approx_mlp(bits)
    ct = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                             dtype="float32").with_approx_mlp(bits)
    params = jax_init(cj, jax.random.PRNGKey(0))
    return cj, ct, params, params_from_jax(jax.tree.map(np.asarray, params),
                                           device="cpu")


def _compare_serves(got, n_batches):
    """Same swaps, per-batch plans and tokens on both sides, drift within
    1e-4 relative, one trace/capture each."""
    (tel_j, eng_j, trail_j), (tel_p, eng_p, trail_p) = got["ref"], got["port"]
    assert tel_p.swaps == tel_j.swaps
    assert [e["plan"] for e in tel_p.events] == [e["plan"] for e in tel_j.events]
    assert [e["class"] for e in tel_p.events] == [e["class"] for e in tel_j.events]
    assert len(trail_p) == len(trail_j) == n_batches
    for (tok_p, pid_p), (tok_j, pid_j) in zip(trail_p, trail_j):
        assert pid_p == pid_j and np.array_equal(tok_p, tok_j)
    dj = [e["drift"] for e in tel_j.events]
    dp = [e["drift"] for e in tel_p.events]
    assert [d is None for d in dp] == [d is None for d in dj]
    assert any(d is not None for d in dp)
    for a, b in zip(dp, dj):
        if b is not None:
            assert a == pytest.approx(b, rel=1e-4, abs=1e-9)
    assert eng_p.trace_count == eng_j.trace_count == 1
    assert eng_p.plan.plan_id == eng_j.plan.plan_id


def test_e2e_adaptive_serve_hot_swaps_without_retrace(tmp_path):
    cj, ct, params, pt = _models()
    libs = {}

    def run(serving, _, load):
        side = "port" if serving is port_serving else "ref"
        lib = libs[side] = tmp_path / side
        store = fill_library(lib, [benchmark("mul_i4"), trunc_mul2()])
        compiled, exact_area, _ = load(lib)
        ladder = serving.PlanLadder.build(compiled, ct.n_layers,
                                          exact_area=exact_area, levels=4)
        assert len(ladder) >= 2
        # an unreachable latency target: the controller walks up on any
        # machine; a huge drift budget leaves the walk unobstructed
        ctrl = serving.QoSController(ladder, serving.ControllerConfig(
            target_ms_per_step=1e-6, drift_budget=1e9, patience=1, cooldown=0,
            shadow_every=1, ewma_alpha=1.0))
        watcher = serving.LibraryWatcher(lib, min_poll_s=0.0)
        trail = []

        def on_batch_end(engine, batch_idx):
            trail.append((engine.last_tokens.copy(), engine.plan.plan_id))
            if batch_idx == 2:   # a background sweep lands a cheaper op
                circ = zero_mul2()
                store.put_circuit(circ, OperatorSignature("mul", 2, "wce", 9),
                                  area=area(circ), source="fleet")

        kw = dict(batch=2, prompt_len=4, gen_len=4, plan=ladder.plan(0),
                  compiled=compiled, exact_area=exact_area)
        if side == "port":
            engine = serving.ServingEngine(ct, pt, device="cpu", **kw)
        else:
            engine = serving.ServingEngine(cj, params, **kw)
        tel = engine.serve(serving.steady(6, 2, prompt_len=4, gen_len=4),
                           controller=ctrl, watcher=watcher,
                           telemetry=serving.Telemetry(), on_batch_end=on_batch_end)
        return tel, engine, trail

    traces = {"ref": tmp_path / "trace-ref", "port": tmp_path / "trace-port"}
    for side, trace in (("ref", jax_trace), ("port", port_trace)):
        trace.configure(traces[side], process_tag="e2e")
    try:
        got = _both(run)
    finally:
        jax_trace.reset()
        port_trace.reset()
    _compare_serves(got, 6)
    # the same spans and events, nested the same way, with the same attributes
    shapes = {}
    for side, trace in (("ref", jax_trace), ("port", port_trace)):
        spans = trace.read_trace(traces[side])
        names = {sp["id"]: sp["name"] for sp in spans}
        shapes[side] = [(sp["name"], names.get(sp["parent"]), sorted(sp["attrs"]))
                        for sp in spans]
    assert shapes["port"] == shapes["ref"]
    kinds = {name for name, _, _ in shapes["port"]}
    assert {"serve.batch", "serve.prefill", "serve.decode", "serve.shadow",
            "serve.swap", "serve.control", "serve.refresh"} <= kinds
    assert ("serve.shadow", "serve.decode", []) in shapes["port"]
    tel, engine, _ = got["port"]
    reasons = {s["reason"] for s in tel.swaps}
    assert any(r.startswith("qos-") for r in reasons) and "library" in reasons
    assert tel.swap_count >= 2
    keys_used = {c.key for c in engine.plan.choices}
    new_keys = {r.key for r, _ in engine._compiled if r.wce == 9}
    assert keys_used & new_keys
    s = tel.summary()
    assert s["batches"] == 6 and s["requests"] == 12 and s["plans_used"] >= 2
    assert engine.static_step.replays == 6 * (8 + 1)   # 8 steps + 1 shadow a batch


def test_e2e_mixed_class_serve_single_trace(mixed_library, tmp_path):
    """tests/test_sensitivity.py's class-aware mixed-width serve, replayed
    through both engines on reduced qwen3-4b in f32 without a measured
    profile: the same swaps, per-batch classes, plans and tokens, drift
    within 1e-4 relative, the same online estimate, one capture."""
    cj, ct, params, pt = _models()
    L = ct.n_layers
    libs = {"ref": mixed_library, "port": tmp_path / "port-lib"}
    shutil.copytree(mixed_library, libs["port"])
    jmixed = jax_load_mixed_frontier(libs["ref"])
    sens_vecs = {b: np.array([10.0] + [1.0] * (L - 1)) for b in jmixed.widths}
    budget = choose_mixed_budget(jmixed, sens_vecs, L)
    width_map, _ = select_width_map(jmixed, sens_vecs, budget, L)
    assert set(width_map) == {4, 8}
    sides = {"ref": (jax_serving, jax_sens, jax_load_mixed_frontier, jax_build_mixed_ladder),
             "port": (port_serving, port_sens, load_mixed_frontier, build_mixed_ladder)}
    got, extra = {}, {}
    for side, (serving, sens, load, build) in sides.items():
        lib = libs[side]
        mixed = load(lib)
        ladder = build(mixed, width_map, sens_vecs, levels=4)
        book = sens.ClassBook.parse("gold:1.0,batch:1e9")
        scheduler = sens.ClassScheduler(book, ladder, shadow_every=1)
        ctrl = serving.QoSController(ladder, serving.ControllerConfig(
            target_ms_per_step=1e-6, drift_budget=1e9, patience=1, cooldown=0,
            shadow_every=1, ewma_alpha=1.0))
        online = sens.OnlineSensitivity(L)
        watcher = serving.LibraryWatcher(lib, min_poll_s=0.0, widths=mixed.widths)
        store = OperatorStore(lib)
        trail = []

        def on_batch_end(engine, batch_idx, store=store, trail=trail):
            trail.append((engine.last_tokens.copy(), engine.plan.plan_id))
            if batch_idx == 1:   # a background sweep lands a cheaper op
                circ = zero_mul2()
                store.put_circuit(circ, OperatorSignature("mul", 2, "wce", 9),
                                  area=area(circ), source="fleet")

        kw = dict(batch=2, prompt_len=4, gen_len=4, plan=ladder.plan(0),
                  compiled=mixed.compiled, sensitivities=sens_vecs,
                  width_map=width_map)
        engine = (serving.ServingEngine(ct, pt, device="cpu", **kw) if side == "port"
                  else serving.ServingEngine(cj, params, **kw))
        profile = serving.steady(4, 3, prompt_len=4, gen_len=4,
                                 class_mix=(("gold", 0.5), ("batch", 0.5)))
        tel = engine.serve(profile, controller=ctrl, scheduler=scheduler,
                           watcher=watcher, online=online,
                           telemetry=serving.Telemetry(), on_batch_end=on_batch_end)
        got[side] = (tel, engine, trail)
        extra[side] = (online, scheduler, watcher, len(mixed.compiled))

    _compare_serves(got, len(got["port"][2]))
    np.testing.assert_allclose(extra["port"][0].sensitivities(),
                               extra["ref"][0].sensitivities(), rtol=1e-4)
    tel, engine, _ = got["port"]
    online, scheduler, watcher, n_compiled = extra["port"]
    s = tel.summary()
    classes = s["classes"]
    assert set(classes) == {"gold", "batch"}
    for name, row in classes.items():
        assert row["drift_samples"] >= 1
        assert row["mean_drift"] <= scheduler.book.get(name).drift_budget
    assert classes["gold"]["mean_drift"] <= classes["batch"]["mean_drift"]
    assert any(r.startswith("qos-") for r in s["swaps_by_reason"])
    assert watcher.refreshes >= 1
    assert len(scheduler.ladder.compiled) > n_compiled
    assert online.n_updates >= 1
    assert engine.trace_count == 1
