"""PyTorch port of the QoS read path against the JAX package:
``library/qos`` (plans, ladders, refreshes, stacks, stack validation,
sensitivity probes) and ``precision/plans`` (width selection,
width-compiled frontiers, the mixed-width half).

Replays, on the port, the QoS cases of tests/test_library.py, the
plan-ladder cases of tests/test_serving.py and the W8A8 plan cases of
tests/test_precision.py; each also holds the port's plans (``plan_id``,
per-layer choices, budgets), stacks and ladders equal to the reference's
on the same on-disk library.  Everything here is host numpy, so every
comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import arith as jarith  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import synth as jsynth  # noqa: E402
from repro.library import compile as jcompile  # noqa: E402
from repro.library import qos as jqos  # noqa: E402
from repro.library import store as jstore  # noqa: E402
from repro.precision import plans as jplans  # noqa: E402
from repro.serving import controller as jcontroller  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import circuit_from_jax  # noqa: E402
from repro_torch.core import arith, baselines  # noqa: E402
from repro_torch.core.synth import area  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.library import (OperatorSignature, OperatorStore,  # noqa: E402
                                 ParetoFrontier, compile_record, plan_ladder,
                                 refresh_plan, select_plan, stack_luts,
                                 validate_lut_stack)
from repro_torch.library import compile as tcompile  # noqa: E402
from repro_torch.library import qos  # noqa: E402
from repro_torch.library.store import OperatorRecord  # noqa: E402
from repro_torch.precision import plans  # noqa: E402
from repro_torch.precision.widths import NATIVE_BLOCK_BITS, exact_table  # noqa: E402
from repro_torch.serving.controller import PlanLadder  # noqa: E402
from test_sensitivity import mixed_library  # noqa: E402,F401  (fixture)
from test_serving import fill_library, trunc_mul2, two_op_library  # noqa: E402,F401
from test_serving import zero_mul2  # noqa: E402


def plan_view(p):
    """Everything a plan decides, for an exact comparison."""
    return (p.plan_id, [(c.layer, c.key, c.area, c.predicted_drift)
                        for c in p.choices],
            p.budget, p.predicted_total, p.exact_area)


def same_plans(got, want):
    assert [plan_view(p) for p in got] == [plan_view(p) for p in want]


def same_stacks(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for b in want:
            same_stacks(got[b], want[b])
        return
    assert got.dtype == want.dtype and np.array_equal(got, want)


def frontiers(root, target_bits=None):
    """The port's and the reference's compiled frontier of one store."""
    got = tcompile.load_mul_frontier(root, target_bits)
    want = jcompile.load_mul_frontier(root, target_bits)
    assert [r.key for r, _ in got[0]] == [r.key for r, _ in want[0]]
    assert got[1:] == want[1:]
    return got, want


# ---------------------------------------------------------------------------
# tests/test_library.py: QoS selection
# ---------------------------------------------------------------------------
def _operator_set(port: bool):
    """Three synthetic frontier operators (area descending, error ascending)."""
    store = (OperatorRecord, OperatorSignature, arith.benchmark) if port else \
        (jstore.OperatorRecord, jstore.OperatorSignature, jarith.benchmark)
    Compiled = tcompile.CompiledLut if port else jcompile.CompiledLut
    ops_ = []
    for key, a, mae in (("fine", 8.0, 0.1), ("mid", 5.0, 0.5), ("coarse", 2.0, 2.0)):
        wce = int(mae * 4)
        rec = store[0](signature=store[1]("mul", 2, "wce", max(wce, 1)),
                       circuit=store[2]("mul_i4"), area=a, wce=wce,
                       mae=float(wce) / 4, key=key)
        lut = exact_table("mul", 4).astype(np.int32)
        ops_.append((rec, Compiled(lut, "mul", 2, wce, mae)))
    return ops_


def test_qos_budget_monotonicity():
    ops_, jops = _operator_set(True), _operator_set(False)
    sens = np.array([0.3, 1.0, 0.1, 2.0, 0.5])
    budgets = [0.0, 0.05, 0.2, 0.5, 1.0, 2.0, 5.0, 50.0]
    got = [select_plan(ops_, sens, b, exact_area=10.0) for b in budgets]
    same_plans(got, [jqos.select_plan(jops, sens, b, exact_area=10.0)
                     for b in budgets])
    areas = [p.total_area for p in got]
    assert all(a1 >= a2 - 1e-12 for a1, a2 in zip(areas, areas[1:])), areas
    assert areas[0] == 10.0 * len(sens)
    assert areas[-1] == 2.0 * len(sens)


def test_qos_respects_budget_and_insensitive_layers():
    ops_, jops = _operator_set(True), _operator_set(False)
    sens = np.array([0.0, 1.0])
    plan = select_plan(ops_, sens, 0.0, exact_area=10.0)
    assert plan.choices[0].key == "coarse"
    assert plan.choices[1].key is None
    assert plan.predicted_total <= 0.0 + 1e-12
    plan2 = select_plan(ops_, sens, 0.55, exact_area=10.0)
    assert plan2.predicted_total <= 0.55
    assert plan2.choices[1].key == "mid"
    same_plans([plan, plan2], [jqos.select_plan(jops, sens, b, exact_area=10.0)
                               for b in (0.0, 0.55)])


def test_qos_stack_and_sensitivity_probe():
    ops_, jops = _operator_set(True), _operator_set(False)
    plan = select_plan(ops_, np.zeros(3), 0.0, exact_area=10.0)
    stack = stack_luts(plan, ops_)
    assert stack.shape == (3, 16, 16) and stack.dtype == np.int32
    jplan = jqos.select_plan(jops, np.zeros(3), 0.0, exact_area=10.0)
    same_plans([plan], [jplan])
    same_stacks(stack, jqos.stack_luts(jplan, jops))

    probe, jprobe = ops_[-1][1], jops[-1][1]
    drifts = {0: 0.6, 1: 0.0, 2: 1.2}

    def drift(luts):
        return drifts[next(i for i, l in enumerate(luts) if l is not None)]

    sens = qos.measure_sensitivities(drift, 3, probe)
    np.testing.assert_allclose(sens, [0.6 / probe.mae16, 0.0, 1.2 / probe.mae16])
    assert np.array_equal(sens, jqos.measure_sensitivities(drift, 3, jprobe))
    costs = qos.measure_layer_costs(drift, 3, ops_)
    assert np.array_equal(costs, jqos.measure_layer_costs(drift, 3, jops))
    # a measured (L, O) matrix selects as the reference does; a stale one
    # (wrong operator count) is refused
    same_plans([select_plan(ops_, costs, 1.0, exact_area=10.0)],
               [jqos.select_plan(jops, costs, 1.0, exact_area=10.0)])
    with pytest.raises(ValueError, match="re-priced"):
        select_plan(ops_, costs[:, :2], 1.0, exact_area=10.0)


@pytest.fixture(scope="module")
def mul2_ops():
    """The reference fixture's sound 2-bit multipliers, found by the
    port's ``muscat_like`` (the reference's are identical)."""
    exact = circuit_from_jax(jarith.benchmark("mul_i4"))
    out = {}
    for et in (1, 2, 4):
        res = baselines.muscat_like(exact, et=et, restarts=2, wall_budget_s=1e9)
        want = jbaselines.muscat_like(jarith.benchmark("mul_i4"), et=et,
                                      restarts=2, wall_budget_s=1e9)
        assert res.area == want.area
        out[et] = (res.circuit, res.area)
    return out


def test_library_end_to_end_routes_matmul(tmp_path, mul2_ops):
    store = OperatorStore(tmp_path / "lib")
    for et in (1, 2, 4):
        circ, a = mul2_ops[et]
        store.put_circuit(circ, OperatorSignature("mul", 2, "wce", et), area=a)
    fr = ParetoFrontier.from_store(store, "mul", 2)
    assert len(fr) >= 1
    rec = fr.best_under_error(4)
    comp = compile_record(rec)

    rng = np.random.default_rng(0)
    a_ = rng.integers(0, 16, (8, 16), dtype=np.int64)
    b_ = rng.integers(0, 16, (16, 8), dtype=np.int64)
    got = ops.approx_matmul(torch.from_numpy(a_).int(), torch.from_numpy(b_).int(),
                            torch.from_numpy(comp.lut), backend="ref").numpy()
    want = np.einsum("mkn->mn", comp.lut[a_[:, :, None],
                                         np.broadcast_to(b_[None], (8, 16, 8))])
    np.testing.assert_array_equal(got, want)
    # the same store read by the reference plans identically
    (c, ea, _), (jc, jea, _) = frontiers(tmp_path / "lib")
    same_plans([select_plan(c, np.ones(3), b, exact_area=ea) for b in (0.0, 1e9)],
               [jqos.select_plan(jc, np.ones(3), b, exact_area=jea)
                for b in (0.0, 1e9)])


# ---------------------------------------------------------------------------
# tests/test_serving.py: plan ladder / refresh / validation
# ---------------------------------------------------------------------------
def test_plan_ladder_monotone(two_op_library):
    (compiled, exact_area, _), (jc, jea, _) = frontiers(two_op_library)
    sens = np.ones(3)
    ladder = plan_ladder(compiled, sens, exact_area=exact_area, levels=5)
    same_plans(ladder, jqos.plan_ladder(jc, sens, exact_area=jea, levels=5))
    assert len(ladder) >= 2
    assert all(c.key is None for c in ladder[0].choices)
    areas = [p.total_area for p in ladder]
    drifts = [p.predicted_total for p in ladder]
    assert all(a > b for a, b in zip(areas, areas[1:])), areas
    assert all(a <= b for a, b in zip(drifts, drifts[1:])), drifts
    cheapest = min(rec.area for rec, _ in compiled)
    assert all(c.area == cheapest for c in ladder[-1].choices)
    for p, jp in zip(ladder, jqos.plan_ladder(jc, sens, exact_area=jea, levels=5)):
        same_stacks(stack_luts(p, compiled), jqos.stack_luts(jp, jc))
        assert qos.plan_layer_areas(p) == jqos.plan_layer_areas(jp)


def test_plan_ladder_minimum_levels_reach_full_descent(two_op_library):
    (compiled, exact_area, _), (jc, jea, _) = frontiers(two_op_library)
    cheapest = min(rec.area for rec, _ in compiled)
    for levels in (2, 3):
        ladder = plan_ladder(compiled, np.ones(2), exact_area=exact_area,
                             levels=levels)
        same_plans(ladder, jqos.plan_ladder(jc, np.ones(2), exact_area=jea,
                                            levels=levels))
        assert all(c.key is None for c in ladder[0].choices)
        assert all(c.area == cheapest for c in ladder[-1].choices), levels


def test_refresh_plan_keeps_budget_and_monotonicity(tmp_path):
    root = tmp_path / "lib"
    store = fill_library(root, [jarith.benchmark("mul_i4"), trunc_mul2()])
    (compiled, exact_area, _), (jc, jea, _) = frontiers(root)
    sens = np.ones(4)
    lo = select_plan(compiled, sens, 1.0, exact_area=exact_area)
    hi = select_plan(compiled, sens, 1e9, exact_area=exact_area)

    circ = zero_mul2()
    store.put_circuit(circ, jstore.OperatorSignature("mul", 2, "wce", 9),
                      area=jsynth.area(circ), source="test")
    (compiled2, exact_area2, _), (jc2, jea2, _) = frontiers(root)
    assert len(compiled2) == len(compiled) + 1
    lo2 = refresh_plan(lo, compiled2, sens, exact_area=exact_area2)
    hi2 = refresh_plan(hi, compiled2, sens, exact_area=exact_area2)
    jlo, jhi = (jqos.select_plan(jc, sens, b, exact_area=jea) for b in (1.0, 1e9))
    same_plans([lo2, hi2], [jqos.refresh_plan(p, jc2, sens, exact_area=jea2)
                            for p in (jlo, jhi)])
    assert lo2.budget == lo.budget and hi2.budget == hi.budget
    assert lo2.total_area >= hi2.total_area
    assert hi2.total_area < hi.total_area


def test_validate_lut_stack_rejects_mismatch():
    ok = np.zeros((4, 16, 16), np.int32)
    validate_lut_stack(ok, np.ones((4, 16, 16), np.int32))
    for bad in (np.zeros((5, 16, 16), np.int32), np.zeros((4, 16, 16), np.int64)):
        with pytest.raises(ValueError, match="refusing"):
            validate_lut_stack(ok, bad)
        with pytest.raises(ValueError, match="refusing"):
            jqos.validate_lut_stack(ok, bad)
    # tensors, as the serving engine holds them
    live = torch.zeros((4, 16, 16), dtype=torch.int32)
    validate_lut_stack(live, torch.ones((4, 16, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="refusing"):
        validate_lut_stack(live, torch.zeros((4, 256, 256), dtype=torch.int32))


def test_validate_lut_stack_mixed_groups():
    a = {4: np.zeros((2, 16, 16), np.int32), 8: np.zeros((1, 256, 256), np.int32)}
    b = {4: np.ones((2, 16, 16), np.int32), 8: np.ones((1, 256, 256), np.int32)}
    validate_lut_stack(a, b)
    for new, match in (({4: a[4]}, "width map is frozen"),
                       ({4: a[4], 8: np.zeros((2, 256, 256), np.int32)}, "refusing")):
        with pytest.raises(ValueError, match=match):
            validate_lut_stack(a, new)
        with pytest.raises(ValueError, match=match):
            jqos.validate_lut_stack(a, new)
    with pytest.raises(ValueError, match="width map is frozen"):
        validate_lut_stack(a[4], b)


def test_plan_id_tracks_assignment_not_budget(two_op_library):
    (compiled, exact_area, _), (jc, jea, _) = frontiers(two_op_library)
    sens = np.ones(2)
    got = [select_plan(compiled, sens, b, exact_area=exact_area)
           for b in (0.0, 1e-9, 1e9)]
    a, b, c = got
    assert a.plan_id == b.plan_id
    assert a.plan_id != c.plan_id
    same_plans(got, [jqos.select_plan(jc, sens, b, exact_area=jea)
                     for b in (0.0, 1e-9, 1e9)])


def test_plan_ladder_class_and_build_ladder(two_op_library):
    (compiled, exact_area, _), (jc, jea, _) = frontiers(two_op_library)
    sens = np.array([1.0, 0.5, 2.0])
    got = PlanLadder.build(compiled, 3, exact_area=exact_area,
                           sensitivities=sens, levels=4)
    want = jcontroller.PlanLadder.build(jc, 3, exact_area=jea,
                                        sensitivities=sens, levels=4)
    same_plans(got.plans, want.plans)
    assert len(got) == len(want) and got.requested_levels == want.requested_levels
    for level in range(len(got)):
        same_stacks(got.luts(level), want.luts(level))
        assert got.luts(level) is got.luts(level)   # stacked once
    fr = plans.WidthFrontier.load(two_op_library, 4)
    jfr = jplans.WidthFrontier.load(two_op_library, 4)
    assert (len(fr), fr.exact_area, fr.meta) == (len(jfr), jfr.exact_area, jfr.meta)
    same_plans(fr.ladder(3, sensitivities=sens, levels=4).plans, want.plans)
    same_plans(plans.build_ladder(compiled, 3, exact_area=exact_area).plans,
               jplans.build_ladder(jc, 3, exact_area=jea).plans)
    same_plans([fr.select_plan(sens, 1.0)], [jfr.select_plan(sens, 1.0)])
    refreshed = got.refresh(compiled, exact_area)
    same_plans(refreshed.plans, want.refresh(jc, jea).plans)


# ---------------------------------------------------------------------------
# tests/test_precision.py: width-compiled frontier -> plan -> stack
# ---------------------------------------------------------------------------
def _fill(root, circuits, bits=2):
    store = OperatorStore(root)
    exact_vals = arith.benchmark(f"mul_i{2 * bits}").eval_words().astype(np.int64)
    for circ in circuits:
        wce = int(np.abs(circ.eval_words().astype(np.int64) - exact_vals).max())
        store.put_circuit(circ, OperatorSignature("mul", bits, "wce", max(wce, 1)),
                          area=area(circ))
    return store


def test_w8_plan_stack_and_validation(tmp_path):
    lib = tmp_path / "lib"
    _fill(lib, [arith.benchmark("mul_i4"), circuit_from_jax(trunc_mul2())], bits=2)
    (compiled, exact_area, _), (jc, jea, _) = frontiers(lib, 8)
    plan = select_plan(compiled, np.ones(3), budget=1e12, exact_area=exact_area)
    stack = stack_luts(plan, compiled)
    assert stack.shape == (3, 256, 256) and stack.dtype == np.int32
    jplan = jqos.select_plan(jc, np.ones(3), budget=1e12, exact_area=jea)
    same_plans([plan], [jplan])
    same_stacks(stack, jqos.stack_luts(jplan, jc))
    with pytest.raises(ValueError, match="8-bit"):
        validate_lut_stack(stack, np.zeros((3, 16, 16), np.int32))
    # load_frontier / WidthFrontier at 8 give the same frontier
    fr = plans.WidthFrontier.load(lib, 8)
    assert [r.key for r, _ in fr.compiled] == [r.key for r, _ in compiled]
    assert fr.exact_area == exact_area and fr.meta == {"frontier_bits": 8}


def test_stack_luts_rejects_mixed_width_frontier(tmp_path):
    store = _fill(tmp_path / "lib", [circuit_from_jax(trunc_mul2())])
    rec = store.query("mul", 2)[0]
    mixed = [(rec, compile_record(rec)), (rec, compile_record(rec, target_bits=8))]
    plan = select_plan([(rec, compile_record(rec))], np.ones(2), 1e12,
                       exact_area=10.0)
    with pytest.raises(ValueError, match="single-width"):
        stack_luts(plan, mixed)


def test_select_width_from_model_config():
    for arch in ("qwen3-4b", "stablelm-1.6b"):
        cfg, jcfg = get_config(arch, reduced=True), jax_config(arch, reduced=True)
        assert plans.select_width(cfg).bits == NATIVE_BLOCK_BITS
        assert plans.select_width(cfg, requested=8).bits == 8
        cfg8 = cfg.with_approx_mlp(bits=8)
        assert cfg8.approx_mlp and cfg8.approx_bits == 8
        assert plans.select_width(cfg8).bits == 8
        with pytest.raises(ValueError, match="contradicts"):
            plans.select_width(cfg8, requested=4)
        for c, jc_ in ((cfg, jcfg), (cfg8, jcfg.with_approx_mlp(bits=8)),
                       (cfg.with_approx_mlp(4), jcfg.with_approx_mlp(4))):
            for req in (None, 4, 8):
                try:
                    want = jplans.select_width(jc_, req).bits
                except ValueError:
                    with pytest.raises(ValueError):
                        plans.select_width(c, req)
                    continue
                assert plans.select_width(c, req).bits == want
    assert plans.DEFAULT_WIDTH_BITS == jplans.DEFAULT_WIDTH_BITS


# ---------------------------------------------------------------------------
# the mixed half of precision/plans
# ---------------------------------------------------------------------------
def test_width_keys_and_groups():
    assert plans.width_of_key(None) == jplans.width_of_key(None) == 4
    assert plans.width_of_key("w8:abc") == 8
    with pytest.raises(ValueError, match="width-namespaced"):
        plans.width_of_key("abc")
    wm = (8, 4, 8, 4, 4)
    for b in (4, 8):
        assert plans.group_layers(wm, b) == jplans.group_layers(wm, b)


@pytest.fixture
def mixed_pair(mixed_library):
    mixed = plans.load_mixed_frontier(mixed_library)
    jmixed = jplans.load_mixed_frontier(mixed_library)
    assert [r.key for r, _ in mixed.compiled] == [r.key for r, _ in jmixed.compiled]
    assert np.array_equal(mixed.op_bits, jmixed.op_bits)
    assert mixed.widths == jmixed.widths == (4, 8)
    for b in mixed.widths:
        assert mixed.exact_area(b) == jmixed.exact_area(b)
        for (_, c), (_, jc) in zip(mixed.by_width[b].compiled,
                                   jmixed.by_width[b].compiled):
            assert np.array_equal(c.lut, jc.lut) and c.mae == jc.mae
    return mixed, jmixed


@pytest.mark.parametrize("sens_kind", ["sensitive-first", "uniform", "matrix"])
def test_mixed_width_map_stacks_and_ladder_match_jax(mixed_pair, sens_kind):
    mixed, jmixed = mixed_pair
    L = 4
    if sens_kind == "matrix":
        rng = np.random.default_rng(4)
        sens = {b: rng.uniform(0.1, 3.0, (L, len(mixed.by_width[b].compiled)))
                for b in mixed.widths}
    else:
        first = 10.0 if sens_kind == "sensitive-first" else 1.0
        sens = {b: np.array([first, 1.0, 1.0, 1.0]) for b in mixed.widths}
    costs = plans.mixed_cost_matrix(mixed, sens, L)
    assert np.array_equal(costs, jplans.mixed_cost_matrix(jmixed, sens, L))
    budget = plans.choose_mixed_budget(mixed, sens, L)
    assert budget == jplans.choose_mixed_budget(jmixed, sens, L)
    report, width_map, plan = plans.mixed_comparison(mixed, sens, budget, L)
    jreport, jwm, jplan = jplans.mixed_comparison(jmixed, sens, budget, L)
    assert report == jreport and width_map == jwm
    same_plans([plan], [jplan])
    got_wm, got_plan = plans.select_width_map(mixed, sens, budget, L)
    assert got_wm == width_map and plan_view(got_plan) == plan_view(plan)
    for c in plan.choices:
        assert plans.width_of_key(c.key, mixed.native_bits) == width_map[c.layer]

    stacks = plans.stack_mixed_luts(plan, mixed.compiled, width_map)
    same_stacks(stacks, jplans.stack_mixed_luts(jplan, jmixed.compiled, jwm))
    exact = plans.exact_mixed_stacks(width_map)
    same_stacks(exact, jplans.exact_mixed_stacks(jwm))

    ladder = plans.build_mixed_ladder(mixed, width_map, sens, levels=4)
    jladder = jplans.build_mixed_ladder(jmixed, jwm, sens, levels=4)
    same_plans(ladder.plans, jladder.plans)
    assert np.array_equal(ladder.sensitivities, jladder.sensitivities)
    for level in range(len(ladder)):
        same_stacks(ladder.luts(level), jladder.luts(level))
        for c in ladder.plan(level).choices:
            if c.key is not None:
                assert plans.width_of_key(c.key) == width_map[c.layer]
    same_stacks(ladder.luts(0), exact)
    areas = [p.total_area for p in ladder.plans]
    assert all(a > b for a, b in zip(areas, areas[1:])), areas
    with pytest.raises(AssertionError, match="build_mixed_ladder"):
        ladder.refresh(mixed.compiled, mixed.exact_area(4))


def test_mixed_plan_uses_both_widths_and_beats_uniform(mixed_pair):
    mixed, _ = mixed_pair
    L = 4
    sens = {b: np.array([10.0, 1.0, 1.0, 1.0]) for b in mixed.widths}
    budget = plans.choose_mixed_budget(mixed, sens, L)
    report, width_map, plan = plans.mixed_comparison(mixed, sens, budget, L)
    assert set(width_map) == {4, 8} and width_map[0] == 4
    assert report["mixed_area"] < report["best_uniform_area"]
    assert plan.predicted_total <= budget
    allowed = np.zeros((3, len(mixed.compiled)), dtype=bool)
    allowed[:, 0] = True
    p = select_plan(mixed.compiled, np.ones((3, len(mixed.compiled))), 1e9,
                    exact_area=mixed.exact_area(4), allowed=allowed)
    assert {c.key for c in p.choices} <= {None, mixed.compiled[0][0].key}
    with pytest.raises(ValueError, match="re-price"):
        plans.mixed_cost_matrix(mixed, {b: np.ones((L, 9)) for b in mixed.widths}, L)


def test_stack_mixed_luts_refuses_a_wrong_width(mixed_pair):
    mixed, _ = mixed_pair
    L = 4
    sens = {b: np.array([10.0, 1.0, 1.0, 1.0]) for b in mixed.widths}
    budget = plans.choose_mixed_budget(mixed, sens, L)
    width_map, plan = plans.select_width_map(mixed, sens, budget, L)
    flipped = tuple(4 if b == 8 else 8 for b in width_map)
    with pytest.raises(ValueError, match="mapped to"):
        plans.stack_mixed_luts(plan, mixed.compiled, flipped)
