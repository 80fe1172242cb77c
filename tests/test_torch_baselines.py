"""PyTorch port of the comparison baselines and the CPU engines against the
JAX package: ``muscat_like``, ``mecals_like`` and ``random_sound``
(``core/baselines``), and the anneal and rewrite engines of the registry
(``core/engine``).

Both sides get the same exact circuit (carried across with
``circuit_from_jax``) and the same seed, with a wall budget that never
binds, so restarts and step counts bound the work and the results do not
depend on the clock.  Every comparison is exact: netlists node for node,
areas, worst-case errors and engine stats.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import arith as jarith  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.library.store import circuit_to_dict as j_to_dict  # noqa: E402
from repro_torch.convert import circuit_from_jax  # noqa: E402
from repro_torch.core import baselines, engine  # noqa: E402
from repro_torch.core.miter import worst_case_error  # noqa: E402
from repro_torch.core.synth import area  # noqa: E402
from repro_torch.library.store import circuit_to_dict  # noqa: E402

NO_CLOCK = 1e9   # a wall budget no run reaches


def _same_circuit(port, ref):
    assert circuit_to_dict(port) == j_to_dict(ref)


@pytest.mark.parametrize("name,et,seed", [
    ("adder_i4", 1, 0), ("adder_i4", 2, 3), ("mul_i4", 1, 0), ("mul_i4", 2, 1),
    ("mul_i4", 4, 0), ("mul_i8", 4, 0), ("mul_i8", 28, 2), ("mul_i8", 56, 0)])
def test_muscat_like_matches_jax(name, et, seed):
    jexact = jarith.benchmark(name)
    want = jbaselines.muscat_like(jexact, et, restarts=2, seed=seed,
                                  wall_budget_s=NO_CLOCK)
    got = baselines.muscat_like(circuit_from_jax(jexact), et, restarts=2,
                                seed=seed, wall_budget_s=NO_CLOCK)
    _same_circuit(got.circuit, want.circuit)
    assert (got.area, got.wce) == (want.area, want.wce)
    assert got.wce <= et
    assert worst_case_error(circuit_from_jax(jexact), got.circuit) == got.wce


@pytest.mark.parametrize("name,et,seed", [
    ("adder_i4", 1, 0), ("mul_i4", 1, 2), ("mul_i4", 2, 0), ("mul_i8", 56, 0)])
def test_mecals_like_matches_jax(name, et, seed):
    jexact = jarith.benchmark(name)
    want = jbaselines.mecals_like(jexact, et, seed=seed, wall_budget_s=NO_CLOCK)
    got = baselines.mecals_like(circuit_from_jax(jexact), et, seed=seed,
                                wall_budget_s=NO_CLOCK)
    _same_circuit(got.circuit, want.circuit)
    assert (got.area, got.wce) == (want.area, want.wce)
    assert got.wce <= et


@pytest.mark.parametrize("name,et,pit", [("adder_i4", 2, None),
                                         ("mul_i4", 4, None), ("mul_i4", 8, 6)])
def test_random_sound_matches_jax(name, et, pit):
    jexact = jarith.benchmark(name)
    kw = dict(count=30, pit=pit, batch=512, max_batches=20, seed=5)
    want = jbaselines.random_sound(jexact, et, **kw)
    got = baselines.random_sound(circuit_from_jax(jexact), et, **kw)
    assert got and got == want


def _outcome_view(out):
    return (out.engine, out.benchmark, out.et, out.stats,
            [(c.area, c.proxies, circuit_to_dict(c.circuit)) for c in out.results])


def _jax_outcome_view(out):
    return (out.engine, out.benchmark, out.et, out.stats,
            [(c.area, c.proxies, j_to_dict(c.circuit)) for c in out.results])


@pytest.mark.parametrize("bits,et,metric,opts", [
    (2, 2, "wce", {"steps": 1500, "restarts": 2, "keep": 3}),
    (2, 4, "wce", {"steps": 800, "restarts": 2, "keep": 8, "pit": 6}),
    # the smoke sweep's mae job (tests/test_precision.py), at fewer steps
    (2, 1, "mae", {"steps": 1500, "restarts": 2}),
    (2, 2, "mse", {"steps": 600, "restarts": 1})])
def test_anneal_engine_matches_jax(bits, et, metric, opts):
    kw = dict(error_metric=metric, budget_s=NO_CLOCK, seed=7)
    want = jengine.get_engine("anneal", **opts).run(
        jengine.SearchJob("mul", bits, et, "anneal", **kw))
    got = engine.get_engine("anneal", **opts).run(
        engine.SearchJob("mul", bits, et, "anneal", **kw))
    assert got.results, "the case should find sound results"
    assert _outcome_view(got) == _jax_outcome_view(want)
    assert [c.params.lits.tobytes() + c.params.sel.tobytes() for c in got.results] == \
           [c.params.lits.tobytes() + c.params.sel.tobytes() for c in want.results]


@pytest.mark.parametrize("name", ["muscat", "mecals"])
@pytest.mark.parametrize("bits,et,metric", [(2, 1, "wce"), (2, 2, "mae"),
                                            (4, 28, "wce")])
def test_rewrite_engines_match_jax(name, bits, et, metric):
    kw = dict(error_metric=metric, budget_s=NO_CLOCK, seed=1)
    want = jengine.get_engine(name).run(jengine.SearchJob("mul", bits, et, name, **kw))
    got = engine.get_engine(name).run(engine.SearchJob("mul", bits, et, name, **kw))
    assert _outcome_view(got) == _jax_outcome_view(want)
    assert len(got.results) == 1 and got.ok


@pytest.mark.parametrize("name", ["muscat", "mecals"])
def test_rewrite_engines_refuse_mse_and_options(name):
    job = dict(error_metric="mse")
    with pytest.raises(ValueError, match="anneal"):
        jengine.get_engine(name).run(jengine.SearchJob("mul", 2, 2, name, **job))
    with pytest.raises(ValueError, match="anneal"):
        engine.get_engine(name).run(engine.SearchJob("mul", 2, 2, name, **job))
    with pytest.raises(TypeError, match="no options"):
        engine.get_engine(name, steps=3)
    with pytest.raises(KeyError, match="unknown error metric"):
        engine.get_engine(name).run(engine.SearchJob("mul", 2, 2, name,
                                                     error_metric="nope"))


def test_baseline_results_are_sound_and_smaller():
    """The system test's fixture on the port: ET 4 on the 4-bit multiplier."""
    exact = circuit_from_jax(jarith.benchmark("mul_i8"))
    res = baselines.muscat_like(exact, et=4, restarts=2, wall_budget_s=NO_CLOCK)
    assert worst_case_error(exact, res.circuit) <= 4
    assert res.area < area(exact)
    assert np.isfinite(res.wall_s) and res.wall_s >= 0
