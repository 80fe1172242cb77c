"""PyTorch port of the search side against the JAX package: the circuit IR,
benchmarks, synthesis and miter; the tensor search's fitness, elite order
and harvest; and the tensor engine end to end on the CPU.

Nothing on this path is float beyond integer-valued float32 fitness, so
every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import arith as jarith  # noqa: E402
from repro.core import circuits as jcircuits  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import miter as jmiter  # noqa: E402
from repro.core import synth as jsynth  # noqa: E402
from repro.core import templates as jtemplates  # noqa: E402
from repro.core.tensor_search import _proxy_score as j_proxy_score  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.convert import circuit_from_jax, template_params_from_jax  # noqa: E402
from repro_torch.core import arith, circuits, engine, miter, synth, templates  # noqa: E402
from repro_torch.core import tensor_search as ts  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.library.store import circuit_to_dict  # noqa: E402

BENCHMARKS = jarith.BENCHMARKS


def _jax_dict(c):
    from repro.library.store import circuit_to_dict as j_to_dict

    return j_to_dict(c)


# ---------------------------------------------------------------------------
# (d) circuits / arith / synth / miter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", BENCHMARKS)
def test_benchmarks_match_jax(name):
    jc, tc = jarith.benchmark(name), arith.benchmark(name)
    assert circuit_to_dict(tc) == _jax_dict(jc)
    assert np.array_equal(tc.eval_words(), jc.eval_words())
    assert np.array_equal(tc.eval_words(), jarith.reference_values(name))
    assert arith.parse_benchmark_name(name) == jarith.parse_benchmark_name(name)
    assert synth.area(tc) == jsynth.area(jc)
    assert circuit_to_dict(synth.synthesize(tc)) == _jax_dict(jsynth.synthesize(jc))
    assert circuits.packed_words(tc.n_inputs) == tc.output_tables().shape[1]
    assert np.array_equal(circuits.input_truth_tables(tc.n_inputs),
                          jcircuits.input_truth_tables(jc.n_inputs))


@pytest.mark.parametrize("name,pit", [("adder_i4", 4), ("adder_i6", 6),
                                      ("mul_i4", 6), ("mul_i6", 10),
                                      ("mul_i8", 16)])
def test_random_shared_instantiations_match_jax(name, pit):
    exact = arith.benchmark(name)
    n, m = exact.n_inputs, exact.n_outputs
    ev = exact.eval_words()
    jt = jtemplates.SharedTemplate(n, m, pit=pit)
    tt = templates.SharedTemplate(n, m, pit=pit)
    rng = np.random.default_rng(7)
    for _ in range(6):
        jp = jt.random_params(rng)
        tp = template_params_from_jax(jp)
        assert np.array_equal(tt.eval_outputs(tp), jt.eval_outputs(jp))
        assert tt.proxies(tp) == jt.proxies(jp)
        jc = jt.instantiate(jp, name="x")
        tc = tt.instantiate(tp, name="x")
        assert circuit_to_dict(tc) == _jax_dict(jc)
        js, ts_ = jsynth.synthesize(jc), synth.synthesize(tc)
        assert circuit_to_dict(ts_) == _jax_dict(js)
        assert synth.area(ts_, presynthesized=True) == jsynth.area(js, presynthesized=True)
        assert tuple(miter.measure_error(tc, ev)) == tuple(jmiter.measure_error(jc, ev))
        assert miter.worst_case_error(exact, tc) == jmiter.worst_case_error(
            jarith.benchmark(name), jc)
        assert np.array_equal(
            miter.values_from_tables(tt.eval_outputs(tp), n),
            jmiter.values_from_tables(jt.eval_outputs(jp), n))
        for et in (1, 8, 64):
            assert miter.params_sound(tt, tp, ev, et) == jmiter.params_sound(jt, jp, ev, et)


def test_circuit_carried_from_jax_evaluates_the_same():
    jc = jsynth.synthesize(jarith.benchmark("mul_i6"))
    tc = circuit_from_jax(jc)
    assert np.array_equal(tc.node_tables(), jc.node_tables())
    assert np.array_equal(tc.live_nodes(), jc.live_nodes())
    assert np.array_equal(tc.fanout_counts(), jc.fanout_counts())
    bits = np.random.default_rng(0).random((3, 77)) < 0.5
    assert np.array_equal(circuits.pack_bits(bits), jcircuits.pack_bits(bits))
    assert np.array_equal(circuits.unpack_bits(circuits.pack_bits(bits), 77), bits)


def test_error_stats_value_and_metric_errors():
    stats = miter.ErrorStats(wce=3, mae=1.5, mse=2.25)
    assert stats.value("mae") == 1.5
    with pytest.raises(KeyError):
        stats.value("max")
    assert miter.ERROR_METRICS == jmiter.ERROR_METRICS


# ---------------------------------------------------------------------------
# (b) fitness and elite order
# ---------------------------------------------------------------------------
def _population(rng, name, T, P):
    exact = arith.benchmark(name)
    n, m = exact.n_inputs, exact.n_outputs
    u = rng.random((P, T, n))
    lits = np.where(u < 0.25, 0, np.where(u < 0.5, 1, 2)).astype(np.int32)
    sel = (rng.random((P, m, T)) < 0.3).astype(np.int32)
    lits[P // 2:P // 2 + 8] = lits[0]   # ties and duplicates
    sel[P // 2:P // 2 + 8] = sel[0]
    return exact, lits, sel


def _jax_fitness(exact, lits, sel, et):
    in_tt = jnp.asarray(jcircuits.input_truth_tables(exact.n_inputs))
    ev = jnp.asarray(exact.eval_words().astype(np.int32))

    @jax.jit
    def fitness(lits, sel):
        wce, esum = jref.template_eval(lits, sel, in_tt, ev)
        violation = (jnp.float32(1e6) + 100.0 * wce.astype(jnp.float32)
                     + esum.astype(jnp.float32))
        return jnp.where(wce <= et, j_proxy_score(lits, sel), violation), wce

    return fitness(jnp.asarray(lits), jnp.asarray(sel))


@pytest.mark.parametrize("name,T,P,et", [("adder_i4", 4, 300, 2),
                                         ("mul_i4", 6, 257, 3),
                                         ("mul_i6", 10, 128, 12),
                                         ("mul_i8", 16, 96, 56)])
def test_fitness_and_elite_order_match_jax(name, T, P, et, rng):
    exact, lits, sel = _population(rng, name, T, P)
    jfit, jwce = _jax_fitness(exact, lits, sel, et)
    in_tt = torch.from_numpy(circuits.input_truth_tables(exact.n_inputs))
    ev = torch.from_numpy(exact.eval_words().astype(np.int32))
    tl, tsl = torch.from_numpy(lits), torch.from_numpy(sel)
    assert np.array_equal(ts._proxy_score(tl, tsl).numpy(),
                          np.asarray(j_proxy_score(jnp.asarray(lits), jnp.asarray(sel))))
    wce, esum = ops.template_eval(tl, tsl, in_tt, ev)
    fit = ts._fitness(tl, tsl, wce, esum, et)
    assert fit.dtype == torch.float32
    assert np.array_equal(fit.numpy().view(np.uint32),
                          np.asarray(jfit).view(np.uint32))   # bit for bit
    assert np.array_equal(wce.numpy(), np.asarray(jwce))
    assert float(fit.max()) < 2 ** 24
    order = torch.argsort(fit, stable=True).numpy()
    assert np.array_equal(order, np.asarray(jnp.argsort(jfit)))


# ---------------------------------------------------------------------------
# (c) the harvest of a given population
# ---------------------------------------------------------------------------
def _jax_harvest(exact, lits, sel, fit, et, keep, T):
    """The harvest loop of ``repro.core.tensor_search``, on a given
    population, through ``repro.core.engine.harvest``."""
    tpl = jtemplates.SharedTemplate(exact.n_inputs, exact.n_outputs, pit=T)
    order = np.asarray(jnp.argsort(fit))
    exact_np = exact.eval_words()
    seen, out = set(), []
    for idx in order:
        if len(out) >= keep or float(fit[idx]) >= float(jnp.float32(1e6)):
            break
        p = jtemplates.TemplateParams(np.asarray(lits[idx], dtype=np.int8),
                                      np.asarray(sel[idx]).astype(bool))
        fp = p.lits.tobytes() + p.sel.tobytes()
        if fp in seen:
            continue
        seen.add(fp)
        out.append(jengine.harvest(tpl, p, exact_np, et, engine="tensor",
                                   name=f"{exact.name}_tensor",
                                   meta={"fitness": float(fit[idx])}))
    return out


@pytest.mark.parametrize("name,T,P,et,keep", [("adder_i4", 4, 300, 3, 16),
                                              ("mul_i4", 6, 257, 6, 16),
                                              ("mul_i4", 6, 257, 9, 300)])
def test_harvest_matches_jax_loop(name, T, P, et, keep, rng):
    exact, lits, sel = _population(rng, name, T, P)
    jfit, _ = _jax_fitness(exact, lits, sel, et)
    want = _jax_harvest(jarith.benchmark(name), lits, sel, jfit, et, keep, T)
    assert want, "the population must hold sound candidates"
    tpl = templates.SharedTemplate(exact.n_inputs, exact.n_outputs, pit=T)
    got = ts.harvest_population(
        tpl, torch.from_numpy(lits), torch.from_numpy(sel),
        torch.from_numpy(np.array(jfit)), exact_values=exact.eval_words(),
        et=et, keep=keep, name=f"{exact.name}_tensor", t0=0.0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.area == w.area
        assert g.proxies == w.proxies
        assert g.meta == w.meta
        assert g.params.lits.tobytes() == w.params.lits.tobytes()
        assert g.params.sel.tobytes() == w.params.sel.tobytes()
        assert circuit_to_dict(g.circuit) == _jax_dict(w.circuit)


def test_harvest_raises_on_a_wrong_fitness(rng):
    exact, lits, sel = _population(rng, "mul_i4", 6, 64)
    tpl = templates.SharedTemplate(exact.n_inputs, exact.n_outputs, pit=6)
    fit = torch.zeros(64)   # claims every candidate is sound
    with pytest.raises(engine.UnsoundResultError, match="re-verification"):
        ts.harvest_population(tpl, torch.from_numpy(lits), torch.from_numpy(sel),
                              fit, exact_values=exact.eval_words(), et=1,
                              keep=64, name="x", t0=0.0)


# ---------------------------------------------------------------------------
# (g) the engine end to end on the CPU
# ---------------------------------------------------------------------------
def _summary(outcome):
    return ([(c.area, c.proxies, c.meta, c.params.lits.tobytes(),
              c.params.sel.tobytes(), circuit_to_dict(c.circuit))
             for c in outcome.results], outcome.stats)


def test_tensor_engine_on_cpu_is_sound_and_deterministic():
    job = engine.SearchJob("adder", 2, et=2, engine="tensor", budget_s=600)
    eng = engine.get_engine("tensor", population=1024, generations=30,
                            device="cpu")
    out = eng.run(job)
    exact = job.exact()
    exact_area = synth.area(exact)
    assert out.ok and out.engine == "tensor" and out.benchmark == "adder_i4"
    assert out.stats == {"generations": 30, "evaluations": 30 * 1024}
    assert 0 < len(out.results) <= 16
    for c in out.results:
        assert miter.measure_error(c.circuit, exact.eval_words()).wce <= 2
        assert c.area <= exact_area
        assert c.meta["fitness"] < ts.BIG
    assert out.best.area == min(c.area for c in out.results)
    again = eng.run(job)
    assert _summary(again) == _summary(out)
    other = engine.get_engine("tensor", population=1024, generations=30,
                              device="cpu").run(
        engine.SearchJob("adder", 2, et=2, engine="tensor", seed=1))
    assert _summary(other) != _summary(out)


def test_tensor_search_backends_draw_the_same_numbers():
    exact = arith.benchmark("mul_i4")
    a = ts.tensor_search(exact, 2, population=256, generations=8, keep=4,
                         device="cpu", backend="auto")
    b = ts.tensor_search(exact, 2, population=256, generations=8, keep=4,
                         device="cpu", backend="ref")
    assert _summary(a) == _summary(b)


def test_tensor_search_seeds_and_budget():
    exact = arith.benchmark("adder_i4")
    seed = template_params_from_jax(jtemplates.SharedTemplate(4, 3, pit=4)
                                    .random_params(np.random.default_rng(3)))
    out = ts.tensor_search(exact, 6, pit=4, population=64, generations=0,
                           keep=64, seeds=[seed], device="cpu")
    fps = {c.params.lits.tobytes() + c.params.sel.tobytes() for c in out.results}
    assert seed.lits.tobytes() + seed.sel.tobytes() in fps
    cut = ts.tensor_search(exact, 2, population=64, generations=50,
                           wall_budget_s=0.0, device="cpu")
    assert cut.stats["generations"] == 0


def test_job_keys_and_registry_match_jax():
    for kw in ({}, {"seed": 3, "budget_s": 12.5}, {"error_metric": "mae"}):
        j = jengine.SearchJob("mul", 4, 28, "tensor", **kw)
        t = engine.SearchJob("mul", 4, 28, "tensor", **kw)
        assert t.key() == j.key()
        assert t.describe() == j.describe()
        assert t.benchmark_name == j.benchmark_name
    assert engine.ENGINE_NAMES == jengine.ENGINE_NAMES
    assert engine.available_engines() == ("tensor",)
    for name in ("shared", "xpat", "anneal", "muscat", "mecals"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            engine.get_engine(name)
    with pytest.raises(KeyError):
        engine.get_engine("nope")
    with pytest.raises(ValueError, match="mse"):
        engine.get_engine("tensor", device="cpu").run(
            engine.SearchJob("adder", 2, 2, "tensor", error_metric="mse"))
