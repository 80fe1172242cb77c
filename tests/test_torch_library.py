"""PyTorch port of the operator library against the JAX package: one
on-disk store read and written by both packages, Pareto frontiers,
composition, and the compiled LUTs (tables, areas and ``wce16``) of 2-bit
and 4-bit blocks at targets 4 and 8.  All comparisons are exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import arith as jarith  # noqa: E402
from repro.core import synth as jsynth  # noqa: E402
from repro.core import templates as jtemplates  # noqa: E402
from repro.library import compile as jcompile  # noqa: E402
from repro.library import pareto as jpareto  # noqa: E402
from repro.library import store as jstore  # noqa: E402
from repro.precision import compose as jcompose  # noqa: E402
from repro.quant import lut as jlut  # noqa: E402
from repro_torch.convert import (circuit_from_jax, signature_from_jax,  # noqa: E402
                                 template_params_from_jax)
from repro_torch.core import arith, engine, synth  # noqa: E402
from repro_torch.library import compile as tcompile  # noqa: E402
from repro_torch.library import pareto as tpareto  # noqa: E402
from repro_torch.library import store as tstore  # noqa: E402
from repro_torch.precision import compose as tcompose  # noqa: E402
from repro_torch.quant import lut as tlut  # noqa: E402


def _random_ops(name, pit, count, seed):
    """Random SHARED-template netlists of a benchmark (JAX side), each
    with its params, synthesized netlist and area."""
    exact = jarith.benchmark(name)
    tpl = jtemplates.SharedTemplate(exact.n_inputs, exact.n_outputs, pit=pit)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        p = tpl.random_params(rng)
        c = jsynth.synthesize(tpl.instantiate(p, name=f"{name}_r{i}"))
        out.append((c, p, jsynth.area(c, presynthesized=True), tpl.proxies(p)))
    return out


def _fill(store_mod, root, signature_cls, convert):
    st = store_mod.OperatorStore(root)
    sig = signature_cls("mul", 2, "wce", 15)
    for c, p, a, prox in _random_ops("mul_i4", 6, 5, 0):
        st.put_circuit(convert[0](c), sig, area=a, source="tensor",
                       proxies=prox, params=convert[1](p),
                       meta={"fitness": 12.0})
    sig8 = signature_cls("mul", 4, "wce", 255)
    for c, p, a, prox in _random_ops("mul_i8", 16, 4, 1):
        st.put_circuit(convert[0](c), sig8, area=a, source="tensor",
                       proxies=prox, params=convert[1](p))
    st.put_circuit(convert[0](jarith.benchmark("adder_i4")),
                   signature_cls("adder", 2, "wce", 1), area=9.0)
    return st


def _same_records(a_store, b_store):
    assert [s.dirname for s in a_store.signatures()] == \
        [s.dirname for s in b_store.signatures()]
    assert a_store.version_token() == b_store.version_token()
    for sa, sb in zip(a_store.signatures(), b_store.signatures()):
        ra, rb = a_store.records(sa), b_store.records(sb)
        assert len(ra) == len(rb) > 0
        for x, y in zip(ra, rb):
            assert x.key == y.key == x.content_key() == y.content_key()
            assert (x.area, x.wce, x.mae, x.mse, x.source, x.proxies, x.meta) == \
                (y.area, y.wce, y.mae, y.mse, y.source, y.proxies, y.meta)
            assert x.payload() == y.payload()
    qa = a_store.query("mul", max_threshold=20)
    qb = b_store.query("mul", max_threshold=20)
    assert [r.key for r in qa] == [r.key for r in qb]


def test_store_written_by_jax_reads_in_the_port(tmp_path):
    js = _fill(jstore, tmp_path, jstore.OperatorSignature, (lambda c: c, lambda p: p))
    _same_records(js, tstore.OperatorStore(tmp_path))


def test_store_written_by_the_port_reads_in_jax(tmp_path):
    ts = _fill(tstore, tmp_path, tstore.OperatorSignature,
               (circuit_from_jax, template_params_from_jax))
    _same_records(tstore.OperatorStore(tmp_path), jstore.OperatorStore(tmp_path))
    assert ts.records(tstore.OperatorSignature("mul", 2, "wce", 15))[0].params is not None


def test_both_packages_write_identical_files(tmp_path):
    _fill(jstore, tmp_path / "j", jstore.OperatorSignature, (lambda c: c, lambda p: p))
    _fill(tstore, tmp_path / "t", tstore.OperatorSignature,
          (circuit_from_jax, template_params_from_jax))
    jfiles = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*.json"))
    tfiles = sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*.json"))
    assert jfiles == tfiles and jfiles
    for rel in jfiles:
        assert (tmp_path / "j" / rel).read_bytes() == (tmp_path / "t" / rel).read_bytes()


def test_store_refuses_unsound_and_signatures_match(tmp_path):
    st = tstore.OperatorStore(tmp_path)
    c = arith.benchmark("mul_i4")
    trunc = circuit_from_jax(jsynth.synthesize(
        jtemplates.SharedTemplate(4, 4, pit=2).instantiate(
            jtemplates.TemplateParams(np.full((2, 4), 2, np.int8),
                                      np.zeros((4, 2), bool)))))
    with pytest.raises(ValueError, match="unsound"):
        st.put_circuit(trunc, tstore.OperatorSignature("mul", 2, "wce", 1), area=0.0)
    st.put_circuit(c, tstore.OperatorSignature("mul", 2, "wce", 1), area=synth.area(c))
    (tmp_path / "not_a_signature").mkdir()
    assert [s.dirname for s in st.signatures()] == ["mul2b_wce1"]
    for bad in (("div", 2, "wce", 1), ("mul", 5, "wce", 1), ("mul", 2, "wce", 0.5),
                ("mul", 2, "wce2", 1)):
        with pytest.raises(ValueError):
            tstore.OperatorSignature(*bad)
    js = jstore.OperatorSignature("adder", 3, "mae", 4)
    assert signature_from_jax(js).dirname == js.dirname
    assert tstore.OperatorSignature.from_dirname("adder3b_mae4") == signature_from_jax(js)
    assert engine.SearchJob("mul", 2, 3, "tensor").signature().dirname == "mul2b_wce3"


def test_pareto_matches_jax(tmp_path):
    js = _fill(jstore, tmp_path, jstore.OperatorSignature, (lambda c: c, lambda p: p))
    ts = tstore.OperatorStore(tmp_path)
    jf = jpareto.ParetoFrontier.from_store(js, "mul")
    tf = tpareto.ParetoFrontier.from_store(ts, "mul")
    assert [r.key for r in tf.front] == [r.key for r in jf.front]
    assert tf.cheapest().key == jf.cheapest().key
    assert tf.most_accurate().key == jf.most_accurate().key
    assert [r.key for r in tf.query(max_error=9)] == [r.key for r in jf.query(max_error=9)]
    assert tpareto.frontier_sizes(ts) == jpareto.frontier_sizes(js)
    pts = [(3, 1), (1, 3), (2, 2), (2, 3), (3, 3), (1, 3)]
    objs = (lambda p: p[0], lambda p: p[1])
    assert tpareto.pareto_front(pts, objs) == jpareto.pareto_front(pts, objs)


@pytest.mark.parametrize("kind", ["mul", "adder"])
@pytest.mark.parametrize("block,target", [(1, 4), (2, 4), (3, 4), (4, 4),
                                          (2, 8), (4, 8)])
def test_composition_matches_jax(kind, block, target):
    rng = np.random.default_rng(block * 10 + target)
    side = 1 << block
    top = 1 << (2 * block if kind == "mul" else block + 1)   # output bits
    base = rng.integers(0, top, size=(side, side))
    assert np.array_equal(tcompose.compose_table(base, kind, block, target),
                          jcompose.compose_table(base, kind, block, target))
    assert tcompose.compose_blocks(block, target) == jcompose.compose_blocks(block, target)
    assert tcompose.compose_glue_bits(block, target) == jcompose.compose_glue_bits(block, target)
    if kind == "adder" and block < target:
        assert np.array_equal(tcompose.chain_add(base, block, target),
                              jcompose.chain_add(base, block, target))


def test_composition_identity_failure_raises(monkeypatch):
    monkeypatch.setattr(tcompose, "_VERIFIED", set())
    monkeypatch.setattr(tcompose, "exact_table",
                        lambda kind, bits: np.zeros((1 << bits, 1 << bits), np.int64) + 1)
    with pytest.raises(tcompose.CompositionError):
        tcompose.verify_exactness("mul", 2, 4)


@pytest.mark.parametrize("name,pit,kind,bits", [("mul_i4", 6, "mul", 2),
                                                ("mul_i8", 16, "mul", 4),
                                                ("adder_i4", 4, "adder", 2),
                                                ("adder_i8", 8, "adder", 4)])
@pytest.mark.parametrize("target", [4, 8])
def test_compile_circuit_matches_jax(name, pit, kind, bits, target):
    for c, _, _, _ in _random_ops(name, pit, 2, 3):
        tc = circuit_from_jax(c)
        assert np.array_equal(tlut.build_lut(tc), jlut.build_lut(c))
        want = jcompile.compile_circuit(c, kind, bits, target)
        got = tcompile.compile_circuit(tc, kind, bits, target)
        assert np.array_equal(got.lut, want.lut) and got.lut.dtype == want.lut.dtype
        assert (got.wce16, got.mae16, got.target_bits, got.side) == \
            (want.wce16, want.mae16, want.target_bits, want.side)
        assert (got.tile is None) == (want.tile is None)
        if want.tile is not None:
            assert np.array_equal(got.tile, want.tile)
    assert np.array_equal(tlut.exact_mul_lut(), jlut.exact_mul_lut())


@pytest.mark.parametrize("target", [None, 4, 8])
def test_load_mul_frontier_matches_jax(tmp_path, target):
    _fill(jstore, tmp_path, jstore.OperatorSignature, (lambda c: c, lambda p: p))
    jcompile.clear_compile_cache()
    tcompile.clear_compile_cache()
    want, want_area, want_bits = jcompile.load_mul_frontier(tmp_path, target_bits=target)
    got, got_area, got_bits = tcompile.load_mul_frontier(tmp_path, target_bits=target)
    assert (got_area, got_bits) == (want_area, want_bits)
    assert len(got) == len(want) > 0
    for (tr, tl), (jr, jl) in zip(got, want):
        assert (tr.key, tr.area, tr.wce) == (jr.key, jr.area, jr.wce)
        assert np.array_equal(tl.lut, jl.lut)
        assert (tl.wce16, tl.mae16, tl.area_lo, tl.area_hi, tl.bits, tl.target_bits) == \
            (jl.wce16, jl.mae16, jl.area_lo, jl.area_hi, jl.bits, jl.target_bits)
    # the second compile of each record is a cache hit
    tcompile.load_mul_frontier(tmp_path, target_bits=target)
    assert tcompile.compile_cache_stats()["hits"] >= len(got)


def test_load_mul_frontier_without_multipliers(tmp_path):
    st = tstore.OperatorStore(tmp_path)
    st.put_circuit(arith.benchmark("adder_i4"),
                   tstore.OperatorSignature("adder", 2, "wce", 1), area=1.0)
    with pytest.raises(LookupError, match="no multiplier"):
        tcompile.load_mul_frontier(tmp_path)


def test_search_results_go_through_the_store_to_a_lut(tmp_path):
    """The search path end to end on the CPU: tensor search -> put_circuit
    -> load_mul_frontier -> (16, 16) table, the same tables the JAX
    package compiles from the same library."""
    job = engine.SearchJob("mul", 2, et=2, engine="tensor")
    out = engine.get_engine("tensor", population=512, generations=24,
                            keep=4, device="cpu").run(job)
    assert out.results
    st = tstore.OperatorStore(tmp_path)
    for c in out.results:
        st.put_circuit(c.circuit, job.signature(), area=c.area, source="tensor",
                       proxies=c.proxies, params=c.params, meta=c.meta)
    tcompile.clear_compile_cache()
    jcompile.clear_compile_cache()
    got, exact_area, bits = tcompile.load_mul_frontier(tmp_path)
    want, _, _ = jcompile.load_mul_frontier(tmp_path)
    assert bits == 2 and exact_area == synth.area(arith.benchmark("mul_i4"))
    assert all(lut.lut.shape == (16, 16) and lut.lut.dtype == np.int32 for _, lut in got)
    assert [np.array_equal(a.lut, b.lut) for (_, a), (_, b) in zip(got, want)] == \
        [True] * len(want)
    assert min(r.area for r, _ in got) < exact_area
