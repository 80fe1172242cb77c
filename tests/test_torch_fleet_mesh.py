"""PyTorch port: the search fleet's runtime mesh
(``repro_torch.launch.mesh.make_fleet_mesh``), ``tensor_search(mesh=)``,
``TensorEngine(mesh=)`` and the fleet worker's wiring, on CPU shards.

A mesh's devices each evaluate one contiguous shard of the population;
the random draws stay the one generator's, so a run on a mesh of k
shards returns the meshless run's ``SearchOutcome`` at the population
rounded up to a multiple of k, as the reference rounds it
(``src/repro/core/tensor_search.py:76-83``).  The mesh is runtime wiring:
no receipt changes with it.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.arith import benchmark  # noqa: E402
from repro_torch.core.engine import SearchJob, TensorEngine, get_engine  # noqa: E402
from repro_torch.core.tensor_search import tensor_search  # noqa: E402
from repro_torch.fleet import SWEEPS, run_job, run_sweep  # noqa: E402
from repro_torch.fleet.worker import RECEIPT_DIR  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.mesh import FleetMesh, make_fleet_mesh  # noqa: E402
from repro_torch.library import OperatorStore  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

SEARCH = {"population": 250, "generations": 25, "elites": 16, "keep": 4}
TENSOR_JOBS = dataclasses.replace(
    SWEEPS["smoke"], engines=("tensor",), extra_jobs=(),
    engine_opts={"tensor": {"population": 256, "generations": 20, "elites": 16,
                            "keep": 3}})
TIMES = ("wall_s", "engine_s", "commit_s")


@pytest.fixture(autouse=True)
def fresh_obs():
    def reset():
        ttrace.reset(clear_env=True)
        tmetrics.set_registry(tmetrics.MetricRegistry())
    reset()
    yield
    reset()


def _quiet(*_a, **_k):
    pass


def outcome_key(o):
    """Everything a ``SearchOutcome`` says but its times."""
    return ([(c.circuit.name, c.area, c.params.lits.tobytes(), c.params.sel.tobytes(),
              c.proxies, c.meta["fitness"]) for c in o.results],
            o.engine, o.benchmark, o.et, o.stats)


def test_fleet_mesh_puts_the_named_devices_on_one_data_axis():
    m = make_fleet_mesh(["cpu"] * 3)
    assert isinstance(m, FleetMesh)
    assert m.shape == {"data": 3} and m.axis_names == ("data",)
    assert m.devices == (torch.device("cpu"),) * 3


def test_fleet_mesh_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fleet_mesh()
    with pytest.raises(ValueError):
        make_fleet_mesh([])


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_search_on_a_mesh_equals_the_meshless_run_at_the_rounded_population(shards):
    """mul_i4 at ET 2: the outcome on a mesh of 1, 2 or 3 CPU shards is
    the meshless run's at ``population`` rounded up to a multiple of the
    shard count (250, 250, 252), bit for bit: results, areas, fitness and
    ``stats["evaluations"]``."""
    exact = benchmark("mul_i4")
    got = tensor_search(exact, 2, seed=5, mesh=make_fleet_mesh(["cpu"] * shards), **SEARCH)
    rounded = SEARCH["population"] + (-SEARCH["population"]) % shards
    want = tensor_search(exact, 2, seed=5, device="cpu",
                         **{**SEARCH, "population": rounded})
    assert got.results, "no sound result to compare"
    assert outcome_key(got) == outcome_key(want)
    assert got.stats["evaluations"] == SEARCH["generations"] * rounded


@pytest.mark.parametrize("population", [64, 65, 70, 71])
def test_population_rounds_up_as_the_reference_rounds_it(population):
    """``population += (-population) % n_shards`` over a data extent of 4."""
    got = tensor_search(benchmark("adder_i4"), 1, population=population, generations=1,
                        elites=8, keep=1, mesh=make_fleet_mesh(["cpu"] * 4))
    assert got.stats["evaluations"] == -(-population // 4) * 4


def test_each_shard_runs_template_eval_on_its_own_device(monkeypatch):
    """One ``template_eval`` call a shard a generation, each on one
    contiguous slice of the population, and their fitness gathered in
    order."""
    from repro_torch.kernels import ops

    calls = []
    real = ops.template_eval

    def spy(lits, sel, *a, **k):
        calls.append(lits.shape[0])
        return real(lits, sel, *a, **k)

    monkeypatch.setattr(ops, "template_eval", spy)
    tensor_search(benchmark("mul_i4"), 2, population=90, generations=2, elites=8,
                  keep=1, mesh=make_fleet_mesh(["cpu"] * 3))
    assert calls == [30] * 9   # 3 shards x (2 generations + the harvest)


def test_tensor_engine_carries_the_mesh_through_the_registry():
    m = make_fleet_mesh(["cpu"] * 2)
    eng = get_engine("tensor", mesh=m, **SEARCH)
    assert eng.mesh is m and eng.search_kw == SEARCH
    assert TensorEngine().mesh is None
    job = SearchJob("mul", 2, 2, "tensor", seed=1)
    want = get_engine("tensor", device="cpu", **SEARCH).run(job)
    assert outcome_key(eng.run(job)) == outcome_key(want)


def _receipts(root):
    out = {}
    for p in sorted((root / RECEIPT_DIR).glob("*.json")):
        rec = json.loads(p.read_text())
        out[p.name] = {k: v for k, v in rec.items() if k not in TIMES}
    return out


def _records(root):
    store = OperatorStore(root)
    return {s.dirname: sorted(r.key for r in store.records(s))
            for s in store.signatures()}


def test_run_job_on_a_mesh_writes_the_meshless_receipt_and_records(tmp_path):
    job = SearchJob("mul", 2, 2, "tensor", seed=0)
    opts = {"tensor": {"population": 128, "generations": 20, "elites": 16, "keep": 3}}
    a = run_job(job, tmp_path / "a", engine_opts=opts, device="cpu")
    b = run_job(job, tmp_path / "b", engine_opts=opts, mesh=make_fleet_mesh(["cpu"] * 2))
    assert a.status == b.status == "ok" and a.n_results == b.n_results > 0
    assert _receipts(tmp_path / "a") == _receipts(tmp_path / "b")
    assert _records(tmp_path / "a") == _records(tmp_path / "b")


def test_sweep_runs_tensor_jobs_on_a_fleet_mesh_where_cards_are_many(monkeypatch, tmp_path):
    """With more than one card visible and no ``device``, ``run_sweep``
    builds one fleet mesh for its tensor jobs (two CPU shards stand in for
    the cards here); its receipts and records are those of the sweep on
    one device.  With a ``device`` it builds none."""
    built = []

    def fleet_mesh(devices=None):
        assert devices is None
        built.append(make_fleet_mesh(["cpu"] * 2))
        return built[-1]

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(tmesh, "make_fleet_mesh", fleet_mesh)
    on_mesh = run_sweep(TENSOR_JOBS, tmp_path / "mesh", workers=0, log=_quiet)
    assert len(built) == 1
    plain = run_sweep(TENSOR_JOBS, tmp_path / "plain", workers=0, device="cpu", log=_quiet)
    assert len(built) == 1
    assert [r.status for r in on_mesh] == [r.status for r in plain] == ["ok"] * len(plain)
    assert [r.stats for r in on_mesh] == [r.stats for r in plain]
    assert _receipts(tmp_path / "mesh") == _receipts(tmp_path / "plain")
    assert _records(tmp_path / "mesh") == _records(tmp_path / "plain")


def test_sweep_builds_no_mesh_on_one_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(tmesh, "make_fleet_mesh",
                        lambda devices=None: pytest.fail("mesh built on one card"))
    spec = dataclasses.replace(TENSOR_JOBS, benchmarks=("mul",))
    res = run_sweep(spec, tmp_path / "lib", workers=0, device="cpu", log=_quiet)
    assert res and all(r.status == "ok" for r in res)
    assert np.all([r.stats["evaluations"] > 0 for r in res])
