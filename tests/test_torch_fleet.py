"""PyTorch port: the fleet (``repro_torch.fleet``), the instrumented engine
registry and the search CLI (``repro_torch.core.search``) against the JAX
package's.

The first eleven tests replay ``tests/test_fleet.py`` on the port; the
rest hold the port against the reference: the same plans, seeds and
receipt paths, the same records from the CPU engines (which are host
numpy in both packages, so bit for bit), the same CLI report with times
masked, the same metrics from an instrumented run, and the search CLI's
printed lines and stored records.  The tensor engine runs on the CPU
here (``device="cpu"``); its searches use torch's random numbers, so its
netlists are held for soundness and determinism, not against the
reference's.
"""

import dataclasses
import json
import multiprocessing
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as jengine  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.fleet import __main__ as jfleet_cli  # noqa: E402
from repro.fleet import plan as jplan  # noqa: E402
from repro.fleet import worker as jworker  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch.core.arith import benchmark  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    Candidate,
    InstrumentedEngine,
    SearchJob,
    SearchOutcome,
    UnsoundResultError,
    available_engines,
    get_engine,
    harvest,
    verify_circuit,
)
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core.miter import measure_error  # noqa: E402
from repro_torch.core.templates import SharedTemplate, TemplateParams  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    SWEEPS,
    SweepSpec,
    load_spec,
    plan_jobs,
    run_job,
    run_sweep,
)
from repro_torch.fleet import __main__ as tfleet_cli  # noqa: E402
from repro_torch.fleet import worker as tworker  # noqa: E402
from repro_torch.fleet.worker import RECEIPT_DIR  # noqa: E402
from repro_torch.library import (  # noqa: E402
    OperatorSignature,
    OperatorStore,
    frontier_sizes,
)
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.obs.trace import read_trace  # noqa: E402

SPEC = SweepSpec(
    name="test",
    benchmarks=("adder", "mul"),
    bits=(2,),
    ets=(2,),
    engines=("anneal",),
    budget_s=30.0,
    engine_opts={"anneal": {"steps": 3000, "restarts": 2, "keep": 3}},
)

# the CPU engines of both packages on one small grid: the same records
CPU_SPEC = {"name": "cpu-engines", "benchmarks": ["adder", "mul"], "bits": [2],
            "ets": [1, 2], "engines": ["anneal", "muscat", "mecals"],
            "budget_s": 30.0,
            "engine_opts": {"anneal": {"steps": 1500, "restarts": 2, "keep": 3}}}

# the smoke sweep's tensor jobs
TENSOR_SMOKE = dataclasses.replace(SWEEPS["smoke"], engines=("tensor",),
                                   extra_jobs=())


@pytest.fixture(autouse=True)
def fresh_obs():
    """Both packages' tracer and metric registry are process-global:
    each test starts and ends with none and an empty one."""
    def reset():
        for tr, mt in ((jtrace, jmetrics), (ttrace, tmetrics)):
            tr.reset(clear_env=True)
            mt.set_registry(mt.MetricRegistry())
    reset()
    yield
    reset()


def _quiet(*_a, **_k):
    pass


# ---------------------------------------------------------------------------
# tests/test_fleet.py, replayed on the port
# ---------------------------------------------------------------------------
def test_plan_expansion_is_deterministic_and_seed_stable():
    jobs1 = plan_jobs(SPEC)
    jobs2 = plan_jobs(SPEC)
    assert jobs1 == jobs2
    assert len(jobs1) == 2  # 2 benchmarks x 1 bits x 1 et x 1 engine
    assert [j.benchmark for j in jobs1] == ["adder", "mul"]
    wider = dataclasses.replace(SPEC, ets=(1, 2))
    by_fields = {(j.benchmark, j.bits, j.et, j.engine): j.seed
                 for j in plan_jobs(wider)}
    for j in jobs1:
        assert by_fields[(j.benchmark, j.bits, j.et, j.engine)] == j.seed
    reseeded = plan_jobs(dataclasses.replace(SPEC, seed=1))
    assert [(j.benchmark, j.et) for j in reseeded] == [(j.benchmark, j.et) for j in jobs1]
    assert all(a.seed != b.seed for a, b in zip(reseeded, jobs1))


def test_plan_et_fracs_scale_with_operator_range():
    spec = SweepSpec(name="t", benchmarks=("mul",), bits=(2,),
                     et_fracs=(0.25,), engines=("anneal",))
    (job,) = plan_jobs(spec)
    assert job.et == round(0.25 * 9)
    (job_a,) = plan_jobs(dataclasses.replace(spec, benchmarks=("adder",)))
    assert job_a.et == round(0.25 * 6)


def test_load_spec_rejects_unknown_engine_and_missing_grid():
    with pytest.raises(ValueError, match="unknown engine"):
        SweepSpec(name="t", benchmarks=("mul",), bits=(2,), ets=(1,),
                  engines=("no-such-engine",))
    with pytest.raises(ValueError, match="neither ets nor et_fracs"):
        SweepSpec(name="t", benchmarks=("mul",), bits=(2,),
                  engines=("anneal",))
    assert load_spec("smoke").name == "smoke"
    assert load_spec("smoke", budget_s=1.0).budget_s == 1.0
    with pytest.raises(FileNotFoundError):
        load_spec("no-such-sweep")


def test_job_key_is_stable_and_field_sensitive():
    j = SearchJob(benchmark="mul", bits=2, et=1, engine="anneal")
    assert j.key() == SearchJob(benchmark="mul", bits=2, et=1,
                                engine="anneal").key()
    assert j.key() != dataclasses.replace(j, et=2).key()
    assert j.signature() == OperatorSignature("mul", 2, "wce", 1)
    assert j.benchmark_name == "mul_i4"


def test_anneal_engine_emits_verified_candidates():
    job = SearchJob(benchmark="adder", bits=2, et=2, engine="anneal",
                    budget_s=20.0, seed=1)
    out = get_engine("anneal", steps=3000, restarts=2).run(job)
    assert isinstance(out, SearchOutcome) and out.engine == "anneal"
    assert out.results, "annealer found nothing at the easy ET"
    exact = benchmark("adder_i4").eval_words().astype(np.int64)
    for cand in out.results:
        assert isinstance(cand, Candidate)
        got = cand.circuit.eval_words().astype(np.int64)
        assert np.abs(got - exact).max() <= 2
    assert out.best.area == min(c.area for c in out.results)


def test_harvest_raises_descriptive_error_on_unsound_params():
    exact = benchmark("adder_i4")
    tpl = SharedTemplate(exact.n_inputs, exact.n_outputs, pit=2)
    params = TemplateParams(
        np.full((2, exact.n_inputs), 2, dtype=np.int8),
        np.ones((exact.n_outputs, 2), dtype=bool),
    )
    with pytest.raises(UnsoundResultError, match="wce .* > ET 0"):
        harvest(tpl, params, exact.eval_words(), 0, engine="test")
    with pytest.raises(UnsoundResultError, match="re-verification"):
        verify_circuit(tpl.instantiate(params), exact.eval_words(), 0)


def test_available_engines_always_include_solver_free_ones():
    names = available_engines()
    for engine in ("tensor", "anneal", "muscat", "mecals"):
        assert engine in names


def _put_worker(args):
    root, n_inputs, nodes, outputs, name, area_ = args
    from repro_torch.core.circuits import Circuit, Gate, Op

    c = Circuit(n_inputs=n_inputs, name=name)
    c.nodes = [Gate(Op(op), tuple(a)) for op, a in nodes]
    c.outputs = list(outputs)
    store = OperatorStore(root)
    rec = store.put_circuit(c, OperatorSignature("mul", 2, "wce", 2),
                            area=area_, source="muscat")
    return rec.key


def test_concurrent_puts_of_same_netlist_are_idempotent(tmp_path):
    """Two workers committing the same netlist into one store must land
    exactly one record, never torn JSON."""
    from repro_torch.core.baselines import muscat_like

    res = muscat_like(benchmark("mul_i4"), et=2, restarts=1, wall_budget_s=5)
    payload = (str(tmp_path / "lib"), res.circuit.n_inputs,
               [[g.op.value, list(g.args)] for g in res.circuit.nodes],
               list(res.circuit.outputs), res.circuit.name, res.area)
    # spawn, not fork: this process has jax (multithreaded) loaded
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(2) as pool:
        keys = pool.map(_put_worker, [payload] * 4)
    assert len(set(keys)) == 1
    store = OperatorStore(tmp_path / "lib")
    assert len(store) == 1
    (rec,) = store.records(OperatorSignature("mul", 2, "wce", 2))
    assert rec.key == keys[0] and rec.wce <= 2
    assert not list((tmp_path / "lib").rglob("*.tmp"))


def test_smoke_sweep_densifies_frontier_and_resumes_as_noop(tmp_path):
    lib = tmp_path / "lib"
    results = run_sweep(SPEC, lib, workers=0, log=_quiet)
    assert all(r.status == "ok" for r in results)
    store = OperatorStore(lib)
    sizes = frontier_sizes(store)
    assert len(sizes) >= 2, sizes
    assert all(front >= 1 for _, front in sizes.values())
    n_records = len(store)
    assert n_records > 0
    receipts = list((lib / RECEIPT_DIR).glob("*.json"))
    assert len(receipts) == len(results)
    assert all(json.loads(p.read_text())["status"] == "ok" for p in receipts)
    again = run_sweep(SPEC, lib, workers=0, log=_quiet)
    assert all(r.status == "skipped" for r in again)
    assert len(store) == n_records
    for p in receipts:
        p.unlink()
    rerun = run_sweep(SPEC, lib, workers=0, log=_quiet)
    assert all(r.status == "ok" for r in rerun)
    assert len(store) == n_records
    deeper = dataclasses.replace(SPEC, engine_opts={
        "anneal": {"steps": 3500, "restarts": 2, "keep": 3}})
    assert all(r.status == "ok"
               for r in run_sweep(deeper, lib, workers=0, log=_quiet))


def test_failed_job_writes_receipt_and_is_retried(tmp_path):
    """The SMT engines need z3, which the port does not have: the job
    fails with an error naming z3, its receipt says so, and a later run
    retries it."""
    job = SearchJob(benchmark="mul", bits=2, et=1, engine="shared",
                    budget_s=1.0)
    res = run_job(job, tmp_path / "lib")
    assert res.status == "failed" and "z3" in res.error
    doc = json.loads(tworker._receipt_path(tmp_path / "lib", job, {}).read_text())
    assert doc["status"] == "failed"
    assert run_job(job, tmp_path / "lib").status == "failed"


def test_fleet_cli_reports_densification(tmp_path, capsys):
    spec_file = tmp_path / "spec.json"
    spec_file.write_text(json.dumps({
        "name": "cli-test", "benchmarks": ["adder"], "bits": [2], "ets": [2],
        "engines": ["anneal"], "budget_s": 20.0,
        "engine_opts": {"anneal": {"steps": 3000, "restarts": 2, "keep": 3}},
    }))
    rc = tfleet_cli.main(["--library", str(tmp_path / "lib"), "--sweep",
                          str(spec_file), "--workers", "0", "--min-new", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "frontier densification" in out
    assert "adder2b_wce2" in out


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
def _job_view(jobs):
    return [(j.benchmark, j.bits, j.et, j.engine, j.error_metric, j.budget_s,
             j.seed, j.key()) for j in jobs]


@pytest.mark.parametrize("sweep", ["smoke", "8bit", "nightly", "json"])
def test_plans_equal_reference(sweep, tmp_path):
    if sweep == "json":
        path = tmp_path / "spec.json"
        path.write_text(json.dumps({
            "name": "mixed", "benchmarks": ["mul", "adder"], "bits": [2, 3],
            "ets": [1, 3], "et_fracs": [0.125, 0.5], "engines": ["tensor", "anneal"],
            "seed": 7, "extra_jobs": [{"benchmark": "mul", "bits": 2, "et": 2,
                                       "engine": "anneal", "error_metric": "mae",
                                       "budget_s": 5.0}]}))
        sweep = str(path)
    want = jplan.plan_jobs(jplan.load_spec(sweep, budget_s=None, seed=None))
    got = plan_jobs(load_spec(sweep, budget_s=None, seed=None))
    assert _job_view(got) == _job_view(want) and got
    assert set(SWEEPS) == set(jplan.SWEEPS)


def test_receipt_path_equals_reference(tmp_path):
    for job, opts in [(SearchJob("mul", 2, 1, "tensor", seed=3),
                       {"population": 512, "generations": 24}),
                      (SearchJob("adder", 3, 2, "anneal", error_metric="mae"), {})]:
        jjob = jengine.SearchJob(**dataclasses.asdict(job))
        assert (tworker._receipt_path(tmp_path, job, opts)
                == jworker._receipt_path(tmp_path, jjob, opts))
    # a tensor job's device is wiring, not an option: its receipt lands
    # where the reference's does and records the reference's options
    spec = dataclasses.replace(TENSOR_SMOKE, benchmarks=("mul",), ets=(2,))
    (job,) = plan_jobs(spec)
    res = run_job(job, tmp_path / "lib", engine_opts=spec.engine_opts, device="cpu")
    assert res.status == "ok"
    jjob = jengine.SearchJob(**dataclasses.asdict(job))
    path = jworker._receipt_path(tmp_path / "lib", jjob, spec.engine_opts["tensor"])
    doc = json.loads(path.read_text())
    assert doc["engine_opts"] == spec.engine_opts["tensor"]
    assert doc["job"] == dataclasses.asdict(jjob)


def _records(root):
    store = OperatorStore(root)
    return {s.dirname: sorted(r.key for r in store.records(s))
            for s in store.signatures()}


def test_cpu_engine_sweep_writes_the_reference_records(tmp_path):
    spec_file = tmp_path / "spec.json"
    spec_file.write_text(json.dumps(CPU_SPEC))
    jres = jworker.run_sweep(jplan.load_spec(str(spec_file)), tmp_path / "ref",
                             workers=0, log=_quiet)
    tres = run_sweep(load_spec(str(spec_file)), tmp_path / "port", workers=0,
                     log=_quiet)
    assert [r.status for r in tres] == [r.status for r in jres] == ["ok"] * 12
    assert [r.n_results for r in tres] == [r.n_results for r in jres]
    want = _records(tmp_path / "ref")
    assert _records(tmp_path / "port") == want and sum(map(len, want.values())) > 0
    assert (sorted(p.name for p in (tmp_path / "port" / RECEIPT_DIR).glob("*.json"))
            == sorted(p.name for p in (tmp_path / "ref" / RECEIPT_DIR).glob("*.json")))


def test_tensor_smoke_sweep_on_cpu_is_sound_deterministic_and_resumes(tmp_path):
    lib = tmp_path / "lib"
    results = run_sweep(TENSOR_SMOKE, lib, workers=0, device="cpu", log=_quiet)
    assert [r.status for r in results] == ["ok"] * 4
    opts = TENSOR_SMOKE.engine_opts["tensor"]
    assert all(r.stats["generations"] == opts["generations"] for r in results)
    store = OperatorStore(lib)
    recs = store.query()
    assert recs and sum(r.n_results for r in results) >= len(recs)
    for sig in store.signatures():
        exact = benchmark(f"{sig.op_kind}_i{2 * sig.bits}").eval_words()
        for rec in store.records(sig):
            assert measure_error(rec.circuit, exact).wce <= sig.threshold
    keys = _records(lib)
    assert all(r.status == "skipped"
               for r in run_sweep(TENSOR_SMOKE, lib, workers=0, device="cpu",
                                  log=_quiet))
    for p in (lib / RECEIPT_DIR).glob("*.json"):
        p.unlink()
    rerun = run_sweep(TENSOR_SMOKE, lib, workers=0, device="cpu", log=_quiet)
    assert [r.status for r in rerun] == ["ok"] * 4
    assert [r.n_results for r in rerun] == [r.n_results for r in results]
    assert _records(lib) == keys


def test_pool_starts_by_fork_until_cuda_is_up(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert tworker.pool_method() == "fork"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert tworker.pool_method() == "spawn"

    # run_sweep asks multiprocessing for the chosen start method; an
    # in-process pool stands in for the real one
    asked = []

    class InlinePool:
        def __init__(self, n):
            self.n = n

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def map(self, fn, items):
            return [fn(x) for x in items]

    class Ctx:
        def Pool(self, n):
            return InlinePool(n)

    def get_context(method):
        asked.append(method)
        return Ctx()

    monkeypatch.setattr(tworker.multiprocessing, "get_context", get_context)
    lines = []
    res = run_sweep(SPEC, tmp_path / "lib", workers=4, log=lines.append)
    assert asked == ["spawn"] and [r.status for r in res] == ["ok", "ok"]
    assert lines[0] == "fleet: 2 CPU job(s) on a spawn pool of 2 worker(s)"


def _masked(text: str) -> list[str]:
    """Report lines with times (``12.3s``) masked and the library path
    replaced, so two runs into two libraries compare."""
    return [re.sub(r"\d+\.\d+s", "<t>s", line) for line in text.splitlines()]


def test_fleet_cli_report_equals_reference(tmp_path, capsys):
    spec_file = tmp_path / "spec.json"
    spec_file.write_text(json.dumps(CPU_SPEC))
    out = {}
    for name, cli in (("ref", jfleet_cli), ("port", tfleet_cli)):
        lib = tmp_path / "lib"
        rc = cli.main(["--library", str(lib), "--sweep", str(spec_file),
                       "--workers", "0", "--min-new", "1"])
        rc2 = cli.main(["--library", str(lib), "--sweep", str(spec_file),
                        "--workers", "0"])
        out[name] = (rc, rc2, _masked(capsys.readouterr().out))
        (tmp_path / "lib").rename(tmp_path / name)
    assert out["port"] == out["ref"]
    rc, rc2, lines = out["port"]
    assert rc == rc2 == 0
    assert "jobs: 0 ok, 12 resumed/skipped, 0 failed; 0 operator(s) added under " \
           "0 signature(s)" in lines
    assert json.loads((tmp_path / "port" / RECEIPT_DIR / "last_update.json")
                      .read_text())["sweep"] == "cpu-engines"


def test_trace_report_finds_search_spans_inside_fleet_jobs(tmp_path, capsys):
    lib = tmp_path / "lib"
    spec_file = tmp_path / "spec.json"
    spec_file.write_text(json.dumps({
        "name": "traced", "benchmarks": ["mul"], "bits": [2], "ets": [2],
        "engines": ["anneal", "tensor"],
        "engine_opts": {"anneal": {"steps": 1000, "restarts": 1, "keep": 2},
                        "tensor": {"population": 64, "generations": 4,
                                   "elites": 8, "keep": 2}}}))
    rc = tfleet_cli.main(["--library", str(lib), "--sweep", str(spec_file),
                          "--workers", "0", "--trace", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    trace_dir = lib / RECEIPT_DIR / "trace"
    spans = read_trace(trace_dir)
    jobs = {s["id"]: s for s in spans if s["name"] == "fleet.job"}
    runs = [s for s in spans if s["name"] == "search.run"]
    assert len(jobs) == 2 and len(runs) == 2
    assert {jobs[s["parent"]]["attrs"]["engine"] for s in runs} == {"anneal", "tensor"}
    assert all(s["attrs"]["engine"] == jobs[s["parent"]]["attrs"]["engine"]
               for s in runs)
    assert f"trace ({trace_dir}):" in out and "per-engine wall-time:" in out
    # the report reads only this run's jobs
    lines = []
    tfleet_cli.trace_report(trace_dir, {"no-such-key"}, out=lines.append)
    assert lines == []
    tfleet_cli.trace_report(trace_dir, {s["attrs"]["key"] for s in jobs.values()},
                            out=lines.append)
    assert lines[1] == "  slowest 2 job(s):" and len(lines) == 7


# ---------------------------------------------------------------------------
# the instrumented registry
# ---------------------------------------------------------------------------
def _metric_view(reg):
    out = {}
    for name, labels, m in reg.entries():
        key = (name, tuple(sorted(labels.items())))
        if name == "search_run_s":
            out[key] = m.count
        else:
            out[key] = m.to_doc().get("value", m.to_doc().get("count"))
    return out


def test_instrumented_engine_reports_the_reference_metrics():
    job = dict(benchmark="mul", bits=2, et=2, engine="anneal", budget_s=30.0, seed=4)
    jeng = jengine.get_engine("anneal", steps=1500, restarts=2)
    teng = get_engine("anneal", steps=1500, restarts=2)
    assert isinstance(teng, InstrumentedEngine) and teng.name == "anneal"
    assert teng.steps == 1500        # attributes pass through
    jout = jeng.run(jengine.SearchJob(**job))
    tout = teng.run(SearchJob(**job))
    assert tout.stats == jout.stats
    want = _metric_view(jmetrics.get_registry())
    got = _metric_view(tmetrics.get_registry())
    assert got == want and ("search_runs_total", (("engine", "anneal"),)) in got
    for name in ("tensor", "muscat", "mecals"):
        opts = {"device": "cpu"} if name == "tensor" else {}
        assert isinstance(get_engine(name, **opts), InstrumentedEngine)
    assert get_engine("tensor", device="cpu", population=8).search_kw == {
        "device": "cpu", "population": 8}


# ---------------------------------------------------------------------------
# the search CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--benchmark", "mul_i4", "--et", "1", "2"],
    ["--benchmark", "mul_i4", "--et", "2", "4", "--method", "muscat"],
    ["--benchmark", "adder_i4", "--et", "1", "--method", "mecals", "--seed", "3"],
], ids=["auto", "muscat", "mecals"])
def test_search_cli_prints_and_stores_the_reference_results(argv, tmp_path, capsys):
    argv = argv + ["--budget-s", "30"]
    jsearch.main(argv + ["--library", str(tmp_path / "ref")])
    want = capsys.readouterr().out.replace(str(tmp_path / "ref"), "LIB")
    tsearch.main(argv + ["--library", str(tmp_path / "port")])
    got = capsys.readouterr().out.replace(str(tmp_path / "port"), "LIB")
    assert got == want and "new operator(s) -> LIB" in got
    if "--method" not in argv:
        assert got.splitlines()[0] == "--method auto -> anneal (z3 missing)"
    assert _records(tmp_path / "port") == _records(tmp_path / "ref")
    # a second run finds the same netlists: 0 new
    tsearch.main(argv + ["--library", str(tmp_path / "port")])
    assert all(line.endswith("0 new operator(s) -> " + str(tmp_path / "port"))
               for line in capsys.readouterr().out.splitlines() if "ET=" in line)


def test_search_cli_runs_the_tensor_engine_where_asked(tmp_path, capsys, monkeypatch):
    tsearch.main(["--benchmark", "mul_i4", "--et", "2", "--method", "tensor",
                  "--library", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("mul_i4 ET=  2 [tensor]: best area") and len(OperatorStore(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.main(["--benchmark", "mul_i4", "--et", "2", "--method", "tensor"])


def test_progressive_search_raises_the_reference_error():
    exact = benchmark("mul_i4")
    with pytest.raises(RuntimeError) as want:
        jsearch.progressive_search(jengine.SearchJob("mul", 2, 1, "shared").exact(), 1)
    with pytest.raises(RuntimeError) as got:
        tsearch.progressive_search(exact, 1)
    assert str(got.value) == str(want.value) and "z3" in str(got.value)
