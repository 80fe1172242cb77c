"""PyTorch port: the ``obs`` inspector and its exports against the JAX package's.

The port's serve launcher writes one trace dir, bench summary and
post-mortem dir on the CPU (continuous, classes, a measured profile, the
health plane).  Over those files every subcommand of ``python -m
repro.obs`` and of ``python -m repro_torch.obs`` prints the same standard
output and exits with the same code; ``chrome_trace`` gives the same
document; ``compare_bench`` judges the cases of tests/test_health.py the
same; ``render_report`` prints the same table; and a ``MetricsServer`` on
a free port answers ``/metrics``, ``/healthz`` and ``/costs.json`` the
same on both sides.
"""

import json
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.arith import benchmark  # noqa: E402
from repro.obs import __main__ as jinspect  # noqa: E402
from repro.obs import costs as jcosts  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import httpd as jhttpd  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import perfetto as jperfetto  # noqa: E402
from repro.obs import provenance as jprov  # noqa: E402
from repro.obs import regress as jregress  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.obs import __main__ as pinspect  # noqa: E402
from repro_torch.obs import costs as pcosts  # noqa: E402
from repro_torch.obs import export as pexport  # noqa: E402
from repro_torch.obs import httpd as phttpd  # noqa: E402
from repro_torch.obs import metrics as pmetrics  # noqa: E402
from repro_torch.obs import perfetto as pperfetto  # noqa: E402
from repro_torch.obs import provenance as pprov  # noqa: E402
from repro_torch.obs import regress as pregress  # noqa: E402
from repro_torch.obs import trace as ptrace  # noqa: E402
from repro_torch.obs.trace import read_trace  # noqa: E402
from repro_torch.sensitivity.profile import SensitivityProfile  # noqa: E402
from test_serving import fill_library, trunc_mul2  # noqa: E402

SIDES = {"ref": (jinspect, jcosts, jexport, jhttpd, jmetrics, jperfetto, jprov,
                 jregress),
         "port": (pinspect, pcosts, pexport, phttpd, pmetrics, pperfetto, pprov,
                  pregress)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' tensors are tiny: intra-op threads only add
    overhead here and crowd the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One serve of the port's launcher on the CPU: its trace dir, bench
    summary and post-mortem dir."""
    root = tmp_path_factory.mktemp("inspect")
    lib = root / "lib"
    fill_library(lib, [benchmark("mul_i4"), trunc_mul2()])
    prof = SensitivityProfile(model="qwen3-4b-reduced", n_layers=2,
                              sens={4: np.array([0.3, 0.2])}).save(root / "p.json")
    argv = ["--reduced", "--batch", "2", "--prompt-len", "4", "--gen-len", "6",
            "--continuous", "--library", str(lib), "--profile", str(prof),
            "--qos-class", "gold:1e9@250ms,batch:1e9", "--max-slots", "2",
            "--page-size", "4", "--schedule", "spike", "--ticks", "3",
            "--per-tick", "3", "--prompt-dist", "uniform:2-4", "--adaptive",
            "--target-ms-per-step", "0.001", "--drift-budget", "1e9",
            "--shadow-every", "1", "--health", "--postmortem-dir",
            str(root / "pm"), "--trace", str(root / "trace"),
            "--bench-json", str(root / "serve.json"), "--device", "cpu"]
    prev = pmetrics.set_registry(pmetrics.MetricRegistry())
    try:
        serve.main(argv)
    finally:
        ptrace.reset()
        pmetrics.set_registry(prev)
    (root / "base").mkdir()
    shutil.copy(root / "serve.json", root / "base" / "serve.json")
    return root


# every subcommand, with the flags that change what it prints or returns;
# "{d}" is the served dir, "{side}" a per-side scratch dir
COMMANDS = {
    "summary": ["summary", "--trace", "{d}/trace"],
    "summary-json": ["summary", "--trace", "{d}/trace", "--json", "--limit", "3"],
    "summary-gates": ["summary", "--trace", "{d}/trace", "--require-span",
                      "serve.step=1", "--require-span", "no.such.span",
                      "--require-class-latency"],
    "summary-implicit": ["--trace", "{d}/trace"],
    "summary-missing": ["summary", "--trace", "{d}/nothing"],
    "slowest": ["slowest", "--trace", "{d}/trace", "--name", "serve", "--limit", "4"],
    "prom": ["prom", "--trace", "{d}/trace"],
    "health": ["health", "--bench", "{d}/serve.json"],
    "health-page": ["health", "--bench", "{d}/serve.json", "--max-state", "page"],
    "health-json": ["health", "--bench", "{d}/serve.json", "--json", "--max-state", "ok"],
    "postmortem": ["postmortem", "--dir", "{d}/pm", "--last"],
    "postmortem-require": ["postmortem", "--dir", "{d}/pm", "--require", "99", "--json"],
    "requests": ["requests", "--trace", "{d}/trace", "--require-complete"],
    "requests-json": ["requests", "--trace", "{d}/trace", "--json"],
    "requests-rid": ["requests", "--trace", "{d}/trace", "--rid", "9999"],
    "provenance": ["provenance", "--trace", "{d}/trace"],
    "provenance-json": ["provenance", "--trace", "{d}/trace", "--json"],
    "costs": ["costs", "--trace", "{d}/trace", "--require-reconciled"],
    "costs-json": ["costs", "--trace", "{d}/trace", "--json"],
    "export": ["export", "--trace", "{d}/trace", "--format", "chrome"],
    "diff": ["diff", "--bench", "{d}/serve.json", "{d}/absent.json",
             "--baseline-dir", "{d}/base", "--history-dir", "{side}/hist"],
    "diff-no-baseline": ["diff", "--bench", "{d}/serve.json", "--baseline-dir",
                         "{d}/pm", "--require-baseline", "--json"],
}


@pytest.mark.parametrize("case", sorted(COMMANDS))
def test_inspector_subcommands_agree(case, served, tmp_path, capsys):
    got = {}
    for side, (inspect, *_) in SIDES.items():
        argv = [a.format(d=served, side=tmp_path / side) for a in COMMANDS[case]]
        rc = inspect.main(argv)
        got[side] = (rc, capsys.readouterr().out)
    assert got["port"] == got["ref"]
    if case in ("summary", "requests", "provenance", "costs", "health-page"):
        assert got["port"][0] == 0
    if case == "diff":
        hist = [sorted(p.name for p in (tmp_path / s / "hist").iterdir())
                for s in SIDES]
        assert hist[0] == hist[1] == ["serve-0000.json"]


def test_export_to_a_file_agrees(served, tmp_path, capsys):
    docs = {}
    for side, (inspect, *_) in SIDES.items():
        out = tmp_path / side / "trace.json"
        assert inspect.main(["export", "--trace", str(served / "trace"),
                             "--out", str(out)]) == 0
        assert capsys.readouterr().out.startswith("wrote ")
        docs[side] = json.loads(out.read_text())
    assert docs["port"] == docs["ref"]
    assert docs["port"]["otherData"]["spans"] > 0


def test_chrome_trace_agrees(served):
    spans = read_trace(served / "trace")
    assert jperfetto.chrome_trace(spans) == pperfetto.chrome_trace(spans)
    # a torn tail: a span whose parent record is missing roots its own track,
    # and two overlapping roots take two tracks
    torn = [{"id": "a", "name": "x.a", "t0": 1.0, "dur_s": 2.0},
            {"id": "b", "name": "x.b", "t0": 1.5, "dur_s": 0.5, "parent": "gone"},
            {"id": "c", "name": "y.c", "t0": 1.2, "dur_s": 0.1, "parent": "a",
             "attrs": {"k": 1}}]
    assert jperfetto.chrome_trace(torn) == pperfetto.chrome_trace(torn)
    assert pperfetto.chrome_trace([]) == jperfetto.chrome_trace([])


def _regress_cases(regress):
    """tests/test_health.py's bench regression sentinel cases."""
    base = {"decode_tok_s": 200.0, "prefill_tok_s": 100.0, "ms_per_step": 10.0,
            "trace_count": 1, "wall_s": 5.0, "requests": 8,
            "classes": {"gold": {"p95_ms_per_step": 8.0}}}
    cur = {"decode_tok_s": 90.0, "prefill_tok_s": 260.0, "ms_per_step": 2.0,
           "trace_count": 2, "wall_s": 50.0, "requests": 6}
    ok = {"decode_tok_s": 150.0, "prefill_tok_s": 120.0, "ms_per_step": 12.0,
          "trace_count": 1, "wall_s": 1.0, "requests": 8,
          "classes": {"gold": {"p95_ms_per_step": 9.0}}}
    rules = (regress.Rule("*requests*", "exact"),) + regress.DEFAULT_RULES
    judged = [regress.Rule("x", d, rel_tol=0.1).judge(b, c)
              for d in ("higher", "lower", "both", "exact")
              for b, c in ((100, 120), (100, 105), ("a", "b"), (True, False))]
    return [regress.compare_bench(cur, base), regress.compare_bench(ok, base),
            regress.compare_bench({"requests": 6}, {"requests": 8}, rules),
            regress.flatten({"a": {"b": [1, {"c": 2}]}, "d": 3}), judged]


def test_compare_bench_agrees(tmp_path):
    want, got = _regress_cases(jregress), _regress_cases(pregress)
    assert got == want
    assert {f["metric"] for f in got[0]["regressions"]} == \
        {"decode_tok_s", "trace_count", "classes.gold.p95_ms_per_step"}
    assert got[1]["regressions"] == [] and got[0]["compared"] == 4
    tol = tmp_path / "tolerances.json"
    tol.write_text(json.dumps({"rules": [{"pattern": "*requests*",
                                          "direction": "exact"}]}))
    assert [(r.pattern, r.direction, r.rel_tol, r.abs_tol)
            for r in pregress.load_rules(tol)] == \
        [(r.pattern, r.direction, r.rel_tol, r.abs_tol)
         for r in jregress.load_rules(tol)]
    for regress in (pregress, jregress):
        with pytest.raises(ValueError):
            regress.Rule("x", "weird")
        with pytest.raises(ValueError):
            regress.Rule("x", rel_tol=-1.0)


def test_render_report_agrees(served):
    records = pprov.read_ledger(served / "trace")
    rep = pcosts.cost_report(records)
    assert rep == jcosts.cost_report(jprov.read_ledger(served / "trace"))
    assert rep["reconciled"] and rep["classes"]
    rep["replicas"] = {"replica0": dict(rep["totals"], tokens=3)}
    variants = [rep, {"problems": ["no model"]}, {"problems": []}]
    for r in variants:
        assert pcosts.render_report(r) == jcosts.render_report(r)
    assert pcosts.render_report(rep).startswith("model qwen3-4b-reduced: 2 layers")


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _registry(metrics):
    reg = metrics.MetricRegistry()
    reg.counter("serve_requests_total", cls="gold").inc(3)
    reg.gauge("serve_occupancy").set(0.5)
    h = reg.histogram("serve_ms_per_step", cls="batch")
    for v in (1.0, 2.5, 9.0):
        h.observe(v)
    return reg


@pytest.mark.parametrize("state", ["ok", "warn", "page", None])
def test_metrics_server_answers_agree(served, state):
    answers = {}
    for side, (_, _, export, httpd, metrics, *_) in SIDES.items():
        reg = _registry(metrics)
        health = None if state is None else (lambda: {"state": state, "pages": 1})
        servers = [httpd.MetricsServer(port=0, snapshot_providers=[reg.snapshot],
                                       health_provider=health,
                                       trace_dir=str(served / "trace")),
                   httpd.MetricsServer(port=0, snapshot_providers=[reg.snapshot])]
        got = []
        try:
            for srv in servers:
                port = srv.start()
                assert port > 0 and srv.port == port
                got.append([_get(port, p) for p in
                            ("/metrics", "/healthz?x=1", "/costs.json", "/nope")])
        finally:
            for srv in servers:
                srv.stop()
        assert all(srv._thread is None for srv in servers)
        # without a trace dir /metrics is the registry's Prometheus text
        assert got[1][0] == (200, export.prometheus_text(reg))
        answers[side] = got
    assert answers["port"] == answers["ref"]
    traced = answers["port"][0]
    assert traced[1][0] == {"ok": 200, "warn": 429, "page": 503, None: 200}[state]
    assert traced[2][0] == 200 and json.loads(traced[2][1])["reconciled"]
    assert answers["port"][1][2][0] == 404 and traced[3][0] == 404
