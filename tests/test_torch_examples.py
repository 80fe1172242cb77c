"""PyTorch port: the examples (``python -m repro_torch.examples.<name>``)
against the reference's scripts under ``examples/``, on the CPU.

``approx_inference`` in its library mode reads a library that the port's
fleet filled and must list the same frontier as the reference's script
over that library, then print a plan within its budget (the drift matrix
differs: each package makes its own random weights).  ``serve_batch``
serves reduced gemma3-1b through the port's launcher, captured once,
with the reference's bench-summary keys.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import runpy
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch.examples import approx_inference, serve_batch  # noqa: E402
from repro_torch.fleet import __main__ as fleet_cli  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_obs():
    def reset():
        for tr, mt in ((jtrace, jmetrics), (ttrace, tmetrics)):
            tr.reset(clear_env=True)
            mt.set_registry(mt.MetricRegistry())
    reset()
    yield
    reset()


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """A 2-bit multiplier library filled by the port's fleet, its tensor
    jobs on the CPU."""
    root = tmp_path_factory.mktemp("lib")
    spec = root.parent / "spec.json"
    spec.write_text(json.dumps({
        "name": "examples", "benchmarks": ["mul"], "bits": [2], "ets": [1, 2, 4],
        "engines": ["tensor", "muscat", "mecals"],
        "engine_opts": {"tensor": {"population": 256, "generations": 12,
                                   "elites": 32, "keep": 3}}}))
    with contextlib.redirect_stdout(io.StringIO()):
        rc = fleet_cli.main(["--library", str(root), "--sweep", str(spec),
                             "--workers", "0", "--min-new", "1", "--device", "cpu"])
    assert rc == 0
    ttrace.reset(clear_env=True)
    return root


def _reference_example(name: str):
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _listing(text: str) -> list[str]:
    lines = text.splitlines()
    return lines[:lines.index("")]


def test_approx_inference_library_mode_lists_the_reference_frontier(library):
    ref = _reference_example("approx_inference")
    args = argparse.Namespace(arch="qwen3-4b", reduced=True, library=str(library),
                              qos_budget=1e9)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        ref.library_main(args)
    want = buf.getvalue()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        approx_inference.main(["--library", str(library), "--qos-budget", "1e9",
                               "--device", "cpu"])
    got = buf.getvalue()
    assert _listing(got) == _listing(want)
    assert len(_listing(got)) >= 2     # the header and at least one operator
    total = next(line for line in got.splitlines() if line.startswith("total area"))
    drift, budget = (float(x) for x in
                     total.split("predicted drift ")[1].split(" <= budget "))
    assert drift <= budget and "% saving" in total and "(0.0% saving)" not in total
    assert "measured drift" in got and "-> per-layer operators" in got


def test_approx_inference_defaults(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        approx_inference.main(["--library", "unused"])
    calls = []
    monkeypatch.setattr(approx_inference, "adhoc_main",
                        lambda args, dev: calls.append((args, dev)))
    approx_inference.main(["--device", "cpu"])
    (args, dev), = calls
    assert (args.arch, args.reduced, args.qos_budget, dev.type) == (
        "qwen3-4b", True, 0.05, "cpu")


def test_serve_batch_serves_reduced_gemma3(tmp_path, monkeypatch, capsys):
    got_path, want_path = tmp_path / "port.json", tmp_path / "ref.json"
    serve_batch.main(["--arch", "gemma3-1b", "--device", "cpu",
                      "--bench-json", str(got_path)])
    out = capsys.readouterr().out
    assert "arch=gemma3-1b-reduced" in out
    monkeypatch.setattr(sys, "argv", ["serve_batch.py", "--arch", "gemma3-1b",
                                      "--bench-json", str(want_path)])
    runpy.run_path(str(ROOT / "examples" / "serve_batch.py"), run_name="__main__")
    got, want = json.loads(got_path.read_text()), json.loads(want_path.read_text())
    assert sorted(got) == sorted(want)
    assert got["trace_count"] == 1 and got["requests"] == want["requests"] == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_batch.main(["--arch", "gemma3-1b"])
