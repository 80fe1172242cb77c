"""The result line's schema, the refusal without a card, and that a run
loads neither JAX nor the JAX package."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from conftest import ROOT
from portbench import harness, run


@pytest.mark.parametrize("seed", [2**31 + 11, 2**33 + 7])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(small, seed, trace):
    line = harness.run_cell("stablelm-w8-offline", seed, 0.6, trace, t_start=time.perf_counter(),
                            device="cpu", root=small)
    json.loads(json.dumps(line, allow_nan=False))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0, line["checks"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["window_s"] > 0 and "busy_s" in dev
        bd = line["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in bd.values())
        assert "setup_s" not in line["metrics"]
    else:
        assert "setup_s" in line["metrics"] and "breakdown" not in line


def test_no_result_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", "stablelm-w8-offline", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA device" in out.err


def test_a_run_loads_no_jax(small):
    code = f"""
import sys, time
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from pathlib import Path
from portbench import harness, run
harness.run_cell("stablelm-w8-offline", 3, 0.6, False, t_start=time.perf_counter(),
                 device="cpu", root=Path({str(small)!r}))
print(run.loaded_forbidden(), "repro_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "reproduce_me", sys)
    assert "repro" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.kernels", sys)
    assert run.loaded_forbidden() == ["repro"]
