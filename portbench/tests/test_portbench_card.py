"""On the card: one short run of the cell through the command the
driver runs, its result line read back.  Skips without a CUDA device;
on the chip: ``python3 -m pytest -q -m cuda portbench/tests``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "stablelm-w8-offline", "--seed", str(2**31 + 5), "--seconds", "5",
                          "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]
