"""Shared set-up of the benchmark's CPU tests: the import paths, and a
copy of the benchmark whose cell runs its configuration's reduced
twin (``repro_torch.configs``' ``REDUCED``) at a size the CPU holds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL_CONFIGS = {
    "stablelm-1.6b-w8": {"hidden_size": 64, "intermediate_size": 160,
                         "num_attention_heads": 4, "num_key_value_heads": 4,
                         "num_hidden_layers": 2, "vocab_size": 512},
}
SMALL_TRAFFIC = {
    "offline-b128-p1024-g128": {"batch": 8, "prompt_len": 8, "prompt_dist": "uniform:4-8",
                              "gen_len": 12, "trace_steps": 2},
}
# the mean gap limit of the reduced cell, from CPU readings over 22 seeds
# of 8 sampled requests (96 served tokens): sound runs at most 0.0017, the
# float8 control at least 0.0130
SMALL_LIMITS = {"stablelm-w8-offline": 0.005}


def small_root(dest: Path) -> Path:
    """A checkout-like directory: ``BENCHMARK.json`` and ``portbench/``
    as committed, with every configuration, mix and limit cut down."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = dest / "portbench"
    for name, small in SMALL_CONFIGS.items():
        path = bench / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text()) | small | {"arch_reduced": True}
        path.write_text(json.dumps(cfg))
    for name, small in SMALL_TRAFFIC.items():
        path = bench / "traffic" / f"{name}.json"
        path.write_text(json.dumps(json.loads(path.read_text()) | small))
    for name, limit in SMALL_LIMITS.items():
        path = bench / "workloads" / f"{name}.json"
        cell = json.loads(path.read_text())
        cell["check"]["mean_gap"] = limit
        cell["check"]["sample_requests"] = 8
        path.write_text(json.dumps(cell))
    return dest


@pytest.fixture(scope="session")
def small(tmp_path_factory) -> Path:
    return small_root(tmp_path_factory.mktemp("bench"))
