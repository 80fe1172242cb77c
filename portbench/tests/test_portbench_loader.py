"""The harness finds a cell, a configuration, a mix, a metric and a
table added as new files, with no file that exists edited."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest

from conftest import small_root
from portbench import harness, loader


def _add_cell(root, name="stablelm-w8-new"):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/stablelm-1.6b-w8.json").read_text())
    cfg["name"] = "stablelm-new"
    (root / "portbench/configs/stablelm-new.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "portbench/traffic/offline-b128-p1024-g128.json").read_text())
    mix["name"], mix["batch"] = "offline-new", 2
    (root / "portbench/traffic/offline-new.json").write_text(json.dumps(mix))
    (root / f"portbench/workloads/{name}.json").write_text(json.dumps(
        {"config": "stablelm-new", "traffic": "offline-new",
         "check": {"sample_requests": 2, "mean_gap": 1.0}}))
    (root / "portbench/metrics/rows_a_step.py").write_text(
        "def read(ctx):\n    return float(ctx.run.rows_per_step)\n")
    # no file of its own: read by ``metrics/rows_a_step.py``
    bench["per_layer"].append({"name": "rows_a_step.new", "unit": "rows",
                               "better": "higher", "source": "program_counter",
                               "layer": "test", "moves": "gen_tok_s",
                               "workloads": [name]})
    bench["configs"].append({"name": "stablelm-new", "source": "x",
                             "file": "portbench/configs/stablelm-new.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": "stablelm-new",
                               "traffic": "offline-new", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append(name)
    bench["per_layer"].append({"name": "rows_a_step", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "gen_tok_s", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_new_cell_runs_from_new_files_only(tmp_path):
    root = small_root(tmp_path / "copy")
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    _add_cell(root)
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
    assert loader.cell("stablelm-w8-new", root)["traffic"] == "offline-new"
    names = [m["name"] for m in loader.metrics_for("stablelm-w8-new", True, root)]
    assert "rows_a_step" in names and "step_ms.offline" not in names
    import time

    line = harness.run_cell("stablelm-w8-new", 5, 0.01, True, t_start=time.perf_counter(),
                            device="cpu", root=root)
    assert line["metrics"]["rows_a_step"] == {"value": 2.0, "unit": "rows"}
    assert line["metrics"]["rows_a_step.new"] == {"value": 2.0, "unit": "rows"}
    line = harness.run_cell("stablelm-w8-new", 5, 0.01, False, t_start=time.perf_counter(),
                            device="cpu", root=root)
    assert set(line["metrics"]) == {"gen_tok_s", "setup_s"}


def test_a_cell_file_must_agree_with_benchmark_json(tmp_path):
    root = small_root(tmp_path / "copy")
    path = root / "portbench/workloads/stablelm-w8-offline.json"
    cell = json.loads(path.read_text())
    cell["traffic"] = "offline-other"
    path.write_text(json.dumps(cell))
    with pytest.raises(loader.BenchError, match="names traffic"):
        loader.cell("stablelm-w8-offline", root)


def test_a_reader_falls_back_to_the_name_before_its_first_dot(tmp_path):
    root = small_root(tmp_path / "copy")
    assert loader.reader("step_mfu.offline", root) is not None
    (root / "portbench/metrics/step_mfu.offline.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    assert loader.reader("step_mfu.offline", root)(None) == 7.0
    with pytest.raises(loader.BenchError, match="no reader"):
        loader.reader("no_such_metric.offline", root)


def test_the_frozen_table_is_checked_at_load(tmp_path):
    t = loader.table("mul_i8_exact")
    assert t.lut.shape == (256, 256) and t.lut.dtype == np.int32
    assert np.array_equal(t.lut, np.arange(256)[:, None] * np.arange(256)[None, :])
    root = tmp_path / "copy"
    shutil.copytree(loader.ROOT / "portbench" / "tables", root / "portbench" / "tables")
    path = root / "portbench/tables/mul_i8_exact.json"
    doc = json.loads(path.read_text())
    bad = dict(doc, block=[[0, 0, 0, 0], [0, 1, 2, 3], [0, 2, 4, 6], [0, 3, 6, 3]])
    path.write_text(json.dumps(bad))
    with pytest.raises(loader.BenchError, match="worst-case error 6"):
        loader.table("mul_i8_exact", root)
    table = t.lut.astype(int).tolist()
    table[3][3] += 1
    path.write_text(json.dumps(dict(doc, table=table)))
    with pytest.raises(loader.BenchError, match="not its block composed"):
        loader.table("mul_i8_exact", root)


@pytest.mark.parametrize("target_bits", [4, 8])
def test_composition_matches_the_program(target_bits):
    from repro_torch.precision.compose import compose_table

    block = np.asarray(json.loads(
        (loader.ROOT / "portbench/tables/mul_i8_exact.json").read_text())["block"])
    side = 1 << target_bits
    exact = np.arange(side)[:, None] * np.arange(side)[None, :]
    assert np.array_equal(loader.compose(block, 2, target_bits), exact)
    # an approximate block: its top entry one low
    approx = block.copy()
    approx[3, 3] -= 1
    assert np.array_equal(loader.compose(approx, 2, target_bits),
                          compose_table(approx, "mul", 2, target_bits))
