"""Finds every part of the benchmark by its name, as data.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics.
Everything that belongs to one entry sits in files of its own, found by
the entry's name:

- a configuration: ``portbench/configs/<config>.json``;
- a traffic mix: ``portbench/traffic/<traffic>.json``;
- a cell: ``portbench/workloads/<cell>.json`` (its output check);
- a metric's reader: ``portbench/metrics/<metric>.py``, a ``read(ctx)``,
  or, where there is none, ``metrics/<metric up to its first '.'>.py``,
  so that one reader serves ``step_mfu.offline`` and a later ``step_mfu.chat``;
- an operator table: ``portbench/tables/<table>.json``.

A later change adds an entry by adding files; no file here changes.
Nothing in this module imports the program or JAX.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = "portbench"


class BenchError(ValueError):
    """A benchmark file is missing, malformed or disagrees with another."""


def _json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"no such file: {path}")
    with path.open() as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name``: its ``BENCHMARK.json`` entry merged with its
    own file, which must name the same configuration and traffic."""
    entries = {w["name"]: w for w in benchmark(root)["workloads"]}
    if name not in entries:
        raise BenchError(f"no cell {name!r} in BENCHMARK.json; "
                         f"cells: {sorted(entries)}")
    own = _json(Path(root) / BENCH / "workloads" / f"{name}.json")
    entry = entries[name]
    for key in ("config", "traffic"):
        if own.get(key) != entry[key]:
            raise BenchError(f"cell {name}: its file names {key} "
                             f"{own.get(key)!r}, BENCHMARK.json {entry[key]!r}")
    return {**own, **entry}


def config(name: str, root: Path = ROOT) -> dict:
    cfg = _json(Path(root) / BENCH / "configs" / f"{name}.json")
    if cfg.get("name") != name:
        raise BenchError(f"configs/{name}.json names itself {cfg.get('name')!r}")
    return cfg


def traffic(name: str, root: Path = ROOT) -> dict:
    mix = _json(Path(root) / BENCH / "traffic" / f"{name}.json")
    if mix.get("name") != name:
        raise BenchError(f"traffic/{name}.json names itself {mix.get('name')!r}")
    return mix


class Table(NamedTuple):
    """An operator table: the ``(2**target_bits,)*2`` table the LUT path
    serves, and the ``block_bits`` multiplier it composes."""

    lut: np.ndarray        # int32
    block: np.ndarray      # int64
    block_bits: int
    target_bits: int


def table(name: str, root: Path = ROOT) -> Table:
    """The table ``name``, after checking it anew: its block's worst-case
    error against the exact block products is at most the threshold it
    claims, and the table (made here when the file holds only the block)
    is that block composed by shift-add to ``target_bits``-bit operands."""
    doc = _json(Path(root) / BENCH / "tables" / f"{name}.json")
    block = np.asarray(doc["block"], dtype=np.int64)
    bb, tb = int(doc["block_bits"]), int(doc["target_bits"])
    side = 1 << bb
    if block.shape != (side, side) or tb % bb or tb not in (4, 8):
        raise BenchError(f"table {name}: block shape {block.shape}, "
                         f"{bb}-bit block to {tb} bits")
    exact = np.arange(side)[:, None] * np.arange(side)[None, :]
    wce = int(np.abs(block - exact).max())
    if wce > int(doc["error_threshold"]):
        raise BenchError(f"table {name}: worst-case error {wce} over its "
                         f"threshold {doc['error_threshold']}")
    lut = compose(block, bb, tb)
    if doc.get("table") is not None and not np.array_equal(
            np.asarray(doc["table"], dtype=np.int64), lut):
        raise BenchError(f"table {name}: the table is not its block composed "
                         f"to {tb}-bit operands")
    return Table(lut.astype(np.int32), block, bb, tb)


def compose(block: np.ndarray, block_bits: int, target_bits: int) -> np.ndarray:
    """A ``target_bits`` multiplier table from a ``block_bits`` one: the
    sum of the chunk products ``block[a_i, b_j] << block_bits (i + j)``."""
    side = 1 << target_bits
    mask = (1 << block_bits) - 1
    n = -(-target_bits // block_bits)
    codes = np.arange(side)
    chunks = [(codes >> (block_bits * i)) & mask for i in range(n)]
    out = np.zeros((side, side), dtype=np.int64)
    for i, ac in enumerate(chunks):
        for j, bc in enumerate(chunks):
            out += block[ac[:, None], bc[None, :]] << (block_bits * (i + j))
    return out


def peaks(kind: str, root: Path = ROOT) -> dict | None:
    """The published peaks of the device ``kind``, or None if the table
    has no row for it."""
    return _json(Path(root) / BENCH / "peaks.json")["devices"].get(kind)


def metrics_for(cell_name: str, trace: bool, root: Path = ROOT) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: its end-to-end metrics
    with ``trace`` off, its per-layer ones with it on.  An end-to-end
    metric without ``workloads`` belongs to every cell; a per-layer one
    without it to every cell that reports the metric it moves."""
    doc = benchmark(root)
    e2e = [m for m in doc["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in doc["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            and (m["moves"] in moved or "workloads" in m)]


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``, or of
    ``metrics/<metric up to its first '.'>.py`` where there is none."""
    base = Path(root) / BENCH / "metrics"
    path = base / f"{metric}.py"
    if not path.is_file():
        path = base / f"{metric.split('.')[0]}.py"
    if not path.is_file():
        raise BenchError(f"no reader for metric {metric!r} in {base}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
