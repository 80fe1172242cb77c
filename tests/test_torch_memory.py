"""PyTorch port: what the dry-run's memory count holds, on reduced configs
and fake worlds (``repro_torch.launch.dryrun``, ``launch.analysis``).

A cell's record does not depend on what ran before it in the process
(DTensor's sharding propagation, which builds a fake mesh once a process
and runs a decomposed op on it, is hidden from the counter as all of its
planning is).  ``tools/dryrun_peak.py`` lists the storages live at a
cell's peak, which add up to its temporary bytes.  Where ``model``
divides the query heads but not the KV heads, each rank takes only the KV
heads of its own query heads (``parallel.api.select_on_shards``): no rank
builds every query head's keys, and on four gloo ranks the train step
equals the plain step.  RWKV6's train cell holds less through the WKV
scan's autograd function than through autograd over its loop.
"""

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.models import init_model, layers, lm  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.train.optim import tree_leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ShapeConfig("tiny_train", 16, 8, "train")
DECODE = ShapeConfig("tiny_decode", 16, 32, "decode")
TIMES = ("wall_s", "lower_s", "compile_s")

_CELLS = r"""
import json, sys, tempfile
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig
shape = ShapeConfig("tiny_train", 16, 8, "train")
for arch in sys.argv[1:]:
    with tempfile.TemporaryDirectory() as d:
        cfg = dryrun.replace_layers(get_config(arch, reduced=True), 4)
        rec = dryrun.run_cell(arch, shape.name, multi_pod=False, out_dir=d,
                              cfg=cfg, shape=shape, mesh_dims=(4, 4))
    print(json.dumps(rec))
"""


def cells_in_one_process(*archs: str) -> list[dict]:
    """``run_cell`` for each reduced arch's train cell at 4 layers on
    4 x 4 (extrapolated from depths 1 and 2, so that what the first run of
    a process counts alone shows), in that order in one fresh process; the
    records without their times."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    run = subprocess.run([sys.executable, "-c", _CELLS, *archs], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    recs = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    return [{k: v for k, v in r.items() if k not in TIMES} for r in recs]


def test_a_cell_after_another_counts_as_it_does_alone():
    """Reduced mixtral's train record, counted after reduced deepseek's in
    the same process, equals its record counted first in a fresh process,
    to the byte: FLOPs, bytes, collectives and every memory size."""
    (alone,) = cells_in_one_process("mixtral-8x7b")
    _, after = cells_in_one_process("deepseek-v2-lite-16b", "mixtral-8x7b")
    assert alone["status"] == after["status"] == "ok"
    assert after == alone


def load_peak_tool():
    spec = importlib.util.spec_from_file_location("dryrun_peak",
                                                  ROOT / "tools" / "dryrun_peak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counted_cell(arch: str, shape: ShapeConfig, cfg=None, mesh_dims=(4, 4)):
    """``lower_cell`` under the peak tool's counter: (counter, meta)."""
    tool = load_peak_tool()
    original, analysis.CostCounter = analysis.CostCounter, tool.PeakCounter
    try:
        _, meta = dryrun.lower_cell(arch, shape.name, multi_pod=False,
                                    cfg=cfg or get_config(arch, reduced=True),
                                    shape=shape, mesh_dims=mesh_dims)
    finally:
        analysis.CostCounter = original
    return tool.PeakCounter.last, meta


@pytest.mark.parametrize("arch,shape", [("qwen3-4b", DECODE), ("hymba-1.5b", TRAIN)])
def test_peak_listing_adds_up_to_the_temporary_bytes(arch, shape):
    """The storages ``tools/dryrun_peak.py`` lists at a cell's peak add up
    to the cell's ``temp_size_in_bytes``, and each has the op and shape
    that brought it."""
    c, meta = counted_cell(arch, shape)
    assert meta["temp_size_in_bytes"] > 0
    assert sum(n for _, n in c.at_peak) == meta["temp_size_in_bytes"]
    assert all(tok in c.what for tok, _ in c.at_peak)


def test_decode_ranks_take_only_their_own_kv_heads():
    """Reduced qwen3-4b (4 query heads over 2 KV heads) decoding on a 4 x 4
    world, where ``model`` divides the query heads only: no op builds a
    rank-local tensor of every query head's cached keys or values (the
    repeat of all KV heads did, (B, C, 2, 2, hd) or (B, C, 4, hd)), and the
    keys each rank selects are its own query head's, (B, C, 1, hd)."""
    c, meta = counted_cell("qwen3-4b", DECODE)
    B, C, hd = DECODE.global_batch // 4, DECODE.seq_len, 16
    shapes = {shape for _, shape, _ in c.what.values()}
    assert (B, C, 2, 2, hd) not in shapes and (B, C, 4, hd) not in shapes
    assert (B, C, 1, hd) in shapes


def rwkv_cfg(n_heads: int = 3):
    cfg = get_config("rwkv6-3b", reduced=True)
    return dataclasses.replace(cfg, d_model=16 * n_heads, n_heads=n_heads,
                               n_kv_heads=n_heads)


def test_rwkv_train_cell_holds_less_through_the_scan_function(monkeypatch):
    """Reduced rwkv6 with 3 heads of 16 on a 4 x 4 world (its scan split
    by value columns): the train cell's temporary bytes through the WKV
    scan's autograd function stay below those through autograd over the
    plain loop, at the same FLOPs within 2% (the function's backward runs
    one product a step more)."""
    shape = ShapeConfig("tiny_train", 16, 32, "train")
    c, got = counted_cell("rwkv6-3b", shape, rwkv_cfg())
    got_flops = c.flops
    monkeypatch.setattr(layers, "wkv_scan", layers._rwkv_wkv_scan)
    c, loop = counted_cell("rwkv6-3b", shape, rwkv_cfg())
    assert got["temp_size_in_bytes"] < loop["temp_size_in_bytes"]
    assert abs(got_flops - c.flops) <= 0.02 * c.flops


# (arch, mesh extents over ("data", "model")): "model" = 4 divides the 4
# query heads and not the 2 KV heads
GQA_GLOO = [("qwen3-4b", (1, 4)), ("mixtral-8x7b", (1, 4))]
GQA_GLOO_ATOL = 2e-6


def _gqa_gloo_rank(rank: int, store_path: str, results: str) -> None:
    """One rank of a four-rank gloo world: each ``GQA_GLOO`` case's
    reduced train loss and gradients (float32) on DTensors laid out by the
    dry-run's specs, against the same step without a mesh, and how often
    each rank selected its own KV heads."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import parallel
    from repro_torch.launch.dryrun import _distribute
    from repro_torch.parallel import specs

    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4), rank=rank,
                            world_size=4)
    calls = []
    select = layers.select_on_shards

    def spy(x, dim, index):
        calls.append(dim)
        return select(x, dim, index)

    def loss_and_grads(cfg, p, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        loss = lm.lm_loss(cfg, live, batch, backend="ref", device="cpu")
        return loss, torch.autograd.grad(loss, tree_leaves(live))

    try:
        got = []
        for arch, ext in GQA_GLOO:
            cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
            params = init_model(cfg, 0, device="cpu")
            tokens = torch.as_tensor(np.random.default_rng(0).integers(
                0, cfg.vocab_size, (TRAIN.global_batch, TRAIN.seq_len)), dtype=torch.int32)
            want, want_grads = loss_and_grads(cfg, params, {"tokens": tokens})
            m = init_device_mesh("cpu", ext, mesh_dim_names=("data", "model"))
            calls.clear()
            layers.select_on_shards = spy
            try:
                with parallel.activate(m) as ctx, implicit_replication():
                    p_d = _distribute(params, specs.named(m, specs.param_specs(ctx, params)), m)
                    b_spec = specs.batch_specs(cfg, TRAIN, ctx)["tokens"]
                    t_d = distribute_tensor(tokens, m, parallel.api.placements(b_spec, m))
                    loss, grads = loss_and_grads(cfg, p_d, {"tokens": t_d})
                    loss = loss.full_tensor()
                    grads = [g.full_tensor() for g in grads]
            finally:
                layers.select_on_shards = select
            got.append({"loss": float((loss - want).abs()),
                        "grad": max(float((g - w).abs().max())
                                    for g, w in zip(grads, want_grads)),
                        "scale": max(float(w.abs().max()) for w in want_grads),
                        "selects": len(calls)})
        with open(f"{results}.{rank}", "w") as f:
            f.write(json.dumps(got))
    finally:
        dist.destroy_process_group()


def test_gqa_train_step_on_four_gloo_ranks_matches_the_plain_step(tmp_path):
    """On a four-rank gloo world with ``model`` = 4, reduced qwen3-4b's and
    mixtral-8x7b's train steps select each rank's KV heads (keys and
    values, each layer), and their loss and every gradient equal the plain
    step within ``GQA_GLOO_ATOL``: the gradient of the whole KV heads is a
    partial sum over ``model``."""
    import torch.multiprocessing as mp

    mp.start_processes(_gqa_gloo_rank,
                       args=(str(tmp_path / "store"), str(tmp_path / "gqa")),
                       nprocs=4, join=True, start_method="spawn")
    for rank in range(4):
        got = json.loads((tmp_path / f"gqa.{rank}").read_text())
        assert len(got) == len(GQA_GLOO)
        for (arch, _), g in zip(GQA_GLOO, got):
            n_layers = get_config(arch, reduced=True).n_layers
            assert g["selects"] == 2 * n_layers, (arch, g)
            assert g["loss"] <= GQA_GLOO_ATOL, (arch, g)
            assert g["grad"] <= GQA_GLOO_ATOL, (arch, g)
            assert g["scale"] > 1e-3, (arch, g)
