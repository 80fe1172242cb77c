"""One run of one cell: set-up, the measured window, the output check
and the metrics, as the result line's fields.

Set-up is everything from the process's start to the first timed step:
imports, CUDA's start, the kernel libraries (built on a checkout's first
run, loaded from ``build/repro_torch_kernels/`` after), the weights made
on the device, the engine and its decode step captured as a CUDA graph
(the capture warms the step up first).  The window follows
(:mod:`portbench.drivers`); the peak of device memory is read when it
closes; then the program's state is freed and the reference checks the
served tokens in the memory it leaves.
"""

from __future__ import annotations

import gc
import math
import time
from types import SimpleNamespace

from . import check, counts, loader, program
from .drivers import serve_fixed
from .weights import Weights


def build(cell_name: str, seed: int, device, root=loader.ROOT):
    """The cell's parts, its weights drawn from ``seed`` and its engine
    built with the step captured."""
    cell = loader.cell(cell_name, root)
    cfg = loader.config(cell["config"], root)
    mix = loader.traffic(cell["traffic"], root)
    table = loader.table(cfg["table"], root) if cfg.get("table") else None
    mc = program.model_config(cfg, table)
    weights = Weights(cfg, device)
    weights.fill(seed)
    engine = program.fixed_engine(mc, weights.params, mix, table, device)
    engine.static_step   # captured now, as set-up
    return SimpleNamespace(cell=cell, cfg=cfg, mix=mix, table=table,
                           weights=weights, engine=engine)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda", root=loader.ROOT) -> dict:
    import torch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    b = build(cell_name, seed, dev, root)
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    run = serve_fixed(b.engine, b.mix, b.cfg, seed, seconds, trace)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    del b.engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    chk = b.cell["check"]
    sample = check.pick(run.pool, int(chk["sample_requests"]), seed)
    got = check.served_gap(b.cfg, b.weights.params, b.table, sample, dev)
    limit = chk.get("mean_gap")
    checks = {
        "mean_gap": {"value": got["mean_gap"] if math.isfinite(got["mean_gap"]) else None,
                     "limit": limit},
        "tokens_compared": {"value": got["tokens"],
                            "limit": int(chk["sample_requests"]) * int(b.mix["gen_len"])},
    }
    correct = (limit is not None and got["mean_gap"] <= limit
               and got["tokens"] >= checks["tokens_compared"]["limit"])

    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    ctx = SimpleNamespace(run=run, cfg=b.cfg, mix=b.mix, setup_s=setup_s,
                          dims=counts.dims(b.cfg), peaks=loader.peaks(kind, root))
    metrics = {}
    for m in loader.metrics_for(cell_name, trace, root):
        value = loader.reader(m["name"], root)(ctx)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    # a batch that fails raises, and the run prints no line
    line = {"correct": bool(correct), "attempted": run.attempted,
            "failed": 0, "metrics": metrics,
            "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                       "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and run.trace is not None:
        line["device"]["busy_s"] = run.trace.busy_s
        line["device"]["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    line["checks"] = checks
    return line
