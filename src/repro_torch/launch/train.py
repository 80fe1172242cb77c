"""Training launcher: config -> (restore?) -> step loop -> checkpoints.

Own copy of ``repro.launch.train``: the same flags, defaults and printed
lines, plus ``--device`` (the card by default; ``--device cpu --reduced``
runs on the CPU).  One card, so no mesh.  The data pipeline is a pure
function of ``(seed, step)`` (:mod:`repro_torch.train.data`), so a run
checkpointed every ``--ckpt-every`` steps and restarted resumes from
``LATEST`` bit for bit.

The step differentiates the plain route (:mod:`repro_torch.train.step`):
no kernel launches while training.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b --steps 100
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..device import resolve_device
from ..models import init_model
from ..train import (
    DataState, OptimizerConfig, checkpoint, init_opt_state, make_train_step,
    next_batch,
)
from ..train.optim import tree_leaves


def main(argv=None) -> dict:
    """Run the CLI; returns the run's summary: the final ``params`` and
    ``opt_state``, per-step ``losses`` and ``grad_norms``, ``n_params``,
    ``start`` (the step resumed from) and ``step_ms``, each step's time
    (by CUDA events on a card, by the host clock on the CPU)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs on the CPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=max(1, args.steps // 10),
                              total_steps=args.steps)

    params = init_model(cfg, args.seed, device=dev)
    opt_state = init_opt_state(params)
    ds = DataState(seed=args.seed, step=0)
    start = 0
    if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
        params, opt_state, meta, start = checkpoint.restore(
            args.ckpt_dir, params, opt_state)
        ds = DataState.from_dict(meta["data_state"])
        print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              remat=args.remat)

    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    losses, gnorms, step_ms = [], [], []
    t0 = time.time()
    for step in range(start, args.steps):
        batch, ds = next_batch(cfg, args.batch, args.seq, ds, device=dev)
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        ts = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if dev.type == "cuda":
            ev[1].record()
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        step_ms.append(ev[0].elapsed_time(ev[1]) if dev.type == "cuda"
                       else 1e3 * (time.perf_counter() - ts))
        if (step + 1) % args.log_every == 0:
            dt = (time.time() - t0) / (step + 1 - start)
            print(f"step {step+1:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {gnorms[-1]:.3f}  "
                  f"lr {float(metrics['lr']):.2e}  {dt*1e3:.0f} ms/step",
                  flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, step + 1, params, opt_state,
                            data_state=ds.as_dict())

    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, args.steps, params, opt_state,
                        data_state=ds.as_dict())
    first = np.mean(losses[: max(1, len(losses) // 10)])
    last = np.mean(losses[-max(1, len(losses) // 10):])
    print(f"done: loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "grad_norms": gnorms, "step_ms": step_ms, "n_params": n_params,
            "start": start}


if __name__ == "__main__":
    main()
