"""End-to-end training example: train a ~100M-parameter qwen3-family model
for a few hundred steps on the synthetic pipeline, with checkpoints, on
the card unless given ``--device cpu``.  Exits 1 when the loss did not
improve.

It runs the port's train step and checkpoints (:mod:`repro_torch.train`)
with a mid-size config, field for field the reference example's.

    PYTHONPATH=src python -m repro_torch.examples.train_small [--steps 300]
"""

import argparse
import dataclasses
import os
import sys
import tempfile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_model
from repro_torch.train import (
    DataState, OptimizerConfig, checkpoint, init_opt_state, make_train_step,
    next_batch,
)
from repro_torch.train.optim import tree_leaves


def small_config():
    """~100M params: qwen3 family, narrow-deep, small vocab."""
    return dataclasses.replace(
        get_config("qwen3-4b"),
        name="qwen3-100m",
        n_layers=8, d_model=640, n_heads=10, n_kv_heads=5, head_dim=64,
        d_ff=1792, vocab_size=32000,
    )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_small"))
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs on the CPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = small_config()
    params = init_model(cfg, 0, device=dev)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"{cfg.name}: {n/1e6:.1f}M params, {args.steps} steps "
          f"@ batch {args.batch}x{args.seq}")

    opt_cfg = OptimizerConfig(lr=6e-4, warmup_steps=30, total_steps=args.steps)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg, remat="none")
    ds = DataState(seed=0, step=0)

    losses = []
    for step in range(args.steps):
        batch, ds = next_batch(cfg, args.batch, args.seq, ds, device=dev)
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if (step + 1) % 20 == 0:
            print(f"  step {step+1:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}", flush=True)
        if (step + 1) % 100 == 0 or step + 1 == args.steps:
            checkpoint.save(args.ckpt_dir, step + 1, params, opt_state,
                            data_state=ds.as_dict())

    first, last = losses[0], sum(losses[-20:]) / 20
    print(f"loss {first:.3f} -> {last:.3f}")
    if last >= first:
        print("WARNING: loss did not improve", file=sys.stderr)
        sys.exit(1)
    print(f"checkpoints in {args.ckpt_dir} "
          f"(latest step {checkpoint.latest_step(args.ckpt_dir)})")


if __name__ == "__main__":
    main()
