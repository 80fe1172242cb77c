#!/usr/bin/env python3
"""The collectives a rematerialised layer issues, as the ``"dots"`` policy
sees them, on the host's torch (no card):

    python3 tools/remat_collectives.py [--arch ARCH ...] [--depth N]

For each arch's ``train_4k`` cell on a fake 16x16 world (meta tensors,
bf16 attention, cut to ``--depth`` layers) this runs the step under
``remat="full"`` and ``"dots"`` and prints the counter's wire bytes,
collective counts and temporary bytes, and then, for ``"dots"``, each
collective and product the policy was asked about inside a layer: the
op, whether in the forward or its recomputation, and the policy's
answer.  Which reductions land inside a layer depends on DTensor's
version, so the two remats' collectives may differ on one torch and not
on another.
"""

from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.dryrun import lower_cell, replace_layers  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append",
                    default=None, help="default: command-r-plus-104b and mixtral-8x7b")
    ap.add_argument("--depth", type=int, default=1)
    args = ap.parse_args()
    print(f"torch {torch.__version__}")
    seen: collections.Counter = collections.Counter()
    policy = lm._dots_policy

    def watched(ctx, op, *a, **kw):
        answer = policy(ctx, op, *a, **kw)
        name = str(op)
        if "c10d" in name or op in lm._DOTS:
            seen[(name, "recompute" if ctx.is_recompute else "forward",
                  answer.name)] += 1
        return answer

    lm._dots_policy = watched
    try:
        for arch in args.arch or ["command-r-plus-104b", "mixtral-8x7b"]:
            cfg = replace_layers(get_config(arch), args.depth)
            for remat in ("full", "dots"):
                seen.clear()
                counter, meta = lower_cell(arch, "train_4k", multi_pod=False, remat=remat,
                                           attn_bf16=True, cfg=cfg)
                print(f"{arch} depth {args.depth} remat={remat}: wire "
                      f"{counter.collectives.wire_bytes_total:.6g} B, collectives "
                      f"{dict(counter.collectives.counts)}, temp "
                      f"{meta['temp_size_in_bytes'] / 1e9:.4g} GB")
                for (name, phase, answer), n in sorted(seen.items()):
                    print(f"    {name} {phase} {answer} x{n}")
    finally:
        lm._dots_policy = policy


if __name__ == "__main__":
    main()
