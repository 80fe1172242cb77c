#!/usr/bin/env python3
"""Per-rank bytes that the MoE dispatch holds replicated under a mesh:

    python3 tools/moe_gather_bytes.py [--shape train_4k] [--microbatches 1]

``repro_torch.models.layers.moe_ffn`` gathers through
``repro_torch.parallel.api.take``, which replicates the gather's source
on every rank and returns its output replicated.  For each MoE config
at the shape's global batch this prints one JSON line with the bytes a
rank then holds for one layer, counted from the config's shapes (no
tensor is made):

- ``flat``: the tokens ``(T, D)``, the source of the dispatch's gather;
- ``ys``: the expert outputs ``(E, C, D)``, the source of the combine's;
- ``xs``: the dispatch's output ``(E, C, D)``, before it is resharded;
- ``picked``: the combine's output ``(T * K, D)``, and ``picked_f32`` its
  float32 copy, before the picks are sharded over ``batch``.

The backward holds a gradient of each source the size of the source.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402


def gather_bytes(cfg, tokens: int) -> dict:
    mo = cfg.moe
    T, D, K, E = tokens, cfg.d_model, mo.top_k, mo.n_experts
    C = T * K if mo.impl == "ragged" else max(1, math.ceil(T * K / E * mo.capacity_factor))
    item = cfg.torch_dtype.itemsize
    return {"T": T, "D": D, "E": E, "K": K, "C": C,
            "flat": T * D * item, "ys": E * C * D * item, "xs": E * C * D * item,
            "picked": T * K * D * item, "picked_f32": T * K * D * 4}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args()
    shape = SHAPES[args.shape]
    tokens = shape.global_batch * shape.seq_len // args.microbatches
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.moe is None:
            continue
        row = gather_bytes(cfg, tokens)
        row["sources"] = row["flat"] + row["ys"]
        print(json.dumps({"arch": arch, "shape": args.shape, **row}), flush=True)


if __name__ == "__main__":
    main()
