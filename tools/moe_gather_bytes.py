#!/usr/bin/env python3
"""Per-rank bytes that the MoE dispatch holds under the production mesh:

    python3 tools/moe_gather_bytes.py [--shape train_4k] [--microbatches 1]

``repro_torch.models.layers.moe_ffn`` lays its blocks out as the
reference's ``shard`` calls name them: experts over ``expert`` (``data``)
when ``E`` divides its extent, else the slots over ``batch``.  Each rank
gathers its own blocks' rows of the tokens
(``repro_torch.parallel.api.gather_rows``) and adds its gated outputs
into a whole float32 result that is reduce-scattered back over ``batch``
(``scatter_rows``).  For each MoE config at the shape's global batch on
16x16 (``data`` 16) this prints one JSON line with the bytes a rank holds
for one layer, counted from the config's shapes (no tensor is made):

- ``flat_gathered``: the tokens ``(T, D)`` all-gathered for the dispatch,
  alive only inside it (its backward's gradient the same size);
- ``xs`` and ``ys``: the rank's share of the ``(E, C, D)`` blocks, in and
  out of the experts, and ``vals_f32`` the gated outputs in float32;
- ``combine_f32``: the whole ``(T, D)`` float32 sum before its
  reduce-scatter, alive only inside the combine (its backward gathers a
  gradient the same size);
- ``block_whole`` and ``picked_whole``: the ``(E, C, D)`` block and the
  ``(T * K, D)`` picks whole, which no rank now holds.
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

DATA = 16      # the production mesh's data extent (16x16)


def dispatch_bytes(cfg, tokens: int, data: int = DATA) -> dict:
    mo = cfg.moe
    T, D, K, E = tokens, cfg.d_model, mo.top_k, mo.n_experts
    C = T * K if mo.impl == "ragged" else max(1, math.ceil(T * K / E * mo.capacity_factor))
    item = cfg.torch_dtype.itemsize
    ep = E % data == 0
    share = (E // data) * C if ep else E * (C // data if C % data == 0 else C)
    return {"T": T, "D": D, "E": E, "K": K, "C": C,
            "layout": "experts over data" if ep else "slots over batch",
            "flat_gathered": T * D * item, "xs": share * D * item, "ys": share * D * item,
            "vals_f32": share * D * 4, "combine_f32": T * D * 4,
            "block_whole": E * C * D * item, "picked_whole": T * K * D * item}


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
        row = dispatch_bytes(cfg, tokens)
        print(json.dumps({"arch": arch, "shape": args.shape, **row}), flush=True)


if __name__ == "__main__":
    main()
