#!/usr/bin/env python3
"""The storages a dry-run cell holds at its temporary peak, by op, shape
and bytes, on the host's CPU (no card):

    python3 tools/dryrun_peak.py --arch qwen3-4b --shape decode_32k \
        [--depth N] [--multi-pod] [--top 20]

Runs the cell's step once, as ``repro_torch.launch.dryrun.lower_cell``
does (a fake world, meta tensors), under a subclass of its
``CostCounter`` that also notes, for each storage the counted ops
allocate, the op that allocated it and the tensor's shape and dtype.
At the peak of the counter's live-storage record (the cell's
``temp_size_in_bytes``, its outputs left out) it prints the live storages
grouped by (op, shape, dtype), largest first, in GB (1e9 bytes) a
device.  ``--depth`` cuts the model to N layers (the time-loop families'
train and prefill cells take hours at full depth); the default is the
full depth.  The last line is one JSON object with the cell, its
temporary bytes and the groups.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from torch.utils._pytree import tree_leaves  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402


class PeakCounter(analysis.CostCounter):
    """A ``CostCounter`` that keeps, for each storage its record holds,
    ``(op, shape, dtype)`` of the tensor that brought it, and the
    storages live at the peak ``temp_bytes`` reads."""

    last: "PeakCounter | None" = None

    def __init__(self, **kw):
        super().__init__(**kw)
        self.what: dict[int, tuple[str, tuple, str]] = {}
        self.at_peak: list[tuple[int, int]] = []
        self._func = None
        PeakCounter.last = self
        record = self.memory.allocated

        def allocated(operands, out):
            first = len(self.memory.events)
            record(operands, out)
            for t in tree_leaves(out):
                tok = self.memory.live.get(id(getattr(t, "untyped_storage", lambda: None)()))
                if tok is not None and tok >= first:
                    self.what[tok] = (str(self._func), tuple(t.shape), str(t.dtype))
        self.memory.allocated = allocated

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._func = func
        return super().__torch_dispatch__(func, types, args, kwargs)

    def temp_bytes(self, outputs=()) -> int:
        top = super().temp_bytes(outputs)
        from torch.distributed.tensor import DTensor

        skip = set()
        for t in tree_leaves(outputs):
            if hasattr(t, "untyped_storage"):
                t = t.to_local() if isinstance(t, DTensor) else t
                skip.add(self.memory.live.get(id(t.untyped_storage())))
        cur, live, sizes = 0, set(), {}
        for tok, n in self.memory.events:
            if tok in skip:
                continue
            cur += n
            if n > 0:
                live.add(tok)
                sizes[tok] = n
            else:
                live.discard(tok)
            if cur == top:
                self.at_peak = [(tok_, sizes[tok_]) for tok_ in sorted(live)]
                break
        return top


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--depth", type=int, default=None, help="layers (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.depth is not None:
        cfg = dryrun.replace_layers(cfg, args.depth)
    original, analysis.CostCounter = analysis.CostCounter, PeakCounter
    try:
        _, meta = dryrun.lower_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                                    cfg=cfg)
    finally:
        analysis.CostCounter = original
    c = PeakCounter.last
    groups: dict = defaultdict(lambda: [0, 0])
    for tok, n in c.at_peak:
        g = groups[c.what.get(tok, ("?", (), "?"))]
        g[0] += 1
        g[1] += n
    rows = sorted(groups.items(), key=lambda kv: -kv[1][1])
    temp = meta["temp_size_in_bytes"]
    print(f"{args.arch} {args.shape} ({cfg.n_layers} layers): temporary "
          f"{temp / 1e9:.3f} GB a device, {len(c.at_peak)} storages live at the peak")
    print(f"{'GB':>9} {'count':>6}  op, shape, dtype")
    for (op, shape, dtype), (count, n) in rows[:args.top]:
        print(f"{n / 1e9:9.4f} {count:6d}  {op} {list(shape)} {dtype}")
    print(json.dumps({"arch": args.arch, "shape": args.shape, "layers": cfg.n_layers,
                      "temp_size_in_bytes": temp,
                      "groups": [{"op": op, "shape": list(shape), "dtype": dtype,
                                  "count": count, "bytes": n}
                                 for (op, shape, dtype), (count, n) in rows]}))


if __name__ == "__main__":
    main()
