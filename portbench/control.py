"""Readings that set a cell's limit on the output check: the sound
program's widest gap over many seeds, and the float8 control's on the
first few, in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> --control <k> --seeds <n> ...

The cell is built once; each seed draws its weights into the same
buffers (so the captured step stays valid), serves the cell's own mix for
a short window at its own load, and compares a sample of what it served
with the reference, as a run does.  On the first ``k`` seeds the control,
the reference in float8, is read on the same prompts and tokens.  One
JSON line a seed.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.run import _paths  # noqa: E402


def readings(b, seeds, seconds: float, n_control: int, device):
    from portbench import check
    from portbench.drivers import serve_fixed

    n = int(b.cell["check"]["sample_requests"])
    for i, seed in enumerate(seeds):
        if i:
            b.weights.fill(seed)
        run = serve_fixed(b.engine, b.mix, b.cfg, seed, seconds, False)
        sample = check.pick(run.pool, n, seed)
        out = {"seed": seed, "sound": check.served_gap(b.cfg, b.weights.params,
                                                      b.table, sample, device)}
        if i < n_control:
            out["control"] = check.control_gap(b.cfg, b.weights.params, b.table,
                                               sample, device)
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    b = harness.build(args.workload, args.seeds[0], "cuda")
    for out in readings(b, args.seeds, args.seconds, args.control, torch.device("cuda")):
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
