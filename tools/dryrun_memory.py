#!/usr/bin/env python3
"""Bytes a device of every ``ok`` dry-run cell, the port's beside the
JAX package's, on the host's CPU (no card):

    python3 tools/dryrun_memory.py build/dryrun [--reference] [--multi-pod]

``build/dryrun`` holds the port's records, as
``python -m repro_torch.launch.dryrun --all --out build/dryrun`` writes
them.  For each ``ok`` record this prints one JSON line with the port's
``temp_size_in_bytes``, ``argument_size_in_bytes`` and
``output_size_in_bytes``.  With ``--reference`` each line also holds the
same three of the reference's ``lower_cell`` for the cell at full depth
(``repro.launch.dryrun``, XLA's ``memory_analysis`` of the compiled
step on 512 forced host devices), run in a subprocess with
``JAX_PLATFORMS=cpu``, and the seconds it took.  The last line is a
markdown table in GB (1e9 bytes) against the H100's 80 GB.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CARD_BYTES = 80e9
KEYS = ("temp_size_in_bytes", "argument_size_in_bytes", "output_size_in_bytes")

_REFERENCE = r"""
import json, sys, time
from repro.launch import dryrun as D
for arch, shape, multi_pod in json.loads(sys.argv[1]):
    t0 = time.time()
    compiled, _ = D.lower_cell(arch, shape, multi_pod=multi_pod)
    mem = compiled.memory_analysis()
    print(json.dumps({"arch": arch, "shape": shape,
                      **{k: int(getattr(mem, k)) for k in json.loads(sys.argv[2])},
                      "seconds": round(time.time() - t0, 1)}), flush=True)
"""


def reference(cells: list[tuple[str, str, bool]]) -> dict:
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(cells),
                          json.dumps(KEYS)], env=env, capture_output=True, text=True)
    if run.returncode:
        raise SystemExit(run.stderr[-3000:])
    rows = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    return {(r["arch"], r["shape"]): r for r in rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("records", help="directory of the port's dry-run records")
    ap.add_argument("--reference", action="store_true",
                    help="also run the JAX package's lower_cell for each cell")
    ap.add_argument("--multi-pod", action="store_true", help="the 2x16x16 records")
    args = ap.parse_args()
    mesh = "2x16x16" if args.multi_pod else "16x16"
    recs = [json.loads(p.read_text())
            for p in sorted(Path(args.records).glob(f"*__{mesh}.json"))]
    recs = [r for r in recs if r["status"] == "ok"]
    ref = (reference([(r["arch"], r["shape"], args.multi_pod) for r in recs])
           if args.reference else {})
    table = ["| Cell | Port temp GB | Reference temp GB | Port / reference args GB | "
             "Port / reference outputs GB | Port temp + args, share of 80 GB |",
             "| --- | --- | --- | --- | --- | --- |"]
    for r in recs:
        mem = r["memory_analysis"]
        want = ref.get((r["arch"], r["shape"]), {})
        row = {"arch": r["arch"], "shape": r["shape"], "mesh": mesh,
               **{f"port_{k}": mem.get(k) for k in KEYS},
               **{f"reference_{k}": want.get(k) for k in KEYS},
               "reference_seconds": want.get("seconds")}
        print(json.dumps(row), flush=True)

        def gb(v):
            return "—" if v is None else f"{v / 1e9:.2f}"
        table.append(
            f"| {r['arch']} {r['shape']} | {gb(mem.get(KEYS[0]))} | {gb(want.get(KEYS[0]))} | "
            f"{gb(mem.get(KEYS[1]))} / {gb(want.get(KEYS[1]))} | "
            f"{gb(mem.get(KEYS[2]))} / {gb(want.get(KEYS[2]))} | "
            f"{(mem.get(KEYS[0], 0) + mem.get(KEYS[1], 0)) / CARD_BYTES:.3f} |")
    print("\n".join(table))


if __name__ == "__main__":
    main()
