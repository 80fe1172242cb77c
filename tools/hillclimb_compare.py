#!/usr/bin/env python3
"""The hill-climb's nine records, the port's beside the JAX package's, on
the host's CPU (no card):

    PYTHONPATH=src python -m repro_torch.experiments.hillclimb --out build/perf_torch
    python3 tools/hillclimb_compare.py build/perf_torch --reference-out build/perf_ref

For each iteration of ``repro_torch.experiments.hillclimb.STEPS`` this
runs the reference's ``run_cell`` with the same knobs and tag
(``repro.launch.dryrun``, XLA on 512 forced host devices, in a
subprocess with ``JAX_PLATFORMS=cpu``), writing its records to
``--reference-out``, and prints one JSON line with both records'
modelled terms (seconds from counts and each package's data-sheet
peaks: the port's are the H100's, the reference's a TPU's), their
per-device FLOPs, bytes, wire bytes and temporary bytes, and then a
markdown table.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.experiments.hillclimb import STEPS, _t_step  # noqa: E402

_REFERENCE = r"""
import json, sys
from repro.launch.dryrun import run_cell
for arch, shape, tag, kw in json.loads(sys.argv[1]):
    if "rules_override" in kw:
        kw["rules_override"] = {k: tuple(v) for k, v in kw["rules_override"].items()}
    rec = run_cell(arch, shape, multi_pod=False, out_dir=sys.argv[2], tag=tag, **kw)
    print(json.dumps({"tag": tag, "status": rec["status"]}), flush=True)
"""

FIELDS = ("t_compute", "t_memory", "t_collective", "hlo_flops", "hlo_bytes",
          "wire_bytes", "roofline_fraction")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("port", help="directory of the port's hill-climb records")
    ap.add_argument("--reference-out", required=True,
                    help="directory for the reference's records")
    args = ap.parse_args()
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, "-c", _REFERENCE,
                          json.dumps([list(s) for s in STEPS]), args.reference_out],
                         env=env, capture_output=True, text=True)
    if run.returncode:
        raise SystemExit(run.stderr[-3000:])
    table = ["| Iteration | t_step s port / ref | t_comp | t_mem | t_coll | "
             "FLOP a device port / ref | temp GB port / ref |",
             "| --- | --- | --- | --- | --- | --- | --- |"]
    for arch, shape, tag, _ in STEPS:
        name = f"{arch}__{shape}__16x16__{tag}.json"
        mine = json.loads((Path(args.port) / name).read_text())
        ref = json.loads((Path(args.reference_out) / name).read_text())
        row = {"arch": arch, "tag": tag, "port_status": mine["status"],
               "reference_status": ref["status"]}
        for side, rec in (("port", mine), ("reference", ref)):
            if rec["status"] == "ok":
                row.update({f"{side}_{k}": rec[k] for k in FIELDS})
                row[f"{side}_t_step"] = _t_step(rec)
                row[f"{side}_temp_size_in_bytes"] = (
                    rec.get("memory_analysis", {}).get("temp_size_in_bytes"))
        print(json.dumps(row), flush=True)

        def pair(k, fmt="{:.3g}", scale=1.0):
            a, b = row.get(f"port_{k}"), row.get(f"reference_{k}")
            return " / ".join("—" if v is None else fmt.format(v / scale) for v in (a, b))
        table.append(f"| {arch} {tag} | {pair('t_step')} | {pair('t_compute')} | "
                     f"{pair('t_memory')} | {pair('t_collective')} | "
                     f"{pair('hlo_flops', '{:.4g}')} | "
                     f"{pair('temp_size_in_bytes', '{:.2f}', 1e9)} |")
    print("\n".join(table))


if __name__ == "__main__":
    main()
