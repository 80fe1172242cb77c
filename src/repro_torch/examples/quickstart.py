"""Quickstart: the paper's pipeline on one benchmark, as far as it runs
without z3.  Port of ``examples/quickstart.py``:

1. The SHARED progressive search at ET=2 on the exact 3-bit adder
   (``adder_i6``) -- left out: it needs z3.
2. The baselines: MUSCAT-like gate pruning and MECALS-like substitution
   (XPAT, the non-shared SMT template, needs z3 and is left out).
3. The hybrid (a loose SMT seed, then the tensorized minimization) --
   left out: its seed comes from ``MiterZ3``.
4. The 4-bit multiplier (``mul_i8``) pruned at ET=8 and turned into the
   LUT that serving routes matmuls through, with its error profile.

Steps 2 and 4 are host numpy, as in the reference; nothing runs on a
device.  The left-out steps are named, never filled in with another
engine's numbers.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.arith import benchmark
from repro_torch.core.baselines import mecals_like, muscat_like
from repro_torch.core.synth import area
from repro_torch.quant.lut import build_lut, exact_mul_lut

ET = 2
LEFT_OUT = "left out: the port has no {} (it needs z3)"


def main(argv: list[str] | None = None) -> dict:
    """Run the quickstart and print its report; returns the numbers it
    printed (areas in µm², errors)."""
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    exact = benchmark("adder_i6")
    out: dict = {"exact_area": area(exact)}
    print(f"benchmark=adder_i6 (3-bit adder)  exact area={out['exact_area']} µm²  ET={ET}")

    print("\n[1/4] SHARED progressive search (the paper)")
    print("  " + LEFT_OUT.format("progressive_search"))

    print("\n[2/4] baselines")
    print("  XPAT (nonshared): " + LEFT_OUT.format("progressive_search"))
    rm = muscat_like(exact, et=ET, restarts=2, wall_budget_s=30)
    print(f"  MUSCAT-like gate pruning: {rm.area} µm² (wce {rm.wce})")
    rc = mecals_like(exact, et=ET, wall_budget_s=30)
    print(f"  MECALS-like substitution: {rc.area} µm² (wce {rc.wce})")
    out.update(muscat=(rm.area, rm.wce), mecals=(rc.area, rc.wce))

    print("\n[3/4] beyond-paper hybrid (loose-SMT seed -> tensorized minimization)")
    print("  " + LEFT_OUT.format("MiterZ3, which makes the seed"))

    print("\n[4/4] 4-bit multiplier LUT for deployment (repro_torch.quant)")
    mult = benchmark("mul_i8")
    rm8 = muscat_like(mult, et=8, restarts=2, wall_budget_s=60)
    lut = build_lut(rm8.circuit)
    err = np.abs(lut - exact_mul_lut())
    exact_mul = area(mult)
    print(f"  multiplier ET=8: area {rm8.area} µm² vs exact {exact_mul} µm² "
          f"({100 * (1 - rm8.area / exact_mul):.1f}% saving)")
    print(f"  LUT max error {err.max()}, mean error {err.mean():.2f}")
    out.update(mul_area=rm8.area, mul_exact_area=exact_mul, lut=lut,
               lut_max_err=int(err.max()), lut_mean_err=float(err.mean()))
    return out


if __name__ == "__main__":
    main()
