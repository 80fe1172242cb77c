"""Approximate-arithmetic inference screening on the port.

Two modes, as ``examples/approx_inference.py`` of the reference:

* **ad-hoc** (default): synthesize a few approximate 4-bit multipliers
  in-process, build their LUTs, and measure logit drift when a real
  model's MLP matmuls route through them.

* **library + QoS** (``--library <dir> [--qos-budget B]``): load the
  Pareto frontier of operators a previous search persisted (``python -m
  repro_torch.fleet --library <dir>`` or ``python -m
  repro_torch.core.search --library <dir>``), compile each to the 16x16
  LUT the approx_matmul kernel consumes, *measure per-layer sensitivity*
  through :mod:`repro_torch.sensitivity.profile` (the same measured code
  path the serve launcher's ``--profile`` consumes), and let the QoS
  selector assign each layer the smallest operator that keeps predicted
  drift within budget — then run the model on the resulting per-layer
  plan and report what each layer used
  (:func:`repro_torch.launch.analysis.plan_report`).

    PYTHONPATH=src python -m repro_torch.examples.approx_inference \
        --library runs/lib --qos-budget 0.02

Runs on the card unless given ``--device cpu``; weights are random, made
from a seed by the port's own init.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.arith import benchmark
from repro_torch.core.baselines import muscat_like
from repro_torch.core.synth import area
from repro_torch.device import resolve_device
from repro_torch.models import forward_fn, init_model
from repro_torch.quant.lut import build_lut, exact_mul_lut


def make_model(arch: str, reduced: bool, device: torch.device, seed: int = 0):
    cfg = get_config(arch, reduced=reduced).with_approx_mlp()
    params = init_model(cfg, seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                                     device=device)}
    fwd = forward_fn(cfg)

    def logits(lut) -> torch.Tensor:
        with torch.no_grad():
            return fwd(cfg, params, batch, lut=lut, device=device)[0]

    return cfg, params, batch, logits


def adhoc_main(args, dev: torch.device) -> None:
    """The original screening flow: one-shot in-process operators."""
    exact_mult = benchmark("mul_i8")
    print(f"exact 4-bit multiplier area: {area(exact_mult)} µm²")
    luts = {}
    for et in (2, 8, 32):
        res = muscat_like(exact_mult, et=et, restarts=2, wall_budget_s=45)
        luts[et] = (build_lut(res.circuit), res.area)
        print(f"  ET={et:3d}: area {res.area} µm² "
              f"({100*(1-res.area/area(exact_mult)):.0f}% saving)")

    cfg, _, _, logits = make_model(args.arch, args.reduced, dev)
    logits_f = logits(None)
    logits_q = logits(exact_mul_lut())

    print(f"\nmodel={cfg.name}  (MLP matmuls -> W4A4 with LUT multiplier)")
    print(f"  int4 quantization alone: mean |Δlogit| = "
          f"{float((logits_f - logits_q).abs().mean()):.4f}")

    base_top1 = logits_q.argmax(-1)
    for et, (lut, a) in luts.items():
        logits_a = logits(lut)
        drift = float((logits_q - logits_a).abs().mean())
        agree = float((logits_a.argmax(-1) == base_top1).float().mean())
        print(f"  ET={et:3d}: extra drift {drift:.4f}, "
              f"top-1 agreement {100*agree:.1f}%, area saving "
              f"{100*(1 - a/area(exact_mult)):.0f}%")

    print("\n-> the area/accuracy tradeoff the paper navigates, measured on "
          "a real architecture instead of operator error alone.")


def library_main(args, dev: torch.device) -> None:
    """Frontier-driven per-layer QoS selection from a persisted library."""
    from repro_torch.launch.analysis import plan_report
    from repro_torch.library import load_mul_frontier, select_plan, stack_luts
    from repro_torch.library.compile import compile_cache_stats
    from repro_torch.sensitivity.profile import measure_cost_matrix

    try:
        compiled, exact_area, bits = load_mul_frontier(args.library)
    except LookupError as e:
        raise SystemExit(str(e))
    print(f"library {args.library}: {len(compiled)} operator(s) on the "
          f"{bits}-bit multiplier frontier (exact area {exact_area} µm²):")
    for rec, comp in compiled:
        print(f"  {rec.key}  src={rec.source:<7s} area {rec.area:>7.3f} µm² "
              f"wce={rec.wce:<3d} -> compiled 16x16 LUT "
              f"wce16={comp.wce16} mae16={comp.mae16:.4f}")

    cfg, params, batch, logits = make_model(args.arch, args.reduced, dev)
    base = logits(exact_mul_lut())
    base_top1 = base.argmax(-1)
    L = cfg.n_layers

    # per-(layer, operator) drift, measured one probe at a time through the
    # shared sensitivity pipeline; `python -m repro_torch.sensitivity.profile
    # --library ...` persists the same measurement for the serve launcher
    print(f"\nmeasuring per-(layer, operator) drift on {cfg.name} "
          f"({L} layers x {len(compiled)} operators)...")
    costs = measure_cost_matrix(cfg, params, batch, compiled, device=dev)
    print("  drift matrix (layers x operators):")
    print(np.array2string(costs, precision=4, suppress_small=True))

    plan = select_plan(compiled, costs, args.qos_budget, exact_area=exact_area)
    print(f"\nQoS plan under budget {args.qos_budget} "
          f"(mean |Δlogit| vs int4-exact):")
    print(plan_report(plan))

    logits_p = logits(stack_luts(plan, compiled))
    drift = float((logits_p - base).abs().mean())
    agree = float((logits_p.argmax(-1) == base_top1).float().mean())
    cs = compile_cache_stats()
    print(f"\nmeasured drift {drift:.5f} (predicted {plan.predicted_total:.5f}), "
          f"top-1 agreement {100*agree:.1f}%")
    print(f"compile cache: {cs['hits']} hits / {cs['misses']} misses "
          f"({cs['size']} table(s))")
    print("-> per-layer operators selected from the persisted frontier, "
          "compiled to LUTs, routed through approx_matmul.")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    # reduced by default: the plain invocation stays small
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--library", default=None,
                    help="operator-store directory (enables the QoS flow)")
    ap.add_argument("--qos-budget", type=float, default=0.05,
                    help="allowed mean |Δlogit| vs the int4-exact baseline")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.library:
        library_main(args, dev)
    else:
        adhoc_main(args, dev)


if __name__ == "__main__":
    main()
