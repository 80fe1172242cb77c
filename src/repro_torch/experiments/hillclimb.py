"""The perf hill-climb: baseline -> iterations for the 3 selected pairs.

Own copy of the reference's ``experiments/hillclimb.py``.  Each iteration
runs the dry-run cell (:func:`repro_torch.launch.dryrun.run_cell`) with
one change enabled and writes its record under a tagged file name in
``experiments/perf_torch/``.  Per-pair results are reported through
:class:`~repro_torch.core.engine.SearchOutcome`, the type the operator
searches emit, so winner selection is its generic ``pareto``/``min_by``
machinery: the Pareto iterations over (modelled step time, bytes
accessed) and the fastest.  The times are the roofline's modelled terms
from counts and the H100's data-sheet peaks, not measurements.

    PYTHONPATH=src python -m repro_torch.experiments.hillclimb [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable

from ..core.engine import SearchOutcome
from ..launch.dryrun import run_cell
from ..models.config import ModelConfig, ShapeConfig

OUT = os.path.join("experiments", "perf_torch")

# (arch, shape, tag, kwargs) -- it0 is the re-measured baseline for exact
# comparability (identical harness, post-baseline-archive code).
STEPS = [
    # -------- pair 1: deepseek-v2-lite x train_4k (worst, collective-bound)
    ("deepseek-v2-lite-16b", "train_4k", "it1_blocked_noEP",
     dict(rules_override={"expert_fsdp": ()})),
    ("deepseek-v2-lite-16b", "train_4k", "it2_blocked_EP", dict()),
    ("deepseek-v2-lite-16b", "train_4k", "it3_EP_bf16attn",
     dict(attn_bf16=True)),
    # -------- pair 2: mixtral x train_4k (paper-representative, collective)
    ("mixtral-8x7b", "train_4k", "it1_blocked", dict()),
    ("mixtral-8x7b", "train_4k", "it2_blocked_bf16attn", dict(attn_bf16=True)),
    ("mixtral-8x7b", "train_4k", "it3_blocked_bf16_dots",
     dict(attn_bf16=True, remat="dots")),
    # -------- pair 3: command-r-plus x train_4k (memory-bound dense)
    ("command-r-plus-104b", "train_4k", "it1_bf16attn", dict(attn_bf16=True)),
    ("command-r-plus-104b", "train_4k", "it2_bf16_dots",
     dict(attn_bf16=True, remat="dots")),
    ("command-r-plus-104b", "train_4k", "it3_bf16_dots_mb4",
     dict(attn_bf16=True, remat="dots", microbatches=4)),
]


def _t_step(rec: dict) -> float:
    return max(rec["t_compute"], rec["t_memory"], rec["t_collective"])


def add_record(by_pair: dict[tuple, SearchOutcome], arch: str, shape_name: str,
               tag: str, rec: dict) -> SearchOutcome:
    """Count one iteration's record into its pair's outcome (made on the
    pair's first record); an ``ok`` record joins the results, tagged."""
    outcome = by_pair.setdefault(
        (arch, shape_name),
        SearchOutcome(engine="perf_hillclimb", benchmark=f"{arch}/{shape_name}",
                      stats={"iterations": 0, "errors": 0}),
    )
    outcome.stats["iterations"] += 1
    if rec["status"] == "ok":
        outcome.results.append({**rec, "tag": tag})
    else:
        outcome.stats["errors"] += 1
        outcome.error = f"{tag}: {rec.get('error', rec['status'])[:200]}"
    return outcome


def picks(by_pair: dict[tuple, SearchOutcome], say=print) -> dict[tuple, dict]:
    """Each pair's winners by dominance over (modelled step time, bytes
    accessed), not by eyeballing the log: the same machinery as the
    operator library.  ``say`` gets the reference's line for each pair.
    Returns ``{(arch, shape): {"pareto": tags, "fastest": tag, "t_step":
    seconds}}`` for the pairs with an ``ok`` iteration."""
    out = {}
    for (arch, shape_name), outcome in by_pair.items():
        if not outcome.results:
            say(f"{arch} {shape_name}: no successful iterations ({outcome.error})")
            continue
        front = outcome.pareto((_t_step, lambda r: r["hlo_bytes"]))
        tags = [r["tag"] for r in front]
        best = outcome.min_by(_t_step)
        say(f"{arch} {shape_name}: pareto iterations [{', '.join(tags)}]; "
            f"fastest {best['tag']} at t_step={_t_step(best):.3g}s")
        out[(arch, shape_name)] = {"pareto": tags, "fastest": best["tag"],
                                   "t_step": _t_step(best)}
    return out


def hillclimb(steps=STEPS, out_dir: str = OUT, *,
              cfg: Callable[[str], ModelConfig] | None = None,
              shape: ShapeConfig | None = None,
              mesh_dims: tuple[int, ...] | None = None) -> dict[tuple, SearchOutcome]:
    """Run ``steps`` and print the reference's lines: one an iteration,
    then each pair's Pareto iterations and its fastest (:func:`picks`).
    ``cfg`` maps an arch to its config, and ``shape`` and ``mesh_dims``
    replace every step's shape and the mesh's extents (small runs in
    tests).  Returns ``{(arch, shape): SearchOutcome}``, each ``ok``
    record tagged."""
    os.makedirs(out_dir, exist_ok=True)
    by_pair: dict[tuple, SearchOutcome] = {}
    t_start = time.time()
    for arch, shape_name, tag, kw in steps:
        t0 = time.time()
        rec = run_cell(arch, shape.name if shape is not None else shape_name,
                       multi_pod=False, out_dir=out_dir, tag=tag,
                       cfg=cfg(arch) if cfg is not None else None, shape=shape,
                       mesh_dims=mesh_dims, **kw)
        add_record(by_pair, arch, shape_name, tag, rec)
        if rec["status"] == "ok":
            print(f"{arch:24s} {shape_name:10s} {tag:22s} "
                  f"t_comp={rec['t_compute']:.3g}s t_mem={rec['t_memory']:.3g}s "
                  f"t_coll={rec['t_collective']:.3g}s "
                  f"roofline={rec['roofline_fraction']:.4f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
        else:
            print(f"{arch} {shape_name} {tag} -> {rec['status']}: "
                  f"{rec.get('error','')[:200]}", flush=True)
    for outcome in by_pair.values():
        outcome.wall_s = time.time() - t_start
    picks(by_pair, say=lambda line: print(line, flush=True))
    return by_pair


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT, help="directory of the tagged records")
    ap.add_argument("--step", action="append", default=None,
                    help="run only the iterations with this tag (repeatable)")
    args = ap.parse_args(argv)
    steps = [s for s in STEPS if args.step is None or s[2] in args.step]
    if not steps:
        ap.error(f"no iteration tagged {args.step}")
    by_pair = hillclimb(steps, args.out)
    if any(o.stats["errors"] for o in by_pair.values()):
        raise SystemExit("hill-climb iterations failed")


if __name__ == "__main__":
    main()
