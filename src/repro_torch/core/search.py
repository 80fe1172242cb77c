"""Fill an operator library from the command line: the z3-free half of
``repro.core.search``.

``python -m repro_torch.core.search --benchmark mul_i4 --et 1 2 4
--library runs/lib`` runs one engine of the registry
(:mod:`repro_torch.core.engine`) per error threshold and stores every
sound result in an :class:`~repro_torch.library.store.OperatorStore`, with
the reference's printed lines.  The paper's progressive SMT search needs
z3, which the port's machines do not have, so ``--method auto`` resolves
to the annealer (as the reference does without z3) and
:func:`progressive_search` raises the reference's error.
"""

from __future__ import annotations

from .circuits import Circuit
from .engine import SearchOutcome

__all__ = ["progressive_search", "main"]


def progressive_search(
    exact: Circuit,
    et: int,
    method: str = "shared",
    *,
    max_primary: int | None = None,
    explore_after_sat: int = 6,
    timeout_ms: int = 30_000,
    wall_budget_s: float = 600.0,
    seed: int = 0,
    tighten: bool = True,
    sink=None,
) -> SearchOutcome:
    """The paper's progressive proxy-constrained SMT search.  It needs the
    z3 solver, which the port does not have: always raises, with the
    reference's message for a z3-less image."""
    raise RuntimeError(
        "z3-solver is not installed; progressive_search needs the SMT "
        "backend (use repro.core.baselines / tensor_search instead)"
    )


def main(argv: list[str] | None = None) -> None:
    """``python -m repro_torch.core.search --benchmark mul_i4 --et 1 2 4
    --library runs/lib`` — search and persist every sound result.

    One-benchmark front-end over the engine registry; sweeps over many
    benchmarks / engines are ``python -m repro_torch.fleet``'s job.
    ``--method auto`` takes the annealer, since the SMT search needs z3.
    ``--device`` is where the tensor engine runs (the card unless
    ``cpu``); the other engines run on the host.
    """
    import argparse

    from ..device import resolve_device
    from ..library import OperatorStore
    from .arith import parse_benchmark_name
    from .engine import ENGINE_NAMES, SearchJob, get_engine

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--benchmark", default="mul_i4",
                    help="e.g. mul_i4 (2-bit), mul_i8 (4-bit), adder_i4")
    ap.add_argument("--et", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--method", default="auto",
                    choices=["auto", *ENGINE_NAMES])
    ap.add_argument("--library", default=None,
                    help="operator-store directory to sink results into")
    ap.add_argument("--budget-s", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tensor engine; cpu runs its "
                         "plain PyTorch path")
    args = ap.parse_args(argv)

    try:
        kind, bits = parse_benchmark_name(args.benchmark)
    except KeyError:
        ap.error(f"unknown benchmark {args.benchmark!r} "
                 "(expected e.g. mul_i4, adder_i6, mul_i8)")
    method = args.method
    if method == "auto":
        method = "anneal"
        print(f"--method auto -> {method} (z3 missing)")
    opts = {}
    if method == "tensor":
        opts["device"] = resolve_device(args.device)

    store = OperatorStore(args.library) if args.library else None
    for et in args.et:
        job = SearchJob(benchmark=kind, bits=bits, et=et, engine=method,
                        budget_s=args.budget_s, seed=args.seed)
        outcome = get_engine(method, **opts).run(job)
        stored = 0
        if store is not None:
            sig = job.signature()
            n_before = len(store)
            for cand in outcome.results:
                store.put_circuit(cand.circuit, sig, area=cand.area,
                                  source=method, proxies=cand.proxies,
                                  params=cand.params,
                                  meta={**cand.meta, "wall_s": cand.wall_s})
            stored = len(store) - n_before
        best = outcome.best
        print(f"{args.benchmark} ET={et:3d} [{method}]: "
              + (f"best area {best.area} µm²" if best else "no sound result")
              + (f", {stored} new operator(s) -> {args.library}"
                 if store is not None else ""))


if __name__ == "__main__":
    main()
