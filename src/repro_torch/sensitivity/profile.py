"""Offline per-layer sensitivity profiling: measure, persist, reuse.

Own copy of ``repro.sensitivity.profile`` over the port's model.  The
QoS planner is only as good as its drift model; this module is the one
measured code path:

* a **probe** (:func:`truncation_probe`) is a deterministic synthetic
  approximate table -- the exact product table with its low bits dropped
  -- so profiling needs no operator library and two runs of the profiler
  produce bit-identical profiles;
* :func:`model_eval_drift` builds the one forward evaluator every
  measurement routes through (per-layer table overrides vs the all-exact
  baseline *at the same width*, so the measured number is pure LUT
  approximation drift);
* :func:`measure_profile` probes one layer at a time at every serving
  width and emits a :class:`SensitivityProfile` -- per-width, per-layer
  drift per unit compiled-table mae -- persisted as JSON next to the
  operator library (``<library>/_profiles/<model>.json``), in the
  reference's format: a profile written by either package loads on the
  other;
* with a library at hand, :func:`measure_cost_matrix` measures the full
  per-(layer, operator) drift matrix for a width's frontier; the profile
  stores it keyed by operator content keys so plan construction can price
  *known* operators by measurement and fall back to the linear model only
  for operators a background fleet sweep adds later (:func:`costs_for`).

On the card every forward runs the LUT matmul and flash kernels.  The
8-bit probe is the exact 256x256 product with its low 8 bits dropped,
which is not composed from a 16x16 tile: its layer runs the direct
lookup kernel, the composed layers the W8A8 kernel.

CLI (writes the profile the serve launcher's ``--profile`` consumes; the
card unless ``--device cpu``)::

    python -m repro_torch.sensitivity.profile --arch qwen3-4b --reduced \
        --library runs/lib --widths 4,8 --out runs/lib/_profiles/qwen3-4b.json
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..kernels import ops
from ..models import forward_fn, init_model
from ..precision.widths import SUPPORTED_WIDTHS, exact_table, get_width

__all__ = [
    "Probe",
    "truncation_probe",
    "SensitivityProfile",
    "model_eval_drift",
    "measure_profile",
    "measure_cost_matrix",
    "costs_for",
    "default_profile_path",
    "load_profile",
]

PROFILE_FORMAT = 1


@dataclass(frozen=True)
class Probe:
    """A synthetic approximate operator used to excite one layer at a
    time.  Duck-types the slice of ``CompiledLut`` the qos measurement
    helpers read (``lut`` + ``mae16``)."""

    lut: np.ndarray          # (side, side) int32
    mae: float
    bits: int
    drop: int

    @property
    def mae16(self) -> float:   # CompiledLut-compatible spelling
        return self.mae


def truncation_probe(bits: int, drop: int | None = None) -> Probe:
    """The exact ``bits``-bit product table with the low ``drop`` bits
    zeroed (default: the low half of the product).  Deterministic, well
    above numerical noise, and library-independent."""
    w = get_width(bits)
    drop = bits if drop is None else int(drop)
    exact = exact_table("mul", bits)
    lut = (exact >> drop) << drop
    mae = float(np.abs(lut - exact).mean())
    if not mae > 0:
        raise ValueError(f"a probe dropping {drop} bit(s) is exact")
    return Probe(lut=lut.astype(np.int32), mae=mae, bits=w.bits, drop=drop)


@dataclass
class SensitivityProfile:
    """Measured per-layer drift sensitivities of one model, per width.

    ``sens[bits][l]`` is layer ``l``'s measured drift per unit
    compiled-table mae at serving width ``bits`` (the linear model the
    QoS planner prices unknown operators with).  ``costs[bits]`` is an
    optional measured per-(layer, operator) drift matrix over a concrete
    frontier, keyed by operator content keys.
    """

    model: str
    n_layers: int
    sens: dict[int, np.ndarray]                 # bits -> (L,)
    probe_mae: dict[int, float] = field(default_factory=dict)
    costs: dict[int, tuple[list[str], np.ndarray]] = field(
        default_factory=dict)                   # bits -> (keys, (L, O))
    meta: dict = field(default_factory=dict)

    @property
    def widths(self) -> tuple[int, ...]:
        return tuple(sorted(self.sens))

    def sensitivities(self, bits: int) -> np.ndarray:
        b = int(bits)
        if b not in self.sens:
            raise KeyError(
                f"profile of {self.model!r} was not measured at width {b} "
                f"(profiled widths: {self.widths}); re-run "
                f"python -m repro_torch.sensitivity.profile with --widths "
                f"covering the serving width")
        return np.asarray(self.sens[b], dtype=np.float64).copy()

    # ------------------------------------------------------------- persist
    def to_doc(self) -> dict:
        return {
            "format_version": PROFILE_FORMAT,
            "model": self.model,
            "n_layers": self.n_layers,
            "sens": {str(b): np.asarray(s).tolist()
                     for b, s in self.sens.items()},
            "probe_mae": {str(b): m for b, m in self.probe_mae.items()},
            "costs": {str(b): {"keys": list(keys),
                               "matrix": np.asarray(m).tolist()}
                      for b, (keys, m) in self.costs.items()},
            "meta": self.meta,
        }

    def save(self, path) -> Path:
        from ..library.store import atomic_write_json

        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        atomic_write_json(p, self.to_doc())
        return p

    @classmethod
    def from_doc(cls, doc: dict) -> "SensitivityProfile":
        return cls(
            model=doc["model"],
            n_layers=int(doc["n_layers"]),
            sens={int(b): np.asarray(s, dtype=np.float64)
                  for b, s in doc["sens"].items()},
            probe_mae={int(b): float(m)
                       for b, m in doc.get("probe_mae", {}).items()},
            costs={int(b): (list(d["keys"]),
                            np.asarray(d["matrix"], dtype=np.float64))
                   for b, d in doc.get("costs", {}).items()},
            meta=doc.get("meta", {}),
        )


def load_profile(path) -> SensitivityProfile:
    return SensitivityProfile.from_doc(json.loads(Path(path).read_text()))


def default_profile_path(library, model: str) -> Path:
    """Where a profile lives relative to the operator library it was
    measured next to."""
    return Path(library) / "_profiles" / f"{model}.json"


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------
def model_eval_drift(cfg, params, batch, bits: int, *,
                     backend: ops.Backend = "auto",
                     device: str | torch.device = "cuda"):
    """The one measured-drift evaluator: returns ``eval_drift(per_layer)``
    where ``per_layer[l]`` is layer ``l``'s ``(side, side)`` table
    (``None`` = exact), evaluated as mean |Δlogit| against the all-exact
    baseline at width ``bits``.  The baseline forward runs once here; each
    probe passes its per-layer stack to the same forward as an argument,
    so the model is never rebuilt.  ``backend="ref"`` runs every forward
    on the plain route."""
    if not cfg.approx_mlp:
        raise ValueError("profiling routes MLP matmuls through LUTs; build "
                         "the config with .with_approx_mlp()")
    dev = resolve_device(device)
    fwd = forward_fn(cfg)
    batch = {"tokens": torch.as_tensor(batch["tokens"], device=dev)}
    w = get_width(bits)
    exact = exact_table("mul", bits).astype(np.int32)

    def logits(stack: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return fwd(cfg, params, batch, lut=stack, backend=backend,
                       device=dev)[0]

    base = logits(np.broadcast_to(exact, (cfg.n_layers, w.side, w.side)).copy())

    def eval_drift(per_layer) -> float:
        stack = np.stack([exact if t is None else np.asarray(t, np.int32)
                          for t in per_layer])
        return float((logits(stack) - base).abs().mean())

    return eval_drift


def measure_profile(cfg, params, batch, *, widths=SUPPORTED_WIDTHS,
                    drop: int | None = None, library=None,
                    meta: dict | None = None,
                    backend: ops.Backend = "auto",
                    device: str | torch.device = "cuda"
                    ) -> SensitivityProfile:
    """Probe one layer at a time at every serving width and (optionally,
    with a library) measure the full per-(layer, operator) cost matrix of
    each width's frontier.  Deterministic for fixed (cfg, params, batch).
    ``backend="ref"`` measures on the plain route."""
    from ..library.qos import measure_layer_costs, measure_sensitivities

    dev = resolve_device(device)
    probes = {bits: truncation_probe(bits, drop)
              for bits in sorted(int(b) for b in widths)}
    sens: dict[int, np.ndarray] = {}
    probe_mae: dict[int, float] = {}
    costs: dict[int, tuple[list[str], np.ndarray]] = {}
    for bits, probe in probes.items():
        ev = model_eval_drift(cfg, params, batch, bits, backend=backend,
                              device=dev)
        sens[bits] = measure_sensitivities(ev, cfg.n_layers, probe)
        probe_mae[bits] = probe.mae
        if library is not None:
            from ..precision.plans import load_frontier

            compiled, _, _ = load_frontier(library, bits)
            matrix = measure_layer_costs(ev, cfg.n_layers, compiled)
            costs[bits] = ([rec.key for rec, _ in compiled], matrix)
    return SensitivityProfile(
        model=cfg.name, n_layers=cfg.n_layers, sens=sens,
        probe_mae=probe_mae, costs=costs, meta=dict(meta or {}),
    )


def measure_cost_matrix(cfg, params, batch, compiled,
                        bits: int | None = None, *,
                        device: str | torch.device = "cuda") -> np.ndarray:
    """Measured ``(L, O)`` drift matrix for one width's frontier."""
    from ..library.qos import measure_layer_costs

    if bits is None:
        sides = {comp.lut.shape[-1] for _, comp in compiled}
        if len(sides) != 1:
            raise ValueError(f"frontier mixes LUT sides {sorted(sides)}")
        bits = sides.pop().bit_length() - 1
    ev = model_eval_drift(cfg, params, batch, bits, device=device)
    return measure_layer_costs(ev, cfg.n_layers, compiled)


def costs_for(profile: SensitivityProfile | None, bits: int, compiled,
              n_layers: int) -> np.ndarray:
    """The ``(L, O)`` cost matrix a plan/ladder build should use for one
    width's frontier: measured columns where the profile covered the
    operator, the profile's linear model otherwise, uniform sensitivities
    when there is no profile at all.  This is what lets a measured plan
    keep pricing operators a fleet sweep lands *after* profiling."""
    maes = np.array([comp.mae for _, comp in compiled])
    if profile is None:
        return np.ones(n_layers)[:, None] * maes[None, :]
    if profile.n_layers != n_layers:
        raise ValueError(f"profile measured {profile.n_layers} layers, "
                         f"model has {n_layers}")
    sens = profile.sensitivities(bits)
    out = sens[:, None] * maes[None, :]
    measured = profile.costs.get(int(bits))
    if measured is not None:
        keys, matrix = measured
        col = {k: i for i, k in enumerate(keys)}
        for o, (rec, _) in enumerate(compiled):
            i = col.get(rec.key)
            if i is not None:
                out[:, o] = matrix[:, i]
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="measure a per-layer sensitivity profile")
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--widths", default="4,8",
                    help="comma-separated serving widths to profile")
    ap.add_argument("--library", default=None,
                    help="operator store; also measures the per-(layer, "
                         "operator) cost matrix of each width's frontier")
    ap.add_argument("--out", default=None,
                    help="profile JSON path (default: "
                         "<library>/_profiles/<arch>.json)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    out = args.out
    if out is None:
        if args.library is None:
            raise SystemExit("--out is required without --library")
        cfg_name = get_config(args.arch, reduced=args.reduced).name
        out = default_profile_path(args.library, cfg_name)

    cfg = get_config(args.arch, reduced=args.reduced).with_approx_mlp()
    params = init_model(cfg, args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                                     generator=gen, device=dev)}
    widths = tuple(int(b) for b in args.widths.split(","))
    profile = measure_profile(
        cfg, params, batch, widths=widths, library=args.library,
        meta={"arch": args.arch, "reduced": bool(args.reduced),
              "seed": args.seed, "batch": args.batch, "seq": args.seq},
        device=dev,
    )
    path = profile.save(out)

    from ..launch.analysis import sensitivity_report

    print(sensitivity_report(profile))
    print(f"profile -> {path}")


if __name__ == "__main__":
    main()
