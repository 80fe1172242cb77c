"""Reports the launchers print: the per-layer QoS plan table and the
measured sensitivity table.

Own copy of the reporting half of ``repro.launch.analysis``; its roofline
half reads XLA's compiled HLO and has no counterpart here.
"""

from __future__ import annotations

__all__ = ["plan_report", "sensitivity_report", "model_flops_decode"]


# ---------------------------------------------------------------------------
# QoS layer-plan reporting: which approximate operator each layer runs on
# ---------------------------------------------------------------------------
def plan_report(plan) -> str:
    """Human-readable per-layer operator table for a QoS
    :class:`~repro_torch.library.qos.LayerPlan` -- operator key, area vs
    the exact baseline, compiled-table error, and the plan-level totals."""
    lines = [
        f"{'layer':>5s}  {'operator':<18s} {'area µm²':>9s} {'Δarea':>7s} "
        f"{'pred.drift':>10s}"
    ]
    for c in plan.choices:
        name = c.key if c.key is not None else "exact"
        saving = 1.0 - c.area / plan.exact_area if plan.exact_area else 0.0
        lines.append(
            f"{c.layer:>5d}  {name:<18s} {c.area:>9.3f} {100 * saving:>6.1f}% "
            f"{c.predicted_drift:>10.5f}"
        )
    lines.append(
        f"total area {plan.total_area:.3f} µm² vs exact "
        f"{plan.exact_total_area:.3f} µm² "
        f"({100 * plan.area_saving:.1f}% saving), predicted drift "
        f"{plan.predicted_total:.5f} <= budget {plan.budget:.5f}"
    )
    return "\n".join(lines)


def sensitivity_report(profile) -> str:
    """Human-readable measured per-layer sensitivity table for a
    :class:`~repro_torch.sensitivity.profile.SensitivityProfile` -- one
    column per profiled serving width (drift per unit compiled-table mae),
    printed next to the per-layer operator table so a plan can be read
    against the measurements that priced it."""
    widths = profile.widths
    head = f"{'layer':>5s}"
    for b in widths:
        head += f"  {'w' + str(b) + ' drift/mae':>14s}"
    lines = [f"measured sensitivities: {profile.model} "
             f"({profile.n_layers} layers)", head]
    sens = {b: profile.sensitivities(b) for b in widths}
    for l in range(profile.n_layers):
        row = f"{l:>5d}"
        for b in widths:
            row += f"  {sens[b][l]:>14.5f}"
        lines.append(row)
    for b in widths:
        hot = int(sens[b].argmax())
        lines.append(
            f"w{b}: most sensitive layer {hot} "
            f"({sens[b][hot]:.5f}), least {int(sens[b].argmin())} "
            f"({sens[b].min():.5f})"
            + (f", measured cost matrix over "
               f"{len(profile.costs[b][0])} operator(s)"
               if b in profile.costs else "")
        )
    return "\n".join(lines)


def model_flops_decode(n_active_params: int, tokens: int) -> float:
    return 2.0 * n_active_params * tokens
