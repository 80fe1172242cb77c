"""Cost-accounting plane: the area/energy dividend, attributed.

The provenance ledger (:mod:`repro_torch.obs.provenance`) records which (plan,
ladder level, per-layer operator keys) decoded which generated-token
ranges; this module turns those facts into the number the paper is
actually about — how much area·work approximation saved, per request,
QoS class, layer, and plan.  Area is the standard energy proxy for
approximate DNN accelerators (Armeniakos et al., the survey the library
prices operators against), so the dividend is reported in two units:

* **approx MACs** — MLP multiply-accumulates that ran through an
  approximate operator instead of the exact array multiplier.
* **area·MACs saved** — those MACs weighted by the per-layer area gap
  ``exact_area - operator_area``, i.e. proxy energy.  Composed W8A8
  areas ignore partial-product glue adders (a documented lower bound
  since the precision tier landed), so the dividend is a **bracket**
  ``[lo, hi]``: the guaranteed saving uses each operator's glue-adder-
  inclusive upper-bound area (``CompiledLut.area_hi``), the optimistic
  end uses the composed lower bound.

MAC counts derive from the model config and mirror exactly what the
decode step routes through LUTs (``models/lm.py``): dense gated FFNs
route ``w1``/``w3``/``w2`` (3·D·F per token per layer); the reference
also prices GELU FFNs, MoE shared experts and RWKV, families the port
has not taken over yet.

The hard invariant: a completed request's attributed MACs must exactly
tile ``gen_len × Σ_layers macs_per_layer`` — the ledger ranges cover
``[0, gen_len)`` with zero gap and zero overlap.  Any mismatch is an
**audit failure** (``reconciled: false``, CI gates on it), never a
warning.  Everything here is stdlib-only and offline: the engine writes
``model`` and enriched ``plan`` records into the ledger, so a report
needs nothing but the files.  Own copy of ``repro.obs.costs``.
"""

from __future__ import annotations

__all__ = [
    "mlp_macs_per_layer",
    "plan_cost_row",
    "render_report",
    "cost_report",
]


def mlp_macs_per_layer(cfg) -> list[int]:
    """Per-layer LUT-routable MLP MACs per generated token, derived from
    the model config.  Counts only matmuls the decode step actually
    routes through the approximate-operator path; attention, the MoE
    router and the routed experts, and the head are exact compute and
    never earn a dividend.

    Raises :class:`ValueError` for RWKV families — their channel mix
    bypasses the LUT path entirely, so there is nothing to account; the
    engine then serves with the cost plane off.
    """
    if getattr(cfg, "rwkv", None) is not None:
        raise ValueError(
            f"{cfg.name}: RWKV channel mix does not route through the LUT "
            "path; no approx MACs to account")
    d = int(cfg.d_model)
    if getattr(cfg, "moe", None) is not None:
        # only the always-on shared experts ride ffn(..., lut); the
        # sorted top-k dispatch runs exact batched matmuls
        per = int(cfg.moe.n_shared) * 3 * d * int(cfg.moe.d_ff_expert)
    elif getattr(cfg, "encoder", None) is not None:
        per = 2 * d * int(cfg.d_ff)        # GELU FFN: w1, w2
    else:
        per = 3 * d * int(cfg.d_ff)        # gated FFN: w1, w3, w2
    return [per] * int(cfg.n_layers)


def plan_cost_row(plan, macs_per_layer, *, layer_areas=None) -> dict:
    """Per-token cost increments for a live plan — the row the engine
    caches per ``plan_id`` and multiplies by decode-token counts each
    step.  ``layer_areas`` is the per-layer ``(area_lo, area_hi)`` list
    from :func:`repro_torch.library.qos.plan_layer_areas`; without it the
    bracket collapses to the choices' own (lower-bound) areas.

    Returns ``{"macs", "approx_macs", "saved_lo", "saved_hi",
    "layers": {layer_idx: saved_lo}}`` — ``saved_lo`` is the guaranteed
    dividend (exact area minus the operator's *upper*-bound area).
    """
    total = int(sum(macs_per_layer))
    if plan is None:
        return {"macs": total, "approx_macs": 0,
                "saved_lo": 0.0, "saved_hi": 0.0, "layers": {}}
    ea = float(plan.exact_area)
    approx = 0
    saved_lo = saved_hi = 0.0
    layers: dict[str, float] = {}
    for li, c in enumerate(plan.choices):
        if c.key is None:
            continue
        m = int(macs_per_layer[li])
        if not m:
            continue
        if layer_areas is not None:
            a_lo, a_hi = layer_areas[li]
        else:
            a_lo = a_hi = float(c.area)
        approx += m
        lo = m * (ea - a_hi)
        saved_lo += lo
        saved_hi += m * (ea - a_lo)
        layers[str(li)] = lo
    return {"macs": total, "approx_macs": approx,
            "saved_lo": saved_lo, "saved_hi": saved_hi, "layers": layers}


# ---------------------------------------------------------------------------
# offline attribution over merged ledger records
# ---------------------------------------------------------------------------
def _agg(row: dict, macs: int, approx: int, lo: float, hi: float,
         tokens: int = 0) -> None:
    row["mlp_macs"] = row.get("mlp_macs", 0) + macs
    row["approx_macs"] = row.get("approx_macs", 0) + approx
    row["saved_lo"] = row.get("saved_lo", 0.0) + lo
    row["saved_hi"] = row.get("saved_hi", 0.0) + hi
    row["tokens"] = row.get("tokens", 0) + tokens


def _finish(row: dict) -> dict:
    out = {"tokens": row.get("tokens", 0),
           "mlp_macs": row.get("mlp_macs", 0),
           "approx_macs": row.get("approx_macs", 0),
           "area_mac_saved": [round(row.get("saved_lo", 0.0), 4),
                              round(row.get("saved_hi", 0.0), 4)]}
    if out["mlp_macs"]:
        out["approx_frac"] = round(out["approx_macs"] / out["mlp_macs"], 6)
    return out


def cost_report(records: list[dict]) -> dict:
    """Join the merged ledger against the model's MAC vector and the
    plans' per-layer areas into the attributed dividend (see module
    docstring).  ``reconciled`` is the hard invariant: every request
    with a ``done`` record tiles ``[0, gen_len)`` exactly *and* its
    attributed MACs equal ``gen_len × Σ macs_per_layer``.
    """
    from .provenance import audit

    aud = audit(records)
    model = None
    for r in records:
        if r.get("k") == "model":
            model = r
            break
    problems: list[str] = []
    out: dict = {
        "reconciled": False,
        "n_requests": aud["n_requests"],
        "n_done": aud["n_done"],
        "n_complete": aud["n_complete"],
    }
    if model is None:
        problems.append("no model record in ledger "
                        "(serve predates the cost plane?)")
        out["problems"] = problems
        return out
    macs = [int(m) for m in model["macs"]]
    out["model"] = {"name": model.get("name"), "n_layers": len(macs),
                    "macs_per_token": int(sum(macs))}
    mpt = sum(macs)

    plans = aud["plans"]
    plan_missing_areas: set[str] = set()
    totals: dict = {}
    classes: dict[str, dict] = {}
    layers: dict[str, dict] = {}
    plan_rows: dict[str, dict] = {}
    replicas: dict[str, dict] = {}
    requests: dict = {}
    mac_gap = 0
    reconciled = aud["n_done"] > 0

    for rkey, req in aud["requests"].items():
        tokens = sum(r["t1"] - r["t0"] for r in req["ranges"])
        attributed = tokens * mpt
        row = {"cls": req["cls"], "tokens": tokens, "mlp_macs": attributed,
               "approx_macs": 0, "saved_lo": 0.0, "saved_hi": 0.0}
        replica = req.get("replica")
        for r in req["ranges"]:
            n = r["t1"] - r["t0"]
            pid = r["plan"]
            prow = plan_rows.setdefault(pid, {})
            p = plans.get(pid)
            if pid == "exact" or p is None:
                _agg(prow, n * mpt, 0, 0.0, 0.0, tokens=n)
                continue
            areas = p.get("areas")
            areas_hi = p.get("areas_hi") or areas
            ea = p.get("exact_area")
            if areas is None or ea is None:
                if pid not in plan_missing_areas:
                    plan_missing_areas.add(pid)
                    problems.append(f"plan {pid} has no area record; its "
                                    "dividend is unpriced")
                areas = areas_hi = None
            r_approx = 0
            r_lo = r_hi = 0.0
            for li, key in enumerate(p["layers"]):
                if key == "exact" or not macs[li]:
                    continue
                m = n * macs[li]
                r_approx += m
                if areas is not None:
                    lo = m * (ea - areas_hi[li])
                    hi = m * (ea - areas[li])
                    r_lo += lo
                    r_hi += hi
                    lrow = layers.setdefault(str(li), {})
                    _agg(lrow, m, m, lo, hi)
            row["approx_macs"] += r_approx
            row["saved_lo"] += r_lo
            row["saved_hi"] += r_hi
            _agg(prow, n * mpt, r_approx, r_lo, r_hi, tokens=n)

        rrow = _finish(row)
        rrow["cls"] = req["cls"]
        if replica:
            rrow["replica"] = replica
        if "gen_len" in req:
            expected = req["gen_len"] * mpt
            rrow["expected_macs"] = expected
            rrow["reconciled"] = (attributed == expected
                                  and req["complete"])
            if not rrow["reconciled"]:
                reconciled = False
                gap = expected - attributed
                mac_gap += gap
                problems.append(
                    f"request {rkey}: attributed {attributed} MACs vs "
                    f"{expected} expected (gap {gap}); "
                    + "; ".join(req["problems"]))
        requests[rkey] = rrow
        _agg(totals, row["mlp_macs"], row["approx_macs"],
             row["saved_lo"], row["saved_hi"], tokens=tokens)
        _agg(classes.setdefault(req["cls"], {}), row["mlp_macs"],
             row["approx_macs"], row["saved_lo"], row["saved_hi"],
             tokens=tokens)
        if replica:
            _agg(replicas.setdefault(replica, {}), row["mlp_macs"],
                 row["approx_macs"], row["saved_lo"], row["saved_hi"],
                 tokens=tokens)

    if aud["n_done"] == 0:
        problems.append("no completed requests to reconcile")

    out["reconciled"] = reconciled and not plan_missing_areas
    out["mac_gap"] = mac_gap
    out["totals"] = _finish(totals)
    out["classes"] = {c: _finish(r) for c, r in sorted(classes.items())}
    out["layers"] = {k: _finish(v)
                     for k, v in sorted(layers.items(), key=lambda i: int(i[0]))}
    out["plans"] = {p: _finish(r) for p, r in sorted(plan_rows.items())}
    if replicas:
        out["replicas"] = {n: _finish(r)
                           for n, r in sorted(replicas.items())}
    out["requests"] = requests
    out["problems"] = problems
    return out


def render_report(rep: dict) -> str:
    """Human-readable costs table for the CLI."""
    lines: list[str] = []
    if "model" not in rep:
        lines.append("cost report: no model record")
        for p in rep.get("problems", ()):
            lines.append(f"  ! {p}")
        return "\n".join(lines)
    m = rep["model"]
    lines.append(f"model {m['name']}: {m['n_layers']} layers, "
                 f"{m['macs_per_token']} LUT-routable MACs/token")
    t = rep["totals"]
    lo, hi = t["area_mac_saved"]
    lines.append(
        f"requests {rep['n_requests']} (done {rep['n_done']}, complete "
        f"{rep['n_complete']})  reconciled={str(rep['reconciled']).lower()}")
    lines.append(f"tokens {t['tokens']}  mlp_macs {t['mlp_macs']}  "
                 f"approx_macs {t['approx_macs']} "
                 f"({100 * t.get('approx_frac', 0.0):.1f}%)")
    lines.append(f"area·MAC saved [{lo:.1f}, {hi:.1f}] µm²·MAC")
    hdr = f"  {'class':<10} {'tokens':>7} {'approx_macs':>12} " \
          f"{'saved_lo':>14} {'saved_hi':>14}"
    if rep["classes"]:
        lines.append(hdr)
        for cls, row in rep["classes"].items():
            clo, chi = row["area_mac_saved"]
            lines.append(f"  {cls:<10} {row['tokens']:>7} "
                         f"{row['approx_macs']:>12} {clo:>14.1f} {chi:>14.1f}")
    if rep.get("replicas"):
        lines.append(f"  {'replica':<10} {'tokens':>7} {'approx_macs':>12} "
                     f"{'saved_lo':>14} {'saved_hi':>14}")
        for name, row in rep["replicas"].items():
            clo, chi = row["area_mac_saved"]
            lines.append(f"  {name:<10} {row['tokens']:>7} "
                         f"{row['approx_macs']:>12} {clo:>14.1f} {chi:>14.1f}")
    for p in rep.get("problems", ()):
        lines.append(f"  ! {p}")
    return "\n".join(lines)
