"""Serving launcher: a thin CLI over :mod:`repro_torch.serving`.

Own copy of ``repro.launch.serve``: the same flags, defaults, argument
checks, printed lines and bench-summary keys, plus ``--device`` (the card
by default; ``--device cpu --reduced`` runs the plain PyTorch path).  One
card, so no mesh.  Every engine captures its decode step once as a CUDA
graph on the card; ``decode step traced 1x`` and the bench summary's
``trace_count`` count captures.  Requests are synthetic prompts on a deterministic load profile
(steady / ramp / spike); decoding is greedy.  Prefill and decode
throughput are reported *separately* — prefill here is a python-loop over
the prompt through the decode step, so folding it into one number would
silently understate decode throughput.

Three serving modes:

* plain                — exact decode, no operator library.
* ``--library``        — one QoS plan selected at startup (as before).
* ``--adaptive``       — the plan is a runtime input: a QoS controller
  walks the operator frontier between batches (latency target vs drift
  budget), and ``--watch-library`` additionally picks up operators a
  background fleet sweep adds mid-serve.  The decode step is never
  captured again across swaps.

``--continuous`` switches any mode from batch-boundary admission to
continuous batching over a fixed pool of ``--max-slots`` decode slots
with paged KV (``--page-size`` / ``--pages``): requests join and leave
the running batch per step, classes declaring a latency SLO
(``--qos-class "gold:0.02@8ms,batch:0.2"``) preempt lower tiers, and
``--prompt-dist "bimodal:4-16"`` makes arrivals heterogeneous in length.
``--compare-fixed`` runs the fixed-batch engine on the *same* profile
first and emits paired rows; ``--replicas N`` fronts N engines (sharing
one watched store, per-replica plan state) with a class-affinity router.

``--width`` picks the LUT operand width for any library mode: 4 serves
W4A4 on the native 16x16 tables, 8 serves W8A8 on 256x256 tables composed
from the same searched blocks (:mod:`repro_torch.precision`); all three modes
and the watcher work at either width.

Measured sensitivities, QoS classes, mixed width
(:mod:`repro_torch.sensitivity`):

* ``--profile p.json`` prices plans with a *measured* per-layer
  sensitivity profile (``python -m repro_torch.sensitivity.profile``) instead
  of the uniform linear model;
* ``--qos-class "gold:0.02,batch:0.2"`` declares per-request traffic
  tiers with their own drift budgets — per-class queues drain in priority
  order and each batch decodes on its class's ladder level (with
  ``--adaptive`` the load-driven global level still caps everyone);
  ``--class-mix`` shapes the synthetic arrival mix;
* ``--mixed-width`` serves a per-layer width map — sensitive layers on
  native 16x16 tiles, tolerant layers on composed 256x256 W8A8 tables —
  chosen by one greedy descent over both frontiers at once
  (``--mixed-budget``, default auto).  The decode step is still
  captured exactly once; the bench summary reports the mixed plan's area against
  the best uniform-width plan at the same budget.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import ARCH_IDS, get_config
from ..device import resolve_device
from ..models import init_model
from ..obs.export import dump_metrics, write_bench_json
from ..obs.health import HealthPlane, state_rank
from ..obs.metrics import MetricRegistry, get_registry
from ..obs.trace import configure as configure_tracing
from ..serving import (
    ContinuousServingEngine,
    ControllerConfig,
    LibraryWatcher,
    PlanLadder,
    QoSController,
    Replica,
    ReplicaRouter,
    ServingEngine,
    Telemetry,
    make_profile,
    parse_prompt_dist,
)
from ..serving.loadgen import PROFILES


def _frontier(library: str, width):
    from ..precision.plans import load_frontier

    try:
        return load_frontier(library, width)
    except LookupError as e:
        raise SystemExit(str(e))


def _startup_plan(cfg, compiled, exact_area, budget: float, sens=None):
    """The one-shot selection: uniform sensitivities (mae16-unit budget)
    unless a measured ``--profile`` cost model is at hand."""
    from ..library import select_plan
    from .analysis import plan_report

    plan = select_plan(compiled,
                       np.ones(cfg.n_layers) if sens is None else sens,
                       budget, exact_area=exact_area)
    print(f"QoS plan ({len(compiled)} frontier operator(s)):")
    print(plan_report(plan))
    if all(c.key is None for c in plan.choices):
        print("note: budget admits no downgrade — every layer stays exact "
              "(try a larger --qos-budget)")
    return plan


def _budget_level(ladder, budget: float) -> int:
    """Deepest ladder level whose selection budget fits ``budget`` — the
    startup level of a non-adaptive mixed-width serve."""
    lvl = 0
    for i, p in enumerate(ladder.plans):
        if p.budget <= budget:
            lvl = i
    return lvl


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--library", default=None,
                    help="approximate-operator store; routes MLP matmuls "
                         "through QoS-selected per-layer LUT multipliers")
    ap.add_argument("--width", type=int, choices=(4, 8), default=4,
                    help="LUT operand width: 4 = native W4A4 (16x16 "
                         "tables), 8 = W8A8 — searched blocks composed "
                         "into 256x256 tables (repro_torch.precision)")
    ap.add_argument("--qos-budget", type=float, default=None,
                    help="startup QoS budget (non-adaptive mode only). "
                         "Without --profile: summed compiled-table mae16 "
                         "units, default 50.0.  With --profile the plan is "
                         "priced in measured-drift (mean |Δlogit|) units, "
                         "so the budget must be given explicitly — the "
                         "mae16-scaled default would admit the full "
                         "greedy descent.")
    # ---- measured sensitivities / QoS classes / mixed width ---------------
    ap.add_argument("--profile", default=None,
                    help="measured SensitivityProfile JSON (produced by "
                         "python -m repro_torch.sensitivity.profile); plans and "
                         "ladders price operators with measured per-layer "
                         "sensitivities instead of the uniform model")
    ap.add_argument("--qos-class", default=None, metavar="SPEC",
                    help='per-request QoS classes with drift budgets, e.g. '
                         '"gold:0.02,std:0.05,batch:0.2" (listed order = '
                         'drain priority); requires --library')
    ap.add_argument("--class-mix", default=None, metavar="SPEC",
                    help='synthetic arrival mix over the declared classes, '
                         'e.g. "gold:0.1,std:0.6,batch:0.3" (default: '
                         'equal shares)')
    ap.add_argument("--mixed-width", action="store_true",
                    help="serve a per-layer width map (native 16x16 tiles "
                         "for sensitive layers, composed 256x256 W8A8 "
                         "tables for tolerant ones) chosen jointly over "
                         "both frontiers; incompatible with --width 8")
    ap.add_argument("--mixed-budget", type=float, default=None,
                    help="drift budget for the width-map selection "
                         "(default: auto — the greedy breakpoint with the "
                         "largest mixed-vs-uniform area advantage)")
    # ---- load profile -----------------------------------------------------
    ap.add_argument("--schedule", choices=PROFILES, default="steady",
                    help="synthetic load profile shape")
    ap.add_argument("--ticks", type=int, default=1,
                    help="load-profile length in arrival ticks")
    ap.add_argument("--per-tick", type=int, default=None,
                    help="arrivals per tick (steady) / peak (ramp, spike); "
                         "default: --batch")
    ap.add_argument("--prompt-dist", default=None, metavar="SPEC",
                    help='heterogeneous prompt lengths, "kind:lo-hi" with '
                         'kind uniform|bimodal (e.g. "bimodal:4-16"); '
                         "deterministic per seed, truncation-stable vs "
                         "fixed-length prompts")
    # ---- continuous batching ---------------------------------------------
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: token-level admission over a "
                         "fixed slot pool with paged KV; requests join/"
                         "leave per step, SLO classes (--qos-class "
                         '"gold:0.02@8ms") preempt lower tiers')
    ap.add_argument("--max-slots", type=int, default=None,
                    help="decode-slot pool size (default: --batch)")
    ap.add_argument("--page-size", type=int, default=8,
                    help="KV page size in cache positions")
    ap.add_argument("--pages", type=int, default=None,
                    help="KV page-pool size (default: every slot's worst "
                         "case plus one slot of preemption headroom)")
    ap.add_argument("--steps-per-tick", type=int, default=None,
                    help="decode steps between arrival ticks "
                         "(default: --gen-len)")
    ap.add_argument("--compare-fixed", action="store_true",
                    help="also serve the same profile on the fixed-batch "
                         "engine and emit paired fixed-vs-continuous rows "
                         "in the bench summary")
    ap.add_argument("--replicas", type=int, default=1,
                    help=">=2 fronts that many continuous engines with a "
                         "class-affinity router sharing one watched store")
    # ---- adaptive runtime -------------------------------------------------
    ap.add_argument("--adaptive", action="store_true",
                    help="QoS controller walks the operator frontier between "
                         "batches (requires --library)")
    ap.add_argument("--target-ms-per-step", type=float, default=50.0,
                    help="controller latency target (EWMA decode ms/step)")
    ap.add_argument("--drift-budget", type=float, default=0.05,
                    help="mean |Δlogit| allowed vs the exact shadow step")
    ap.add_argument("--shadow-every", type=int, default=4,
                    help="sample the exact shadow step every N batches")
    ap.add_argument("--ladder-levels", type=int, default=6,
                    help="plan-ladder resolution across the frontier")
    ap.add_argument("--watch-library", action="store_true",
                    help="poll the store between batches and hot-swap in "
                         "operators a background fleet sweep adds")
    ap.add_argument("--poll-s", type=float, default=2.0,
                    help="minimum seconds between store version polls")
    # ---- output -----------------------------------------------------------
    ap.add_argument("--telemetry", default=None,
                    help="write the full telemetry dump (JSON) here")
    ap.add_argument("--bench-json", default=None,
                    help="write the telemetry summary (tok/s, ms/step, swap "
                         "count) here, e.g. BENCH_serve.json")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="observability trace dir: batch/prefill/decode "
                         "spans + a metric snapshot land there; point it at "
                         "a fleet run's trace dir for one merged view "
                         "(python -m repro_torch.obs summary --trace DIR)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve live GET /metrics (Prometheus text), "
                         "/healthz (health state as HTTP status) and "
                         "/costs.json (cost-dividend attribution; needs "
                         "--trace) on 127.0.0.1:PORT for the duration of "
                         "the serve; 0 picks a free port")
    ap.add_argument("--health", action="store_true",
                    help="run the SLO health plane: multi-window burn-rate "
                         "monitors over the declared --qos-class SLOs and "
                         "drift budgets, streaming anomaly detectors "
                         "attributed to swap/refresh/control events, and a "
                         "flight recorder; the state lands in the bench "
                         "summary for python -m repro_torch.obs health")
    ap.add_argument("--postmortem-dir", default=None, metavar="DIR",
                    help="dump atomic post-mortem bundles (flight-recorder "
                         "ring + health state) here on SLO breach, fired "
                         "anomaly, or crash; implies --health "
                         "(python -m repro_torch.obs postmortem --dir DIR)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)

    if args.postmortem_dir:
        args.health = True

    if args.adaptive and not args.library:
        raise SystemExit("--adaptive requires --library (the frontier to walk)")
    if args.watch_library and not args.library:
        raise SystemExit("--watch-library requires --library")
    if args.qos_class and not args.library:
        raise SystemExit("--qos-class requires --library (classes pick "
                         "ladder levels)")
    if args.qos_class and not args.profile:
        raise SystemExit(
            "--qos-class budgets are measured-drift (mean |Δlogit|) units "
            "and cap ladder levels by predicted drift — without a measured "
            "--profile the ladder's predictions are in mae16 cost units "
            "and the caps would be meaningless.  Measure one first: "
            "python -m repro_torch.sensitivity.profile --library <dir> ...")
    if args.class_mix and not args.qos_class:
        raise SystemExit("--class-mix requires --qos-class")
    if args.mixed_width and not args.library:
        raise SystemExit("--mixed-width requires --library")
    if args.mixed_width and args.width != 4:
        raise SystemExit("--mixed-width chooses per-layer widths itself; "
                         "drop --width")
    if not args.continuous and (
            args.max_slots is not None or args.pages is not None
            or args.steps_per_tick is not None or args.compare_fixed
            or args.replicas > 1):
        raise SystemExit("--max-slots/--pages/--steps-per-tick/"
                         "--compare-fixed/--replicas require --continuous")
    if args.replicas < 1:
        raise SystemExit(f"--replicas must be >= 1, got {args.replicas}")
    if args.compare_fixed and args.replicas > 1:
        raise SystemExit("--compare-fixed compares single engines; "
                         "drop --replicas")
    prompt_dist = None
    if args.prompt_dist:
        try:
            prompt_dist = parse_prompt_dist(args.prompt_dist,
                                            args.prompt_len)
        except ValueError as e:
            raise SystemExit(f"--prompt-dist: {e}")
    dev = resolve_device(args.device)
    if args.trace:
        configure_tracing(args.trace)

    profile_obj = None
    if args.profile:
        from ..sensitivity.profile import load_profile

        profile_obj = load_profile(args.profile)

    cfg = get_config(args.arch, reduced=args.reduced)
    plan = compiled = exact_area = controller = watcher = None
    ladder = scheduler = online = None
    mixed_report = width_map = None
    class_mix = book = None
    if args.library:
        from ..precision.plans import select_width
        from ..sensitivity.profile import costs_for

        if cfg.family == "audio":
            raise SystemExit("--library: LUT routing supports LM families only")
        if profile_obj is not None:
            from .analysis import sensitivity_report

            print(sensitivity_report(profile_obj))
        need_ladder = args.adaptive or bool(args.qos_class)
        if args.mixed_width:
            from ..precision.plans import (
                build_mixed_ladder,
                choose_mixed_budget,
                load_mixed_frontier,
                mixed_comparison,
            )

            cfg = cfg.with_approx_mlp()
            mixed = load_mixed_frontier(args.library)
            sens = {bits: costs_for(profile_obj, bits, fr.compiled,
                                    cfg.n_layers)
                    for bits, fr in mixed.by_width.items()}
            # what the *engine* keeps for watcher re-pricing: with a
            # profile it re-derives matrices itself; without one it needs
            # per-width vectors (a frozen (L, O) matrix cannot follow a
            # frontier a background sweep changes)
            engine_sens = (sens if profile_obj is not None
                           else {b: np.ones(cfg.n_layers)
                                 for b in mixed.widths})
            budget = (args.mixed_budget if args.mixed_budget is not None
                      else choose_mixed_budget(mixed, sens, cfg.n_layers))
            mixed_report, width_map, union_plan = mixed_comparison(
                mixed, sens, budget, cfg.n_layers)
            compiled = mixed.compiled
            exact_area = mixed.exact_area(mixed.native_bits)
            counts = mixed_report["width_layers"]
            per_w = ", ".join(f"{len(fr.compiled)} op(s) @ W{b}"
                              for b, fr in sorted(mixed.by_width.items()))
            print(f"library {args.library}: mixed-width frontier ({per_w})")
            print(f"width map (budget {budget:.5f}): "
                  f"{' '.join('w' + str(b) for b in width_map)} — "
                  f"layers per width {counts}")
            print(f"mixed area {mixed_report['mixed_area']:.3f} µm² vs best "
                  f"uniform {mixed_report['best_uniform_area']:.3f} µm² "
                  f"(advantage {mixed_report['advantage']:.3f})")
            ladder = build_mixed_ladder(mixed, width_map, sens,
                                        levels=args.ladder_levels)
            plan = ladder.plan(0 if need_ladder else
                               min(len(ladder) - 1, _budget_level(
                                   ladder, budget)))
            if args.watch_library:
                watcher = LibraryWatcher(args.library,
                                         min_poll_s=args.poll_s,
                                         widths=mixed.widths)
        else:
            width = select_width(cfg, requested=args.width)
            cfg = cfg.with_approx_mlp(bits=width.bits)
            compiled, exact_area, bits = _frontier(args.library, width)
            sens = (costs_for(profile_obj, width.bits, compiled,
                              cfg.n_layers)
                    if profile_obj is not None else None)
            print(f"library {args.library}: {len(compiled)} operator(s) on "
                  f"the {bits}-bit multiplier frontier "
                  f"(serving W{width.bits}A{width.bits}, "
                  f"{width.side}x{width.side} tables)")
            if need_ladder:
                ladder = PlanLadder.build(compiled, cfg.n_layers,
                                          exact_area=exact_area,
                                          sensitivities=sens,
                                          levels=args.ladder_levels)
                plan = ladder.plan(0)   # start exact
            else:
                if sens is not None and args.qos_budget is None:
                    raise SystemExit(
                        "--profile prices the startup plan in measured-"
                        "drift units; give an explicit --qos-budget in "
                        "mean-|Δlogit| terms (the mae16-scaled default "
                        "of 50.0 would max-downgrade every layer)")
                plan = _startup_plan(
                    cfg, compiled, exact_area,
                    50.0 if args.qos_budget is None else args.qos_budget,
                    sens=sens)
            if args.watch_library:
                # non-native widths pin the watcher to the composed
                # frontier; width 4 keeps the legacy block-frontier
                # reload semantics
                tb = width.bits if width.bits != 4 else None
                watcher = LibraryWatcher(args.library, min_poll_s=args.poll_s,
                                         target_bits=tb)
        if args.adaptive:
            controller = QoSController(ladder, ControllerConfig(
                target_ms_per_step=args.target_ms_per_step,
                drift_budget=args.drift_budget,
                shadow_every=args.shadow_every,
            ))
            print(f"adaptive: {len(ladder)}-level plan ladder, target "
                  f"{args.target_ms_per_step} ms/step, drift budget "
                  f"{args.drift_budget}")
        if args.qos_class:
            from ..sensitivity.classes import (ClassBook, ClassScheduler,
                                               parse_class_mix)

            book = ClassBook.parse(args.qos_class)
            scheduler = ClassScheduler(book, ladder,
                                       shadow_every=args.shadow_every)
            class_mix = (parse_class_mix(args.class_mix) if args.class_mix
                         else book.equal_mix())
            tiers = ", ".join(
                f"{c.name}(budget {c.drift_budget}, cap level "
                f"{scheduler.cap(c.name)}"
                + (f", SLO {c.slo_ms}ms" if c.slo_ms is not None else "")
                + ")" for c in book)
            print(f"QoS classes: {tiers}")
        if args.adaptive or args.qos_class:
            from ..sensitivity import OnlineSensitivity

            if profile_obj is not None:
                online = OnlineSensitivity.from_profile(
                    profile_obj, args.width, width_map=width_map)
            else:
                online = OnlineSensitivity(cfg.n_layers)

    def fresh_control():
        """A fresh controller/scheduler/online triple.  QoS state (EWMA,
        hysteresis, per-class backoff, online sensitivities) is strictly
        per-engine, so the --compare-fixed baseline and every extra
        --replicas engine each get their own."""
        c = sc = on = None
        if args.adaptive:
            c = QoSController(ladder, ControllerConfig(
                target_ms_per_step=args.target_ms_per_step,
                drift_budget=args.drift_budget,
                shadow_every=args.shadow_every))
        if args.qos_class:
            from ..sensitivity.classes import ClassScheduler

            sc = ClassScheduler(book, ladder,
                                shadow_every=args.shadow_every)
        if args.adaptive or args.qos_class:
            from ..sensitivity import OnlineSensitivity

            on = (OnlineSensitivity.from_profile(
                profile_obj, args.width, width_map=width_map)
                if profile_obj is not None
                else OnlineSensitivity(cfg.n_layers))
        return c, sc, on

    def make_health(tag):
        """One HealthPlane per engine (states and burn windows are
        per-engine, exactly like the QoS control plane)."""
        if not args.health:
            return None
        return HealthPlane(book, postmortem_dir=args.postmortem_dir,
                           tag=tag)

    profile = make_profile(args.schedule, ticks=args.ticks,
                           per_tick=args.per_tick or args.batch,
                           prompt_len=args.prompt_len, gen_len=args.gen_len,
                           class_mix=class_mix, prompt_dist=prompt_dist)

    if args.continuous and cfg.family == "audio":
        raise SystemExit("--continuous: continuous batching serves LM "
                         "families only (paged decode)")

    params = init_model(cfg, args.seed, device=dev)
    warmup = None
    if cfg.family == "audio":
        from ..models.encdec import prefill_cross
        from ..train.data import DataState, synth_batch

        # the encoder's input for every batch; the warm-up stages each
        # decoder layer's cross K/V into the engine's cache buffers
        frames = synth_batch(cfg, args.batch, 1, DataState(args.seed, 0),
                             device=dev)["frames"]
        warmup = lambda caches: prefill_cross(cfg, params, frames, caches)  # noqa: E731

    common = dict(
        plan=plan, compiled=compiled, exact_area=exact_area,
        width_map=width_map,
        sensitivities=(engine_sens if args.library and args.mixed_width
                       else None),
        sens_profile=profile_obj, device=dev,
    )
    router = None
    fixed_row = None
    health = None
    mserver = None

    def start_metrics(telemetries, health_obj=None, replicas=None):
        """Live scrape endpoint over the registries the serve is about
        to write into — the same snapshots the --trace dump merges at
        exit, read fresh on every GET."""
        if args.metrics_port is None:
            return None
        from ..obs.httpd import MetricsServer

        providers = [get_registry().snapshot]
        providers += [t.registry.snapshot for t in telemetries]
        if replicas is not None:
            def health_provider():
                reports = {r.name: r.health.report()
                           for r in replicas if r.health is not None}
                if not reports:
                    return {"state": "ok"}
                worst = max(reports, key=lambda n: state_rank(
                    reports[n]["state"]))
                return dict(reports[worst], replica=worst)
        elif health_obj is not None:
            health_provider = health_obj.report
        else:
            health_provider = None
        srv = MetricsServer(port=args.metrics_port,
                            snapshot_providers=providers,
                            health_provider=health_provider,
                            trace_dir=args.trace)
        port = srv.start()
        print(f"metrics endpoint -> http://127.0.0.1:{port}/metrics "
              f"(/healthz, /costs.json)")
        return srv

    if args.continuous:
        max_slots = args.max_slots or args.batch

        def make_engine():
            return ContinuousServingEngine(
                cfg, params, max_slots=max_slots,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                page_size=args.page_size, n_pages=args.pages,
                steps_per_tick=args.steps_per_tick, **common)

        if args.compare_fixed:
            # same model, same profile, same (fresh) control plane —
            # the only variable is the batching discipline
            fc, fs, fo = fresh_control()
            baseline = ServingEngine(
                cfg, params, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                **common)
            tb = time.time()
            fixed_row = baseline.serve(
                profile, controller=fc, scheduler=fs, online=fo,
                telemetry=Telemetry(), seed=args.seed).summary()
            fixed_row["wall_s"] = round(time.time() - tb, 3)
            fixed_row["mode"] = "fixed"
            fixed_row["batch"] = args.batch
            fixed_row["trace_count"] = baseline.trace_count

        if args.replicas > 1:
            class_names = ([c.name for c in book]
                           if book is not None else [])
            replicas = []
            for i in range(args.replicas):
                c, sc, on = ((controller, scheduler, online) if i == 0
                             else fresh_control())
                aff = tuple(n for j, n in enumerate(class_names)
                            if j % args.replicas == i)
                replicas.append(Replica(
                    f"replica{i}", make_engine(), controller=c,
                    scheduler=sc, online=on, classes=aff,
                    health=make_health(f"replica{i}")))
            router = ReplicaRouter(replicas, watcher=watcher)
            mserver = start_metrics(
                [r.telemetry for r in replicas], replicas=replicas)
            t0 = time.time()
            s = router.serve(profile, seed=args.seed,
                             steps_per_tick=args.steps_per_tick,
                             log=print)
            wall = time.time() - t0
            engine = replicas[0].engine
            telemetry = replicas[0].telemetry
        else:
            engine = make_engine()
            health = make_health("serve")
            serve_tel = Telemetry()
            mserver = start_metrics([serve_tel], health_obj=health)
            t0 = time.time()
            telemetry = engine.serve(
                profile, controller=controller, watcher=watcher,
                scheduler=scheduler, online=online,
                telemetry=serve_tel, seed=args.seed,
                steps_per_tick=args.steps_per_tick, health=health,
                log=print)
            wall = time.time() - t0
    else:
        engine = ServingEngine(
            cfg, params, batch=args.batch, prompt_len=args.prompt_len,
            gen_len=args.gen_len, warmup_caches=warmup, **common)
        health = make_health("serve")
        serve_tel = Telemetry()
        mserver = start_metrics([serve_tel], health_obj=health)
        t0 = time.time()
        telemetry = engine.serve(profile, controller=controller,
                                 watcher=watcher, scheduler=scheduler,
                                 online=online, telemetry=serve_tel,
                                 seed=args.seed, health=health,
                                 log=print)
        wall = time.time() - t0

    if router is not None:
        print(f"arch={cfg.name} profile={profile.name} mode=router "
              f"replicas={args.replicas} requests={s['requests']} "
              f"preemptions={s.get('preemptions', 0)} wall={wall:.2f}s")
        for name, row in s["replicas"].items():
            print(f"  {name:<10s}: routed {row['routed']}, "
                  f"{row['decode_tok_s']:.1f} tok/s, "
                  f"{row['ms_per_step']:.2f} ms/step, "
                  f"trace {row['trace_count']}x"
                  + (f", plan {row['plan']}" if "plan" in row else ""))
        s["mode"] = "router"
    else:
        s = telemetry.summary()
    if router is not None:
        pass
    elif args.continuous:
        print(f"arch={cfg.name} profile={profile.name} mode=continuous "
              f"slots={engine.max_slots} steps={s.get('steps', 0)} "
              f"requests={s['requests']} wall={wall:.2f}s")
        lat = s.get("latency_ms_per_step", {})
        print(f"  decode : {s['decode_tok_s']:.1f} tok/s "
              f"({s['ms_per_step']:.2f} ms/step"
              + (f", p95 {lat['p95']}" if "p95" in lat else "") + ")")
        if "ttft_ms" in s:
            print(f"  ttft   : p50 {s['ttft_ms']['p50']} ms, "
                  f"p95 {s['ttft_ms']['p95']} ms")
        if s.get("preemptions"):
            print(f"  preemptions: {s['preemptions']}")
    else:
        print(f"arch={cfg.name} profile={profile.name} "
              f"batches={s['batches']} requests={s['requests']} "
              f"wall={wall:.2f}s")
        print(f"  decode : {s['decode_tok_s']:.1f} tok/s "
              f"({s['ms_per_step']:.1f} ms/step)")
        print(f"  prefill: {s['prefill_tok_s']:.1f} tok/s "
              f"(python-loop prefill, timed separately from decode)")
        if engine.last_tokens is not None:
            print("sample:", engine.last_tokens[0, :16].tolist())
    if router is None and engine.plan is not None:
        print(f"  plan swaps: {s['swaps']} {s['swaps_by_reason']} — decode "
              f"step traced {engine.trace_count}x")
    if scheduler is not None and router is None:
        for name, row in s.get("classes", {}).items():
            budget = scheduler.book.get(name).drift_budget
            slo = scheduler.book.get(name).slo_ms
            drift = row.get("mean_drift")
            p95 = row.get("p95_ms_per_step")
            print(f"  class {name:<8s}: {row['requests']} req, "
                  f"{row['ms_per_step']} ms/step"
                  + (f" (p50 {row['p50_ms_per_step']} / p95 {p95} / "
                     f"p99 {row['p99_ms_per_step']})" if p95 is not None
                     else "")
                  + f", mean drift {'-' if drift is None else drift} "
                  f"(budget {budget})"
                  + (f", SLO {slo}ms "
                     + ("OK" if p95 is not None and p95 <= slo else "MISS")
                     if slo is not None else ""))
    if online is not None and online.n_updates:
        print(f"  online sensitivities ({online.n_updates} samples): "
              f"{np.round(online.sensitivities(), 4).tolist()}")
    if args.telemetry:
        telemetry.dump(args.telemetry)
        print(f"telemetry -> {args.telemetry}")
    if router is None and engine.plan is not None:
        # routing facts for smoke gates: the serving width and how many
        # layers actually run a searched (non-exact) operator
        s["width_bits"] = engine.width.bits if engine.width else None
        s["widths"] = list(engine.widths)
        s["approx_layers"] = sum(
            1 for c in engine.plan.choices if c.key is not None)
    if router is None:
        s["trace_count"] = engine.trace_count
    if router is None and args.continuous:
        s["mode"] = "continuous"
        s["max_slots"] = engine.max_slots
        s["page_size"] = engine.page_size
        s["n_pages"] = engine.n_pages
        if fixed_row is not None:
            # the paired rows the acceptance gate reads: same model, same
            # profile, only the batching discipline differs
            cmp = {"fixed": fixed_row}
            if fixed_row.get("decode_tok_s"):
                cmp["decode_tok_s_gain"] = round(
                    s["decode_tok_s"] / fixed_row["decode_tok_s"] - 1, 4)
            fp50 = fixed_row.get("decode_tok_s_pct", {}).get("p50")
            cp50 = s.get("decode_tok_s_pct", {}).get("p50")
            if fp50 and cp50:
                # steady-state (median per-observation) throughput gain:
                # robust to the one-off trace/compile step both engines pay
                cmp["decode_tok_s_p50_gain"] = round(cp50 / fp50 - 1, 4)
            p95g = {}
            for cname, crow in s.get("classes", {}).items():
                frow = fixed_row.get("classes", {}).get(cname, {})
                if crow.get("p95_ms_per_step") and frow.get(
                        "p95_ms_per_step"):
                    p95g[cname] = round(
                        1 - crow["p95_ms_per_step"]
                        / frow["p95_ms_per_step"], 4)
            if p95g:
                cmp["p95_ms_per_step_reduction"] = p95g
            s["compare"] = cmp
            print(f"  vs fixed: decode {fixed_row['decode_tok_s']:.1f} -> "
                  f"{s['decode_tok_s']:.1f} tok/s "
                  f"({100 * cmp.get('decode_tok_s_gain', 0.0):+.1f}%"
                  + (f"; steady-state p50 "
                     f"{100 * cmp['decode_tok_s_p50_gain']:+.1f}%"
                     if "decode_tok_s_p50_gain" in cmp else "") + ")"
                  + (f", p95 ms/step reduction {p95g}" if p95g else ""))
    if mixed_report is not None:
        s["mixed"] = mixed_report
    if scheduler is not None and router is None:
        for name, row in s.get("classes", {}).items():
            row["drift_budget"] = scheduler.book.get(name).drift_budget
            row["slo_ms"] = scheduler.book.get(name).slo_ms
        s["class_state"] = scheduler.snapshot(
            controller.level if controller is not None else None)
    if online is not None and online.n_updates:
        s["online_sensitivity"] = np.round(
            online.sensitivities(), 6).tolist()
    if args.health:
        # the gateable health doc: single engines report their own plane,
        # a router reports its worst replica (per-replica reports already
        # sit in s["replicas"][name]["health"])
        if router is not None:
            reports = {r.name: r.health.report() for r in router.replicas}
            worst = max(reports, key=lambda n: state_rank(
                reports[n]["state"]))
            hr = dict(reports[worst], replica=worst)
        else:
            hr = health.report()
        s["health"] = hr
        print(f"  health : {hr['state']} "
              f"({hr['anomalies_fired']} anomaly(ies), "
              f"{hr['pages']} page transition(s), "
              f"{hr['dumps']} post-mortem(s))"
              + (f" [worst replica: {worst}]" if router is not None
                 else ""))
        for a in hr.get("recent_anomalies", [])[-3:]:
            cause = a.get("cause")
            print(f"    anomaly {a['signal']}@{a['step']} "
                  f"{a['direction']} z={a['zscore']:+.1f}"
                  + (f" <- {cause['event']}@{cause['step']}"
                     + (f" [{cause['event_id']}]" if cause["event_id"]
                        else "")
                     if cause else " (no recent control event)"))
        if args.postmortem_dir and hr["dumps"]:
            print(f"post-mortems -> {args.postmortem_dir} "
                  f"({hr['dumps']} bundle(s); "
                  f"python -m repro_torch.obs postmortem --dir "
                  f"{args.postmortem_dir})")
    if mserver is not None:
        # stop before the exit snapshot lands in the trace dir: the live
        # endpoint merges trace-dir snapshots into every scrape, so
        # serving past the dump would double-count this process
        mserver.stop()
    if args.trace:
        # the serve-side metric snapshot joins any fleet-side ones already
        # in the dir: per-batch latency/throughput histograms (telemetry's
        # own registry) plus the process registry the watcher and class
        # scheduler record into; a router merges every replica's registry
        snaps = [get_registry().snapshot()]
        if router is not None:
            snaps += [r.telemetry.registry.snapshot()
                      for r in router.replicas]
        else:
            snaps.append(telemetry.registry.snapshot())
        merged = MetricRegistry.from_snapshots(snaps)
        dump_metrics(args.trace, merged)
        print(f"trace -> {args.trace}")
        if args.continuous:
            # lifecycle roll-up for the provenance-smoke gate: how many
            # request chains the trace reconstructs, and how many are
            # causally complete (python -m repro_torch.obs requests drills in)
            from ..obs.requests import build_timelines
            from ..obs.trace import read_trace
            tls = build_timelines(read_trace(args.trace))
            s["requests_traced"] = len(tls)
            s["requests_complete"] = sum(
                1 for t in tls.values() if t.complete)
            print(f"  request chains: {s['requests_complete']}/"
                  f"{s['requests_traced']} complete "
                  f"(python -m repro_torch.obs requests --trace {args.trace})")
    if args.bench_json:
        write_bench_json(args.bench_json, s)
        print(f"bench summary -> {args.bench_json}")


if __name__ == "__main__":
    main()
