"""Adaptive serving engine: a request queue drained in fixed-size batches,
each prefilled and then greedily decoded, with the MLP matmuls routed
through a per-layer approximate-multiplier LUT stack that hot-swaps
between batches.

The engine serves either a raw stack (``luts=``) or a QoS plan (``plan=``
with its ``compiled`` frontier), as the reference's constructor takes it:
the plan is stacked by :func:`repro_torch.library.qos.stack_luts` --
``(L, 16, 16)`` for W4A4, composed ``(L, 256, 256)`` for W8A8 -- or, with
a ``width_map``, by :func:`repro_torch.precision.plans.stack_mixed_luts`
into one ``(n_group, side, side)`` stack per width.  The live stack is
moved to the device once, into buffers the engine owns;
:meth:`ServingEngine.swap_plan` copies a new plan's stack into those same
buffers.

**One captured step.**  The reference jits its decode step once and pins
``trace_count == 1`` across every swap.  The port's counterpart is a
:class:`StaticStep`: the decode step over fixed buffers -- the token
``(B, 1)``, the position (a one-element device tensor), the per-layer KV
caches, the stack the step reads (one buffer per width group) and the
output logits -- captured once as a ``torch.cuda.CUDAGraph`` on the card
and replayed for every prefill and decode token of every batch and for
the shadow step.  On the CPU the same step runs eagerly over the same
buffers.  ``trace_count`` counts captures (builds on the CPU) and stays
1.  Whatever a batch decodes on -- the live stack, a per-batch override,
the exact shadow stack -- is copied into the step's own stack buffer
before the replays that read it, so no swap, class stack or shadow step
changes an address the graph recorded.

One ``run_batch`` serves up to ``batch`` requests: prefill walks the
prompt through the same step, token by token, then greedy decode extends
``gen_len`` tokens.  Prefill and decode are timed separately, each
ending in a device synchronise.  Between batches :meth:`ServingEngine.serve`
runs the control plane: the library watcher's refresh, per-class stacks
from a class scheduler, the exact shadow step that measures drift, the
online sensitivity estimate and the QoS controller's level moves, with
telemetry and trace spans.

Drift sampling: on a shadow batch the final decode step is also run on
the exact stack, on the same caches saved before and restored after; the
mean |Δlogit| between the live and shadow step is the drift the
controller holds under its budget.  Its time is excluded from
``decode_s``.

**Continuous batching.**  :class:`ContinuousServingEngine` decodes
token-at-a-time over a fixed pool of slots, requests joining and leaving
per step, KV in a paged pool, SLO classes preempting lower tiers.  Its
step is a :class:`PagedStaticStep`: the same capture over per-slot
positions, an active mask and page tables, copied in from the host each
step.  Both engines mirror every swap, refresh and control move into an
SLO health plane when one is given.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..library.qos import (LayerPlan, plan_layer_areas, refresh_plan,
                           stack_luts, validate_lut_stack)
from ..models import decode_fn, decode_paged_fn, init_caches, init_paged_caches
from ..models.lm import check_device, check_lut_depth, to_device_luts
from ..obs.trace import current_tracer
from ..obs.trace import event as trace_event
from ..obs.trace import span as trace_span
from ..precision.widths import exact_table, width_from_stack
from .controller import effective_load_ms
from .loadgen import LoadProfile, Request, synth_requests
from .telemetry import Telemetry

__all__ = ["BatchStats", "ContinuousServingEngine", "PagedStaticStep",
           "ServingEngine", "StaticStep"]

# warm-up runs of the step before its capture, on a side stream: the
# kernels' first calls load the library and set their launch attributes,
# which a capture must not record
_WARMUP = 3


def _area_hi_map(compiled) -> dict[str, float]:
    """Operator key -> glue-inclusive area upper bound over a compiled
    frontier (``CompiledLut.area_hi``; records compiled without a
    bracket collapse to their own area).  Mixed-width frontiers can
    carry one key at two widths -- keeping the max keeps the value a
    sound upper bound."""
    out: dict[str, float] = {}
    for rec, comp in compiled:
        hi = getattr(comp, "area_hi", None)
        hi = rec.area if hi is None else max(rec.area, hi)
        out[rec.key] = max(out.get(rec.key, 0.0), hi)
    return out


def _leaves(stack) -> tuple:
    """The tensors of a stack: itself, or one per width group, by width."""
    if isinstance(stack, dict):
        return tuple(stack[b] for b in sorted(stack))
    return (stack,)


def _owned(stack, device: torch.device):
    """A stack (or mixed-width dict) as int32 tensors on ``device`` in
    memory of their own: ``torch.as_tensor`` may share the caller's."""
    moved = to_device_luts(stack, device)
    if isinstance(moved, dict):
        return {b: moved[b].clone() for b in sorted(moved)}
    return moved.clone()


@dataclass
class BatchStats:
    """Measurements of one served batch."""

    n_requests: int
    prefill_s: float
    decode_s: float
    prefill_tokens: int
    decode_tokens: int
    decode_steps: int
    drift: float | None = None

    @property
    def ms_per_step(self) -> float:
        return 1e3 * self.decode_s / max(1, self.decode_steps)

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def prefill_tok_s(self) -> float:
        return self.prefill_tokens / self.prefill_s if self.prefill_s else 0.0


class StaticStep:
    """The engine's decode step over fixed buffers: ``tok`` ``(B, 1)``
    int32, ``pos`` ``(1,)`` long, ``caches`` (one dict a layer, from
    :func:`repro_torch.models.init_caches`: KV, MLA's compressed cache,
    or the SSM's and RWKV's recurrent state, all written in place),
    ``luts`` (the stack the step reads, a dict per width group for
    a mixed map, or ``None``) and ``logits`` ``(B, V)`` float32.

    On a CUDA device the step is warmed up on a side stream and captured
    once as a CUDA graph; :meth:`replay` replays it and credits each
    kernel wrapper's ``launches`` with the launches one replay makes
    (counted at capture, when the wrappers ran but launched nothing).  On
    the CPU :meth:`replay` runs the step eagerly and copies its logits
    into ``logits``.  Callers write ``tok``, ``pos``, the caches and the
    stack in place; nothing is ever reallocated.
    """

    def __init__(self, cfg, params, *, batch: int, total: int, luts,
                 width_map, backend: ops.Backend,
                 device: torch.device) -> None:
        self.device = device
        self.tok = torch.zeros((batch, 1), dtype=torch.int32, device=device)
        self.pos = torch.zeros((1,), dtype=torch.long, device=device)
        self.caches = init_caches(cfg, batch, total, device=device)
        step = decode_fn(cfg)

        def run() -> torch.Tensor:
            return step(cfg, params, self.caches, self.tok, self.pos,
                        luts=self.luts, width_map=width_map,
                        backend=backend)[0]

        self._build(run, luts, (batch, cfg.vocab_size))

    def _build(self, run: Callable[[], torch.Tensor], luts,
               logits_shape: tuple[int, int]) -> None:
        """Own a copy of ``luts``, then capture ``run`` (on a card) or
        keep it to run eagerly (on the CPU)."""
        self.luts = (None if luts is None else
                     {b: t.clone() for b, t in luts.items()}
                     if isinstance(luts, dict) else luts.clone())
        self._saved = None          # cache copies for the shadow step
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self._graph = None
        self._credits: list[tuple[Callable, int]] = []
        if self.device.type == "cuda":
            self._capture(run)
        else:
            self._run = run
            self.logits = torch.zeros(logits_shape, dtype=torch.float32,
                                      device=self.device)

    def _capture(self, run) -> None:
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                run()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        # the capture releases cached blocks first; so does this, so that
        # the growth of the reserved memory is the graph's own pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        counters = ops.launch_counters()
        before = [fn.launches for fn in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.logits = run()
        torch.cuda.synchronize(self.device)
        # the wrappers counted calls that the capture only recorded: take
        # them back, and credit them once per replay instead
        for fn, n in zip(counters, before):
            if fn.launches != n:
                self._credits.append((fn, fn.launches - n))
            fn.launches = n
        self._graph = graph
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved

    @property
    def launches_per_replay(self) -> dict[str, int]:
        return {fn.__name__: n for fn, n in self._credits}

    def replay(self) -> torch.Tensor:
        """Run the step once on the buffers' current contents; returns
        ``logits``, overwritten by the next replay."""
        if self._graph is not None:
            self._graph.replay()
            for fn, n in self._credits:
                fn.launches += n
        else:
            self.logits.copy_(self._run())
        self.replays += 1
        return self.logits

    def load(self, stack) -> None:
        """Copy ``stack`` (shaped like ``luts``) into the step's stack."""
        for dst, src in zip(_leaves(self.luts), _leaves(stack)):
            dst.copy_(src)

    def reset(self) -> None:
        """Zero the caches in place, as a fresh batch needs them."""
        for c in self.caches:
            for buf in c.values():
                buf.zero_()

    def save_caches(self) -> None:
        """Copy every cache tensor (rings and page pools alike) into a
        copy allocated on first use and reused after."""
        if self._saved is None:
            self._saved = [{k: torch.empty_like(v) for k, v in c.items()}
                           for c in self.caches]
        for dst, src in zip(self._saved, self.caches):
            for k, buf in src.items():
                dst[k].copy_(buf)

    def restore_caches(self) -> None:
        for dst, src in zip(self.caches, self._saved):
            for k, buf in src.items():
                dst[k].copy_(buf)


class PagedStaticStep(StaticStep):
    """The continuous engine's decode step over fixed buffers: ``tok``
    ``(S, 1)`` int32, ``pos`` ``(S,)`` long, ``active`` ``(S,)`` bool,
    ``tables`` ``(S, T)`` long, ``caches`` (:func:`repro_torch.models.init_paged_caches`:
    a page pool ``{"kp", "vp"}`` per global layer, ``{"ckvp", "krp"}``
    per MLA layer, a per-slot ring ``{"k", "v"}`` per windowed one),
    ``luts`` and ``logits`` ``(S, V)``.

    Captured once on a card and run eagerly on the CPU, as
    :class:`StaticStep`.  Each step the host writes its numpy inputs with
    :meth:`write`, through staging buffers of its own (page-locked on a
    card, so the copies are asynchronous): joins, leaves, preemptions,
    plan swaps and class stacks change buffer contents, never an address
    the graph recorded.
    """

    def __init__(self, cfg, params, *, slots: int, n_pages: int,
                 page_size: int, table_entries: int, total: int, luts,
                 width_map, backend: ops.Backend,
                 device: torch.device) -> None:
        self.device = device
        self.tok = torch.zeros((slots, 1), dtype=torch.int32, device=device)
        self.pos = torch.zeros((slots,), dtype=torch.long, device=device)
        self.active = torch.zeros((slots,), dtype=torch.bool, device=device)
        self.tables = torch.zeros((slots, table_entries), dtype=torch.long,
                                  device=device)
        self.caches = init_paged_caches(cfg, slots, n_pages, page_size, total,
                                        device=device)
        pin = device.type == "cuda"
        self._inputs = [(buf, torch.zeros(buf.shape, dtype=buf.dtype,
                                          pin_memory=pin))
                        for buf in (self.tok, self.pos, self.active,
                                    self.tables)]
        step = decode_paged_fn(cfg)

        def run() -> torch.Tensor:
            return step(cfg, params, self.caches, self.tok, self.pos,
                        self.active, self.tables, luts=self.luts,
                        width_map=width_map, backend=backend)[0]

        self._build(run, luts, (slots, cfg.vocab_size))

    def write(self, tok: np.ndarray, pos: np.ndarray, active: np.ndarray,
              tables: np.ndarray) -> None:
        """Copy one step's host inputs into the step's buffers.  The
        staging buffers are rewritten only after the previous step's
        argmax was read, so its copies have completed."""
        for (buf, host), arr in zip(self._inputs, (tok, pos, active, tables)):
            host.numpy()[...] = arr
            buf.copy_(host, non_blocking=True)


class ServingEngine:
    """Batched greedy serving of one model on one device.

    ``luts``: a raw per-layer LUT stack (numpy or tensor), or ``None``.
    ``plan``: a :class:`~repro_torch.library.qos.LayerPlan` over the
    ``compiled`` frontier, stacked once into the live buffers; with a
    ``width_map`` (one width per layer) the plan is a mixed-width one and
    each width group gets its own buffer.  ``exact_area`` and
    ``sensitivities`` are the frontier's accounting, kept for refreshes.
    Without ``luts`` and ``plan`` the MLP matmuls are exact.
    ``backend="ref"`` runs the plain version of every kernel (the tests
    and ``chip_smoke.py`` hold the kernels against it); it is captured
    the same way.  A measured ``sens_profile``
    (:class:`~repro_torch.sensitivity.profile.SensitivityProfile`) prices
    the frontiers a refresh adopts (:func:`~repro_torch.sensitivity.profile.costs_for`).
    ``warmup_caches(caches)`` stages state the decode step reads into the
    step's own cache buffers, in place, at the start of every batch,
    after they are zeroed (the encoder–decoder family passes
    :func:`~repro_torch.models.encdec.prefill_cross`, which writes each
    layer's cross K/V where the captured step reads it); it returns the
    buffers it was given.
    """

    def __init__(self, cfg, params, *, batch: int, prompt_len: int,
                 gen_len: int, plan: LayerPlan | None = None, compiled=None,
                 exact_area: float | None = None, sensitivities=None,
                 width_map=None, sens_profile=None, luts=None,
                 warmup_caches: Callable | None = None,
                 backend: ops.Backend = "auto",
                 device: str | torch.device = "cuda") -> None:
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        check_device(params, self.device)
        self.batch = int(batch)
        self.prompt_len = int(prompt_len)
        self.gen_len = int(gen_len)
        self.total = self.prompt_len + self.gen_len
        self.backend = backend
        self._warmup = warmup_caches
        self.last_tokens: np.ndarray | None = None   # (n_requests, gen_len)
        self._static: StaticStep | None = None
        self._trace_count = 0
        # the SLO health plane (obs.health.HealthPlane), bound by serve()
        # or start(); every control-plane trace event is mirrored into it
        # so fired anomalies attribute to the swap/refresh/control behind
        self._health = None
        # chaos hook: extra seconds slept inside the timed step section of
        # the continuous engine (the induced-latency-spike drill)
        self.inject_step_delay = 0.0
        # per-plan cost rows (obs.costs.plan_cost_row), cached by plan_id
        self._cost_rows: dict[str, dict] = {}
        self._macs_per_layer = None

        self._adaptive = plan is not None
        self._plan = plan
        self._compiled = list(compiled) if compiled is not None else []
        self._exact_area = exact_area
        # a vector for uniform-width serves, a {bits: vector-or-matrix}
        # dict for mixed-width, kept for ladder rebuilds
        if isinstance(sensitivities, dict):
            self._sens = sensitivities
        else:
            self._sens = (np.ones(cfg.n_layers) if sensitivities is None
                          else np.asarray(sensitivities, dtype=np.float64))
        self._width_map = (tuple(int(b) for b in width_map)
                           if width_map is not None else None)
        # measured SensitivityProfile (optional): refresh paths re-price
        # measured cost matrices against the refreshed frontier through it
        # -- a stale (L, O) matrix cannot follow a frontier whose operator
        # set a background fleet sweep just changed
        self._profile = sens_profile
        self._mae_by_key = {rec.key: comp.mae for rec, comp in self._compiled}
        self._area_hi_by_key = _area_hi_map(self._compiled)

        if plan is not None and luts is not None:
            raise ValueError("give a plan or a raw luts stack, not both")
        if self._width_map is not None and plan is None:
            raise ValueError("a width_map routes a mixed-width plan; give plan=")
        if (plan is not None or luts is not None) and not cfg.approx_mlp:
            raise ValueError("a LUT stack routes MLP matmuls; build the "
                             "config with .with_approx_mlp()")
        self._exact_luts = None
        if self._width_map is not None:
            from ..precision.plans import exact_mixed_stacks, stack_mixed_luts

            if len(self._width_map) != cfg.n_layers:
                raise ValueError(f"width_map has {len(self._width_map)} "
                                 f"entries for {cfg.n_layers} layers")
            luts = stack_mixed_luts(plan, self._compiled, self._width_map)
            self._exact_luts = to_device_luts(
                exact_mixed_stacks(self._width_map), self.device)
        elif plan is not None:
            luts = stack_luts(plan, self._compiled)
        self._luts = None if luts is None else _owned(luts, self.device)
        if isinstance(self._luts, dict):
            self.width = None
            self.widths = tuple(sorted(self._luts))
        elif self._luts is not None:
            # raises unless (L, side, side)
            self.width = width_from_stack(self._luts)
            self.widths = (self.width.bits,)
            if self._luts.shape[0] != cfg.n_layers:
                raise ValueError(f"stack has {self._luts.shape[0]} tables for "
                                 f"{cfg.n_layers} layers")
            if plan is not None:
                # the exact shadow stack shares the live stack's width: a
                # W8A8 serve shadows against the exact 256x256 table
                side = self.width.side
                self._exact_luts = to_device_luts(np.broadcast_to(
                    exact_table("mul", self.width.bits).astype(np.int32),
                    (cfg.n_layers, side, side)).copy(), self.device)
        else:
            self.width = None
            self.widths = ()
        for t in _leaves(self._luts) if self._luts is not None else ():
            ops.check_luts(t, backend=backend)
        if self._luts is not None:
            check_lut_depth(cfg, self._luts, backend=backend)

    # ----------------------------------------------------------------- state
    @property
    def trace_count(self) -> int:
        """How many times the decode step was captured (built, on the
        CPU); must stay 1."""
        return self._trace_count

    @property
    def plan(self) -> LayerPlan | None:
        return self._plan

    @property
    def static_step(self) -> StaticStep:
        """The captured step, built (warmed up and captured) on first use."""
        if self._static is None:
            self._static = self._new_step()
            self._trace_count += 1
        return self._static

    def _new_step(self) -> StaticStep:
        return StaticStep(
            self.cfg, self.params, batch=self.batch, total=self.total,
            luts=self._luts, width_map=self._width_map,
            backend=self.backend, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _adopt(self, luts):
        """A per-batch stack on the device, in the live stack's form (one
        ``(L, side, side)`` stack, or a ``{bits: stack}`` dict over the
        live width groups) and checked for the kernel route once."""
        if self._luts is None:
            raise ValueError("engine was built without a LUT stack")
        new = to_device_luts(luts, self.device)
        if isinstance(self._luts, dict) != isinstance(new, dict) or (
                isinstance(new, dict) and sorted(new) != sorted(self._luts)):
            form = (f"a {{bits: stack}} dict over widths {sorted(self._luts)}"
                    if isinstance(self._luts, dict)
                    else "one (L, side, side) stack")
            raise ValueError(f"a per-batch override takes the live stack's "
                             f"form: {form}")
        for live, t in zip(_leaves(self._luts), _leaves(new)):
            if t.shape != live.shape:
                raise ValueError(f"stack shape {tuple(t.shape)} differs from "
                                 f"the live {tuple(live.shape)}")
        for t in _leaves(new):
            ops.check_luts(t, backend=self.backend)
        return new

    # ------------------------------------------------------------------ swap
    def swap_plan(self, plan: LayerPlan, stack, *, reason: str = "manual",
                  telemetry: Telemetry | None = None,
                  batch_idx: int = 0) -> bool:
        """Adopt a new plan between batches: copy its stack into the live
        buffers in place, so they keep their addresses; the captured step
        reads it from the next batch on.  Suppresses no-op swaps (same
        per-layer assignment); validates the stack against the live one
        (shape, dtype, width groups) and for the kernel route before
        anything is written, so a refused swap leaves the live stack
        untouched.  Records the swap in ``telemetry`` and as a
        ``serve.swap`` trace event.  Returns whether the plan changed."""
        if self._plan is None:
            raise ValueError("engine was built without a QoS plan")
        if plan.plan_id == self._plan.plan_id:
            return False
        new = to_device_luts(stack, self.device)
        validate_lut_stack(self._luts, new)
        for t in _leaves(new):
            ops.check_luts(t, backend=self.backend)
        if isinstance(new, dict):
            for bits, src in new.items():
                self._luts[bits].copy_(src)
        else:
            self._luts.copy_(new)
        old_id = self._plan.plan_id
        self._plan = plan
        if telemetry is not None:
            telemetry.register_plan(plan)
            telemetry.record_swap(batch=batch_idx, reason=reason,
                                  old=old_id, new=plan.plan_id)
        eid = trace_event("serve.swap", reason=reason, batch=batch_idx,
                          old=old_id, new=plan.plan_id)
        if self._health is not None:
            self._health.note_event("serve.swap", step=batch_idx,
                                    event_id=eid, reason=reason,
                                    old=old_id, new=plan.plan_id)
        return True

    def _set_frontier(self, compiled) -> None:
        self._compiled = list(compiled)
        self._mae_by_key = {rec.key: comp.mae for rec, comp in self._compiled}
        self._area_hi_by_key = _area_hi_map(self._compiled)
        self._cost_rows = {}

    def refresh_library(self, compiled, exact_area: float, *,
                        controller=None, scheduler=None,
                        reason: str = "library",
                        telemetry: Telemetry | None = None,
                        batch_idx: int = 0) -> bool:
        """Adopt a refreshed frontier (the watcher path).  With a
        controller (or class scheduler), its ladder is rebuilt and the
        current level re-stacked; without either, the live plan's budget
        re-selects over the new frontier via
        :func:`repro_torch.library.qos.refresh_plan`.

        Nothing -- engine frontier, controller ladder -- is mutated until
        the new stack passes :func:`~repro_torch.library.qos.validate_lut_stack`
        inside :meth:`swap_plan`: a surprising store merge raises and
        leaves the runtime serving consistently on the old plan."""
        new_sens = self._uniform_sens(compiled)
        if controller is not None or scheduler is not None:
            owner = (controller.ladder if controller is not None
                     else scheduler.ladder)
            new_ladder = owner.refresh(compiled, exact_area,
                                       sensitivities=new_sens)
            level = (min(controller.level, len(new_ladder) - 1)
                     if controller is not None else 0)
            plan, stack = new_ladder.plan(level), new_ladder.luts(level)
        else:
            new_ladder = level = None
            plan = refresh_plan(
                self._plan, compiled,
                self._sens if new_sens is None else new_sens,
                exact_area=exact_area)
            stack = stack_luts(plan, compiled)
        changed = self.swap_plan(plan, stack, reason=reason,
                                 telemetry=telemetry, batch_idx=batch_idx)
        self._set_frontier(compiled)
        self._exact_area = exact_area
        if controller is not None:
            controller.adopt(new_ladder, level=level)
        if scheduler is not None:
            scheduler.adopt(new_ladder)
        return changed

    def refresh_mixed(self, mixed, *, controller=None, scheduler=None,
                      reason: str = "library",
                      telemetry: Telemetry | None = None,
                      batch_idx: int = 0) -> bool:
        """The mixed-width watcher path: rebuild the plan ladder over a
        refreshed :class:`~repro_torch.precision.plans.MixedFrontier`
        inside the frozen width map, then re-point the controller and the
        class scheduler at it.  Group shapes are fixed by the width map,
        so the new level stacks validate against the live ones by
        construction -- and are checked anyway before anything is
        adopted."""
        from ..precision.plans import (build_mixed_ladder, mixed_cost_matrix,
                                       stack_mixed_luts)

        if self._width_map is None:
            raise ValueError("engine serves a uniform width")
        sens = self._mixed_sens(mixed)
        old = (controller.ladder if controller is not None
               else scheduler.ladder if scheduler is not None else None)
        if old is None:
            # plain mixed serve (no controller / classes): re-select the
            # live plan's budget inside the frozen width map
            wm = np.asarray(self._width_map)
            plan = refresh_plan(
                self._plan, mixed.compiled,
                mixed_cost_matrix(mixed, sens, len(wm)),
                exact_area=mixed.exact_areas(self._width_map),
                allowed=mixed.op_bits[None, :] == wm[:, None])
            stack = stack_mixed_luts(plan, mixed.compiled, self._width_map)
        else:
            new_ladder = build_mixed_ladder(
                mixed, self._width_map, sens, levels=old.requested_levels)
            level = (min(controller.level, len(new_ladder) - 1)
                     if controller is not None else 0)
            plan, stack = new_ladder.plan(level), new_ladder.luts(level)
        changed = self.swap_plan(plan, stack, reason=reason,
                                 telemetry=telemetry, batch_idx=batch_idx)
        self._set_frontier(mixed.compiled)
        if old is not None and controller is not None:
            controller.adopt(new_ladder, level=level)
        if old is not None and scheduler is not None:
            scheduler.adopt(new_ladder)
        return changed

    def _uniform_sens(self, compiled):
        """Measured pricing for a refreshed uniform-width frontier, or
        ``None`` when there is no profile (the caller keeps its own
        sensitivity model)."""
        if self._profile is None:
            return None
        from ..sensitivity.profile import costs_for

        return costs_for(self._profile, self.width.bits, compiled,
                         self.cfg.n_layers)

    def _mixed_sens(self, mixed):
        """Per-width pricing for a refreshed mixed frontier: measured via
        the profile when present, else the constructor's sensitivity
        model (vectors follow any frontier; a caller-supplied measured
        matrix cannot, and the resulting ValueError makes the watcher
        skip the refresh)."""
        if self._profile is None:
            return self._sens
        from ..sensitivity.profile import costs_for

        return {bits: costs_for(self._profile, bits, fr.compiled,
                                self.cfg.n_layers)
                for bits, fr in mixed.by_width.items()}

    def _plan_maes(self, plan: LayerPlan) -> np.ndarray:
        """Per-layer operator mae of a plan (0 for exact layers) -- the
        attribution vector the online sensitivity estimator consumes."""
        return np.array([0.0 if c.key is None
                         else self._mae_by_key.get(c.key, 0.0)
                         for c in plan.choices])

    # ----------------------------------------------------------------- batch
    def run_batch(self, requests: list[Request], *, shadow: bool = False,
                  luts=None) -> BatchStats:
        """Serve one batch: prefill the prompts, greedily decode
        ``gen_len`` tokens.  Short batches are zero-padded to the fixed
        batch size, so every batch replays the one captured step.

        ``luts`` overrides the live stack for this batch only, in the live
        stack's form (a ``{bits: stack}`` dict for a mixed map); it is
        copied into the step's stack buffer.  ``shadow`` also runs the
        last decode step on the exact stack and reports the drift."""
        src = self._luts if luts is None else self._adopt(luts)
        return self._run(requests, src, shadow=shadow)

    def _run(self, requests: list[Request], src, *, shadow: bool) -> BatchStats:
        if not 0 < len(requests) <= self.batch:
            raise ValueError(f"{len(requests)} requests for a batch of {self.batch}")
        prompts_np = np.zeros((self.batch, self.prompt_len), np.int32)
        for i, r in enumerate(requests):
            # heterogeneous prompt lengths zero-pad to the fixed geometry
            if len(r.tokens) > self.prompt_len:
                raise ValueError(f"request {r.rid} prompt ({len(r.tokens)}) "
                                 f"exceeds prompt_len ({self.prompt_len})")
            prompts_np[i, :len(r.tokens)] = r.tokens
        prompts = torch.from_numpy(prompts_np).to(self.device)
        step = self.static_step
        step.reset()
        if self._warmup is not None and self._warmup(step.caches) is not step.caches:
            raise ValueError("warmup_caches must write the step's cache "
                             "buffers in place and return them")
        if src is not None:
            step.load(src)
        shadow = shadow and self._adaptive
        n = len(requests)

        with trace_span("serve.batch", n_requests=n) as batch_sp:
            with trace_span("serve.prefill", tokens=n * self.prompt_len):
                self._sync()
                t0 = time.perf_counter()
                for t in range(self.prompt_len):
                    step.tok.copy_(prompts[:, t:t + 1])
                    step.pos.fill_(t)
                    logits = step.replay()
                self._sync()
                t1 = time.perf_counter()

            shadow_logits = None
            shadow_s = 0.0
            generated = []
            with trace_span("serve.decode", steps=self.gen_len) as decode_sp:
                for t in range(self.prompt_len, self.total):
                    tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
                    generated.append(tok)
                    step.tok.copy_(tok)
                    step.pos.fill_(t)
                    if shadow and t == self.total - 1:
                        # the exact shadow step on the same caches, saved
                        # before and restored after; timed apart and
                        # excluded from decode_s, as measurement overhead
                        # would bias the latency the controller acts on
                        with trace_span("serve.shadow"):
                            self._sync()
                            ts = time.perf_counter()
                            step.save_caches()
                            step.load(self._exact_luts)
                            shadow_logits = step.replay().clone()
                            step.restore_caches()
                            step.load(src)
                            self._sync()
                            shadow_s = time.perf_counter() - ts
                    logits = step.replay()
                self._sync()
                t2 = time.perf_counter()
                decode_sp.set(shadow_s=round(shadow_s, 6))

            drift = None
            if shadow_logits is not None:
                # only the real rows: zero-padded requests decode garbage
                drift = float((logits[:n] - shadow_logits[:n]).abs().mean())
            stats = BatchStats(
                n_requests=n,
                prefill_s=t1 - t0,
                decode_s=t2 - t1 - shadow_s,
                prefill_tokens=n * self.prompt_len,
                decode_tokens=n * self.gen_len,
                decode_steps=self.gen_len,
                drift=drift,
            )
            batch_sp.set(ms_per_step=round(stats.ms_per_step, 3),
                         decode_tok_s=round(stats.decode_tok_s, 2))
            if drift is not None:
                batch_sp.set(drift=round(drift, 6))
        self.last_tokens = torch.cat(generated, dim=1)[:n].cpu().numpy()
        return stats

    # ----------------------------------------------------------------- serve
    def serve(
        self,
        profile: LoadProfile,
        *,
        controller=None,
        watcher=None,
        scheduler=None,
        online=None,
        telemetry: Telemetry | None = None,
        seed: int = 0,
        on_batch_end: Callable[["ServingEngine", int], None] | None = None,
        log: Callable[[str], None] | None = None,
        health=None,
    ) -> Telemetry:
        """Run the serving loop over a synthetic load profile.

        Each tick's arrivals join the queue; the queue drains in batches
        of up to ``batch`` requests.  With a class ``scheduler``
        (:class:`repro_torch.sensitivity.classes.ClassScheduler`) there is
        one queue per declared QoS class, drained in priority order, and
        each batch decodes on its class's plan stack -- copied into the
        captured step's stack buffer, so still the one capture.  After
        every batch the control plane runs: watcher poll (library
        refresh), per-class drift bookkeeping, online sensitivity update,
        controller observe (global level move), then the optional
        ``on_batch_end`` hook.  A ``health`` plane
        (:class:`repro_torch.obs.health.HealthPlane`) observes every
        batch and mirrors every swap, refresh and control move."""
        if (profile.prompt_len, profile.gen_len) != (self.prompt_len, self.gen_len):
            raise ValueError("profile geometry differs from the engine's")
        if scheduler is not None and not self._adaptive:
            raise ValueError("class-aware serving needs a QoS plan")
        telemetry = telemetry or Telemetry()
        self._health = health
        if self._adaptive:
            telemetry.register_plan(self._plan)
        per_tick = synth_requests(profile, self.cfg.vocab_size, seed)
        queue: deque[Request] = deque()
        queues: dict[str, deque[Request]] | None = None
        if scheduler is not None:
            queues = {name: deque() for name in scheduler.book.names}
        enqueued_at: dict[int, float] = {}
        # class stacks on the device, checked once, keyed by ladder level
        # and dropped when the ladder is refreshed
        device_stacks: dict[int, object] = {}
        device_ladder = None
        batch_idx = 0
        for tick in range(profile.n_ticks):
            now = time.perf_counter()
            for r in per_tick[tick]:
                enqueued_at[r.rid] = now
                if queues is not None:
                    queues[scheduler.book.route(r.qos_class)].append(r)
                else:
                    queue.append(r)
            while True:
                # ---- next batch: priority class queue, or the one queue
                if queues is not None:
                    cls = next((n for n in scheduler.book.names
                                if queues[n]), None)
                    if cls is None:
                        break
                    q = queues[cls]
                else:
                    if not queue:
                        break
                    cls, q = None, queue
                reqs = [q.popleft() for _ in range(min(self.batch, len(q)))]
                backlog = (sum(len(x) for x in queues.values())
                           if queues is not None else len(queue))
                t_drain = time.perf_counter()
                telemetry.record_queue(
                    cls, backlog,
                    [t_drain - enqueued_at.pop(r.rid, t_drain) for r in reqs])

                # ---- resolve this batch's plan --------------------------
                if scheduler is not None:
                    glevel = (controller.level if controller is not None
                              else scheduler.top_level)
                    level_c = scheduler.level_for(cls, glevel)
                    plan_b = scheduler.ladder.plan(level_c)
                    if scheduler.ladder is not device_ladder:
                        device_stacks.clear()
                        device_ladder = scheduler.ladder
                    src = device_stacks.get(level_c)
                    if src is None:
                        src = self._adopt(scheduler.ladder.luts(level_c))
                        device_stacks[level_c] = src
                    telemetry.register_plan(plan_b)
                else:
                    glevel = level_c = None
                    plan_b, src = self._plan, self._luts

                # per-class cadence first (it counts the batch), then the
                # controller's global cadence -- no short-circuit
                sched_want = (scheduler is not None
                              and scheduler.wants_shadow(cls))
                ctrl_want = (controller is not None
                             and controller.wants_shadow(batch_idx))
                want_shadow = self._adaptive and (sched_want or ctrl_want)
                stats = self._run(reqs, src, shadow=want_shadow)
                telemetry.record_batch(
                    batch=batch_idx, tick=tick, n_requests=stats.n_requests,
                    prefill_s=stats.prefill_s, decode_s=stats.decode_s,
                    prefill_tokens=stats.prefill_tokens,
                    decode_tokens=stats.decode_tokens,
                    decode_steps=stats.decode_steps,
                    plan_id=plan_b.plan_id if self._adaptive else None,
                    drift=stats.drift, backlog=backlog, qos_class=cls,
                )
                if stats.drift is not None and self._adaptive:
                    if scheduler is not None:
                        scheduler.observe(cls, stats.drift)
                    if online is not None:
                        online.update(self._plan_maes(plan_b), stats.drift)
                if health is not None:
                    health.observe_step(
                        step=batch_idx, step_ms=stats.ms_per_step,
                        classes={cls: {}} if cls is not None else {},
                        drift=stats.drift, backlog=backlog,
                        plan_id=plan_b.plan_id if self._adaptive else None,
                        level=glevel,
                        class_state=(scheduler.snapshot(glevel)
                                     if scheduler is not None else None))

                # ---- between-batch control plane ------------------------
                if watcher is not None and self._adaptive and watcher.poll():
                    self._watch(watcher, controller, scheduler, telemetry,
                                batch_idx, log)
                if controller is not None and self._adaptive:
                    # the load signal is effective ms/step: service time
                    # scaled by outstanding work
                    eff_ms = effective_load_ms(stats.ms_per_step,
                                               backlog=backlog,
                                               capacity=self.batch)
                    # with classes, a batch decoded below the global level
                    # (its class cap) says nothing about the global point
                    drift_sig = (stats.drift
                                 if scheduler is None or level_c == glevel
                                 else None)
                    level = controller.observe(eff_ms, drift_sig)
                    if level is not None:
                        self._control(controller, scheduler, telemetry,
                                      level, glevel, batch_idx, log)
                if on_batch_end is not None:
                    on_batch_end(self, batch_idx)
                batch_idx += 1
        return telemetry

    def _watch(self, watcher, controller, scheduler, telemetry, batch_idx,
               log, unit: str = "batch") -> None:
        """The watcher saw the store change: refresh the frontier.  A
        store that lost its multipliers (LookupError) or a refreshed stack
        that would not fit the live buffers (ValueError) skips the
        refresh; the serve keeps running on the old plan."""
        try:
            fr = watcher.load_frontier()
            if self._width_map is not None:
                changed = self.refresh_mixed(
                    fr, controller=controller, scheduler=scheduler,
                    telemetry=telemetry, batch_idx=batch_idx)
            else:
                compiled, exact_area, _bits = fr
                changed = self.refresh_library(
                    compiled, exact_area, controller=controller,
                    scheduler=scheduler, telemetry=telemetry,
                    batch_idx=batch_idx)
            eid = trace_event("serve.refresh", cause="watcher",
                              changed=changed, batch=batch_idx)
            if self._health is not None:
                self._health.note_event("serve.refresh", step=batch_idx,
                                        event_id=eid, changed=changed)
            if changed and log:
                log(f"{unit} {batch_idx}: library refresh -> plan "
                    f"{self._plan.plan_id}")
        except (LookupError, ValueError) as e:
            trace_event("serve.refresh", cause="watcher", changed=False,
                        batch=batch_idx, skipped=str(e))
            if log:
                log(f"watcher: refresh skipped ({e})")

    def _control(self, controller, scheduler, telemetry, level, glevel,
                 batch_idx, log, unit: str = "batch") -> None:
        """The controller moved to ``level``: swap the live plan, or, with
        classes, move the global operating point the class stacks resolve
        against at their next batch (or step)."""
        reason = f"qos-{controller.last_reason}"
        eid = trace_event("serve.control", level=level,
                          cause=controller.last_reason, batch=batch_idx)
        if self._health is not None:
            self._health.note_event("serve.control", step=batch_idx,
                                    event_id=eid, level=level,
                                    cause=controller.last_reason)
        if scheduler is None:
            moved = self.swap_plan(controller.plan, controller.luts(),
                                   reason=reason, telemetry=telemetry,
                                   batch_idx=batch_idx)
            if moved and log:
                log(f"{unit} {batch_idx}: controller -> level {level} "
                    f"({controller.last_reason}), plan {self._plan.plan_id}")
            return
        # glevel was read before a possible mid-iteration ladder refresh:
        # clamp both levels to the ladder the swap log points at
        lad = scheduler.ladder
        telemetry.record_swap(
            batch=batch_idx, reason=reason,
            old=lad.plan(min(glevel, len(lad) - 1)).plan_id,
            new=lad.plan(min(level, len(lad) - 1)).plan_id)
        if log:
            log(f"{unit} {batch_idx}: controller -> global level {level} "
                f"({controller.last_reason})")


class ContinuousServingEngine(ServingEngine):
    """Continuous batching over a fixed pool of decode slots.

    The fixed-batch loop admits requests only at batch boundaries, and
    every slot reserves a full-length KV cache.  This engine decodes
    token-at-a-time over ``max_slots`` slots: requests join and leave the
    running batch per step through an active mask, KV lives in a paged
    pool (:mod:`repro_torch.serving.kvcache`), and prefill is the first
    ``len(prompt)-1`` steps of a slot's life through the same step.  The
    step is a :class:`PagedStaticStep`, captured once on a card: each
    step's ``tok``, ``pos``, ``active`` and ``tables`` are copied into its
    buffers, and the stack it decodes on into its stack buffer, so joins,
    leaves, preemptions and plan swaps never recapture (``trace_count``
    stays 1).  One device-to-host read a step, the argmax of the logits,
    ends the timed section.

    Latency SLOs: a :class:`~repro_torch.sensitivity.classes.QoSClass`
    that declares ``slo_ms`` (``gold:0.02@8ms``) is entitled to a slot --
    when the pool is full, its arrivals preempt the worst lower-tier slot.
    The victim keeps its pages (its paged KV survives untouched;
    sliding-window ring rows are copied aside on the device) and resumes
    from the head of its class queue, so preemption costs a suspension,
    never a re-prefill.  Admission drains the class queues weighted-fair
    (:class:`~repro_torch.serving.slots.WeightedFairQueues`).

    Own copy of the reference's ``ContinuousServingEngine``, whose step
    returns new caches; here the caches are written in place.
    """

    # class-level defaults so the provenance/cost bookkeeping helpers stay
    # drivable on a bare instance (tests exercise them without __init__)
    replica_name = ""
    _area_hi_by_key: dict[str, float] = {}
    _macs_per_layer = None

    def __init__(self, cfg, params, *, max_slots: int, prompt_len: int,
                 gen_len: int, page_size: int = 8, n_pages: int | None = None,
                 steps_per_tick: int | None = None, **kw) -> None:
        if kw.pop("warmup_caches", None) is not None:
            raise ValueError("continuous batching serves LM families only")
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        total = int(prompt_len) + int(gen_len)
        pages_per_req = -(-total // self.page_size)
        # default pool: every slot can hold a worst-case request plus one
        # spare slot's worth -- preempted victims keep their pages, so
        # without headroom an SLO arrival into a full pool could never
        # allocate.  Under-provisioned regimes pass n_pages explicitly.
        self.n_pages = ((self.max_slots + 1) * pages_per_req
                        if n_pages is None else int(n_pages))
        self.table_entries = pages_per_req
        self.steps_per_tick = (int(steps_per_tick) if steps_per_tick
                               else max(1, int(gen_len)))
        # the router stamps its replica name here so every req.* lifecycle
        # event names the engine that actually served the request
        self.replica_name = ""
        super().__init__(cfg, params, batch=max_slots, prompt_len=prompt_len,
                         gen_len=gen_len, **kw)
        self._started = False

    def _new_step(self) -> PagedStaticStep:
        return PagedStaticStep(
            self.cfg, self.params, slots=self.max_slots,
            n_pages=self.n_pages, page_size=self.page_size,
            table_entries=self.table_entries, total=self.total,
            luts=self._luts, width_map=self._width_map,
            backend=self.backend, device=self.device)

    def run_batch(self, requests, *, shadow=False, luts=None):
        raise TypeError("the continuous engine serves through serve(), or "
                        "start(), submit() and step_once()")

    # ----------------------------------------------------------------- state
    @property
    def occupancy(self) -> float:
        return self._pool.occupancy if self._started else 0.0

    @property
    def queue_depth(self) -> int:
        return self._queues.depth if self._started else 0

    @property
    def idle(self) -> bool:
        return (not self._started
                or (self._pool.n_active == 0 and self._queues.depth == 0))

    @property
    def load_score(self) -> float:
        """Router's routing signal: active + queued work per slot."""
        if not self._started:
            return 0.0
        return (self._pool.n_active + self._queues.depth) / self.max_slots

    @property
    def preemption_count(self) -> int:
        return self._n_preemptions

    # ----------------------------------------------------------------- setup
    def start(self, *, telemetry: Telemetry | None = None, controller=None,
              watcher=None, scheduler=None, online=None,
              shadow_every: int | None = None, health=None, provenance=None,
              log: Callable[[str], None] | None = None) -> Telemetry:
        """Bind the control plane and reset all serving state (slots,
        pages, queues, caches).  Callable directly (the router drives
        replicas through ``submit``/``step_once``) or via :meth:`serve`.
        The step is captured here on first use; later starts zero its
        caches in place."""
        from ..obs.costs import mlp_macs_per_layer
        from .kvcache import PageAllocator
        from .slots import SlotPool, WeightedFairQueues

        if scheduler is not None and not self._adaptive:
            raise ValueError("class-aware serving needs a QoS plan")
        self.telemetry = telemetry or Telemetry()
        self._controller, self._watcher = controller, watcher
        self._scheduler, self._online, self._log = scheduler, online, log
        self._health = health
        if shadow_every is not None:
            self._shadow_every = max(1, int(shadow_every))
        elif controller is not None:
            self._shadow_every = max(1, controller.config.shadow_every)
        elif scheduler is not None:
            self._shadow_every = scheduler.shadow_every
        else:
            self._shadow_every = 4
        self._alloc = PageAllocator(self.n_pages, self.page_size)
        self.static_step.reset()
        self._pool = SlotPool(self.max_slots)
        if scheduler is not None:
            self._queues = WeightedFairQueues(
                scheduler.book.names, scheduler.book.drain_weights())
        else:
            self._queues = WeightedFairQueues(("std",))
        self._device_stacks: dict[int, object] = {}
        self._device_ladder = None
        self._step_idx = 0
        self._tick = 0
        self._n_preemptions = 0
        self.completions: dict[int, np.ndarray] = {}
        # approximation-provenance ledger: when tracing is configured the
        # ledger rides in the trace dir (one shared writer per process, so
        # router replicas never collide); tests may inject their own
        self._provenance = provenance
        if self._provenance is None:
            tr = current_tracer()
            if tr is not None:
                from ..obs.provenance import ledger_for

                self._provenance = ledger_for(tr.root, tr.tag)
        self._prov_open: dict[int, dict] = {}
        # cost plane: the model's LUT-routable MAC vector prices every
        # provenance range; a family without one serves with it off
        try:
            self._macs_per_layer = mlp_macs_per_layer(self.cfg)
        except ValueError:
            self._macs_per_layer = None
        self._cost_rows = {}
        if self._provenance is not None and self._macs_per_layer is not None:
            self._provenance.note_model(name=self.cfg.name,
                                        macs=self._macs_per_layer)
        if self._adaptive:
            self.telemetry.register_plan(self._plan)
        self._started = True
        return self.telemetry

    # ------------------------------------------------------------- admission
    def submit(self, request: Request, now: float | None = None) -> None:
        """Queue one request.  Join/leave happens per decode step, so this
        never blocks; admission itself waits for a slot and pages."""
        from .slots import SeqState

        if not self._started:
            raise RuntimeError("call start() before submit()")
        if len(request.tokens) > self.prompt_len:
            raise ValueError(f"request {request.rid} prompt "
                             f"({len(request.tokens)}) exceeds prompt_len "
                             f"({self.prompt_len})")
        cls = (self._scheduler.book.route(request.qos_class)
               if self._scheduler is not None else "std")
        now = time.perf_counter() if now is None else now
        self._queues.push(cls, SeqState(
            rid=request.rid, cls=cls,
            prompt=np.asarray(request.tokens, np.int32),
            gen_len=self.gen_len, submitted_t=now))
        self._req_event("req.queued", rid=request.rid, cls=cls,
                        prompt_len=len(request.tokens))

    def _req_event(self, name: str, **attrs) -> str:
        """One request-lifecycle trace event; no-op when tracing is off.
        Carries the request's ``rid`` (and the replica name under a
        router) so the obs side can rebuild each request's chain."""
        if self.replica_name:
            attrs["replica"] = self.replica_name
        return trace_event(name, **attrs)

    def _admissible(self, seq) -> bool:
        # a preempted request still holds its pages; a fresh one needs the
        # pool to cover its whole prompt+gen lifetime (out-of-pages blocks
        # admission up front, it never corrupts a running neighbour)
        return self._alloc.holds(seq.rid) or self._alloc.can_alloc(
            seq.n_tokens)

    def _place(self, idx: int, seq, now: float) -> None:
        if not self._alloc.holds(seq.rid):
            self._alloc.alloc(seq.rid, seq.n_tokens)
        if seq.ring_rows is not None:
            # restore the suspended request's sliding-window ring rows into
            # its new slot, in place in the captured buffers (paged layers
            # need nothing: the table re-points at the same pages)
            caches = self.static_step.caches
            for li, rows in seq.ring_rows.items():
                for k, v in rows.items():
                    caches[li][k][idx].copy_(v)
            seq.ring_rows = None
        cls = seq.cls if self._scheduler is not None else None
        if seq.suspended_at is not None:
            # resume: close the suspension, as a req.* chain link and as a
            # serve.resume control event, so an anomaly right after a
            # resume attributes to the resume
            susp = now - seq.suspended_at
            seq.suspended_at = None
            seq.suspended_s += susp
            if seq.first_token_t is None:
                seq.suspended_before_first_s += susp
            self.telemetry.record_suspension(cls, susp)
            self._req_event("req.resume", rid=seq.rid, cls=seq.cls,
                            slot=idx, suspended_ms=round(1e3 * susp, 3))
            eid = trace_event("serve.resume", step=self._step_idx,
                              rid=seq.rid, cls=seq.cls)
            if self._health is not None:
                self._health.note_event("serve.resume", step=self._step_idx,
                                        event_id=eid, rid=seq.rid,
                                        cls=seq.cls)
        elif seq.admitted_t is None:
            seq.admitted_t = now
            seq.queue_wait_s = now - seq.submitted_t
            self.telemetry.record_queue(cls, self._queues.depth,
                                        [seq.queue_wait_s])
            self._req_event("req.admitted", rid=seq.rid, cls=seq.cls,
                            slot=idx,
                            queue_ms=round(1e3 * seq.queue_wait_s, 3))
            self._req_event("req.prefill", rid=seq.rid, cls=seq.cls,
                            slot=idx, prompt_len=len(seq.prompt))
        self._pool.place(idx, seq)

    def _preempt_slot(self, idx: int, by_cls: str, now: float) -> None:
        seq = self._pool.evict(idx)
        # the victim's ring rows, copied aside on the device (no host
        # read): the slot's next occupant overwrites them
        seq.ring_rows = {li: {"k": layer["k"][idx].clone(),
                              "v": layer["v"][idx].clone()}
                         for li, layer in enumerate(self.static_step.caches)
                         if "k" in layer}
        seq.preempted += 1
        seq.suspended_at = now
        self._n_preemptions += 1
        self._queues.push_front(seq.cls, seq)
        self._prov_close(seq.rid)
        self.telemetry.record_preemption(
            step=self._step_idx, victim_rid=seq.rid, victim_class=seq.cls,
            by_class=by_cls)
        self._req_event("req.preempt", rid=seq.rid, cls=seq.cls,
                        step=self._step_idx, by=by_cls)
        eid = trace_event("serve.preempt", step=self._step_idx, rid=seq.rid,
                          victim=seq.cls, by=by_cls)
        if self._health is not None:
            self._health.note_event("serve.preempt", step=self._step_idx,
                                    event_id=eid, rid=seq.rid,
                                    victim=seq.cls, by=by_cls)
        if self._log:
            self._log(f"step {self._step_idx}: preempt rid={seq.rid} "
                      f"({seq.cls}) for {by_cls}")

    def _admit(self, now: float) -> None:
        # 1) weighted-fair fill of free slots
        while (idx := self._pool.free_slot()) is not None:
            picked = self._queues.pick(self._admissible)
            if picked is None:
                break
            _, seq = picked
            self._place(idx, seq, now)
        # 2) SLO preemption: a queued request whose class declares a
        # latency SLO claims a slot from the worst strictly-lower tier
        if self._scheduler is None:
            return
        book = self._scheduler.book
        for _ in range(self.max_slots):
            if self._pool.free_slot() is not None:
                break
            did = False
            for c in book:
                if c.slo_ms is None:
                    continue
                head = self._queues.peek(c.name)
                if head is None or not self._admissible(head):
                    continue
                victim = self._pool.pick_victim(
                    lambda n: book.get(n).priority, c.priority)
                if victim is None:
                    continue
                self._preempt_slot(victim, by_cls=c.name, now=now)
                self._place(victim, self._queues.pop(c.name), now)
                did = True
                break
            if not did:
                break

    # ------------------------------------------------------------ provenance
    def _prov_extend(self, seq, token_idx: int, plan_b, level) -> None:
        """Charge one generated token to the active plan: extend the
        request's open decode-step range when the plan is unchanged and
        contiguous, else seal it and open a new one.  Ranges also seal on
        preemption and completion, so a finished request's ranges tile
        ``[0, gen_len)`` exactly."""
        pid = plan_b.plan_id if plan_b is not None else "exact"
        r = self._prov_open.get(seq.rid)
        if r is not None and r["plan"] == pid and r["t1"] == token_idx:
            r["t1"] = token_idx + 1
            return
        if r is not None:
            self._provenance.record_range(**r)
        if plan_b is not None:
            # plans missing an exact_area (stub plans in direct-drive
            # tests) stay unpriced; the cost audit flags them
            exact_area = getattr(plan_b, "exact_area", None)
            areas = (plan_layer_areas(plan_b, self._area_hi_by_key)
                     if exact_area is not None else None)
            self._provenance.note_plan(
                plan_b.plan_id, [c.key or "exact" for c in plan_b.choices],
                width_map=self._width_map,
                areas=[lo for lo, _ in areas] if areas else None,
                areas_hi=[hi for _, hi in areas] if areas else None,
                exact_area=exact_area)
        self._prov_open[seq.rid] = {
            "rid": seq.rid, "cls": seq.cls, "t0": token_idx,
            "t1": token_idx + 1, "plan": pid, "level": level, "drift": [],
            "replica": self.replica_name or None}

    def _prov_close(self, rid: int) -> None:
        if self._provenance is None:
            return
        r = self._prov_open.pop(rid, None)
        if r is not None:
            self._provenance.record_range(**r)

    def _cost_row(self, plan_b) -> dict:
        """The per-token cost increments of the step's live plan, cached
        by plan id (refresh paths clear the cache)."""
        pid = plan_b.plan_id if plan_b is not None else "exact"
        row = self._cost_rows.get(pid)
        if row is None:
            from ..obs.costs import plan_cost_row

            areas = (plan_layer_areas(plan_b, self._area_hi_by_key)
                     if plan_b is not None else None)
            row = plan_cost_row(plan_b, self._macs_per_layer,
                                layer_areas=areas)
            self._cost_rows[pid] = row
        return row

    # ------------------------------------------------------------------ step
    def _resolve_stack(self, active_classes):
        """The step's LUT stack: with a scheduler, the batch decodes at the
        level of its strictest active class (slots share one step, so the
        most exacting tenant sets the table for everyone in it).  Returns
        ``(stack, plan, global_level, step_level)``, the stack on the
        device in the live stack's form, checked once a level and cached
        until the ladder is refreshed."""
        if not self._adaptive:
            return None, None, None, None
        if self._scheduler is None:
            lvl = self._controller.level if self._controller else None
            return None, self._plan, lvl, lvl
        sch = self._scheduler
        glevel = (self._controller.level if self._controller is not None
                  else sch.top_level)
        level = min((sch.level_for(c, glevel) for c in active_classes),
                    default=min(glevel, sch.top_level))
        if sch.ladder is not self._device_ladder:
            self._device_stacks.clear()
            self._device_ladder = sch.ladder
        luts = self._device_stacks.get(level)
        if luts is None:
            luts = self._adopt(sch.ladder.luts(level))
            self._device_stacks[level] = luts
        plan = sch.ladder.plan(level)
        self.telemetry.register_plan(plan)
        return luts, plan, glevel, level

    def step_once(self, now: float | None = None) -> bool:
        """Admit what fits, then run one decode step over the pool.
        Returns ``False`` (and runs nothing) when no slot is active."""
        if not self._started:
            raise RuntimeError("call start() before step_once()")
        now = time.perf_counter() if now is None else now
        preempts_before = self._n_preemptions
        self._admit(now)
        occupied = list(self._pool)
        if not occupied:
            return False

        S, T = self.max_slots, self.table_entries
        toks = np.zeros((S, 1), np.int32)
        pos = np.zeros(S, np.int64)
        active = np.zeros(S, bool)
        # every entry of an empty slot, and past an allocation, is the
        # scratch page (SCRATCH_PAGE == 0)
        tables = np.zeros((S, T), np.int64)
        for idx, seq in occupied:
            toks[idx, 0] = seq.next_token()
            pos[idx] = seq.pos
            active[idx] = True
            tables[idx] = self._alloc.padded_table(seq.rid, T)

        classes = sorted({seq.cls for _, seq in occupied})
        luts, plan_b, glevel, step_level = self._resolve_stack(classes)
        if self._adaptive and luts is None:
            luts, plan_b = self._luts, self._plan
        step = self.static_step
        step.write(toks, pos, active, tables)
        want_shadow = (self._adaptive
                       and (self._controller is not None
                            or self._scheduler is not None)
                       and self._step_idx % self._shadow_every == 0)
        shadow_logits = None
        if want_shadow:
            # the exact shadow step on the same caches, saved before and
            # restored after, outside the timed section
            with trace_span("serve.shadow"):
                step.save_caches()
                step.load(self._exact_luts)
                shadow_logits = step.replay().clone()
                step.restore_caches()
                self._sync()
        src = luts if luts is not None else self._luts
        if src is not None:
            step.load(src)
        t0 = time.perf_counter()
        if self.inject_step_delay:
            # chaos hook: the sleep sits inside the timed section, so an
            # injected latency spike is indistinguishable from a real one
            time.sleep(self.inject_step_delay)
        logits = step.replay()
        # the step's one device-to-host read, which ends its timed section
        sampled = logits.argmax(dim=-1).cpu().numpy()
        step_s = time.perf_counter() - t0

        drift = None
        if shadow_logits is not None:
            rows = torch.from_numpy(np.flatnonzero(active)).to(self.device)
            drift = float((logits[rows] - shadow_logits[rows]).abs().mean())

        t_done = time.perf_counter()
        by_class: dict[str, dict] = {}
        for idx, seq in occupied:
            row = by_class.setdefault(
                seq.cls, {"rows": 0, "decode_tokens": 0,
                          "prefill_tokens": 0})
            row["rows"] += 1
            generated, first = seq.advance(int(sampled[idx]))
            if generated:
                row["decode_tokens"] += 1
                if self._provenance is not None:
                    self._prov_extend(seq, len(seq.generated) - 1,
                                      plan_b if self._adaptive else None,
                                      step_level)
                    if drift is not None:
                        self._prov_open[seq.rid]["drift"].append(
                            round(drift, 6))
            else:
                row["prefill_tokens"] += 1
            if first:
                seq.first_token_t = t_done
                self.telemetry.record_ttft(
                    seq.cls if self._scheduler is not None else None,
                    t_done - seq.submitted_t)
                self._req_event(
                    "req.decode", rid=seq.rid, cls=seq.cls,
                    ttft_ms=round(1e3 * (t_done - seq.submitted_t), 3),
                    prefill_ms=round(
                        1e3 * max(0.0, (t_done - seq.admitted_t)
                                  - seq.suspended_before_first_s), 3)
                    if seq.admitted_t is not None else None)
            if seq.done:
                self._pool.evict(idx)
                self._alloc.free(seq.rid)
                gen = np.asarray(seq.generated, np.int32)
                self.completions[seq.rid] = gen
                self.last_tokens = gen[None, :]
                self.telemetry.record_request_done(
                    seq.cls if self._scheduler is not None else None)
                b = seq.breakdown(t_done)
                self._req_event("req.done", rid=seq.rid, cls=seq.cls,
                                steps=seq.pos, preempts=seq.preempted,
                                resumes=seq.preempted, **b)
                if self._provenance is not None:
                    self._prov_close(seq.rid)
                    self._provenance.record_done(
                        rid=seq.rid, cls=seq.cls, gen_len=len(gen),
                        steps=seq.pos, preempts=seq.preempted,
                        replica=self.replica_name or None)

        if self._macs_per_layer is not None:
            cost_row = self._cost_row(plan_b if self._adaptive else None)
            for cls, r in by_class.items():
                if r["decode_tokens"]:
                    self.telemetry.record_costs(
                        cls if self._scheduler is not None else None,
                        r["decode_tokens"], cost_row)

        backlog = self._queues.depth
        occ = self._pool.occupancy
        self.telemetry.record_step(
            step=self._step_idx, tick=self._tick, step_s=step_s,
            by_class=by_class,
            decode_tokens=sum(r["decode_tokens"] for r in by_class.values()),
            prefill_tokens=sum(r["prefill_tokens"]
                               for r in by_class.values()),
            plan_id=plan_b.plan_id if self._adaptive else None,
            drift=drift, backlog=backlog, occupancy=occ)
        self.telemetry.record_pages(used=self._alloc.used_pages,
                                    total=self._alloc.n_pages)
        if self._health is not None:
            self._health.observe_step(
                step=self._step_idx, step_ms=1e3 * step_s,
                classes=by_class, drift=drift, backlog=backlog,
                occupancy=occ,
                preemptions=self._n_preemptions - preempts_before,
                plan_id=plan_b.plan_id if self._adaptive else None,
                level=glevel,
                pages={"used": self._alloc.used_pages,
                       "free": self._alloc.free_pages,
                       "total": self._alloc.n_pages},
                class_state=(self._scheduler.snapshot(glevel)
                             if self._scheduler is not None else None))

        self._control_plane(step_s, drift, plan_b, glevel, backlog, occ)
        self._step_idx += 1
        return True

    def _control_plane(self, step_s, drift, plan_b, glevel, backlog, occ):
        controller, scheduler = self._controller, self._scheduler
        if drift is not None and self._adaptive:
            if scheduler is not None:
                for cls in {seq.cls for _, seq in self._pool}:
                    scheduler.observe(cls, drift)
            if self._online is not None and plan_b is not None:
                self._online.update(self._plan_maes(plan_b), drift)
        if self._watcher is not None and self._adaptive \
                and self._watcher.poll():
            self._watch(self._watcher, controller, scheduler, self.telemetry,
                        self._step_idx, self._log, unit="step")
        if controller is not None and self._adaptive:
            # occupancy replaces the fixed loop's whole-queue heuristic:
            # requests already in slots are being served, only true
            # admission-queue depth counts as waiting work
            eff_ms = effective_load_ms(1e3 * step_s, backlog=backlog,
                                       capacity=self.max_slots,
                                       occupancy=occ)
            drift_sig = (drift if scheduler is None
                         or (glevel is not None
                             and plan_b is scheduler.ladder.plan(glevel))
                         else None)
            level = controller.observe(eff_ms, drift_sig)
            if level is not None:
                self._control(controller, scheduler, self.telemetry, level,
                              glevel, self._step_idx, self._log, unit="step")

    # ----------------------------------------------------------------- serve
    def serve(self, profile: LoadProfile, *, controller=None, watcher=None,
              scheduler=None, online=None,
              telemetry: Telemetry | None = None, seed: int = 0,
              steps_per_tick: int | None = None,
              on_step_end: Callable[["ContinuousServingEngine", int],
                                    None] | None = None,
              log: Callable[[str], None] | None = None,
              health=None) -> Telemetry:
        """Serve a synthetic load profile continuously: each tick's
        arrivals join the admission queues, then up to ``steps_per_tick``
        decode steps run before the next tick's arrivals -- requests keep
        joining and leaving the pool mid-generation.  After the last tick
        the pool drains to empty.  A crash freezes the health plane's
        flight recorder before it propagates."""
        if profile.prompt_len > self.prompt_len:
            raise ValueError(f"profile prompts up to {profile.prompt_len} "
                             f"exceed engine prompt_len {self.prompt_len}")
        if profile.gen_len != self.gen_len:
            raise ValueError("profile gen_len differs from the engine's")
        telemetry = self.start(telemetry=telemetry, controller=controller,
                               watcher=watcher, scheduler=scheduler,
                               online=online, health=health, log=log)
        steps = steps_per_tick or self.steps_per_tick
        per_tick = synth_requests(profile, self.cfg.vocab_size, seed)
        try:
            with trace_span("serve.continuous", slots=self.max_slots,
                            pages=self.n_pages):
                for tick in range(profile.n_ticks):
                    self._tick = tick
                    now = time.perf_counter()
                    for r in per_tick[tick]:
                        self.submit(r, now)
                    for _ in range(steps):
                        if not self.step_once():
                            break
                        if on_step_end is not None:
                            on_step_end(self, self._step_idx - 1)
                while self.step_once():
                    if on_step_end is not None:
                        on_step_end(self, self._step_idx - 1)
        except BaseException as e:
            # the flight recorder's crash path: freeze the ring before the
            # exception unwinds past the serve loop, then re-raise
            if self._health is not None:
                self._health.record_crash(e)
            raise
        return telemetry
