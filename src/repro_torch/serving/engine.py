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
from ..library.qos import (LayerPlan, refresh_plan, stack_luts,
                           validate_lut_stack)
from ..models import decode_fn, init_caches
from ..models.lm import check_device, to_device_luts
from ..obs.trace import event as trace_event
from ..obs.trace import span as trace_span
from ..precision.widths import exact_table, width_from_stack
from .controller import effective_load_ms
from .loadgen import LoadProfile, Request, synth_requests
from .telemetry import Telemetry

__all__ = ["BatchStats", "ServingEngine", "StaticStep"]

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
    int32, ``pos`` ``(1,)`` long, ``caches`` (one ``{"k", "v"}`` per
    layer), ``luts`` (the stack the step reads, a dict per width group for
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
        self.luts = (None if luts is None else
                     {b: t.clone() for b, t in luts.items()}
                     if isinstance(luts, dict) else luts.clone())
        self._saved = None          # cache copies for the shadow step
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        step = decode_fn(cfg)

        def run() -> torch.Tensor:
            return step(cfg, params, self.caches, self.tok, self.pos,
                        luts=self.luts, width_map=width_map,
                        backend=backend)[0]

        self._graph = None
        self._credits: list[tuple[Callable, int]] = []
        if device.type == "cuda":
            self._capture(run)
        else:
            self._run = run
            self.logits = torch.zeros((batch, cfg.vocab_size),
                                      dtype=torch.float32, device=device)

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
            c["k"].zero_()
            c["v"].zero_()

    def save_caches(self) -> None:
        if self._saved is None:
            self._saved = [{k: torch.empty_like(v) for k, v in c.items()}
                           for c in self.caches]
        for dst, src in zip(self._saved, self.caches):
            dst["k"].copy_(src["k"])
            dst["v"].copy_(src["v"])

    def restore_caches(self) -> None:
        for dst, src in zip(self.caches, self._saved):
            dst["k"].copy_(src["k"])
            dst["v"].copy_(src["v"])


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
    the same way.

    A measured ``sens_profile`` is not ported yet and raises.
    """

    def __init__(self, cfg, params, *, batch: int, prompt_len: int,
                 gen_len: int, plan: LayerPlan | None = None, compiled=None,
                 exact_area: float | None = None, sensitivities=None,
                 width_map=None, sens_profile=None, luts=None,
                 backend: ops.Backend = "auto",
                 device: str | torch.device = "cuda") -> None:
        if sens_profile is not None:
            raise NotImplementedError(
                "a measured sensitivity profile is not ported to PyTorch "
                "yet; ROADMAP.md §1 item 3, sensitivity/profile.py")
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        check_device(params, self.device)
        self.batch = int(batch)
        self.prompt_len = int(prompt_len)
        self.gen_len = int(gen_len)
        self.total = self.prompt_len + self.gen_len
        self.backend = backend
        self.last_tokens: np.ndarray | None = None   # (n_requests, gen_len)
        self._static: StaticStep | None = None
        self._trace_count = 0

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
            self._static = StaticStep(
                self.cfg, self.params, batch=self.batch, total=self.total,
                luts=self._luts, width_map=self._width_map,
                backend=self.backend, device=self.device)
            self._trace_count += 1
        return self._static

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
        trace_event("serve.swap", reason=reason, batch=batch_idx,
                    old=old_id, new=plan.plan_id)
        return True

    def _set_frontier(self, compiled) -> None:
        self._compiled = list(compiled)
        self._mae_by_key = {rec.key: comp.mae for rec, comp in self._compiled}
        self._area_hi_by_key = _area_hi_map(self._compiled)

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
        ``None`` (the caller keeps its own sensitivity model): without a
        measured profile, which is not ported yet, always ``None``."""
        return None

    def _mixed_sens(self, mixed):
        """Per-width pricing for a refreshed mixed frontier: the
        constructor's sensitivity model (vectors follow any frontier; a
        caller-supplied measured matrix cannot, and the resulting
        ValueError makes the watcher skip the refresh)."""
        return self._sens

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
        ``on_batch_end`` hook.  ``health`` (the reference's SLO health
        plane) is not ported yet and raises."""
        if health is not None:
            raise NotImplementedError(
                "the SLO health plane (obs/health) is not ported to PyTorch "
                "yet; ROADMAP.md §1 item 2")
        if (profile.prompt_len, profile.gen_len) != (self.prompt_len, self.gen_len):
            raise ValueError("profile geometry differs from the engine's")
        if scheduler is not None and not self._adaptive:
            raise ValueError("class-aware serving needs a QoS plan")
        telemetry = telemetry or Telemetry()
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
               log) -> None:
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
            trace_event("serve.refresh", cause="watcher", changed=changed,
                        batch=batch_idx)
            if changed and log:
                log(f"batch {batch_idx}: library refresh -> plan "
                    f"{self._plan.plan_id}")
        except (LookupError, ValueError) as e:
            trace_event("serve.refresh", cause="watcher", changed=False,
                        batch=batch_idx, skipped=str(e))
            if log:
                log(f"watcher: refresh skipped ({e})")

    def _control(self, controller, scheduler, telemetry, level, glevel,
                 batch_idx, log) -> None:
        """The controller moved to ``level``: swap the live plan, or, with
        classes, move the global operating point the class stacks resolve
        against at their next batch."""
        reason = f"qos-{controller.last_reason}"
        trace_event("serve.control", level=level,
                    cause=controller.last_reason, batch=batch_idx)
        if scheduler is None:
            moved = self.swap_plan(controller.plan, controller.luts(),
                                   reason=reason, telemetry=telemetry,
                                   batch_idx=batch_idx)
            if moved and log:
                log(f"batch {batch_idx}: controller -> level {level} "
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
            log(f"batch {batch_idx}: controller -> global level {level} "
                f"({controller.last_reason})")
