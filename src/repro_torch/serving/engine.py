"""Serving engine: a request queue drained in fixed-size batches, each
prefilled and then greedily decoded, with the MLP matmuls routed through a
per-layer approximate-multiplier LUT stack.

The engine serves either a raw stack (``luts=``) or a QoS plan (``plan=``
with its ``compiled`` frontier), as the reference's constructor takes it:
the plan is stacked by :func:`repro_torch.library.qos.stack_luts` --
``(L, 16, 16)`` for W4A4, composed ``(L, 256, 256)`` for W8A8 -- or, with
a ``width_map``, by :func:`repro_torch.precision.plans.stack_mixed_luts`
into one ``(n_group, side, side)`` stack per width.  The live stack is
moved to the device once, into buffers the engine owns, and handed to the
decode step as an argument on every call; the step never bakes it in.
:meth:`ServingEngine.swap_plan` copies a new plan's stack into those same
buffers, and a per-batch override is copied into one further buffer of
the same shape, so the step always reads fixed addresses -- the contract
a captured decode step needs.

One ``run_batch`` serves up to ``batch`` requests: prefill walks the
prompt through the same decode step, token by token, then greedy decode
extends ``gen_len`` tokens.  Prefill and decode are timed separately,
each ending in a device synchronise.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..library.qos import LayerPlan, stack_luts, validate_lut_stack
from ..models import decode_fn, init_caches
from ..models.lm import check_device, to_device_luts
from ..precision.widths import exact_table, width_from_stack
from .loadgen import LoadProfile, Request, synth_requests

__all__ = ["BatchStats", "ServingEngine"]


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
    """The tensors of a stack: itself, or one per width group."""
    return tuple(stack.values()) if isinstance(stack, dict) else (stack,)


def _owned(stack, device: torch.device):
    """A stack (or mixed-width dict) as int32 tensors on ``device`` in
    memory of their own: ``torch.as_tensor`` may share the caller's."""
    moved = to_device_luts(stack, device)
    if isinstance(moved, dict):
        return {b: t.clone() for b, t in moved.items()}
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

    @property
    def ms_per_step(self) -> float:
        return 1e3 * self.decode_s / max(1, self.decode_steps)

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def prefill_tok_s(self) -> float:
        return self.prefill_tokens / self.prefill_s if self.prefill_s else 0.0


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
    and ``chip_smoke.py`` hold the kernels against it).

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
                "yet; ROADMAP.md §1, sensitivity/profile.py")
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
        self._step_fn = decode_fn(cfg)
        self._override = None  # the buffer per-batch stacks are copied into

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

    @property
    def plan(self) -> LayerPlan | None:
        return self._plan

    def swap_plan(self, plan: LayerPlan, stack, *, reason: str = "manual",
                  telemetry=None, batch_idx: int = 0) -> bool:
        """Adopt a new plan between batches: copy its stack into the live
        buffers in place, so the decode step keeps reading the same
        addresses.  Suppresses no-op swaps (same per-layer assignment);
        validates the stack against the live one (shape, dtype, width
        groups) and for the kernel route before anything is written, so a
        refused swap leaves the live stack untouched.  Returns whether the
        plan changed.  ``reason`` and ``batch_idx`` label the swap in the
        reference's telemetry, which is not ported yet: a ``telemetry``
        raises."""
        if telemetry is not None:
            raise NotImplementedError(
                "serving telemetry is not ported to PyTorch yet; ROADMAP.md "
                "§1, the engine's control plane")
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
        self._plan = plan
        return True

    def _batch_luts(self, luts):
        """The stack this batch decodes on: the live one, or ``luts``
        copied into the override buffer (same shape, checked once)."""
        if luts is None:
            return self._luts
        if self._luts is None:
            raise ValueError("engine was built without a LUT stack")
        new = to_device_luts(luts, self.device)
        if isinstance(self._luts, dict) or isinstance(new, dict):
            raise ValueError("a per-batch override takes one (L, side, side) "
                             "stack; a mixed-width plan changes by swap_plan")
        if new.shape != self._luts.shape:
            raise ValueError(f"stack shape {tuple(new.shape)} differs from the "
                             f"live {tuple(self._luts.shape)}")
        if self._override is None:
            self._override = torch.empty_like(self._luts)
        self._override.copy_(new)
        ops.check_luts(self._override, backend=self.backend)
        return self._override

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self, caches, tok, pos: int, luts):
        return self._step_fn(self.cfg, self.params, caches, tok, pos,
                             luts=luts, width_map=self._width_map,
                             backend=self.backend)

    def run_batch(self, requests: list[Request], *, luts=None) -> BatchStats:
        """Serve one batch: prefill the prompts, greedily decode
        ``gen_len`` tokens.  Short batches are zero-padded to the fixed
        batch size; ``luts`` overrides the live stack for this batch."""
        if not 0 < len(requests) <= self.batch:
            raise ValueError(f"{len(requests)} requests for a batch of {self.batch}")
        step_luts = self._batch_luts(luts)
        prompts_np = np.zeros((self.batch, self.prompt_len), np.int32)
        for i, r in enumerate(requests):
            if len(r.tokens) > self.prompt_len:
                raise ValueError(f"request {r.rid} prompt ({len(r.tokens)}) "
                                 f"exceeds prompt_len ({self.prompt_len})")
            prompts_np[i, :len(r.tokens)] = r.tokens
        prompts = torch.from_numpy(prompts_np).to(self.device)
        caches = init_caches(self.cfg, self.batch, self.total,
                             device=self.device)

        self._sync()
        t0 = time.perf_counter()
        logits = None
        for t in range(self.prompt_len):
            logits, caches = self._step(caches, prompts[:, t:t + 1], t, step_luts)
        self._sync()
        t1 = time.perf_counter()
        generated = []
        for t in range(self.prompt_len, self.total):
            tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
            generated.append(tok)
            logits, caches = self._step(caches, tok, t, step_luts)
        self._sync()
        t2 = time.perf_counter()

        n = len(requests)
        self.last_tokens = torch.cat(generated, dim=1)[:n].cpu().numpy()
        return BatchStats(
            n_requests=n,
            prefill_s=t1 - t0,
            decode_s=t2 - t1,
            prefill_tokens=n * self.prompt_len,
            decode_tokens=n * self.gen_len,
            decode_steps=self.gen_len,
        )

    def serve(self, profile: LoadProfile, *, seed: int = 0) -> list[BatchStats]:
        """Serve a synthetic load profile: each tick's arrivals join the
        queue, which drains in batches of up to ``batch`` requests."""
        if (profile.prompt_len, profile.gen_len) != (self.prompt_len, self.gen_len):
            raise ValueError("profile geometry differs from the engine's")
        per_tick = synth_requests(profile, self.cfg.vocab_size, seed)
        queue: deque[Request] = deque()
        stats: list[BatchStats] = []
        for tick in range(profile.n_ticks):
            queue.extend(per_tick[tick])
            while queue:
                reqs = [queue.popleft() for _ in range(min(self.batch, len(queue)))]
                stats.append(self.run_batch(reqs))
        return stats
