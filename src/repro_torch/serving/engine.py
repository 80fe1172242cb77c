"""Serving engine: a request queue drained in fixed-size batches, each
prefilled and then greedily decoded, with the MLP matmuls routed through a
per-layer approximate-multiplier LUT stack.

The stack — ``(L, 16, 16)`` for W4A4, composed ``(L, 256, 256)`` for
W8A8, as ``repro.library.qos.stack_luts`` produces it — is moved to the
device once and handed to the decode step as an argument on every call;
the step never bakes it in.  A per-batch override is copied into one
buffer of the same shape, so the step keeps reading fixed addresses.

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
from ..models import decode_fn, init_caches
from ..models.lm import check_device, to_device_luts
from ..precision.widths import width_from_stack
from .loadgen import LoadProfile, Request, synth_requests

__all__ = ["BatchStats", "ServingEngine"]


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

    ``luts``: the per-layer LUT stack (numpy or tensor), or ``None`` for
    exact MLP matmuls.  ``backend="ref"`` runs the plain version of every
    kernel (the tests and ``chip_smoke.py`` hold the kernels against it).
    """

    def __init__(self, cfg, params, *, batch: int, prompt_len: int,
                 gen_len: int, luts=None, backend: ops.Backend = "auto",
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
        self.last_tokens: np.ndarray | None = None   # (n_requests, gen_len)
        self._step_fn = decode_fn(cfg)
        self._luts = None
        self._override = None  # the buffer per-batch stacks are copied into
        if luts is not None:
            if not cfg.approx_mlp:
                raise ValueError("a LUT stack routes MLP matmuls; build the "
                                 "config with .with_approx_mlp()")
            self._luts = to_device_luts(luts, self.device)
            width_from_stack(self._luts)  # raises unless (L, side, side)
            if self._luts.shape[0] != cfg.n_layers:
                raise ValueError(f"stack has {self._luts.shape[0]} tables for "
                                 f"{cfg.n_layers} layers")
            ops.check_luts(self._luts, backend=backend)

    def _batch_luts(self, luts):
        """The stack this batch decodes on: the live one, or ``luts``
        copied into the override buffer (same shape, checked once)."""
        if luts is None:
            return self._luts
        if self._luts is None:
            raise ValueError("engine was built without a LUT stack")
        new = to_device_luts(luts, self.device)
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
                             luts=luts, backend=self.backend)

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
