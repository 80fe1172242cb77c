"""Train / prefill / decode step builders.

``make_train_step`` returns the step the launcher runs: the family's loss
and its gradients by ``torch.autograd``, optional microbatch gradient
accumulation in float32 (the reference's ``lax.scan`` over microbatches,
as a Python loop), then the AdamW update in place.  One Python call is
one step; nothing is compiled.

The train step differentiates the plain route: it passes
``backend="ref"`` to the loss, as the reference's dry-run lowers its
train step.  Neither package has a backward kernel (the port's kernels
are bound without autograd, and the reference's Pallas flash attention
cannot be differentiated), so ``backend="auto"`` on a card raises in
:func:`repro_torch.kernels.ops.use_kernel` before any launch rather than
cut the gradient.  Prefill and decode keep ``backend="auto"`` and the
kernels.
"""

from __future__ import annotations

import torch

from ..kernels import ops
from ..models import decode_fn, forward_fn, loss_fn
from ..models.config import ModelConfig
from ..parallel.api import like
from .optim import OptimizerConfig, apply_updates, tree_leaves, tree_map


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: OptimizerConfig,
    *,
    microbatches: int = 1,
    remat: str = "full",
    backend: ops.Backend = "ref",
):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, ``metrics = {"loss", "grad_norm", "lr"}`` as 0-d float32
    tensors.  ``params`` and ``opt_state`` are updated in place and
    returned; the parameters keep ``requires_grad`` off, so a forward on
    them after a step launches the kernels as before."""
    loss = loss_fn(cfg)

    def value_and_grad(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            value = loss(cfg, live, batch, backend=backend, remat=remat,
                         device=tree_leaves(params)[0].device)
            grads = torch.autograd.grad(value, tree_leaves(live))
        return value.detach(), list(grads)

    def compute_grads(params, batch):
        if microbatches == 1:
            return value_and_grad(params, batch)
        n = next(iter(batch.values())).shape[0]
        if n % microbatches:
            raise ValueError(f"batch {n} is not divisible into "
                             f"{microbatches} microbatches")
        size = n // microbatches
        total_loss = None
        # laid out as its parameter under a mesh (a DTensor's zeros_like)
        total = [torch.zeros_like(p, dtype=torch.float32) for p in tree_leaves(params)]
        for i in range(microbatches):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            value, grads = value_and_grad(params, mb)
            total_loss = value if total_loss is None else total_loss + value
            total = [a + g for a, g in zip(total, grads)]
        inv = 1.0 / microbatches
        return total_loss * inv, [g * inv for g in total]

    def train_step(params, opt_state, batch):
        # the gradients as a list in the order of tree_leaves(params),
        # which apply_updates walks
        value, grads = compute_grads(params, batch)
        # under a mesh, each gradient laid out as its parameter and moments
        grads = [like(g, p) for g, p in zip(grads, tree_leaves(params))]
        params, opt_state, metrics = apply_updates(opt_cfg, params, grads,
                                                   opt_state)
        metrics["loss"] = value
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, *, backend: ops.Backend = "auto"):
    """Forward-only full-sequence step (inference prefill): next-token
    logits (B, V)."""
    fwd = forward_fn(cfg)

    @torch.no_grad()
    def prefill(params, batch):
        logits, _ = fwd(cfg, params, batch, backend=backend, remat="none",
                        device=tree_leaves(params)[0].device)
        return logits[:, -1]

    return prefill


def make_decode_step(cfg: ModelConfig):
    step = decode_fn(cfg)

    @torch.no_grad()
    def serve_step(params, caches, tokens, pos):
        return step(cfg, params, caches, tokens, pos)

    return serve_step
