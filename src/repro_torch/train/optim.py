"""AdamW with decoupled weight decay, a cosine schedule and global-norm
clipping, over the port's parameter trees (dicts and lists of tensors).

The reference's order of operations is kept: moments are float32
whatever the parameter's dtype, each gradient is cast to float32 and
scaled by ``min(1, clip / (gnorm + 1e-9))``, bias correction takes
``b ** step`` in float32, and the decay applies to the float32 parameter
before the result rounds back to the parameter's dtype.  Parameters and
moments are updated in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in a fixed order (a dict's
    insertion order), so that trees of one structure zip leaf for leaf."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def init_opt_state(params) -> dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay
    to a tenth of it at ``total_steps``; float32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state):
    """One AdamW step, in place on ``params`` and ``state``.  ``grads``:
    a tree shaped like ``params``, or its leaves as a list in
    :func:`tree_leaves` order.  Returns (params, state, metrics) with
    ``metrics = {"grad_norm", "lr"}``, 0-d float32 tensors on the
    parameters' device."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    state["step"].add_(1)
    step = state["step"].float()
    lr = schedule(cfg, state["step"])
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(torch.full_like(step, b1), step)
    bc2 = 1.0 - torch.pow(torch.full_like(step, b2), step)

    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        g = g.float() * scale
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g * g)
        mhat = mu / bc1
        nhat = nu / bc2
        p32 = p.float()
        delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}
