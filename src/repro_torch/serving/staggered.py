"""Paged decode held against dense decode.

Requests join a paged pool at chosen steps and leave it when done; each
one is also decoded alone in a dense cache.  A request's greedy tokens
must not depend on which slots and pages it shares the pool with.  The
schedule lives here once, and the caller passes the step functions: the
parity tests drive the eager steps on the CPU, the card's smoke run
drives the captured ones.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .kvcache import PageAllocator

DenseStep = Callable[[int, int], torch.Tensor]
PagedStep = Callable[[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
                     torch.Tensor]


def decode_alone(step: DenseStep, prompt: Sequence[int],
                 total: int) -> tuple[list[int], list[torch.Tensor]]:
    """Greedy decode of one request at positions ``0 .. total-2``: the
    prompt's tokens first, then each step's argmax.  ``step(tok, t)``
    returns the logits row of position ``t``.  Returns the argmax and a
    copy of the logits row of every step."""
    outs: list[int] = []
    rows: list[torch.Tensor] = []
    for t in range(total - 1):
        row = step(int(prompt[t]) if t < len(prompt) else outs[-1], t)
        rows.append(row.clone())
        outs.append(int(row.argmax()))
    return outs, rows


def decode_staggered(step: PagedStep, prompts: Sequence[Sequence[int]],
                     joins: Sequence[int], *, slots: int, total: int,
                     page_size: int, n_pages: int
                     ) -> tuple[list[list[int]], list[list[torch.Tensor]]]:
    """The same requests through one paged step over ``slots`` slots:
    request ``i`` decodes in slot ``i`` from step ``joins[i]`` on, over
    ``total`` tokens of pages from one allocator of ``n_pages``; the other
    slots stay inactive.  ``step(tok (S, 1) int32, pos (S,) int64,
    active (S,) bool, tables (S, T) int64)`` takes numpy arrays and
    returns the logits ``(S, V)``.  Returns, per request, what
    :func:`decode_alone` returns."""
    n_entries = -(-total // page_size)
    alloc = PageAllocator(n_pages, page_size)
    for i in range(len(prompts)):
        alloc.alloc(i, total)
    tables = [alloc.padded_table(i, n_entries) for i in range(len(prompts))]
    pos = [0] * len(prompts)
    outs: list[list[int]] = [[] for _ in prompts]
    rows: list[list[torch.Tensor]] = [[] for _ in prompts]
    for s in range(total - 1 + max(joins)):
        tok = np.zeros((slots, 1), np.int32)
        posv = np.zeros(slots, np.int64)
        active = np.zeros(slots, bool)
        tab = np.zeros((slots, n_entries), np.int64)
        for i, p in enumerate(prompts):
            if s < joins[i] or pos[i] >= total - 1:
                continue
            t = pos[i]
            tok[i, 0] = p[t] if t < len(p) else outs[i][-1]
            posv[i], active[i], tab[i] = t, True, tables[i]
        if not active.any():
            break
        logits = step(tok, posv, active, tab)
        for i in np.flatnonzero(active):
            rows[i].append(logits[i].clone())
            outs[i].append(int(logits[i].argmax()))
            pos[i] += 1
    return outs, rows
