"""Slot pool + weighted-fair admission for the continuous-batching engine.

Continuous batching decodes over a fixed pool of ``max_slots`` slots —
the captured step always sees the same ``(max_slots, ...)`` shapes — while
requests join and leave *per step* through an active-mask.  Everything in
this module is host-side bookkeeping around that pool:

* :class:`SeqState` — one request's decode progress (prompt, generated
  tokens, next cache position).  It outlives its slot: a preempted
  request's ``SeqState`` (plus its pages, held in
  :class:`~repro_torch.serving.kvcache.PageAllocator`) is the whole resume
  ticket.
* :class:`SlotPool` — which request occupies which slot, free-slot
  lookup, and the deterministic preemption-victim pick.
* :class:`WeightedFairQueues` — smooth weighted round-robin over the
  per-class admission queues.  The fixed-batch engine drains strictly by
  priority, which starves ``batch`` under sustained ``gold`` load; here
  every class with queued work gets slots in proportion to its weight
  (default ``2^(n-1-i)`` from
  :meth:`repro_torch.sensitivity.classes.ClassBook.drain_weights`), and latency
  guarantees move to the explicit SLO/preemption path instead of being an
  accident of drain order.

Own copy of ``repro.serving.slots``, whole.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping

import numpy as np

__all__ = ["SeqState", "SlotPool", "WeightedFairQueues"]


@dataclass
class SeqState:
    """Decode progress of one admitted request.

    ``pos`` is the next cache position to feed: positions
    ``0 .. len(prompt)-2`` are prefill (the fed token is the prompt),
    every later step feeds the previously generated token and produces a
    new one.  The request is done after ``gen_len`` generated tokens —
    ``len(prompt) + gen_len - 1`` steps in total, all through the same
    captured decode step (one code path, one capture)."""

    rid: int
    cls: str
    prompt: np.ndarray
    gen_len: int
    submitted_t: float
    pos: int = 0
    generated: list = field(default_factory=list)
    preempted: int = 0          # how many times this request was preempted
    ring_rows: dict | None = None   # per-layer ring-buffer snapshot while
    #                                 suspended (paged layers need none:
    #                                 their KV lives in the request's pages)
    # lifecycle timestamps (engine clock): the request-timeline breakdown
    # is computed host-side from these and emitted on req.done, so a
    # chain is auditable even when the trace clock is injected
    admitted_t: float | None = None     # first admission into a slot
    first_token_t: float | None = None  # the TTFT edge
    queue_wait_s: float = 0.0           # submission -> first admission
    suspended_at: float | None = None   # eviction time while preempted
    suspended_s: float = 0.0            # total suspension so far
    suspended_before_first_s: float = 0.0   # suspension during prefill

    @property
    def n_tokens(self) -> int:
        """Cache positions this request may ever touch (its page claim)."""
        return len(self.prompt) + self.gen_len

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.gen_len

    def next_token(self) -> int:
        p = len(self.prompt)
        return int(self.prompt[self.pos]) if self.pos < p \
            else int(self.generated[self.pos - p])

    def advance(self, sampled: int) -> tuple[bool, bool]:
        """Consume one step's output.  Returns ``(generated_now, was_first)``
        — whether this step produced a token, and whether it was the
        request's first (the TTFT edge)."""
        generates = self.pos >= len(self.prompt) - 1
        if generates and not self.done:
            self.generated.append(int(sampled))
            first = len(self.generated) == 1
        else:
            first = False
        self.pos += 1
        return generates, first

    def breakdown(self, done_t: float) -> dict:
        """The lifecycle time breakdown ``req.done`` carries: queueing,
        prefill (suspension excluded), decode (suspension excluded), and
        total suspension, in ms.  The four segments sum to ``total_ms``
        by construction."""
        ft = self.first_token_t if self.first_token_t is not None else done_t
        at = self.admitted_t if self.admitted_t is not None else ft
        susp_decode = self.suspended_s - self.suspended_before_first_s
        return {
            "queue_ms": round(1e3 * self.queue_wait_s, 3),
            "prefill_ms": round(
                1e3 * max(0.0, (ft - at) - self.suspended_before_first_s),
                3),
            "decode_ms": round(1e3 * max(0.0, (done_t - ft) - susp_decode),
                               3),
            "suspension_ms": round(1e3 * self.suspended_s, 3),
            "total_ms": round(1e3 * (done_t - self.submitted_t), 3),
        }


class SlotPool:
    """Occupancy map of the fixed decode-slot pool."""

    def __init__(self, n_slots: int) -> None:
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.n_slots = int(n_slots)
        self.slots: list[SeqState | None] = [None] * self.n_slots

    def __iter__(self):
        """``(slot_idx, SeqState)`` for every occupied slot."""
        return ((i, s) for i, s in enumerate(self.slots) if s is not None)

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def occupancy(self) -> float:
        return self.n_active / self.n_slots

    def free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def place(self, idx: int, seq: SeqState) -> None:
        assert self.slots[idx] is None, f"slot {idx} is occupied"
        self.slots[idx] = seq

    def evict(self, idx: int) -> SeqState:
        seq = self.slots[idx]
        assert seq is not None, f"slot {idx} is empty"
        self.slots[idx] = None
        return seq

    def pick_victim(self, priority_of: Callable[[str], int],
                    below: int) -> int | None:
        """The slot a higher-tier arrival preempts: deterministically the
        occupied slot whose class priority is *worst* (largest number)
        among those strictly below the arriving tier (``priority >
        below``), tie-broken toward the youngest request (largest rid —
        it has the least service invested and, having arrived last, the
        weakest claim).  ``None`` when no slot is preemptible."""
        best: tuple[int, int] | None = None
        best_idx = None
        for i, seq in self:
            p = priority_of(seq.cls)
            if p <= below:
                continue
            key = (p, seq.rid)
            if best is None or key > best:
                best, best_idx = key, i
        return best_idx


class WeightedFairQueues:
    """Smooth weighted round-robin over per-class admission queues.

    Classic SWRR restricted to *active* flows: each pick credits every
    class that has admissible queued work with its weight, takes the
    highest credit (ties resolve toward the earlier-declared — higher
    priority — class), and debits the winner by the total active weight.
    Over any busy window class shares converge to the weight ratio, and
    the whole schedule is a pure function of the arrival order — no RNG,
    so preemption/admission tests replay bit-identically."""

    def __init__(self, names: Iterable[str],
                 weights: Mapping[str, int] | None = None) -> None:
        self.names = tuple(names)
        if not self.names:
            raise ValueError("weighted-fair drain needs at least one class")
        w = dict(weights) if weights is not None else {}
        self.weights = {n: max(1, int(w.get(n, 1))) for n in self.names}
        self.queues: dict[str, deque] = {n: deque() for n in self.names}
        self._credit = {n: 0 for n in self.names}

    def __len__(self) -> int:
        return sum(len(q) for q in self.queues.values())

    @property
    def depth(self) -> int:
        return len(self)

    def push(self, name: str, item) -> None:
        self.queues[name].append(item)

    def push_front(self, name: str, item) -> None:
        """Resume path: a preempted request re-enters at the head of its
        class queue — it already waited its turn once."""
        self.queues[name].appendleft(item)

    def peek(self, name: str):
        q = self.queues[name]
        return q[0] if q else None

    def pop(self, name: str):
        return self.queues[name].popleft()

    def pick(self, admissible: Callable = lambda item: True):
        """Pop the next ``(class, item)`` under weighted-fair sharing,
        considering only classes whose *head* passes ``admissible``
        (e.g. "the page pool can cover it").  Returns ``None`` when no
        class has admissible work."""
        active = [n for n in self.names
                  if self.queues[n] and admissible(self.queues[n][0])]
        if not active:
            return None
        for n in active:
            self._credit[n] += self.weights[n]
        best = max(active, key=lambda n: self._credit[n])
        self._credit[best] -= sum(self.weights[n] for n in active)
        return best, self.queues[best].popleft()
