"""Paged KV cache: a block allocator for the continuous-batching engine.

The fixed-batch engine reserves a dense ``(batch, prompt+gen, ...)`` KV
cache per slot — every slot pays for the *longest* request it might ever
see.  Paging splits the cache into fixed-size pages shared by all slots:
each admitted request owns just enough pages for its own
``prompt_len + gen_len`` tokens, returned to a free list the moment the
request completes.  Heterogeneous prompt lengths then cost what they use,
and total cache memory is ``n_pages * page_size`` tokens instead of
``max_slots * max_len``.

Split of responsibilities:

* :class:`PageAllocator` (this module) is **pure host-side bookkeeping**:
  a free list plus per-request page tables, with hard alloc/free
  invariants (no double alloc, no foreign free, conservation of pages).
  It never touches device memory.
* The device-side page *pools* — one ``(n_pages + 1, page_size, ...)``
  array per paged layer — are built by
  :func:`repro_torch.models.lm.init_paged_caches`; the captured decode step
  scatters each slot's new KV row into ``pool[table[pos // page_size],
  pos % page_size]`` and gathers ``pool[table]`` back for attention.
  Physical page 0 is a **scratch page** reserved by the allocator:
  inactive slots write there and unused table entries point there, so
  masking (not allocation state) is what keeps requests isolated.

Allocation is whole-lifetime: a request's pages for ``prompt + gen``
tokens are claimed at admission, so admission *blocks* when the pool is
exhausted (``can_alloc`` says no) instead of a request stalling — or
corrupting a neighbour — mid-decode.  Preempted requests keep their
pages (their KV survives; resuming is a slot re-stack, not a re-prefill),
which is exactly why ``free`` is keyed by request id, not slot.

Own copy of ``repro.serving.kvcache``, whole.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["PageAllocator", "OutOfPages"]

# physical page id every unused/inactive page-table entry points at; the
# decode step routes masked writes there and never reads it unmasked
SCRATCH_PAGE = 0


class OutOfPages(Exception):
    """The pool cannot satisfy an allocation (admission should block)."""


class PageAllocator:
    """Free-list allocator over ``n_pages`` fixed-size pages.

    Page ids handed out are physical indices in ``[1, n_pages]`` —
    index 0 is the reserved scratch page (:data:`SCRATCH_PAGE`).  The
    free list is LIFO and seeded in descending order, so allocation
    order is deterministic: same admission sequence, same page tables,
    same preempted set (``tests/test_continuous.py`` pins this).
    """

    def __init__(self, n_pages: int, page_size: int) -> None:
        if n_pages < 1 or page_size < 1:
            raise ValueError(
                f"need at least one page of at least one token "
                f"(got n_pages={n_pages}, page_size={page_size})")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # LIFO free list, low ids on top: freshly freed pages are reused
        # first (cache-warm) and allocation stays deterministic
        self._free: list[int] = list(range(self.n_pages, 0, -1))
        self._tables: dict[int, list[int]] = {}

    # ----------------------------------------------------------------- sizing
    def pages_for(self, n_tokens: int) -> int:
        return max(1, math.ceil(int(n_tokens) / self.page_size))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def holds(self, rid: int) -> bool:
        return rid in self._tables

    def table(self, rid: int) -> tuple[int, ...]:
        return tuple(self._tables[rid])

    def can_alloc(self, n_tokens: int) -> bool:
        return self.pages_for(n_tokens) <= len(self._free)

    # ------------------------------------------------------------- alloc/free
    def alloc(self, rid: int, n_tokens: int) -> tuple[int, ...]:
        """Claim pages for ``n_tokens`` cache slots under request ``rid``.

        Raises :class:`OutOfPages` when the free list cannot cover the
        request (callers treat this as "admission blocks") and
        ``ValueError`` on a double allocation — a request that already
        holds pages (e.g. a preempted one) must resume, not re-alloc.
        """
        if rid in self._tables:
            raise ValueError(f"request {rid} already holds pages "
                             f"(preempted requests keep theirs; resume)")
        need = self.pages_for(n_tokens)
        if need > len(self._free):
            raise OutOfPages(
                f"request {rid} needs {need} page(s), {len(self._free)} free "
                f"(of {self.n_pages})")
        pages = [self._free.pop() for _ in range(need)]
        self._tables[rid] = pages
        return tuple(pages)

    def free(self, rid: int) -> int:
        """Return ``rid``'s pages to the free list; returns how many.
        Freeing a request that holds nothing is an error — it would mask
        double-free bugs that corrupt a neighbour's table."""
        pages = self._tables.pop(rid, None)
        if pages is None:
            raise ValueError(f"request {rid} holds no pages")
        self._free.extend(reversed(pages))
        assert len(self._free) <= self.n_pages, "free list overflow"
        return len(pages)

    # ---------------------------------------------------------------- tables
    def padded_table(self, rid: int | None, n_entries: int) -> np.ndarray:
        """``rid``'s page table as a fixed-width int32 row for the captured
        step: unused tail entries (and the whole row for ``rid=None``,
        i.e. an empty slot) point at the scratch page."""
        row = np.full((n_entries,), SCRATCH_PAGE, dtype=np.int32)
        if rid is not None:
            pages = self._tables[rid]
            if len(pages) > n_entries:
                raise ValueError(
                    f"request {rid} holds {len(pages)} pages but the step "
                    f"table has {n_entries} entries")
            row[: len(pages)] = pages
        return row

    def check_invariants(self) -> None:
        """Every physical page is owned exactly once (free list or one
        table), and the scratch page is never handed out."""
        free = list(self._free)
        owned = [p for t in self._tables.values() for p in t]
        seen = free + owned
        assert len(seen) == self.n_pages, (
            f"page conservation violated: {len(seen)} owned vs "
            f"{self.n_pages} total")
        assert len(set(seen)) == len(seen), "a page has two owners"
        assert SCRATCH_PAGE not in seen, "scratch page was allocated"
        assert all(1 <= p <= self.n_pages for p in seen), seen
