"""Library watcher: pick up store changes without stopping the server.

Own copy of ``repro.serving.watcher``, whole; it loads frontiers through
the port's :mod:`repro_torch.library.compile` and
:mod:`repro_torch.precision.plans`.

A background fleet sweep (``python -m repro_torch.fleet``, or the
reference's, same store format) densifies the operator store
*while* the server decodes.  Between batches the engine polls the
watcher; when the store's :meth:`~repro_torch.library.store.OperatorStore.version_token`
changes (records are content-addressed, so any put/merge/removal changes
the token), the watcher reloads the Pareto frontier and the runtime
atomically refreshes its plan — ``ParetoFrontier.from_store`` →
``qos.select_plan``/``refresh_plan`` → ``stack_luts`` — with shape/dtype
validation so a surprising store merge (different bit width) refuses to
swap instead of retracing the decode step.

Polling is rate-limited (``min_poll_s``) because a version check lists
the store directory; between-batch cadence on a busy server would stat
the filesystem far more often than libraries actually change.
"""

from __future__ import annotations

import time
from typing import Callable

from ..library.store import OperatorStore
from ..obs.metrics import MetricRegistry, get_registry

__all__ = ["LibraryWatcher"]


class LibraryWatcher:
    def __init__(self, library, *, min_poll_s: float = 2.0,
                 target_bits: int | None = None,
                 widths: tuple[int, ...] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry: MetricRegistry | None = None) -> None:
        self.library = library
        self.store = OperatorStore(library)
        # the serving width is sticky across refreshes: a W8A8 serve must
        # reload the *8-bit composed* frontier, or every refresh would be
        # refused by the stack validator (16x16 vs 256x256).  A
        # mixed-width serve pins the whole width set instead and reloads
        # a merged MixedFrontier (the engine rebuilds its ladder inside
        # the frozen width map).
        assert target_bits is None or widths is None, \
            "target_bits (uniform) and widths (mixed) are exclusive"
        self.target_bits = target_bits
        self.widths = tuple(int(b) for b in widths) if widths else None
        self.min_poll_s = float(min_poll_s)
        self._clock = clock
        self._token = self.store.version_token()
        self._last_poll = clock()
        self.refreshes = 0
        # watcher health rides the process-wide registry by default so a
        # trace-dir metric snapshot answers "did the server ever see the
        # sweep land?" without grepping serve logs
        self._registry = registry if registry is not None else get_registry()

    @property
    def token(self) -> str:
        return self._token

    def poll(self) -> bool:
        """True when the store's contents changed since the last poll.
        Cheap no-op while the rate limit holds."""
        now = self._clock()
        if self.min_poll_s > 0 and now - self._last_poll < self.min_poll_s:
            return False
        self._last_poll = now
        self._registry.counter("watcher_polls_total").inc()
        token = self.store.version_token()
        if token == self._token:
            return False
        self._token = token
        self._registry.counter("watcher_changes_total").inc()
        return True

    def load_frontier(self):
        """(compiled frontier, exact_area, bits) of the refreshed store —
        the triple every plan-refresh path consumes, compiled at the
        watcher's serving width — or, for a mixed-width watcher, the
        merged :class:`~repro_torch.precision.plans.MixedFrontier`.  Raises
        :class:`LookupError` if the store lost its multipliers (the
        caller keeps serving on the old plan)."""
        self.refreshes += 1
        self._registry.counter("watcher_refreshes_total").inc()
        if self.widths is not None:
            from ..precision.plans import load_mixed_frontier

            return load_mixed_frontier(self.library, self.widths)
        from ..library.compile import load_mul_frontier

        return load_mul_frontier(self.library, target_bits=self.target_bits)
