"""Flight recorder: bounded ring of recent frames, dumped on trouble.

A long serve cannot keep (or re-read) everything it ever did, but the
moments that matter — an SLO page, a fired anomaly, a crash — are only
diagnosable from what happened *just before*.  The recorder keeps a
bounded ring of recent frames (per-step metric deltas, control events,
span notes) plus a merged "context" of the engine's current shape
(active plan, ladder level, per-class scheduler state, page-allocator
stats), and :meth:`FlightRecorder.dump` freezes all of it into one
post-mortem bundle, written atomically (temp file + ``os.replace``) so a
crash mid-dump never leaves a torn JSON.

Bundles are plain JSON under a post-mortem dir —
``postmortem-<tag>-<seq>.json`` — read back by
:func:`read_postmortems` and rendered by
the reference's ``python -m repro.obs postmortem <dir>`` (the port's
inspector comes with ``obs/__main__``).

Own copy of ``repro.obs.flight``, whole.
"""

from __future__ import annotations

import os
import time
from collections import deque
from pathlib import Path

from .trace import atomic_write_json

__all__ = ["FlightRecorder", "read_postmortems", "POSTMORTEM_GLOB"]

POSTMORTEM_GLOB = "postmortem-*.json"


class FlightRecorder:
    """Bounded in-memory ring + atomic post-mortem dumps.

    ``note(kind, **doc)`` appends one frame (step telemetry, a control
    event, a span of interest); ``set_context(**kv)`` merges the current
    engine shape (kept whole, not ringed — it is small and the *latest*
    value is the useful one).  ``dump(reason, ...)`` writes everything.

    ``max_bundles`` caps how many bundles one recorder writes per run so
    a pathological serve (anomaly every step) cannot fill the disk; the
    cap is generous and the refusal is counted in ``dumps_suppressed``.
    """

    def __init__(self, *, capacity: int = 512,
                 postmortem_dir: str | os.PathLike | None = None,
                 tag: str | None = None, max_bundles: int = 16) -> None:
        self.capacity = int(capacity)
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._context: dict = {}
        self.postmortem_dir = (Path(postmortem_dir)
                               if postmortem_dir is not None else None)
        if tag is None:
            import socket

            tag = f"{socket.gethostname()}-{os.getpid()}"
        self.tag = tag
        self.max_bundles = int(max_bundles)
        self._seq = 0
        self.dumps = 0
        self.dumps_suppressed = 0

    # ------------------------------------------------------------------ write
    def note(self, kind: str, **doc) -> None:
        """Append one frame to the ring.  ``kind`` names the frame type
        (``step``, ``event``, ``anomaly``, ``slo``...)."""
        self._ring.append({"kind": kind, **doc})

    def set_context(self, **kv) -> None:
        """Merge the engine's current shape; ``None`` values are kept
        (an explicit "no plan" is information too)."""
        self._context.update(kv)

    @property
    def frames(self) -> list[dict]:
        return list(self._ring)

    @property
    def context(self) -> dict:
        return dict(self._context)

    # ------------------------------------------------------------------- dump
    def bundle(self, reason: str, detail: str = "",
               extra: dict | None = None) -> dict:
        """The post-mortem document: why, the engine shape at dump time,
        and the last ``capacity`` frames in arrival order."""
        return {
            "reason": reason,
            "detail": detail,
            "tag": self.tag,
            "unix_time": round(time.time(), 3),
            "context": dict(self._context),
            "frames": list(self._ring),
            **(extra or {}),
        }

    def dump(self, reason: str, detail: str = "",
             extra: dict | None = None) -> Path | None:
        """Write one post-mortem bundle atomically; returns its path, or
        ``None`` when no dir is configured / the bundle cap is hit.  The
        ring is *not* cleared: a second trigger shortly after the first
        still sees the shared history, and the bundles' overlap makes the
        two triggers' ordering explicit."""
        if self.postmortem_dir is None:
            return None
        if self.dumps >= self.max_bundles:
            self.dumps_suppressed += 1
            return None
        self.postmortem_dir.mkdir(parents=True, exist_ok=True)
        # continue numbering past bundles already on disk (a serve that
        # restarts into the same dir must not overwrite its predecessor's
        # crash bundle)
        while True:
            path = (self.postmortem_dir
                    / f"postmortem-{self.tag}-{self._seq:04d}.json")
            if not path.exists():
                break
            self._seq += 1
        atomic_write_json(path, self.bundle(reason, detail, extra))
        self._seq += 1
        self.dumps += 1
        return path


def read_postmortems(
        postmortem_dir: str | os.PathLike) -> list[tuple[Path, dict]]:
    """Load every readable bundle under a dir, oldest first (bundles are
    atomic, so an unreadable file is foreign and skipped)."""
    import json

    out: list[tuple[Path, dict]] = []
    for path in sorted(Path(postmortem_dir).glob(POSTMORTEM_GLOB)):
        try:
            out.append((path, json.loads(path.read_text())))
        except (json.JSONDecodeError, OSError):
            continue
    return out
