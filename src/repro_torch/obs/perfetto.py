"""Chrome trace-event export: open a serve's span stream as a flame graph.

Own copy of ``repro.obs.perfetto``.
``python -m repro_torch.obs export --format chrome`` converts the merged span
trace (:func:`repro_torch.obs.trace.read_trace` — every writer tag, rotated
segments included) into the Chrome trace-event JSON format that
Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` load
directly, so ``serve.batch`` > ``serve.prefill``/``serve.decode``/
``serve.shadow`` nesting and the ``req.*`` request-lifecycle events
read as a flame graph instead of a JSONL scroll.

Mapping: every span becomes one complete (``"ph": "X"``) event with
microsecond ``ts``/``dur`` relative to the trace's first timestamp.
Chrome nests events on a track (``tid``) purely by time containment,
and our writer guarantees children close before their parents on the
same clock — so parentage is preserved by putting every span on its
*root's* track and packing roots onto tracks greedily (a new root takes
the first track that is idle at its start time).  Span ids and parent
ids ride in ``args`` next to the span's own attrs, so the explicit
parent chain survives the conversion verbatim.  Stdlib-only.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

__all__ = ["chrome_trace", "export_chrome"]


def chrome_trace(spans: list[dict]) -> dict:
    """Convert merged span docs to a Chrome trace-event document."""
    by_id = {s["id"]: s for s in spans if s.get("id")}
    # a span is a root when it has no parent or the parent record is
    # missing (torn tail of a crashed writer)
    root_of: dict[str, str] = {}

    def find_root(sid: str) -> str:
        seen = []
        cur = sid
        while True:
            cached = root_of.get(cur)
            if cached is not None:
                break
            seen.append(cur)
            parent = by_id[cur].get("parent")
            if parent is None or parent not in by_id or parent == cur:
                cached = cur
                break
            cur = parent
        for s in seen:
            root_of[s] = cached
        return cached

    for sid in by_id:
        find_root(sid)

    # greedy track packing over the roots: overlapping roots (two
    # processes, two threads) land on separate tracks so their subtrees
    # nest without interleaving
    roots = sorted({r for r in root_of.values()},
                   key=lambda r: (by_id[r]["t0"], -by_id[r].get("dur_s", 0.0),
                                  r))
    track_end: list[float] = []
    track_of: dict[str, int] = {}
    for r in roots:
        t0 = by_id[r]["t0"]
        t1 = t0 + max(0.0, by_id[r].get("dur_s", 0.0))
        for i, end in enumerate(track_end):
            if end <= t0 + 1e-9:
                track_of[r] = i
                track_end[i] = t1
                break
        else:
            track_of[r] = len(track_end)
            track_end.append(t1)

    t_base = min((s["t0"] for s in by_id.values()), default=0.0)
    events: list[dict] = []
    for sid, s in sorted(by_id.items(), key=lambda i: (i[1]["t0"], i[0])):
        tid = track_of[root_of[sid]] + 1
        args = dict(s.get("attrs") or {})
        args["span_id"] = sid
        if s.get("parent"):
            args["parent_id"] = s["parent"]
        events.append({
            "name": s["name"],
            "cat": s["name"].split(".", 1)[0],
            "ph": "X",
            "pid": 1,
            "tid": tid,
            "ts": round((s["t0"] - t_base) * 1e6, 3),
            "dur": round(max(0.0, s.get("dur_s", 0.0)) * 1e6, 3),
            "args": args,
        })
    meta = [{"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": "repro trace"}}]
    meta += [{"name": "thread_name", "ph": "M", "pid": 1, "tid": i + 1,
              "args": {"name": f"track {i + 1}"}}
             for i in range(len(track_end))]
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"t0": t_base, "spans": len(events)},
    }


def export_chrome(spans: list[dict],
                  out: str | os.PathLike | None = None) -> dict:
    """Render :func:`chrome_trace` to ``out`` (or return it for stdout
    printing).  Parent dirs are created; the write is plain (the export
    is a one-shot CLI, not a crash-safe stream)."""
    doc = chrome_trace(spans)
    if out is not None:
        path = Path(out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc) + "\n")
    return doc
