"""Per-request lifecycle chains reconstructed from the JSONL trace.

The serving layer emits one zero-duration trace event per lifecycle
transition, every one carrying the request id (the repo convention:
*any* serving-layer event with a request in scope carries ``rid``):

    req.queued -> req.admitted -> req.prefill -> req.decode
        [-> req.preempt -> req.resume]* -> req.done

``req.done`` carries the full host-side time breakdown — ``queue_ms``
(submission to first admission), ``prefill_ms`` (first admission to
first generated token, suspensions excluded), ``decode_ms`` (first to
last generated token, suspensions excluded), ``suspension_ms`` (total
preempted-and-waiting time) — so a chain is self-describing even when
trace clocks are injected.  This module groups the merged span stream
(:func:`repro_torch.obs.trace.read_trace`) by request id, validates each
chain's causal completeness, and extracts the critical path (the
dominant breakdown segment): the facts behind the reference's ``python -m repro.obs
requests`` and the ``provenance-smoke`` CI gate.

Own copy of ``repro.obs.requests``, whole.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "LIFECYCLE_EVENTS",
    "BREAKDOWN_KEYS",
    "RequestTimeline",
    "request_events",
    "build_timelines",
    "critical_path",
]

LIFECYCLE_EVENTS = ("req.queued", "req.admitted", "req.prefill",
                    "req.decode", "req.preempt", "req.resume", "req.done")
BREAKDOWN_KEYS = ("queue_ms", "prefill_ms", "decode_ms", "suspension_ms")

# once per chain vs paired vs terminal — the completeness rules
_ONCE = ("req.queued", "req.admitted", "req.prefill", "req.done")


@dataclass
class RequestTimeline:
    """One request's reconstructed lifecycle chain."""

    rid: int
    cls: str = "?"
    replica: str = ""
    events: list = field(default_factory=list)   # trace docs, time order
    breakdown: dict = field(default_factory=dict)
    total_ms: float | None = None
    steps: int | None = None
    preempts: int = 0
    resumes: int = 0
    problems: list = field(default_factory=list)

    @property
    def complete(self) -> bool:
        return not self.problems

    def counts(self) -> dict[str, int]:
        by: dict[str, int] = {}
        for e in self.events:
            by[e["name"]] = by.get(e["name"], 0) + 1
        return by


def request_events(spans: list[dict]) -> list[dict]:
    """The lifecycle events in a merged span stream (``read_trace``
    order, i.e. sorted by ``(t0, id)``)."""
    return [s for s in spans if s.get("name") in LIFECYCLE_EVENTS
            and "rid" in s.get("attrs", {})]


def critical_path(breakdown: dict) -> str | None:
    """The dominant lifecycle segment — where this request's latency
    actually went (``queue_ms`` names an admission problem, ``decode_ms``
    a service-time one, ``suspension_ms`` a preemption-pressure one)."""
    present = {k: breakdown[k] for k in BREAKDOWN_KEYS if k in breakdown}
    if not present:
        return None
    return max(present, key=lambda k: (present[k], k))


def build_timelines(spans: list[dict]) -> dict[int, RequestTimeline]:
    """Group lifecycle events by request id and validate each chain.

    A chain is *complete* when every once-only transition appears
    exactly once, every ``req.preempt`` has a matching ``req.resume``
    (the request came back and finished), the terminal ``req.done``
    carries a non-negative breakdown, and the breakdown's segments sum
    to its ``total_ms`` (1% + 1ms tolerance for float rounding).
    Anything else — a lost event, a resume that never happened, a
    negative duration — lands in ``problems`` and fails the
    ``--require-complete`` CI gate.
    """
    timelines: dict[int, RequestTimeline] = {}
    for e in request_events(spans):
        attrs = e.get("attrs", {})
        rid = int(attrs["rid"])
        tl = timelines.setdefault(rid, RequestTimeline(rid=rid))
        tl.events.append(e)
        if "cls" in attrs:
            tl.cls = str(attrs["cls"])
        if attrs.get("replica"):
            tl.replica = str(attrs["replica"])

    for tl in timelines.values():
        by = tl.counts()
        tl.preempts = by.get("req.preempt", 0)
        tl.resumes = by.get("req.resume", 0)
        for name in _ONCE:
            n = by.get(name, 0)
            if n != 1:
                tl.problems.append(f"{n}x {name} (expected exactly 1)")
        if by.get("req.done") and not by.get("req.decode"):
            tl.problems.append("req.done without req.decode")
        if tl.resumes != tl.preempts:
            tl.problems.append(f"{tl.preempts} preempt(s) but "
                               f"{tl.resumes} resume(s)")
        done = next((e for e in tl.events if e["name"] == "req.done"), None)
        if done is not None:
            attrs = done.get("attrs", {})
            tl.total_ms = attrs.get("total_ms")
            tl.steps = attrs.get("steps")
            if attrs.get("preempts", tl.preempts) != tl.preempts:
                tl.problems.append(
                    f"req.done says {attrs['preempts']} preempt(s), chain "
                    f"has {tl.preempts}")
            for k in BREAKDOWN_KEYS:
                v = attrs.get(k)
                if v is None:
                    tl.problems.append(f"req.done missing {k}")
                elif v < 0:
                    tl.problems.append(f"negative {k} ({v})")
                else:
                    tl.breakdown[k] = float(v)
            if tl.total_ms is not None and len(tl.breakdown) == len(
                    BREAKDOWN_KEYS):
                total = sum(tl.breakdown.values())
                if abs(total - tl.total_ms) > 1.0 + 0.01 * tl.total_ms:
                    tl.problems.append(
                        f"breakdown sums to {total:.3f} ms but total_ms "
                        f"is {tl.total_ms:.3f}")
    return timelines
