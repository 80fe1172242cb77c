"""The device trace of a traced run, from ``torch.profiler``.

A :class:`DeviceTrace` records the CPU and CUDA activity of a stretch of
the run inside one ``portbench.window`` span and reduces it, once the
stretch is over, to what the metrics read: each kernel's launches and
device seconds, the seconds in which any operation ran on the device
(the union of the kernel, copy and set intervals), the window's length
(the span's own), the device operations that took most time and the idle
gaps by the innermost host span or op open at their middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

_SHORT_GAP_US = 20.0
_NAME = 120


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)     # name -> [launches, seconds]
    device_ops: list = field(default_factory=list)  # [[name, seconds]] top 10
    idle_gaps: list = field(default_factory=list)   # [[host op, seconds]] top 10
    steps: int = 0                                  # steps the harness ran in it

    def launches(self, *parts: str) -> tuple[int, float]:
        """Launches and device seconds of the kernels whose name holds
        every one of ``parts``."""
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if all(p in name for p in parts):
                n += c
                s += t
        return n, s


class DeviceTrace:
    """``with DeviceTrace() as tr: ...`` profiles the block;
    :meth:`summary` reduces it afterwards, when the caller's timing no
    longer depends on the time that takes."""

    def __init__(self) -> None:
        self._summary: TraceSummary | None = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._card = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._card else [])
        if self._card:
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function("portbench.window")
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if self._card:
            torch.cuda.synchronize()
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def summary(self, steps: int) -> TraceSummary:
        if self._summary is None:
            self._summary = reduce_events(self._prof.events())
            self._summary.steps = steps
        return self._summary


def reduce_events(events) -> TraceSummary:
    """Reduce a profiler's ``FunctionEvent`` list (times in us)."""
    from torch.autograd import DeviceType

    window = [e for e in events if e.name == "portbench.window"]
    if not window:
        raise RuntimeError("the trace holds no portbench.window span")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    dev, host = [], []
    for e in events:
        if e.name.startswith("portbench."):
            # a span's annotation on the device timeline, not an operation
            if e.device_type == DeviceType.CPU and e.name != "portbench.window":
                host.append(e)
            continue
        if e.device_type == DeviceType.CUDA:
            dev.append(e)
        elif e.device_type == DeviceType.CPU:
            host.append(e)

    kernels: dict[str, list] = defaultdict(lambda: [0, 0.0])
    spans = []
    for e in dev:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        k = kernels[e.name]
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e6
        if b > a:
            spans.append((a, b))
    spans.sort()
    merged: list[list[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)

    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    own = [e for e in host if e.name.startswith("portbench.")]
    by_host: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        if b - a < _SHORT_GAP_US:
            by_host[f"gaps under {_SHORT_GAP_US:g} us"] += (b - a) / 1e6
            continue
        by_host[_innermost(host, starts, own, (a + b) / 2)] += (b - a) / 1e6

    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return TraceSummary(
        window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
        kernels={k: list(v) for k, v in kernels.items()},
        device_ops=[[k[:_NAME], v[1]] for k, v in top],
        idle_gaps=[[k[:_NAME], v] for k, v in
                   sorted(by_host.items(), key=lambda kv: -kv[1])[:10]])


def _innermost(host, starts, own, t: float) -> str:
    """The shortest host event open at ``t``: an op among the last few
    thousand to start, else one of the benchmark's own spans."""
    best, best_len = None, None
    i = bisect.bisect_right(starts, t)
    for e in host[max(0, i - 4000):i] + own:
        if e.time_range.start <= t <= e.time_range.end:
            n = e.time_range.end - e.time_range.start
            if best_len is None or n < best_len:
                best, best_len = e.name, n
    return f"host: {best}" if best else "host: outside any traced op"
