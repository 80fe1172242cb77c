"""How a mix drives the program: offline batches back to back on
``ServingEngine.run_batch``.  The window is whole batches, from the first
to the end of the batch that finishes after ``--seconds``.

The driver returns a :class:`Run`: the window on the host clock, taken by
the benchmark around its calls into the engine, what the window served,
and, with ``trace``, the device trace of a stretch of replays of the
first batch's decode phase (:class:`~portbench.devtrace.DeviceTrace`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from . import program, traffic
from .devtrace import DeviceTrace, TraceSummary


@dataclass
class Run:
    """What a run measured.  Times are seconds on the host clock."""

    window_s: float = 0.0
    rows_per_step: int = 0            # rows the program computes a step
    step_positions: list = field(default_factory=list)  # per window step: its rows' positions
    gen_tokens: int = 0               # tokens generated in the window
    attempted: int = 0
    trace: TraceSummary | None = None
    pool: list = field(default_factory=list)     # finished (prompt, tokens) to sample from


def serve_fixed(engine, mix: dict, cfg: dict, seed: int, seconds: float,
                trace: bool) -> Run:
    from torch.profiler import record_function

    vocab = int(cfg["vocab_size"])
    P, G, B = int(mix["prompt_len"]), int(mix["gen_len"]), int(mix["batch"])
    run = Run(rows_per_step=B)
    step = engine.static_step
    tr = None
    if trace:
        # ``trace_steps`` replays of the first batch's decode phase: a
        # traced run reports no end-to-end metric, so the stretch may lie
        # inside the window
        steps = int(mix["trace_steps"])
        lo = P + (G - steps) // 2
        replay, tr, count = step.replay, DeviceTrace(), [0]

        def traced_replay():
            if count[0] == lo:
                tr.__enter__()
            with record_function("portbench.replay"):
                out = replay()
            count[0] += 1
            if count[0] == lo + steps:
                tr.__exit__(None, None, None)
            return out

        step.replay = traced_replay
    n = 0
    t0 = time.perf_counter()
    while True:
        reqs = traffic.batch(mix, vocab, seed, n)
        engine.run_batch([program.request(r.rid, r.tokens) for r in reqs])
        n += 1
        vars(step).pop("replay", None)       # only the first batch is traced
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.gen_tokens = n * B * G
    run.attempted = n * B
    run.step_positions = [np.full(B, t) for _ in range(n) for t in range(P + G)]
    served = engine.last_tokens
    for i, r in enumerate(reqs):
        padded = np.zeros(P, np.int32)
        padded[:len(r.tokens)] = r.tokens
        run.pool.append((padded, np.asarray(served[i], np.int32), len(r.tokens)))
    if tr is not None:
        run.trace = tr.summary(steps)
    return run
