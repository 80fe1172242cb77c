"""The window's arithmetic over all its work, a stall included, and the
spread of a set of runs."""

from __future__ import annotations

import statistics
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import loader
from portbench.drivers import Run
from portbench.spread import spread


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 10.2, 9.9, 10.4, 10.1, 9.8]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert spread(xs) == (med, pytest.approx((q3 - q1) / med))


def _ctx(run):
    return SimpleNamespace(run=run, setup_s=1.0, peaks=None, cfg={}, mix={},
                           dims=None)


@pytest.mark.parametrize("stall_s", [0.0, 2.0])
def test_a_stall_inside_the_window_counts_in_the_rate_and_the_step(stall_s):
    """Two batches of 100 steps of 50 ms, one step stalled: the rate and
    the mean step are taken over the whole window, the stall's time in."""
    steps = [0.05] * 200
    steps[150] += stall_s
    run = Run(window_s=sum(steps), gen_tokens=2 * 8 * 40,
              step_positions=[np.full(8, t % 100) for t in range(200)])
    assert loader.reader("gen_tok_s")(_ctx(run)) == pytest.approx(640 / (10.0 + stall_s))
    assert loader.reader("step_ms.offline")(_ctx(run)) == pytest.approx(
        1e3 * (10.0 + stall_s) / 200)


def test_setup_is_read_as_it_was_taken():
    assert loader.reader("setup_s")(_ctx(Run())) == 1.0
