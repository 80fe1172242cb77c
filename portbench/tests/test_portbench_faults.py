"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a card is skipped (the reduced cell runs on the
CPU), everything else of a run is driven, once for each fault a serving
cell can have."""

from __future__ import annotations

import time

import pytest
import torch


def _state_unchanged(monkeypatch):
    """The decode step writes no key or value: its caches come back as
    they went in."""
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "index_copy_", lambda *a, **k: None)


def _token_altered(monkeypatch):
    """Every step's logits shifted by one place: the engine serves the
    token after the best one."""
    from repro_torch.serving.engine import StaticStep

    replay = StaticStep.replay

    def shifted(self):
        out = replay(self)
        out.copy_(torch.roll(out, 1, dims=-1))
        return out

    monkeypatch.setattr(StaticStep, "replay", shifted)


def _half_batch(monkeypatch):
    """The second half of the rows served the first half's logits."""
    from repro_torch.serving.engine import StaticStep

    replay = StaticStep.replay

    def halved(self):
        out = replay(self)
        h = out.shape[0] // 2
        out[h:2 * h].copy_(out[:h].clone())
        return out

    monkeypatch.setattr(StaticStep, "replay", halved)


FAULTS = {"state_unchanged": _state_unchanged, "token_altered": _token_altered,
          "half_batch": _half_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_comes_out_not_correct(small, monkeypatch, fault):
    from portbench import harness

    seed, cell = 4242, "stablelm-w8-offline"
    sound = harness.run_cell(cell, seed, 0.6, False, t_start=time.perf_counter(),
                             device="cpu", root=small)
    assert sound["correct"] is True, sound["checks"]
    FAULTS[fault](monkeypatch)
    broken = harness.run_cell(cell, seed, 0.6, False, t_start=time.perf_counter(),
                              device="cpu", root=small)
    assert broken["correct"] is False, broken["checks"]
