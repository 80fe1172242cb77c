"""The control at a size a test run holds: on the reduced cell the
float8 reference, put in the program's place, fails the cell's limit on
the mean gap, where the program passes it."""

from __future__ import annotations

import pytest
import torch

from conftest import SMALL_LIMITS
from portbench import harness
from portbench.control import readings


@pytest.mark.parametrize("seeds", [[21, 22, 23], [31, 32, 33]])
def test_the_control_fails_where_the_program_passes(small, seeds):
    cell = "stablelm-w8-offline"
    b = harness.build(cell, seeds[0], torch.device("cpu"), small)
    for out in readings(b, seeds, 0.1, 3, torch.device("cpu")):
        assert out["sound"]["mean_gap"] <= SMALL_LIMITS[cell], out
        assert out["control"]["mean_gap"] > SMALL_LIMITS[cell], out
