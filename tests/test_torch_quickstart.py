"""PyTorch port: ``python -m repro_torch.examples.quickstart`` against the
reference's ``examples/quickstart.py``.

Steps [2/4] (MUSCAT-like and MECALS-like on ``adder_i6`` at ET 2) and
[4/4] (``mul_i8`` pruned at ET 8, its LUT and error profile) print the
reference's numbers: both packages run the same host numpy.  Steps [1/4]
and [3/4] and the XPAT baseline need z3; the port prints that they are
left out and prints no number for them.
"""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.arith import benchmark as jbenchmark  # noqa: E402
from repro.core.baselines import mecals_like as jmecals  # noqa: E402
from repro.core.baselines import muscat_like as jmuscat  # noqa: E402
from repro.core.synth import area as jarea  # noqa: E402
from repro.quant import build_lut as jbuild_lut  # noqa: E402
from repro.quant import exact_mul_lut as jexact_mul_lut  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402


@pytest.fixture(scope="module")
def run():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = quickstart.main([])
    return got, buf.getvalue()


def test_quickstart_runs_to_its_end_and_names_what_it_leaves_out(run):
    _, text = run
    steps = [line for line in text.splitlines() if line.startswith("[")]
    assert [s[:5] for s in steps] == ["[1/4]", "[2/4]", "[3/4]", "[4/4]"]
    left = [line for line in text.splitlines() if "left out" in line]
    assert len(left) == 3 and all("z3" in line for line in left)
    assert "XPAT (nonshared): left out" in text
    assert "LUT max error" in text.splitlines()[-1]


def test_quickstart_prints_the_reference_baselines_and_lut(run):
    got, text = run
    adder, mult = jbenchmark("adder_i6"), jbenchmark("mul_i8")
    rm = jmuscat(adder, et=2, restarts=2, wall_budget_s=30)
    rc = jmecals(adder, et=2, wall_budget_s=30)
    rm8 = jmuscat(mult, et=8, restarts=2, wall_budget_s=60)
    lut = jbuild_lut(rm8.circuit)
    err = np.abs(lut - jexact_mul_lut())
    assert got["exact_area"] == jarea(adder)
    assert got["muscat"] == (rm.area, rm.wce) and got["mecals"] == (rc.area, rc.wce)
    assert got["mul_area"] == rm8.area and got["mul_exact_area"] == jarea(mult)
    np.testing.assert_array_equal(got["lut"], lut)
    assert (got["lut_max_err"], got["lut_mean_err"]) == (int(err.max()), float(err.mean()))
    assert f"  MUSCAT-like gate pruning: {rm.area} µm² (wce {rm.wce})" in text
    assert f"  MECALS-like substitution: {rc.area} µm² (wce {rc.wce})" in text
    assert f"  LUT max error {err.max()}, mean error {err.mean():.2f}" in text
