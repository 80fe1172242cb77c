"""PyTorch port: the dry-run's hill-climb (``repro_torch.experiments.
hillclimb``) and ``SearchOutcome``'s generic selectors, against the JAX
package's ``experiments/hillclimb.py`` and ``repro.core.engine``.

The selectors are held to the reference's on the same records.  The
hill-climb's nine iterations run on reduced configs at (4, 4) and batch
16; its tags, knobs, printed winners and records are held to the
reference's step list and to the reference's selection logic
(``SearchOutcome.pareto`` over (``_t_step``, ``hlo_bytes``) and
``min_by(_t_step)``) applied to the same records.  The reference's
module forces 512 host devices through ``XLA_FLAGS`` when it is
imported (through ``repro.launch.dryrun``); JAX's backend is started
first, so that this process keeps its one CPU device, and the variable
is restored.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

jax.devices()                        # start the backend before the import below
_flags = os.environ.get("XLA_FLAGS")
_spec = importlib.util.spec_from_file_location(
    "reference_hillclimb", Path(__file__).resolve().parents[1] / "experiments" / "hillclimb.py")
jax_hillclimb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_hillclimb)
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from repro.core.engine import Candidate as JaxCandidate  # noqa: E402
from repro.core.engine import SearchOutcome as JaxOutcome  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.engine import SearchOutcome  # noqa: E402
from repro_torch.experiments import hillclimb  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402


def _records(seed: int, n: int) -> list[dict]:
    """Roofline-like records with ties and dominated points."""
    rng = np.random.default_rng(seed)
    terms = rng.integers(1, 6, size=(n, 4)).astype(float)
    return [{"tag": f"it{i}", "t_compute": a, "t_memory": b, "t_collective": c,
             "hlo_bytes": d} for i, (a, b, c, d) in enumerate(terms)]


@pytest.mark.parametrize("seed", range(6))
def test_min_by_and_pareto_match_reference(seed):
    recs = _records(seed, 12)
    got = SearchOutcome(engine="perf_hillclimb", benchmark="a/s", results=list(recs))
    want = JaxOutcome(engine="perf_hillclimb", benchmark="a/s", results=list(recs))
    objectives = (hillclimb._t_step, lambda r: r["hlo_bytes"])
    assert got.pareto(objectives) == want.pareto(objectives)
    assert got.min_by(hillclimb._t_step) is want.min_by(jax_hillclimb._t_step)
    assert got.best is None and want.best is None       # records carry no area
    empty = SearchOutcome(engine="e", benchmark="b")
    assert empty.min_by(hillclimb._t_step) is None and empty.pareto(objectives) == []


def test_best_still_picks_the_smallest_area():
    areas = [3.5, 1.25, 2.0]
    got = SearchOutcome(engine="e", benchmark="b",
                        results=[JaxCandidate(circuit=None, area=a) for a in areas])
    assert got.best.area == 1.25 == JaxOutcome(engine="e", benchmark="b",
                                               results=list(got.results)).best.area


def test_steps_and_t_step_match_reference():
    assert hillclimb.STEPS == jax_hillclimb.STEPS
    rec = _records(0, 1)[0]
    assert hillclimb._t_step(rec) == jax_hillclimb._t_step(rec)


def test_hillclimb_runs_every_step_small_and_picks_as_the_reference(tmp_path, capsys):
    """The nine iterations on reduced configs at (4, 4), batch 16: every
    record ``ok`` under its tagged file name, and each pair's Pareto
    iterations and fastest, as printed, equal to the reference's
    selection over the same records."""
    shape = ShapeConfig("tiny_train", 16, 16, "train")
    by_pair = hillclimb.hillclimb(hillclimb.STEPS, str(tmp_path),
                                  cfg=lambda arch: get_config(arch, reduced=True),
                                  shape=shape, mesh_dims=(4, 4))
    out = capsys.readouterr().out
    assert len(by_pair) == 3
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(f"{a}__tiny_train__4x4__{t}.json" for a, _, t, _ in hillclimb.STEPS)
    for (arch, shape_name), outcome in by_pair.items():
        assert outcome.stats == {"iterations": 3, "errors": 0} and outcome.ok
        recs = outcome.results
        for r in recs:
            saved = json.loads((tmp_path / f"{arch}__tiny_train__4x4__{r['tag']}.json").read_text())
            assert saved["status"] == "ok" and saved["hlo_flops"] == r["hlo_flops"]
        ref = JaxOutcome(engine="perf_hillclimb", benchmark=f"{arch}/{shape_name}",
                         results=list(recs))
        front = ref.pareto((jax_hillclimb._t_step, lambda r: r["hlo_bytes"]))
        best = ref.min_by(jax_hillclimb._t_step)
        assert (f"{arch} {shape_name}: pareto iterations "
                f"[{', '.join(r['tag'] for r in front)}]; fastest {best['tag']} "
                f"at t_step={jax_hillclimb._t_step(best):.3g}s") in out
    # the knobs reached the step: bf16 attention and remat="dots" change
    # command-r's counts, the microbatches its wire bytes
    cr = {r["tag"]: r for r in by_pair[("command-r-plus-104b", "train_4k")].results}
    assert cr["it2_bf16_dots"]["hlo_flops"] < cr["it1_bf16attn"]["hlo_flops"]
    assert cr["it3_bf16_dots_mb4"]["wire_bytes"] > cr["it2_bf16_dots"]["wire_bytes"]
