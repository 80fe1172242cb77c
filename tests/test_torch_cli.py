"""PyTorch port: the serve launcher and its reports against the JAX package's.

``launch.analysis.plan_report`` and ``sensitivity_report`` print the same
strings.  ``repro.launch.serve.main`` and ``repro_torch.launch.serve.main``
run in this process with the same flags on reduced qwen3-4b in f32, the
port on the reference's weights converted (its ``init_model`` is replaced
here; the program keeps no hook for it), in every serving mode: plain, a
startup QoS plan, adaptive, W8A8, continuous with classes, a measured
profile, the health plane and a trace, two replicas behind the router, and
the fixed-batch comparison.  They must print the same ``sample:`` tokens
and plan table, and write bench summaries with the same keys and the same
timing-free fields.  Each of the reference's argument checks exits with
the same message on both sides.
"""

import dataclasses
import json
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.arith import benchmark  # noqa: E402
from repro.launch import analysis as janalysis  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.library import select_plan as jselect_plan  # noqa: E402
from repro.library.compile import load_mul_frontier as jload  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.sensitivity import profile as jprofile  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import analysis  # noqa: E402
from repro_torch.launch import serve as pserve  # noqa: E402
from repro_torch.library import select_plan  # noqa: E402
from repro_torch.library.compile import load_mul_frontier  # noqa: E402
from repro_torch.obs import metrics as pmetrics  # noqa: E402
from repro_torch.obs import trace as ptrace  # noqa: E402
from repro_torch.sensitivity import profile as pprofile  # noqa: E402
from test_serving import fill_library, trunc_mul2  # noqa: E402

# the bench summary's fields that do not depend on the clock
TIMING_FREE = ("requests", "batches", "swaps", "swaps_by_reason",
               "approx_layers", "width_bits", "widths", "mode",
               "preemptions", "requests_traced", "requests_complete")
# the reference's CLI traces its decode step 2-3 times on the CPU (its
# engines alone trace once); the port's engines capture theirs once


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' tensors are tiny: intra-op threads only add
    overhead here and crowd the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reset_globals():
    """The process-wide tracer and metric registry of both packages: each
    CLI run starts and ends without them (both read one environment
    variable for the trace dir)."""
    jtrace.reset()
    ptrace.reset()
    jmetrics.set_registry(jmetrics.MetricRegistry())
    pmetrics.set_registry(pmetrics.MetricRegistry())


@pytest.fixture(autouse=True)
def _fresh_globals():
    reset_globals()
    yield
    reset_globals()


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """Exact and truncated 2-bit multipliers, the library
    tests/test_torch_qos.py and tests/test_torch_continuous.py serve
    (its frontier composes to W8A8 too)."""
    root = tmp_path_factory.mktemp("cli") / "lib"
    fill_library(root, [benchmark("mul_i4"), trunc_mul2()])
    return root


@pytest.fixture(scope="module")
def sens_profile(tmp_path_factory):
    """A measured-profile file for reduced qwen3-4b (two layers, W4A4)."""
    path = tmp_path_factory.mktemp("prof") / "p.json"
    pprofile.SensitivityProfile(
        model="qwen3-4b-reduced", n_layers=2,
        sens={4: np.array([0.3, 0.2])}, probe_mae={4: 1.5}).save(path)
    return path


def _f32(get):
    return lambda arch, reduced=False: dataclasses.replace(
        get(arch, reduced=reduced), dtype="float32")


def run_both(argv, tmp_path, monkeypatch, capsys):
    """Run the reference CLI and then the port's with ``argv`` (``{side}``
    in an argument names a per-side path); returns ``{side: (stdout,
    bench summary)}``."""
    made = {}
    real_init = jserve.init_model

    def capture(cfg, key):
        made["params"] = real_init(cfg, key)
        return made["params"]

    monkeypatch.setattr(jserve, "get_config", _f32(jax_config))
    monkeypatch.setattr(pserve, "get_config", _f32(get_config))
    monkeypatch.setattr(jserve, "init_model", capture)
    monkeypatch.setattr(pserve, "init_model", lambda cfg, seed, device: params_from_jax(
        jax.tree.map(np.asarray, made["params"]), device=device))
    out = {}
    for side, main in (("ref", jserve.main), ("port", pserve.main)):
        args = [a.format(side=tmp_path / side) for a in argv]
        args += ["--bench-json", str(tmp_path / f"{side}.json")]
        if side == "port":
            args += ["--device", "cpu"]
            main(args)
        else:
            monkeypatch.setattr(sys, "argv", ["serve"] + args)
            main()
        out[side] = (capsys.readouterr().out,
                     json.loads((tmp_path / f"{side}.json").read_text()))
        reset_globals()
    return out


def plan_table(text: str) -> list[str]:
    lines = text.splitlines()
    if not any(line.startswith("QoS plan (") for line in lines):
        return []
    i = next(i for i, line in enumerate(lines) if line.startswith("QoS plan ("))
    j = next(j for j in range(i, len(lines)) if lines[j].startswith("total area"))
    return lines[i:j + 1]


def timing_free(summary: dict) -> dict:
    return {k: summary[k] for k in TIMING_FREE if k in summary}


SMALL = ["--reduced", "--arch", "qwen3-4b", "--batch", "2", "--prompt-len", "4",
         "--gen-len", "8"]
MODES = {
    "plain": [],
    "plan": ["--library", "{lib}", "--qos-budget", "100"],
    "adaptive": ["--library", "{lib}", "--adaptive", "--target-ms-per-step",
                 "0.001", "--drift-budget", "1e9", "--shadow-every", "2",
                 "--schedule", "spike", "--ticks", "3", "--per-tick", "3"],
    "w8": ["--library", "{lib}", "--width", "8", "--qos-budget", "1e9"],
    "continuous": ["--continuous", "--library", "{lib}", "--profile", "{prof}",
                   "--qos-class", "gold:1e9@250ms,batch:1e9",
                   "--class-mix", "gold:0.4,batch:0.6", "--max-slots", "2",
                   "--page-size", "4", "--schedule", "spike", "--ticks", "3",
                   "--per-tick", "3", "--prompt-dist", "uniform:2-4",
                   "--health", "--trace", "{side}-trace", "--shadow-every", "2"],
    "replicas": ["--continuous", "--replicas", "2", "--max-slots", "2",
                 "--page-size", "4", "--schedule", "steady", "--ticks", "2",
                 "--per-tick", "3", "--library", "{lib}", "--qos-budget", "100"],
    "compare-fixed": ["--continuous", "--compare-fixed", "--max-slots", "2",
                      "--page-size", "4", "--ticks", "2", "--per-tick", "3"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_serve_clis_agree(mode, library, sens_profile, tmp_path, monkeypatch,
                          capsys):
    argv = SMALL + [a.replace("{lib}", str(library)).replace("{prof}", str(sens_profile))
                    for a in MODES[mode]]
    got = run_both(argv, tmp_path, monkeypatch, capsys)
    (ref_out, ref), (port_out, port) = got["ref"], got["port"]
    samples = [line for line in ref_out.splitlines() if line.startswith("sample:")]
    assert [line for line in port_out.splitlines()
            if line.startswith("sample:")] == samples
    assert plan_table(port_out) == plan_table(ref_out)
    assert sorted(port) == sorted(ref)
    assert timing_free(port) == timing_free(ref)
    assert port.get("trace_count", 1) == 1
    swaps = re.compile(r"plan swaps: (.*) — decode step traced (\d+)x")
    assert [m[0] for m in swaps.findall(port_out)] == \
        [m[0] for m in swaps.findall(ref_out)]
    assert all(m[1] == "1" for m in swaps.findall(port_out))
    if mode == "plain":
        assert samples
    if mode in ("plan", "w8", "adaptive"):
        assert port["approx_layers"] >= 1
    if mode == "w8":
        assert port["width_bits"] == 8 and "serving W8A8" in port_out
    if mode == "adaptive":
        assert port["swaps"] >= 1
        assert port["swaps_by_reason"] == ref["swaps_by_reason"]
    if mode == "continuous":
        assert port["mode"] == "continuous" and port["trace_count"] == 1
        assert port["requests_complete"] == port["requests_traced"] == port["requests"]
        # the health state and the classes' backoff follow the clock
        assert sorted(port["health"]) == sorted(ref["health"])
        assert sorted(port["classes"]) == sorted(ref["classes"])
        assert sorted(port["class_state"]) == sorted(ref["class_state"])
    if mode == "replicas":
        assert port["mode"] == "router"
        assert {n: r["routed"] for n, r in port["replicas"].items()} \
            == {n: r["routed"] for n, r in ref["replicas"].items()}
        assert all(r["trace_count"] == 1 for r in port["replicas"].values())
    if mode == "compare-fixed":
        assert timing_free(port["compare"]["fixed"]) == \
            timing_free(ref["compare"]["fixed"])
        assert port["compare"]["fixed"]["trace_count"] == 1
        assert sorted(port["compare"]) == sorted(ref["compare"])


# the reference's argument checks (serve.py:258-296, 383-388, 87-93), each
# with the flags that trip it; "{lib}" is a filled library, "{empty}" an
# empty one, "{prof}" a profile
CHECKS = {
    "adaptive-no-library": ["--adaptive"],
    "watch-no-library": ["--watch-library"],
    "class-no-library": ["--qos-class", "gold:0.1"],
    "class-no-profile": ["--library", "{lib}", "--qos-class", "gold:0.1"],
    "mix-no-class": ["--class-mix", "gold:1"],
    "mixed-no-library": ["--mixed-width"],
    "mixed-with-width": ["--library", "{lib}", "--mixed-width", "--width", "8"],
    "slots-not-continuous": ["--max-slots", "2"],
    "pages-not-continuous": ["--pages", "4"],
    "steps-not-continuous": ["--steps-per-tick", "2"],
    "compare-not-continuous": ["--compare-fixed"],
    "replicas-not-continuous": ["--replicas", "2"],
    "replicas-zero": ["--continuous", "--replicas", "0"],
    "compare-with-replicas": ["--continuous", "--compare-fixed", "--replicas", "2"],
    "bad-prompt-dist": ["--prompt-dist", "weird:1-2"],
    "inverted-prompt-dist": ["--prompt-dist", "uniform:9-2"],
    "profile-no-budget": ["--library", "{lib}", "--profile", "{prof}"],
    "empty-library": ["--library", "{empty}"],
}


@pytest.mark.parametrize("case", sorted(CHECKS))
def test_argument_checks_exit_with_the_same_message(case, library, sens_profile,
                                                    tmp_path, monkeypatch):
    (tmp_path / "empty").mkdir()
    argv = SMALL + [a.replace("{lib}", str(library)).replace("{prof}", str(sens_profile))
                    .replace("{empty}", str(tmp_path / "empty")) for a in CHECKS[case]]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as want:
        jserve.main()
    with pytest.raises(SystemExit) as got:
        pserve.main(argv + ["--device", "cpu"])
    want, got = want.value.code, got.value.code
    assert isinstance(want, str) and want
    # the port's messages name its own modules (an empty store's remedy
    # is the port's own fleet)
    assert got.replace("repro_torch.", "repro.") == want


def test_plan_and_sensitivity_reports_are_string_equal(library):
    jcomp, jarea, _ = jload(library)
    tcomp, tarea, _ = load_mul_frontier(library)
    for budget in (0.0, 5.0, 1e9):
        sens = np.array([1.0, 0.5, 2.0])
        want = janalysis.plan_report(jselect_plan(jcomp, sens, budget, exact_area=jarea))
        got = analysis.plan_report(select_plan(tcomp, sens, budget, exact_area=tarea))
        assert got == want
    doc = {"format_version": 1, "model": "m", "n_layers": 3,
           "sens": {"4": [0.2, 0.7, 0.1], "8": [0.01, 0.02, 0.005]},
           "probe_mae": {"4": 1.5, "8": 99.0},
           "costs": {"4": {"keys": ["a", "b"], "matrix": [[1, 2], [3, 4], [5, 6]]}},
           "meta": {}}
    want = janalysis.sensitivity_report(jprofile.SensitivityProfile.from_doc(doc))
    got = analysis.sensitivity_report(pprofile.SensitivityProfile.from_doc(doc))
    assert got == want and "over 2 operator(s)" in got
    assert analysis.model_flops_decode(10, 3) == janalysis.model_flops_decode(10, 3)
