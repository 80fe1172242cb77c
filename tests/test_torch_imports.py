"""PyTorch port: the package imports nothing of JAX or of the JAX package,
and its entry points default to the card."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(' '.join(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    mods = set(out.stdout.split())
    assert len(mods) >= 96  # every module of the port
    # the configs of every family
    assert {f"repro_torch.configs.{m}" for m in (
        "command_r_plus_104b", "internvl2_1b", "mixtral_8x7b",
        "deepseek_v2_lite_16b", "hymba_1_5b", "rwkv6_3b", "whisper_tiny")} <= mods
    # the encoder–decoder family and training
    assert {"repro_torch.models.encdec", "repro_torch.train",
            "repro_torch.train.data", "repro_torch.train.optim",
            "repro_torch.train.step", "repro_torch.train.checkpoint",
            "repro_torch.launch.train", "repro_torch.examples.train_small"} <= mods
    # sharding, the meshes and the dry-run
    assert {"repro_torch.parallel", "repro_torch.parallel.api",
            "repro_torch.parallel.specs", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.launch.analysis"} <= mods
    # the dry-run's hill-climb
    assert {"repro_torch.experiments", "repro_torch.experiments.hillclimb"} <= mods
    # the quickstart (the fleet mesh lives in repro_torch.launch.mesh)
    assert "repro_torch.examples.quickstart" in mods


def test_sharding_modules_load_no_test_internals():
    """The sharding layer, the meshes, the roofline half of the analysis,
    the dry-run and its hill-climb load neither jax, nor repro, nor, until a fake world is
    started, any module of ``torch.testing._internal`` past those that
    ``import torch`` loads itself."""
    code = (
        "import sys, torch\n"
        "def internal(): return {m for m in sys.modules if m.startswith('torch.testing._internal')}\n"
        "base = internal()\n"
        "import repro_torch.parallel, repro_torch.parallel.specs\n"
        "from repro_torch.launch import analysis, dryrun, mesh\n"
        "import repro_torch.experiments.hillclimb\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad and internal() == base, (bad, internal() - base)\n"
        "with mesh.fake_world(4):\n"
        "    assert 'torch.testing._internal.distributed.fake_pg' in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.stdout.strip() == "ok"


def test_port_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro[ .])")
    files = [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
             ROOT / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert not hits, hits


def test_default_device_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, init_paged_caches
    from repro_torch.serving import ContinuousServingEngine, ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-4b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(cfg, seed=0)
    params = init_model(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params, batch=1, prompt_len=2, gen_len=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousServingEngine(cfg, params, max_slots=2, prompt_len=2, gen_len=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_paged_caches(cfg, 2, 4, 4, 8)
    from repro_torch.models import forward_fn
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forward_fn(cfg)(cfg, params, {"tokens": [[1, 2]]})
    # the command-line entry points: no --device means the card
    from repro_torch.launch import serve
    from repro_torch.sensitivity import profile
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--batch", "1", "--prompt-len", "2", "--gen-len", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile.main(["--reduced", "--widths", "4", "--out", "unused.json"])


def test_search_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.core.arith import benchmark
    from repro_torch.core.engine import SearchJob, get_engine
    from repro_torch.core.tensor_search import tensor_search

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = SearchJob("adder", 2, et=2, engine="tensor")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_engine("tensor", population=16, generations=1, elites=4).run(job)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tensor_search(benchmark("adder_i4"), 2, population=16, generations=1, elites=4)
    out = get_engine("tensor", population=16, generations=1, elites=4, device="cpu").run(job)
    assert out.stats["generations"] == 1


def test_search_modules_load_without_jax():
    code = (
        "import sys\n"
        "from repro_torch.core import engine, tensor_search\n"
        "from repro_torch.library import compile, pareto, store\n"
        "from repro_torch.kernels import template_eval\n"
        "from repro_torch import convert\n"
        "out = engine.get_engine('tensor', population=64, generations=2,"
        " device='cpu').run(engine.SearchJob('mul', 2, 2, 'tensor'))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(out.stats['generations'])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.stdout.strip() == "2"


def test_continuous_modules_load_and_serve_without_jax():
    """The continuous tier's modules (paged decode, page allocator, slots,
    router, and the health, provenance and cost planes) load and serve a
    request stream on the CPU with neither jax nor repro in the process."""
    code = (
        "import sys, dataclasses\n"
        "from repro_torch.serving import kvcache, slots, router\n"
        "from repro_torch.obs import costs, provenance, requests, anomaly, flight, health\n"
        "from repro_torch.models import init_paged_caches, decode_paged_fn, init_model\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.serving import ContinuousServingEngine, Telemetry, make_profile\n"
        "cfg = dataclasses.replace(get_config('qwen3-4b', reduced=True), dtype='float32')\n"
        "eng = ContinuousServingEngine(cfg, init_model(cfg, seed=0, device='cpu'),"
        " max_slots=2, prompt_len=6, gen_len=4, page_size=4, device='cpu')\n"
        "hp = health.HealthPlane(None)\n"
        "eng.serve(make_profile('ramp', ticks=2, per_tick=3, prompt_len=6, gen_len=4,"
        " prompt_dist=('uniform', 2, 6)), telemetry=Telemetry(), health=hp)\n"
        "assert eng.trace_count == 1 and eng._alloc.used_pages == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(eng.completions))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.stdout.strip() == "5"   # ramp(2, 3): 2 + 3 arrivals


def test_library_filling_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The fleet and the search CLI run their tensor jobs on the card
    unless given ``--device cpu``."""
    from repro_torch.core import search
    from repro_torch.fleet import __main__ as fleet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.main(["--library", str(tmp_path), "--sweep", "smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search.main(["--benchmark", "mul_i4", "--et", "2", "--method", "tensor"])
    assert not list(tmp_path.iterdir())


def test_fleet_fills_a_library_without_jax(tmp_path):
    """``python -m repro_torch.fleet`` in a process with neither jax nor
    repro: the smoke sweep, its CPU jobs on a forked pool (CUDA is not
    initialised) and its tensor jobs in the process, on the CPU; a second
    run skips every job."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": ""}
    argv = [sys.executable, "-c",
            "import sys, runpy\n"
            "sys.argv = ['fleet'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('repro_torch.fleet', run_name='__main__')\n"
            "finally:\n"
            "    bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "    assert not bad, bad\n",
            "--library", str(tmp_path / "lib"), "--sweep", "smoke", "--device", "cpu",
            "--workers", "2"]
    out = subprocess.run(argv + ["--min-new", "1"], cwd=ROOT, env=env,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "fleet: 5 CPU job(s) on a fork pool of 2 worker(s)" in out.stdout
    assert "jobs: 9 ok, 0 resumed/skipped, 0 failed" in out.stdout
    again = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True)
    assert again.returncode == 0, again.stderr[-2000:]
    assert "jobs: 0 ok, 9 resumed/skipped, 0 failed; 0 operator(s) added" in again.stdout


def test_training_modules_load_and_train_without_jax(tmp_path):
    """The training stack (data, optimizer, step, checkpoints, the
    launcher) and the encoder–decoder family train, checkpoint and resume
    on the CPU with neither jax nor repro in the process."""
    code = (
        "import sys\n"
        "from repro_torch.launch import train\n"
        "from repro_torch.models import encdec\n"
        f"d = {str(tmp_path)!r}\n"
        "argv = ['--reduced', '--arch', 'whisper-tiny', '--device', 'cpu', '--batch', '2',"
        " '--seq', '8', '--log-every', '2', '--ckpt-dir', d]\n"
        "out = train.main(argv + ['--steps', '2'])\n"
        "again = train.main(argv + ['--steps', '3'])\n"
        "assert again['start'] == 2 and len(again['losses']) == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert "resumed from step 2" in out.stdout and out.stdout.strip().endswith("ok")
