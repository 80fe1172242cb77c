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
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert int(out.stdout.strip()) >= 50  # every module of slices 1 to 7


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
    from repro_torch.models import init_model
    from repro_torch.serving import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-4b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(cfg, seed=0)
    params = init_model(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params, batch=1, prompt_len=2, gen_len=2)
    from repro_torch.models import forward_fn
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forward_fn(cfg)(cfg, params, {"tokens": [[1, 2]]})


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
