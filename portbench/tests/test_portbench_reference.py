"""The plain reference against the program's plain route (its decode
step with ``backend="ref"``) on the reduced twins, in float32."""

from __future__ import annotations

import ast

import numpy as np
import pytest
import torch

from conftest import SMALL_CONFIGS
from portbench import loader, program
from portbench.reference import model as ref
from portbench.weights import Weights


def _small(name: str, dtype: str = "float32") -> dict:
    cfg = loader.config(name) | SMALL_CONFIGS[name]
    return cfg | {"arch_reduced": True, "serve_dtype": dtype}


def _program_logits(cfg, params, tokens, table):
    from repro_torch.models import lm

    mc = program.model_config(cfg, table)
    B, S = tokens.shape
    caches = lm.init_decode_caches(mc, B, S, device="cpu")
    luts = None if table is None else torch.as_tensor(program.stack(mc, table))
    out = []
    for t in range(S):
        z, caches = lm.decode_step(mc, params, caches, tokens[:, t:t + 1], t,
                                   luts=luts, backend="ref")
        out.append(z)
    return torch.stack(out, dim=1)


def _exact4():
    """The exact 2-bit block composed to a W4A4 table."""
    block = np.arange(4)[:, None] * np.arange(4)[None, :]
    return loader.Table(loader.compose(block, 2, 4).astype(np.int32), block, 2, 4)


@pytest.mark.parametrize("name", sorted(SMALL_CONFIGS))
@pytest.mark.parametrize("tab", ["mul_i8_exact", "exact4", None])
def test_reference_matches_the_programs_plain_decode(name, tab):
    cfg = _small(name)
    w = Weights(cfg, "cpu")
    w.fill(20240501)
    # the configuration's W8A8 table, a W4A4 one, and none
    table = {"mul_i8_exact": loader.table, "exact4": lambda _: _exact4(),
             None: lambda _: None}[tab](tab)
    cfg = dict(cfg, table=tab)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 512, (3, 12)))
    want = ref.forward(cfg, w.params, tokens, table)
    got = _program_logits(cfg, w.params, tokens, table)
    # float32 on both sides; the reference sums in another order, so a
    # 4-bit code that sits on a rounding edge may flip: held to 1e-4 of
    # the logits' scale
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale


def test_the_float8_control_departs_from_the_reference():
    cfg = _small("stablelm-1.6b-w8")
    w = Weights(cfg, "cpu")
    w.fill(7)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, 512, (2, 10)))
    table = loader.table(cfg["table"])
    exact = ref.forward(cfg, w.params, tokens, table)
    low = ref.forward(cfg, w.params, tokens, table, precision="fp8")
    assert (low - exact).abs().max().item() > 1e-2 * exact.abs().max().item()


def test_the_reference_imports_nothing_of_the_program():
    tree = ast.parse((loader.ROOT / "portbench/reference/model.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert {n.split(".")[0] for n in names} <= {"__future__", "math", "torch"}
