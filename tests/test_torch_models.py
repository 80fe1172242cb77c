"""PyTorch port: reduced qwen3-4b and stablelm-1.6b against the JAX
reference on the same weights (converted with
``repro_torch.convert.params_from_jax``).

Forward logits and a decode sequence are compared for ``lut=None``, the
exact (L,16,16) stack, a truncated stack and a composed W8A8 stack,
against the jitted reference: in f32 at 1e-4, in bf16 at 8e-2 (the bound
of tests/test_models.py::test_decode_matches_forward).  In bf16 the
reference is compiled with ``xla_allow_excess_precision`` off: by default
XLA keeps fused bf16 intermediates in f32, which flips W4 codes
downstream, while the port rounds every op to bf16.  The port's decode
must match the port's forward at the same bounds.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import init_model as jax_init  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.precision.compose import tile_to_width  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import lm  # noqa: E402

B, S = 2, 6
TOL = {"float32": 1e-4, "bfloat16": 8e-2}


def _stack(kind):
    ex = np.arange(16)[:, None] * np.arange(16)[None, :]
    layers = {"exact": [ex, ex], "trunc": [ex, ex & ~3],
              "w8": [tile_to_width(ex), tile_to_width(ex & ~3)]}[kind]
    return np.stack(layers).astype(np.int32)


def _setup(dtype, kind, arch="qwen3-4b"):
    cj = dataclasses.replace(jax_config(arch, reduced=True), dtype=dtype)
    ct = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    lut = None
    if kind is not None:
        bits = 8 if kind == "w8" else 4
        cj, ct, lut = cj.with_approx_mlp(bits), ct.with_approx_mlp(bits), _stack(kind)
    params = jax_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cj.vocab_size, (B, S)).astype(np.int32)
    return cj, ct, params, pt, tokens, lut


def _jit(fn, dtype):
    """``jax.jit(fn)``; in bf16 compiled with XLA's excess precision off,
    so every op rounds to bf16 as the port's do (see the module doc)."""
    jitted = jax.jit(fn)
    if dtype == "float32":
        return jitted
    compiled = []

    def run(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False}))
        return compiled[0](*args)
    return run


def _jax_fns(cj, params, jlut, dtype):
    """The reference's forward and decode step, jitted once each."""
    def fwd(tokens):
        return jlm.forward_lm(cj, params, {"tokens": tokens}, lut=jlut)[0]

    def step(caches, tok, pos):
        return jlm.decode_step(cj, params, caches, tok, pos, luts=jlut)

    return _jit(fwd, dtype), _jit(step, dtype)


# qwen3-4b (GQA, qk-norm) keeps its case ids; stablelm-1.6b (MHA, no
# qk-norm) is the system test's first model
CASES = [pytest.param(dtype, kind, arch, id="-".join(
             ([] if arch == "qwen3-4b" else [arch]) + [dtype, str(kind)]))
         for arch in ("qwen3-4b", "stablelm-1.6b")
         for dtype in ("float32", "bfloat16")
         for kind in (None, "exact", "trunc", "w8")]


@pytest.mark.parametrize("dtype,kind,arch", CASES)
def test_forward_and_decode_match_jax(dtype, kind, arch):
    cj, ct, params, pt, tokens, lut = _setup(dtype, kind, arch)
    jlut = None if lut is None else jnp.asarray(lut)
    jfwd, jstep = _jax_fns(cj, params, jlut, dtype)

    want = np.asarray(jfwd(jnp.asarray(tokens)))
    got, aux = lm.forward_lm(ct, pt, {"tokens": tokens}, lut=lut, device="cpu")
    assert got.shape == (B, S, ct.vocab_size) and got.dtype == torch.float32
    assert float(aux) == 0.0
    assert np.abs(got.numpy() - want).max() < TOL[dtype]

    jcaches = jlm.init_decode_caches(cj, B, S)
    caches = lm.init_decode_caches(ct, B, S, device="cpu")
    tlut = None if lut is None else torch.from_numpy(lut)
    for t in range(S):
        tok = tokens[:, t:t + 1]
        dj, jcaches = jstep(jcaches, jnp.asarray(tok), jnp.int32(t))
        dt_, caches = lm.decode_step(ct, pt, caches, torch.from_numpy(tok), t,
                                     luts=tlut)
        assert np.abs(dt_.numpy() - np.asarray(dj)).max() < TOL[dtype]
        # the port's decode reproduces the port's teacher-forced forward
        assert np.abs(dt_.numpy() - got[:, t].numpy()).max() < TOL[dtype]


def test_shared_table_equals_per_layer_stack():
    """One (side, side) table is shared by every layer, as in the reference."""
    _, ct, _, pt, tokens, lut = _setup("float32", "exact")
    shared, _ = lm.forward_lm(ct, pt, {"tokens": tokens}, lut=lut[0], device="cpu")
    stacked, _ = lm.forward_lm(ct, pt, {"tokens": tokens}, lut=lut, device="cpu")
    assert torch.equal(shared, stacked)


def test_mixed_width_decode_routes_each_layer():
    """A {bits: stack} dict with a width map: layer 0 on W8A8, layer 1 on
    W4A4, matching the reference's mixed-width decode."""
    cj, ct, params, pt, tokens, _ = _setup("float32", "exact")
    ex = np.arange(16)[:, None] * np.arange(16)[None, :]
    luts = {8: tile_to_width(ex & ~3)[None].astype(np.int32),
            4: (ex & ~3)[None].astype(np.int32)}
    wm = (8, 4)
    jc = jlm.init_decode_caches(cj, B, S)
    caches = lm.init_decode_caches(ct, B, S, device="cpu")
    step = jax.jit(lambda c, tok, pos, l: jlm.decode_step(
        cj, params, c, tok, pos, luts=l, width_map=wm))
    for t in range(3):
        tok = tokens[:, t:t + 1]
        dj, jc = step(jc, jnp.asarray(tok), jnp.int32(t),
                      {b: jnp.asarray(a) for b, a in luts.items()})
        dt_, caches = lm.decode_step(ct, pt, caches, torch.from_numpy(tok), t,
                                     luts={b: torch.from_numpy(a) for b, a in luts.items()},
                                     width_map=wm)
        assert np.abs(dt_.numpy() - np.asarray(dj)).max() < TOL["float32"]
    with pytest.raises(ValueError, match="width_map"):
        lm.decode_step(ct, pt, caches, torch.from_numpy(tokens[:, :1]), 0,
                       luts={b: torch.from_numpy(a) for b, a in luts.items()})


def test_params_from_jax_keeps_dtypes_and_splits_layers():
    cj, ct, params, pt, _, _ = _setup("bfloat16", None)
    assert len(pt["layers"]) == ct.n_layers
    w1 = pt["layers"][1]["ffn"]["w1"]
    assert w1.dtype == torch.bfloat16
    want = np.asarray(params["layers"]["ffn"]["w1"][1].astype(jnp.float32))
    assert np.array_equal(w1.float().numpy(), want)


def test_unported_architectures_raise():
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("gemma3-1b", reduced=True)
    with pytest.raises(KeyError):
        get_config("no-such-arch")
