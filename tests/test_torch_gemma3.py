"""PyTorch port: gemma3-1b, the reference's default model, against the JAX
package on the same weights (converted with
``repro_torch.convert.params_from_jax``).

Reduced gemma3-1b has a 16-token local layer and a global one, qk-norm
and tied embeddings.  Its forward and decode run at S = 24, past the
window, so the window bites; in f32 within 2e-5, in bf16 (XLA's excess
precision off) within ``tests/test_torch_models.py``'s 8e-2.  The port's ``forward_lm`` hands each layer its window as a Python ``int``
(local) or ``None`` (global), so on the card the local layers reach the
flash kernel; the plain flash masks as the reference's masked path does.
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
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

ARCH = "gemma3-1b"
B, S = 2, 24
TOL = {"float32": 2e-5, "bfloat16": 8e-2}


def _jit(fn, dtype):
    """``jax.jit(fn)``; in bf16 compiled with excess precision off."""
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


def _setup(dtype, lut_kind):
    cj = dataclasses.replace(jax_config(ARCH, reduced=True), dtype=dtype)
    ct = dataclasses.replace(get_config(ARCH, reduced=True), dtype=dtype)
    lut = None
    if lut_kind == "w4":
        ex = np.arange(16)[:, None] * np.arange(16)[None, :]
        lut = np.stack([ex & ~3, ex]).astype(np.int32)
        cj, ct = cj.with_approx_mlp(4), ct.with_approx_mlp(4)
    params = jax_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cj.vocab_size, (B, S)).astype(np.int32)
    return cj, ct, params, pt, tokens, lut


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_config_equals_reference(reduced):
    assert ARCH in ARCH_IDS
    want = jax_config(ARCH, reduced=reduced)
    got = get_config(ARCH, reduced=reduced)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.n_params() == want.n_params()
    sched = lm.window_schedule(got)
    assert np.array_equal(sched, np.asarray(jlm.window_schedule(want)))
    if not reduced:
        assert [lm.layer_window(sched, i) for i in range(26)].count(512) == 22


@pytest.mark.parametrize("lut_kind", [None, "w4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_decode_match_jax(dtype, lut_kind):
    cj, ct, params, pt, tokens, lut = _setup(dtype, lut_kind)
    jlut = None if lut is None else jnp.asarray(lut)
    jfwd = _jit(lambda t: jlm.forward_lm(cj, params, {"tokens": t}, lut=jlut)[0], dtype)
    jstep = _jit(lambda c, tok, pos: jlm.decode_step(cj, params, c, tok, pos,
                                                     luts=jlut), dtype)
    want = np.asarray(jfwd(jnp.asarray(tokens)))
    got, _ = lm.forward_lm(ct, pt, {"tokens": tokens}, lut=lut, device="cpu")
    assert got.shape == (B, S, ct.vocab_size)
    assert np.abs(got.numpy() - want).max() < TOL[dtype]

    jcaches = jlm.init_decode_caches(cj, B, S)
    caches = lm.init_decode_caches(ct, B, S, device="cpu")
    assert [c["k"].shape[1] for c in caches] == [16, S]   # local ring, global
    tlut = None if lut is None else torch.from_numpy(lut)
    for t in range(S):
        tok = tokens[:, t:t + 1]
        dj, jcaches = jstep(jcaches, jnp.asarray(tok), jnp.int32(t))
        dt_, caches = lm.decode_step(ct, pt, caches, torch.from_numpy(tok), t,
                                     luts=tlut)
        assert np.abs(dt_.numpy() - np.asarray(dj)).max() < TOL[dtype]
        assert np.abs(dt_.numpy() - got[:, t].numpy()).max() < TOL[dtype]


def test_forward_hands_attention_full_int_windows(monkeypatch):
    """Local layers get their window as an ``int``, global ones ``None``:
    the arguments on which ``attention_full`` takes the flash kernel."""
    _, ct, _, pt, tokens, _ = _setup("float32", None)
    seen = []
    real = L.attention_full

    def spy(cfg, p, x, window, **kw):
        seen.append(window)
        return real(cfg, p, x, window, **kw)

    monkeypatch.setattr(L, "attention_full", spy)
    lm.forward_lm(ct, pt, {"tokens": tokens}, device="cpu")
    assert seen == [16, None] and type(seen[0]) is int
    full = get_config(ARCH)
    win = lm.window_schedule(full)
    got = [lm.layer_window(win, i) for i in range(full.n_layers)]
    assert got == [None if (i + 1) % 6 == 0 else 512 for i in range(26)]
    assert all(type(w) is int for w in got if w is not None)


@pytest.mark.parametrize("window", [16, 5, None])
def test_plain_flash_equals_the_masked_path(window):
    """``ref.flash_attention`` with a layer's window equals
    ``_masked_softmax_attn`` at reduced gemma3-1b's shapes (GQA 2:1, head
    dim 32, S past the window), within 2e-5 in f32."""
    ct = get_config(ARCH, reduced=True)
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((B, S, ct.n_heads, ct.hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, ct.n_kv_heads, ct.hd))
                             .astype(np.float32)) for _ in range(2))
    pos = torch.arange(S)
    want = L._masked_softmax_attn(q, k, v, pos, pos, window)
    got = ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=True, window=window).transpose(1, 2)
    assert float((got - want).abs().max()) < 2e-5
