"""PyTorch port: the encoder–decoder family (whisper-tiny) against the JAX
package, on the reference's weights converted with
``repro_torch.convert.params_from_jax`` and the same numpy inputs.

Tolerances.  In f32 ``encode``, ``forward_encdec``, ``encdec_loss`` and
every decode step agree within 1e-5.  In bf16 the reference is compiled
with XLA's excess precision off, as ``tests/test_torch_models.py`` does;
its GELU, norms and the loss agree, but XLA and torch sum some bf16
matmuls and softmax rows in another order, so a few bf16 roundings land
one ulp apart, and the logits (bf16 values, about 3.5 at most here) and
the encoder's output differ by up to two bf16 ulps at the tensor's largest
magnitude (0.03125 for values in [2, 4)): each tensor is held within that,
and the loss within 2e-2.  The tanh GELU is bit-equal to ``jax.nn.gelu`` in bf16; in f32 it
is not, since XLA's CPU ``tanh`` is a rational
approximation that differs from ``torch.tanh`` by an ulp in about half of
its values; the bound is two float32 ulps of 1 times ``max(1, |x|)``
(``1 + tanh`` cancels for negative x, so no relative bound holds).

The reference's decode does not reproduce its own teacher-forced forward:
``decode_step_encdec`` rotates q and k by RoPE, the forward's
self-attention does not.  So the port's decode is held against the
reference's ``decode_step_encdec`` (never its own forward), and the two
agree with the forward at position 0 only, as shown here.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JAX_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import encdec as je  # noqa: E402
from repro.models import init_model as jax_init  # noqa: E402
from repro.models import init_paged_caches as jax_paged  # noqa: E402
from repro.obs import costs as jax_costs  # noqa: E402
from repro.serving import ContinuousServingEngine as JaxContinuous  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.loadgen import steady as jax_steady  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import encdec, init_model, init_paged_caches  # noqa: E402
from repro_torch.models import decode_paged_fn, layers  # noqa: E402
from repro_torch.obs import costs as port_costs  # noqa: E402
from repro_torch.serving import ContinuousServingEngine, ServingEngine  # noqa: E402
from repro_torch.serving.loadgen import steady  # noqa: E402
from test_torch_cli import reset_globals, run_both  # noqa: E402
from test_torch_families import _fields  # noqa: E402
from test_torch_models import _jit  # noqa: E402

B, S = 2, 8
ARCH = "whisper-tiny"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(dtype, seed=0):
    cj = dataclasses.replace(jax_config(ARCH, reduced=True), dtype=dtype)
    ct = dataclasses.replace(get_config(ARCH, reduced=True), dtype=dtype)
    params = jax_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cj.vocab_size, (B, S)).astype(np.int32),
             "frames": rng.standard_normal(
                 (B, cj.encoder.n_frames, cj.d_model)).astype(np.float32)}
    return cj, ct, params, pt, batch


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, dtype):
    """f32: within 1e-5; bf16: within two bf16 ulps at the magnitude of
    the reference tensor's largest value."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    if dtype == "float32":
        bound = 1e-5
    else:
        bound = 2 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got - want)
    assert err.max() <= bound, (float(err.max()), bound)


def test_registry_holds_the_reference_ten():
    assert sorted(ARCH_IDS) == sorted(JAX_IDS) and len(ARCH_IDS) == 10
    for reduced in (False, True):
        got, want = get_config(ARCH, reduced=reduced), jax_config(ARCH, reduced=reduced)
        assert _fields(got) == _fields(want)
        assert got.n_params() == want.n_params()
    assert round(get_config(ARCH).n_params() / 1e6, 1) == 58.7


@pytest.mark.parametrize("shape", [(8, 64), (64, 64), (448, 384), (1500, 384)])
def test_sinusoid_bit_equal(shape):
    assert np.array_equal(encdec.sinusoid(*shape).numpy(), np.asarray(je.sinusoid(*shape)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax_nn_gelu(dtype):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(50_000) * 3,
                        np.linspace(-12, 12, 20_001)]).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    want = f32(jax.nn.gelu(xj))
    got = f32(layers.gelu(torch.from_numpy(f32(xj).copy()).to(getattr(torch, dtype))))
    if dtype == "bfloat16":
        assert np.array_equal(got, want)
    else:
        # tanh an ulp or so apart near +-1, scaled by x / 2 (and not
        # relative: 1 + tanh cancels for negative x)
        bound = 2 * np.spacing(np.float32(1)) * np.maximum(1.0, np.abs(x))
        assert (np.abs(got - want) <= bound).all()


def test_gelu_ffn_has_two_matrices():
    cj, ct, params, pt, _ = setup("float32")
    ffn = pt["dec_layers"][1]["ffn"]
    assert set(ffn) == {"w1", "w2"}
    x = np.random.default_rng(1).standard_normal((B, S, ct.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[1], params["dec_layers"])
    from repro.models import layers as jl
    assert_close(layers.ffn(ct, ffn, torch.from_numpy(x)),
                 jax.jit(lambda v: jl.ffn(cj, lp["ffn"], v))(x), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_forward_and_loss_match(dtype):
    cj, ct, params, pt, batch = setup(dtype)
    enc = _jit(lambda f: je.encode(cj, params, f), dtype)(batch["frames"])
    assert_close(encdec.encode(ct, pt, torch.from_numpy(batch["frames"])), enc, dtype)
    want = _jit(lambda b: je.forward_encdec(cj, params, b)[0], dtype)(batch)
    got, aux = encdec.forward_encdec(ct, pt, batch, device="cpu")
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert_close(got, want, dtype)
    lw = float(_jit(lambda b: je.encdec_loss(cj, params, b), dtype)(batch))
    lt = float(encdec.encdec_loss(ct, pt, batch, device="cpu"))
    assert abs(lt - lw) <= (1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_the_reference_decode(dtype):
    """``prefill_cross`` and 8 steps of ``decode_step_encdec`` against the
    reference's; caches written in place, the position a tensor."""
    cj, ct, params, pt, batch = setup(dtype)
    caches = je.prefill_cross(cj, params, jnp.asarray(batch["frames"]),
                              je.init_encdec_caches(cj, B, S))
    tc = encdec.init_encdec_caches(ct, B, S, device="cpu")
    assert encdec.prefill_cross(ct, pt, batch["frames"], tc) is tc
    for layer in range(ct.n_layers):
        assert_close(tc[layer]["xk"], caches[layer]["xk"], dtype)
    step = _jit(lambda c, t, p: je.decode_step_encdec(cj, params, c, t, p), dtype)
    addr = tc[0]["k"].data_ptr()
    for t in range(S):
        tok = batch["tokens"][:, t:t + 1]
        want, caches = step(caches, tok, jnp.int32(t))
        got, tc2 = encdec.decode_step_encdec(ct, pt, tc, torch.from_numpy(tok),
                                             torch.tensor([t]))
        assert tc2 is tc and tc[0]["k"].data_ptr() == addr
        assert_close(got, want, dtype)
    assert_close(tc[1]["k"], caches[1]["k"], dtype)


def test_decode_reproduces_the_forward_at_position_0_only():
    """The reference-side behaviour: decode's self-attention rotates q and
    k by RoPE, the forward's does not.  Both packages agree with their
    forwards at position 0 (where RoPE is the identity) and not after."""
    cj, ct, params, pt, batch = setup("float32")
    fwd = f32(encdec.forward_encdec(ct, pt, batch, device="cpu")[0])
    tc = encdec.prefill_cross(ct, pt, batch["frames"],
                              encdec.init_encdec_caches(ct, B, S, device="cpu"))
    dec = np.stack([f32(encdec.decode_step_encdec(
        ct, pt, tc, torch.from_numpy(batch["tokens"][:, t:t + 1]), t)[0])
        for t in range(S)], axis=1)
    assert np.abs(dec[:, 0] - fwd[:, 0]).max() < 1e-5
    assert np.abs(dec[:, 1:] - fwd[:, 1:]).max() > 1e-2
    jfwd = np.asarray(je.forward_encdec(cj, params, batch)[0])
    assert np.abs(jfwd[:, 1:] - dec[:, 1:]).max() > 1e-2


def test_decode_refuses_a_lut_stack():
    _, ct, _, pt, batch = setup("float32")
    tc = encdec.init_encdec_caches(ct, B, S, device="cpu")
    ex = torch.from_numpy((np.arange(16)[:, None] * np.arange(16)[None, :]).astype(np.int32))
    with pytest.raises(ValueError, match="routes no matmul through a LUT"):
        encdec.decode_step_encdec(ct, pt, tc, torch.zeros((B, 1), dtype=torch.int32), 0,
                                  luts=ex[None].expand(ct.n_layers, 16, 16))


def test_init_encdec_builds_the_reference_tree():
    cj, ct, params, want, _ = setup("bfloat16")
    got = init_model(ct, seed=0, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(got) == shapes(want)
    assert len(got["enc_layers"]) == ct.encoder.n_layers
    # the split of the stacked layers is bit for bit
    assert np.array_equal(f32(want["dec_layers"][1]["cross"]["wk"]),
                          f32(params["dec_layers"]["cross"]["wk"][1]))
    assert np.array_equal(f32(want["enc_layers"][0]["ffn"]["w2"]),
                          f32(params["enc_layers"]["ffn"]["w2"][0]))


def test_fixed_serve_matches_the_reference_engine():
    """Reduced whisper served by both fixed-batch engines with the
    cross-K/V warm-up: the same tokens a batch, the port's step captured
    (built, on the CPU) once while the warm-up restages every batch."""
    cj, ct, params, pt, batch = setup("float32")
    frames = batch["frames"]
    je_ = JaxEngine(cj, params, batch=2, prompt_len=4, gen_len=6,
                    warmup_caches=lambda c: je.prefill_cross(
                        cj, params, jnp.asarray(frames), c))
    pe = ServingEngine(ct, pt, batch=2, prompt_len=4, gen_len=6, device="cpu",
                       warmup_caches=lambda c: encdec.prefill_cross(ct, pt, frames, c))
    tj = je_.serve(jax_steady(2, 3, prompt_len=4, gen_len=6), seed=1)
    tp = pe.serve(steady(2, 3, prompt_len=4, gen_len=6), seed=1)
    assert tj.n_batches == tp.n_batches == 4
    assert np.array_equal(pe.last_tokens, je_.last_tokens)
    assert pe.trace_count == 1
    xk = pe.static_step.caches[0]["xk"]
    assert float(xk.abs().max()) > 0
    # a warm-up that hands back other buffers would leave the step's unread
    bad = ServingEngine(ct, pt, batch=2, prompt_len=4, gen_len=6, device="cpu",
                        warmup_caches=lambda c: [dict(x) for x in c])
    with pytest.raises(ValueError, match="in place"):
        bad.serve(steady(1, 1, prompt_len=4, gen_len=6), seed=1)


def test_continuous_and_paged_refuse_audio():
    cj, ct, params, pt, _ = setup("float32")
    with pytest.raises(AssertionError) as want:
        JaxContinuous(cj, params, max_slots=2, prompt_len=4, gen_len=4,
                      warmup_caches=lambda c: c)
    with pytest.raises(ValueError) as got:
        ContinuousServingEngine(ct, pt, max_slots=2, prompt_len=4, gen_len=4,
                                warmup_caches=lambda c: c, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_paged(cj, 2, 4, 4, 8)
    with pytest.raises(ValueError) as got:
        init_paged_caches(ct, 2, 4, 4, 8, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="LM families only"):
        decode_paged_fn(ct)


SMALL = ["--reduced", "--arch", ARCH, "--batch", "2", "--prompt-len", "4",
         "--gen-len", "8"]


def test_launcher_serves_whisper_as_the_reference(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --reduced --arch whisper-tiny``
    against the reference's launcher in f32 on the same weights: the same
    sample tokens and request counts, one capture."""
    out = run_both(SMALL, tmp_path, monkeypatch, capsys)
    (ref_out, ref), (port_out, port) = out["ref"], out["port"]
    sample = [line for line in port_out.splitlines() if line.startswith("sample:")]
    assert sample and sample == [line for line in ref_out.splitlines()
                                 if line.startswith("sample:")]
    assert port["requests"] == ref["requests"] and port["batches"] == ref["batches"]
    assert port["trace_count"] == 1


@pytest.mark.parametrize("flag", [["--library", "{side}"], ["--continuous"]],
                         ids=["library", "continuous"])
def test_launcher_refusals_match_the_reference(flag, tmp_path, monkeypatch):
    import sys

    from repro.launch import serve as jserve
    from repro_torch.launch import serve as pserve

    msgs = {}
    for side, main in (("ref", jserve.main), ("port", pserve.main)):
        args = SMALL + [a.format(side=tmp_path / side) for a in flag]
        with pytest.raises(SystemExit) as e:
            if side == "port":
                main(args + ["--device", "cpu"])
            else:
                monkeypatch.setattr(sys, "argv", ["serve"] + args)
                main()
        msgs[side] = str(e.value)
        reset_globals()
    assert msgs["port"] == msgs["ref"] and "LM families only" in msgs["port"]


def test_mlp_macs_price_the_gelu_ffn():
    for reduced in (False, True):
        cj, ct = jax_config(ARCH, reduced=reduced), get_config(ARCH, reduced=reduced)
        got = port_costs.mlp_macs_per_layer(ct)
        assert got == jax_costs.mlp_macs_per_layer(cj)
        assert got == [2 * ct.d_model * ct.d_ff] * ct.n_layers
