"""PyTorch port: ``sensitivity/profile`` against ``repro.sensitivity.profile``.

On reduced qwen3-4b in f32 with the reference's weights converted, the
same tokens go through both profilers: the probe tables are bit-equal,
measured drifts (sensitivity x probe mae, and every cost-matrix entry)
agree within 4e-5 absolute -- twice the 2e-5 logit tolerance of
tests/test_torch_system.py -- the operator keys are equal, ``costs_for``
prices equal profiles equally, a profile written by either side loads on
the other, and both CLIs write equal documents.  On the card the 8-bit
probe, which is not composed from a tile, runs the direct lookup kernel
on its layer and the W8A8 kernel on the others; here the kernel route's
choice is held by spies on the kernel wrappers, which launch nothing.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import init_model as jax_init  # noqa: E402
from repro.precision import plans as jplans  # noqa: E402
from repro.sensitivity import profile as jprofile  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.precision import plans  # noqa: E402
from repro_torch.sensitivity import profile  # noqa: E402
from test_sensitivity import mixed_library  # noqa: E402,F401  (fixture)

DRIFT_TOL = 4e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' tensors are tiny: intra-op threads only add
    overhead here and crowd the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(get, arch="qwen3-4b", reduced=True):
    return dataclasses.replace(get(arch, reduced=reduced), dtype="float32")


@pytest.fixture(scope="module")
def model():
    cj = _f32(jax_config).with_approx_mlp()
    ct = _f32(get_config).with_approx_mlp()
    params = jax_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tokens = np.random.default_rng(3).integers(0, cj.vocab_size, (2, 8))
    return cj, params, ct, pt, tokens


def same_profiles(got, want):
    """Equal but for float roundoff: the drifts within DRIFT_TOL."""
    assert (got.model, got.n_layers, got.meta) == (want.model, want.n_layers,
                                                    want.meta)
    assert got.widths == want.widths and got.probe_mae == want.probe_mae
    for b in want.widths:
        np.testing.assert_allclose(got.sens[b] * got.probe_mae[b],
                                   want.sens[b] * want.probe_mae[b],
                                   rtol=0, atol=DRIFT_TOL)
        assert (got.sens[b] > 0).all()
    assert sorted(got.costs) == sorted(want.costs)
    for b, (keys, m) in want.costs.items():
        assert got.costs[b][0] == keys
        np.testing.assert_allclose(got.costs[b][1], m, rtol=0, atol=DRIFT_TOL)


@pytest.mark.parametrize("bits", [4, 8])
def test_probe_tables_bit_equal(bits):
    for drop in (None, 1, bits + 2):
        got, want = profile.truncation_probe(bits, drop), \
            jprofile.truncation_probe(bits, drop)
        assert got.lut.dtype == want.lut.dtype == np.int32
        assert np.array_equal(got.lut, want.lut)
        assert (got.mae, got.mae16, got.bits, got.drop) == \
            (want.mae, want.mae16, want.bits, want.drop)


@pytest.mark.parametrize("widths", [(4,), (8,)])
@pytest.mark.parametrize("with_library", [False, True])
def test_measure_profile_matches_reference(model, mixed_library, widths,
                                           with_library):
    cj, params, ct, pt, tokens = model
    lib = mixed_library if with_library else None
    want = jprofile.measure_profile(cj, params, {"tokens": jnp.asarray(tokens)},
                                    widths=widths, library=lib, meta={"k": 1})
    got = profile.measure_profile(ct, pt, {"tokens": tokens}, widths=widths,
                                  library=lib, meta={"k": 1}, device="cpu")
    same_profiles(got, want)
    if with_library:
        assert got.costs[widths[0]][1].shape == (ct.n_layers,
                                                 len(got.costs[widths[0]][0]))


@pytest.mark.parametrize("bits", [4, 8])
def test_measure_cost_matrix_matches_reference(model, mixed_library, bits):
    cj, params, ct, pt, tokens = model
    jcomp = jplans.load_frontier(mixed_library, bits)[0]
    tcomp = plans.load_frontier(mixed_library, bits)[0]
    assert [r.key for r, _ in tcomp] == [r.key for r, _ in jcomp]
    want = jprofile.measure_cost_matrix(cj, params, {"tokens": jnp.asarray(tokens)},
                                        jcomp)
    got = profile.measure_cost_matrix(ct, pt, {"tokens": tokens}, tcomp,
                                      device="cpu")
    assert got.shape == want.shape == (ct.n_layers, len(tcomp))
    np.testing.assert_allclose(got, want, rtol=0, atol=DRIFT_TOL)


def test_costs_for_equal_given_equal_profiles(mixed_library):
    n = 2
    doc = {"format_version": 1, "model": "m", "n_layers": n,
           "sens": {"4": [2.0, 0.5], "8": [1.0, 3.0]},
           "probe_mae": {"4": 1.5, "8": 100.0}, "costs": {}, "meta": {}}
    for bits in (4, 8):
        jcomp = jplans.load_frontier(mixed_library, bits)[0]
        tcomp = plans.load_frontier(mixed_library, bits)[0]
        # the first operator measured, the rest priced by the linear model
        doc["costs"][str(bits)] = {"keys": [jcomp[0][0].key, "gone"],
                                   "matrix": [[0.25, 9.0], [0.5, 9.0]]}
        want_p = jprofile.SensitivityProfile.from_doc(doc)
        got_p = profile.SensitivityProfile.from_doc(doc)
        for pw, pg in ((None, None), (want_p, got_p)):
            want = jprofile.costs_for(pw, bits, jcomp, n)
            got = profile.costs_for(pg, bits, tcomp, n)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert got[:, 0].tolist() == [0.25, 0.5]
    with pytest.raises(KeyError, match="not measured at width 2"):
        got_p.sensitivities(2)
    with pytest.raises(ValueError, match="profile measured 2 layers"):
        profile.costs_for(got_p, 4, tcomp, 3)


def test_profile_files_load_on_both_sides(tmp_path):
    prof = profile.SensitivityProfile(
        model="m", n_layers=2, sens={4: np.array([2.0, 0.5]), 8: np.array([1.0, 1.0])},
        probe_mae={4: 1.5, 8: 100.0},
        costs={4: (["k0", "k1"], np.array([[0.1, 0.2], [0.3, 0.4]]))},
        meta={"arch": "qwen3-4b"})
    p = prof.save(tmp_path / "a" / "p.json")
    assert p == tmp_path / "a" / "p.json"
    assert jprofile.load_profile(p).to_doc() == prof.to_doc()
    q = jprofile.load_profile(p).save(tmp_path / "q.json")
    assert profile.load_profile(q).to_doc() == prof.to_doc()
    assert json.loads(q.read_text()) == json.loads(p.read_text())
    assert profile.default_profile_path("lib", "m") == \
        jprofile.default_profile_path("lib", "m")


def test_both_clis_write_equal_documents(model, mixed_library, tmp_path,
                                         monkeypatch, capsys):
    cj, params, ct, pt, _ = model
    from repro import configs as jconfigs
    from repro import models as jmodels

    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, ct.vocab_size, (2, 8), generator=gen)
    monkeypatch.setattr(jconfigs, "get_config",
                        lambda arch, reduced=False: _f32(jax_config, arch, reduced))
    monkeypatch.setattr(jmodels, "init_model", lambda cfg, key: params)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(tokens.numpy()))
    monkeypatch.setattr(profile, "get_config",
                        lambda arch, reduced=False: _f32(get_config, arch, reduced))
    monkeypatch.setattr(profile, "init_model", lambda cfg, seed, device: pt)
    monkeypatch.setattr(torch, "randint", lambda *a, **kw: tokens)
    argv = ["--arch", "qwen3-4b", "--reduced", "--widths", "4,8",
            "--library", str(mixed_library),
            "--batch", "2", "--seq", "8", "--seed", "5"]
    jprofile.main(argv + ["--out", str(tmp_path / "ref.json")])
    ref_out = capsys.readouterr().out
    profile.main(argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    want = jprofile.load_profile(tmp_path / "ref.json")
    got = profile.load_profile(tmp_path / "port.json")
    assert want.meta == {"arch": "qwen3-4b", "reduced": True, "seed": 5,
                         "batch": 2, "seq": 8}
    same_profiles(got, want)
    assert sorted(got.to_doc()) == sorted(want.to_doc())
    assert port_out.splitlines()[:2] == ref_out.splitlines()[:2]
    assert port_out.splitlines()[-1] == f"profile -> {tmp_path / 'port.json'}"
    with pytest.raises(SystemExit, match="--out is required"):
        profile.main(["--reduced", "--device", "cpu"])


def _spy_lut_kernels(monkeypatch):
    """Send the LUT matmuls down the kernel route, as CUDA tensors would
    (flash keeps the plain route), and record the kernel wrapper each
    reaches, one name a call; each spy computes its kernel's sum with
    the plain version, which the route itself never reaches."""
    from repro_torch.kernels import approx_matmul as am

    calls, plain = [], ops.ref.approx_matmul

    def spy(name):
        def kernel(a, b, lut):
            calls.append(name)
            return plain(a, b, lut)
        return kernel

    def refuse(*args, **kw):
        raise AssertionError("the kernel route reached the plain version")

    monkeypatch.setattr(ops, "use_kernel",
                        lambda x, backend: backend == "auto" and x.dtype == torch.int32)
    for name in ("approx_matmul_w4", "approx_matmul_w8", "approx_matmul_w8_direct"):
        monkeypatch.setattr(am, name, spy(name))
    monkeypatch.setattr(ops.ref, "approx_matmul", refuse)
    return calls


def test_w8_probe_refused_before_any_forward(model, monkeypatch):
    """The kernel route takes the uncomposed 8-bit probe: its check passes,
    and measure_profile(widths=(4, 8)) runs every forward on the kernel
    route and equals the reference's sens and probe_mae.  Each width-8
    probe forward sends the probed layer's three products to the direct
    kernel and every other layer's to W8A8; no call reaches the plain
    version."""
    cj, params, ct, pt, tokens = model
    L = ct.n_layers
    probe = profile.truncation_probe(8)
    assert ops.check_luts(torch.from_numpy(probe.lut)) is None   # the plain route
    calls = _spy_lut_kernels(monkeypatch)
    assert ops.check_luts(torch.from_numpy(probe.lut)) is True
    got = profile.measure_profile(ct, pt, {"tokens": tokens}, widths=(4, 8),
                                  device="cpu")
    want = jprofile.measure_profile(cj, params, {"tokens": jnp.asarray(tokens)},
                                    widths=(4, 8))
    same_profiles(got, want)
    w4 = ["approx_matmul_w4"] * (3 * L * (1 + L))
    assert calls[:len(w4)] == w4
    w8 = calls[len(w4):]
    assert len(w8) == 3 * L * (1 + L)
    forwards = [w8[3 * L * f:3 * L * (f + 1)] for f in range(1 + L)]
    assert forwards[0] == ["approx_matmul_w8"] * (3 * L)   # the exact baseline
    for layer, fwd in enumerate(forwards[1:]):
        want_calls = ["approx_matmul_w8"] * (3 * L)
        want_calls[3 * layer:3 * layer + 3] = ["approx_matmul_w8_direct"] * 3
        assert fwd == want_calls


def test_forms_are_read_once_and_carried_to_each_layer(model, monkeypatch):
    """A stack with one uncomposed table among composed ones: the forward
    reads the stack once (check_luts) and each layer's products reach its
    own kernel, the uncomposed layer's the direct one; the decode step
    takes the forms with the stack its caller adopted (ops.route_luts)
    and reads no table at all."""
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.models import forward_fn
    from repro_torch.models.lm import decode_step, init_decode_caches
    from repro_torch.precision.widths import exact_table

    _, _, ct, pt, tokens = model
    L = ct.n_layers
    ct8 = ct.with_approx_mlp(8)
    stack = np.broadcast_to(exact_table("mul", 8).astype(np.int32), (L, 256, 256)).copy()
    odd = L // 2
    stack[odd] = profile.truncation_probe(8).lut
    calls = _spy_lut_kernels(monkeypatch)
    reads = []
    is_composed = am.is_composed
    monkeypatch.setattr(am, "is_composed", lambda t: reads.append(t.shape) or is_composed(t))
    want_calls = ["approx_matmul_w8"] * (3 * L)
    want_calls[3 * odd:3 * odd + 3] = ["approx_matmul_w8_direct"] * 3

    with torch.no_grad():
        logits = forward_fn(ct8)(ct8, pt, {"tokens": tokens}, lut=stack, device="cpu")[0]
    assert reads == [(L, 256, 256)] and calls == want_calls
    routed = ops.route_luts(torch.from_numpy(stack))
    assert routed.direct == tuple(i == odd for i in range(L))
    calls.clear()
    reads.clear()
    caches = init_decode_caches(ct8, 2, 4, device="cpu")
    with torch.no_grad():
        step = decode_step(ct8, pt, caches, torch.from_numpy(tokens[:, :1]), 0,
                           luts=routed)[0]
    assert reads == [] and calls == want_calls
    monkeypatch.undo()
    with torch.no_grad():
        plain = forward_fn(ct8)(ct8, pt, {"tokens": tokens}, lut=stack,
                                backend="ref", device="cpu")[0]
    assert torch.equal(logits, plain) and torch.isfinite(step).all()
