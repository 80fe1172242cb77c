"""PyTorch port: ``sensitivity/profile`` against ``repro.sensitivity.profile``.

On reduced qwen3-4b in f32 with the reference's weights converted, the
same tokens go through both profilers: the probe tables are bit-equal,
measured drifts (sensitivity x probe mae, and every cost-matrix entry)
agree within 4e-5 absolute -- twice the 2e-5 logit tolerance of
tests/test_torch_system.py -- the operator keys are equal, ``costs_for``
prices equal profiles equally, a profile written by either side loads on
the other, and both CLIs write equal documents.  On the card the 8-bit
probe, which is not composed from a tile, is refused before any forward;
here that order is held by routing the check to the kernel route's.
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


def test_w8_probe_refused_before_any_forward(model, monkeypatch):
    """The kernel route refuses the uncomposed 8-bit probe; the profiler
    checks every probe before its first forward (here the check is routed
    to the kernel route's, as a CUDA tensor would be)."""
    _, _, ct, pt, tokens = model
    forwards = []
    real = profile.forward_fn

    def counting_forward_fn(cfg):
        fwd = real(cfg)

        def wrapped(*a, **kw):
            forwards.append(kw["lut"].shape)
            return fwd(*a, **kw)
        return wrapped

    monkeypatch.setattr(profile, "forward_fn", counting_forward_fn)
    use_kernel = ops.use_kernel
    monkeypatch.setattr(ops, "use_kernel", lambda x, backend: backend == "auto")
    with pytest.raises(ValueError, match="not composed from a 16x16 tile"):
        profile.measure_profile(ct, pt, {"tokens": tokens}, widths=(4, 8),
                                device="cpu")
    assert forwards == []
    # the plain route, which CPU tensors take, runs it, as the reference's
    # CPU route does
    monkeypatch.setattr(ops, "use_kernel", use_kernel)
    prof = profile.measure_profile(ct, pt, {"tokens": tokens}, widths=(8,),
                                   device="cpu")
    assert forwards == [(ct.n_layers, 256, 256)] * (1 + ct.n_layers)
    assert (prof.sens[8] > 0).all()
