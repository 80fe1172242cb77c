"""The paper's system on the PyTorch port: ALS -> LUT -> approximate
inference, a replay of the four tests of tests/test_system.py.

The multiplier comes from the port's ``muscat_like`` and must be the
reference's circuit node for node.  The models are the same reduced
stablelm-1.6b and qwen3-4b with the reference's weights and tokens
(carried across with ``params_from_jax``), their logits computed through
the port's plain kernels.  Each forward is held against the reference's,
compiled with XLA's ``xla_allow_excess_precision`` off so that every op
rounds as the port's do (tests/test_torch_models.py), within 2e-5.  The
system assertions -- sound, smaller, LUT error within ET, drift bounded,
drift monotone in ET with none at ET 0 -- are then made on the port's own
numbers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import arith as jarith  # noqa: E402
from repro.core.baselines import muscat_like as jax_muscat_like  # noqa: E402
from repro.library.store import circuit_to_dict as j_to_dict  # noqa: E402
from repro.models import forward_fn as jax_forward_fn  # noqa: E402
from repro.models import init_model as jax_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import circuit_from_jax, params_from_jax  # noqa: E402
from repro_torch.core.baselines import muscat_like  # noqa: E402
from repro_torch.core.miter import worst_case_error  # noqa: E402
from repro_torch.core.synth import area  # noqa: E402
from repro_torch.library.store import circuit_to_dict  # noqa: E402
from repro_torch.models import forward_fn  # noqa: E402
from repro_torch.quant.lut import build_lut, exact_mul_lut  # noqa: E402

ET = 4
TOL = 2e-5


def _port_muscat(exact_jax, **kw):
    """The port's ``muscat_like``, held identical to the reference's."""
    got = muscat_like(circuit_from_jax(exact_jax), **kw)
    want = jax_muscat_like(exact_jax, **kw)
    assert circuit_to_dict(got.circuit) == j_to_dict(want.circuit)
    assert (got.area, got.wce) == (want.area, want.wce)
    return got


@pytest.fixture(scope="module")
def approx_mult():
    """A sound ET=4 approximate 4-bit multiplier, as the reference's
    fixture finds it (restarts bound the work; the wall budget does not)."""
    res = _port_muscat(jarith.benchmark("mul_i8"), et=ET, restarts=2,
                       wall_budget_s=1e9)
    assert res.wce <= ET
    return circuit_from_jax(jarith.benchmark("mul_i8")), res


class _Model:
    """One reduced model on both sides: the port's forward through the
    plain kernels, and the reference's jitted forward with excess
    precision off, compiled once and fed the LUT as an argument."""

    def __init__(self, arch, seed, shape):
        self.cj = jax_config(arch, reduced=True).with_approx_mlp()
        self.ct = get_config(arch, reduced=True).with_approx_mlp()
        key = jax.random.PRNGKey(seed)
        self.params = jax_init(self.cj, key)
        self.pt = params_from_jax(jax.tree.map(np.asarray, self.params),
                                  device="cpu")
        self.tokens = jax.random.randint(key, shape, 0, self.cj.vocab_size)
        self._jfwd = {}

    def _jax(self, lut):
        kind = lut is None
        if kind not in self._jfwd:
            def fwd(tokens, *lut_):
                return jax_forward_fn(self.cj)(
                    self.cj, self.params, {"tokens": tokens},
                    lut=lut_[0] if lut_ else None)[0]

            args = (self.tokens,) if lut is None else (self.tokens, jnp.asarray(lut))
            self._jfwd[kind] = jax.jit(fwd).lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        args = (self.tokens,) if lut is None else (self.tokens, jnp.asarray(lut))
        return np.asarray(self._jfwd[kind](*args))

    def logits(self, lut):
        """The port's logits, after holding them against the reference's."""
        got, _ = forward_fn(self.ct)(self.ct, self.pt,
                                     {"tokens": np.array(self.tokens)},
                                     lut=lut, device="cpu")
        got = got.numpy()
        want = self._jax(lut)
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() < TOL, np.abs(got - want).max()
        return got


def test_found_multiplier_is_sound_and_smaller(approx_mult):
    exact, best = approx_mult
    assert worst_case_error(exact, best.circuit) <= ET
    assert best.area < area(exact)


def test_lut_error_bounded_by_et(approx_mult):
    _, best = approx_mult
    lut = build_lut(best.circuit)
    err = np.abs(lut - exact_mul_lut())
    assert err.max() <= ET


def test_approx_inference_logit_drift_is_bounded(approx_mult):
    _, best = approx_mult
    model = _Model("stablelm-1.6b", 0, (2, 16))
    logits_exact4 = model.logits(exact_mul_lut())
    logits_approx = model.logits(build_lut(best.circuit))
    logits_float = model.logits(None)
    drift_quant = float(np.abs(logits_float - logits_exact4).mean())
    drift_approx = float(np.abs(logits_exact4 - logits_approx).mean())
    assert np.isfinite(drift_approx)
    assert drift_approx < 10 * max(drift_quant, 1e-3), (drift_quant, drift_approx)


def test_logit_drift_is_monotone_in_et():
    exact = jarith.benchmark("mul_i8")
    model = _Model("qwen3-4b", 1, (4, 16))
    le = model.logits(exact_mul_lut())
    drifts = {}
    for et in (0, 4, 32):
        if et == 0:
            lut = exact_mul_lut()
        else:
            lut = build_lut(_port_muscat(exact, et=et, restarts=1,
                                         wall_budget_s=1e9).circuit)
        drifts[et] = float(np.abs(le - model.logits(lut)).mean())
    assert drifts[0] == 0.0
    assert drifts[0] < drifts[4] <= drifts[32] * 1.05, drifts
