"""PyTorch port: the MoE dispatch and the families' engines against the JAX
package, on reduced configs and the reference's weights converted with
``repro_torch.convert.params_from_jax``.

``layers.moe_ffn`` against the reference's: blocked dispatch with a
binding capacity drops the same tokens (the earliest tokens of an expert
are kept), dropless and ``ragged`` give the dropless sums, a zero router
(every probability tied) picks the experts ``jax.lax.top_k`` picks, and
the aux loss is the reference's.  Then the engines: a fixed-batch
``ServingEngine`` serve of reduced hymba (attention + SSM) and of reduced
rwkv6 (recurrent state only), and a continuous serve of reduced
deepseek-v2-lite (MoE + MLA over page pools), each giving the reference
engine's tokens; the continuous engine refuses the recurrent families
with the reference's words.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as jax_serving  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.arith import benchmark  # noqa: E402
from repro.library.compile import load_mul_frontier as jax_load  # noqa: E402
from repro.serving.loadgen import synth_requests as jax_synth  # noqa: E402
from repro.models import init_model as jax_init  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import serving as port_serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.library.compile import load_mul_frontier  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from test_serving import fill_library, trunc_mul2, zero_mul2  # noqa: E402

TOL = 1e-5


def _moe_setup(arch, *, capacity=None, impl=None, zero_router=False):
    cj, ct = jax_config(arch, reduced=True), get_config(arch, reduced=True)
    cj, ct = (dataclasses.replace(c, dtype="float32") for c in (cj, ct))
    changes = {}
    if capacity is not None:
        changes["capacity_factor"] = float(capacity)
    if impl is not None:
        changes["impl"] = impl
    cj = dataclasses.replace(cj, moe=dataclasses.replace(cj.moe, **changes))
    ct = dataclasses.replace(ct, moe=dataclasses.replace(ct.moe, **changes))
    p = JL.init_moe(cj, jax.random.PRNGKey(0))
    if zero_router:
        p["router"] = jnp.zeros_like(p["router"])
    one = {"ln1": np.zeros((1, cj.d_model), np.float32),
           "moe": jax.tree.map(lambda a: np.asarray(a)[None], p)}
    pt = params_from_jax({"layers": one}, device="cpu")["layers"][0]["moe"]
    x = np.random.default_rng(0).standard_normal((2, 12, cj.d_model)).astype(np.float32)
    return cj, ct, p, pt, x


def _dropped(cj, x, p):
    """How many (token, k) picks a blocked dispatch drops, from the
    reference's routing: an expert keeps its first C picks."""
    mo = cj.moe
    flat = jnp.asarray(x.reshape(-1, cj.d_model))
    probs = jax.nn.softmax(flat @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, mo.top_k)
    T, K, E = flat.shape[0], mo.top_k, mo.n_experts
    C = max(1, math.ceil(T * K / E * mo.capacity_factor))
    sizes = np.bincount(np.asarray(idx).reshape(-1), minlength=E)
    return int(np.maximum(sizes - C, 0).sum())


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("capacity", [0.5, 1.25], ids=["binding", "default"])
def test_blocked_dispatch_drops_the_same_tokens(arch, capacity):
    """A capacity below the load drops picks; the port keeps the same
    ones (the earliest tokens of each expert) and returns the same
    output and aux loss."""
    cj, ct, p, pt, x = _moe_setup(arch, capacity=capacity)
    want, want_aux = jax.jit(lambda x: JL.moe_ffn(cj, p, x))(jnp.asarray(x))
    got, aux = L.moe_ffn(ct, pt, torch.from_numpy(x))
    assert np.abs(got.numpy() - np.asarray(want)).max() < TOL
    assert abs(float(aux) - float(want_aux)) < 1e-7
    if capacity < 1:
        assert _dropped(cj, x, p) > 0
        full, _ = L.moe_ffn(ct, pt, torch.from_numpy(x), dropless=True)
        # the dropped picks are what the dropless sums hold besides
        assert not torch.allclose(full, got, atol=1e-3)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_dropless_and_ragged_give_the_reference_sums(arch):
    """``dropless=True`` (decode) and ``impl="ragged"`` (dropless, by
    ``lax.ragged_dot`` in the reference) compute the same sums as the
    reference's dropless and ragged forms, with a capacity that would
    otherwise drop."""
    cj, ct, p, pt, x = _moe_setup(arch, capacity=0.5)
    want, _ = jax.jit(lambda x: JL.moe_ffn(cj, p, x, dropless=True))(jnp.asarray(x))
    got, _ = L.moe_ffn(ct, pt, torch.from_numpy(x), dropless=True)
    assert np.abs(got.numpy() - np.asarray(want)).max() < TOL
    cj, ct, p, pt, x = _moe_setup(arch, capacity=0.5, impl="ragged")
    want_r, _ = jax.jit(lambda x: JL.moe_ffn(cj, p, x))(jnp.asarray(x))
    got_r, _ = L.moe_ffn(ct, pt, torch.from_numpy(x))
    assert np.abs(got_r.numpy() - np.asarray(want_r)).max() < TOL
    assert np.abs(got_r.numpy() - got.numpy()).max() < TOL


def test_zero_router_ties_pick_what_top_k_picks():
    """With a zero router every token's probabilities tie: ``top_k``
    takes the lowest expert ids, and so does the port; the outputs and
    the aux loss then match too."""
    cj, ct, p, pt, x = _moe_setup("deepseek-v2-lite-16b", zero_router=True)
    probs = np.full((24, cj.moe.n_experts), 1.0 / cj.moe.n_experts, np.float32)
    probs[5, 3] = probs[5, 6] = 0.5          # a tie below the top
    probs[7] = np.array([0.1, 0.3, 0.3, 0.1, 0.3, 0.1, 0.1, 0.1], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), cj.moe.top_k)
    got_v, got_i = L._top_k(torch.from_numpy(probs), ct.moe.top_k)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i[0].tolist() == [0, 1] and got_i[7].tolist() == [1, 2]
    want, want_aux = jax.jit(lambda x: JL.moe_ffn(cj, p, x))(jnp.asarray(x))
    got, aux = L.moe_ffn(ct, pt, torch.from_numpy(x))
    assert np.abs(got.numpy() - np.asarray(want)).max() < TOL
    assert float(aux) == pytest.approx(float(want_aux), abs=1e-7)


def test_moe_has_static_shapes_and_no_host_reads():
    """Two calls on different inputs of one shape run the same ops on the
    same shapes: every size comes from (T, K, E, C), none from the data."""
    _, ct, _, pt, x = _moe_setup("deepseek-v2-lite-16b")
    shapes = []

    from torch.utils._python_dispatch import TorchDispatchMode

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor):
                shapes.append((str(func), tuple(out.shape)))
            if func in (torch.ops.aten._local_scalar_dense.default,
                        torch.ops.aten.nonzero.default):
                raise AssertionError(f"{func} reads a value back to the host")
            return out

    runs = []
    for seed in (0, 1):
        xs = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            x.shape).astype(np.float32))
        shapes.clear()
        with Shapes():
            L.moe_ffn(ct, pt, xs, dropless=True)
        runs.append(list(shapes))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
PROMPT, GEN = 4, 5


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """The exact 2-bit multiplier and two cheaper ones, as
    ``tests/test_torch_continuous.py`` fills it; loaded by each package."""
    root = tmp_path_factory.mktemp("familylib") / "lib"
    fill_library(root, [benchmark("mul_i4"), trunc_mul2(), zero_mul2()])
    return {"ref": jax_load(root), "port": load_mul_frontier(root)}


def _engine_pair(library, arch, *, continuous=False, level=1):
    """Both packages' engines on the reduced config in f32, serving W4A4
    at ``level`` of a 4-level ladder over the library (``level=None``:
    exact MLP matmuls)."""
    cj = dataclasses.replace(jax_config(arch, reduced=True), dtype="float32")
    ct = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    params = jax_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    kw = dict(prompt_len=PROMPT, gen_len=GEN)
    kw.update(dict(max_slots=3, page_size=4) if continuous else dict(batch=2))
    engines = {}
    for name, side, cfg, p, extra in (("ref", jax_serving, cj, params, {}),
                                      ("port", port_serving, ct, pt,
                                       {"device": "cpu"})):
        plan_kw = {}
        if level is not None:
            cfg = cfg.with_approx_mlp(4)
            compiled, exact_area, _ = library[name]
            ladder = side.PlanLadder.build(compiled, cfg.n_layers,
                                           exact_area=exact_area, levels=4)
            plan_kw = dict(plan=ladder.plan(level), compiled=compiled,
                           exact_area=exact_area)
        Engine = side.ContinuousServingEngine if continuous else side.ServingEngine
        engines[name] = Engine(cfg, p, **kw, **plan_kw, **extra)
    je, pe = engines["ref"], engines["port"]
    if level is not None:
        assert pe.plan.plan_id == je.plan.plan_id
    return je, pe


def _profiles(ticks, per_tick):
    return (jax_serving.steady(ticks, per_tick, prompt_len=PROMPT, gen_len=GEN),
            port_serving.steady(ticks, per_tick, prompt_len=PROMPT, gen_len=GEN))


@pytest.mark.parametrize("arch,level", [("hymba-1.5b", 1), ("rwkv6-3b", None)],
                         ids=["hymba-w4", "rwkv6"])
def test_fixed_serve_matches_the_reference_engine(library, arch, level):
    """The fixed-batch engine: prefill and decode through the one step
    (built once), the recurrent state and the caches zeroed between
    batches, the same tokens batch by batch as the reference's.  (RWKV
    routes no matmul through a LUT, in the reference as here.)"""
    je, pe = _engine_pair(library, arch, level=level)
    prof_j, prof_p = _profiles(2, 2)
    reqs_j = jax_synth(prof_j, je.cfg.vocab_size, 0)
    reqs_p = port_serving.synth_requests(prof_p, pe.cfg.vocab_size, 0)
    for rj, rp in zip(reqs_j, reqs_p):
        je.run_batch(rj)
        pe.run_batch(rp)
        assert np.array_equal(pe.last_tokens, je.last_tokens)
    assert pe.trace_count == 1
    kinds = {tuple(sorted(c)) for c in pe.static_step.caches}
    assert kinds == ({("k", "ssm", "v")} if arch == "hymba-1.5b"
                     else {("wkv", "x_cm", "x_tm")})


def test_continuous_serve_of_moe_mla_matches_the_reference_engine(library):
    """Reduced deepseek-v2-lite (MoE whose shared expert runs W4A4, MLA over
    compressed page pools) through both continuous engines: the same
    completions for every request, and one capture."""
    je, pe = _engine_pair(library, "deepseek-v2-lite-16b", continuous=True)
    prof_j, prof_p = _profiles(2, 3)
    je.serve(prof_j, seed=0)
    pe.serve(prof_p, seed=0)
    got = {rid: np.asarray(g).tolist() for rid, g in pe.completions.items()}
    want = {rid: np.asarray(g).tolist() for rid, g in je.completions.items()}
    assert got == want and len(got) == 6
    assert pe.trace_count == 1
    assert {tuple(sorted(c)) for c in pe.static_step.caches} == {("ckvp", "krp")}


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_continuous_engine_refuses_recurrent_families(library, arch):
    """Built, then refused when its paged step is built, with the
    reference's ``ValueError`` and words."""
    je, pe = _engine_pair(library, arch, continuous=True, level=None)
    prof_j, prof_p = _profiles(1, 2)
    with pytest.raises(ValueError) as want:
        je.serve(prof_j, seed=0)
    with pytest.raises(ValueError, match="recurrent state") as got:
        pe.serve(prof_p, seed=0)
    assert str(got.value) == str(want.value)
