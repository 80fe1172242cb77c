"""PyTorch port: the serving engine against ``repro.serving.ServingEngine``.

The JAX engine serves a plan selected from a two-operator library (exact
and truncated 2-bit multipliers, as tests/test_serving.py builds it); the
port's engine takes the same plan as the stack ``stack_luts`` produces,
or the plan itself with its frontier, at W4A4, W8A8 and mixed width.
In f32, greedy tokens must be identical, for full and zero-padded short
batches, over a served load profile, and before and after a plan swap.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.library import select_plan, stack_luts  # noqa: E402
from repro.library.compile import load_mul_frontier  # noqa: E402
from repro.models import init_model as jax_init  # noqa: E402
from repro.sensitivity import profile as jax_profile  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.loadgen import steady as jax_steady  # noqa: E402
from repro.serving.loadgen import synth_requests as jax_synth  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro.precision.plans import build_mixed_ladder as jax_build_mixed_ladder  # noqa: E402
from repro.precision.plans import load_mixed_frontier as jax_load_mixed_frontier  # noqa: E402
from repro.serving.controller import PlanLadder as JaxPlanLadder  # noqa: E402
from repro_torch.library import select_plan as tselect_plan  # noqa: E402
from repro_torch.library import stack_luts as tstack_luts  # noqa: E402
from repro_torch.library.compile import load_mul_frontier as tload_mul_frontier  # noqa: E402
from repro_torch.precision.plans import build_mixed_ladder, load_mixed_frontier  # noqa: E402
from repro_torch.sensitivity import profile as port_profile  # noqa: E402
from repro_torch.serving import (PlanLadder, ServingEngine, steady,  # noqa: E402
                                 synth_requests)
from test_sensitivity import mixed_library  # noqa: E402,F401  (fixture)
from test_serving import two_op_library  # noqa: E402,F401  (fixture)

PROMPT, GEN = 4, 6


@pytest.fixture
def engines(two_op_library):
    cj = dataclasses.replace(jax_config("qwen3-4b", reduced=True),
                             dtype="float32").with_approx_mlp(4)
    ct = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                             dtype="float32").with_approx_mlp(4)
    compiled, exact_area, _ = load_mul_frontier(two_op_library)
    # an unbounded budget puts every layer on the cheapest (truncated) rung
    plan = select_plan(compiled, np.ones(cj.n_layers), 1e9, exact_area=exact_area)
    assert all(c.key is not None for c in plan.choices)
    params = jax_init(cj, jax.random.PRNGKey(0))
    je = JaxEngine(cj, params, batch=2, prompt_len=PROMPT, gen_len=GEN,
                   plan=plan, compiled=compiled, exact_area=exact_area)
    pe = ServingEngine(ct, params_from_jax(jax.tree.map(np.asarray, params),
                                           device="cpu"),
                       batch=2, prompt_len=PROMPT, gen_len=GEN,
                       luts=stack_luts(plan, compiled), device="cpu")
    return je, pe


def test_loadgen_copy_reproduces_the_stream():
    for kw in ({}, {"prompt_dist": ("uniform", 2, 4)},
               {"class_mix": (("gold", 0.3), ("batch", 0.7))}):
        want = jax_synth(jax_steady(3, 2, prompt_len=4, gen_len=2, **kw), 512, 7)
        got = synth_requests(steady(3, 2, prompt_len=4, gen_len=2, **kw), 512, 7)
        assert [[(r.rid, r.qos_class, r.tokens.tolist()) for r in t] for t in got] == \
               [[(r.rid, r.qos_class, r.tokens.tolist()) for r in t] for t in want]


def test_greedy_tokens_match_jax_engine(engines):
    je, pe = engines
    reqs = [r for tick in synth_requests(steady(1, 3, prompt_len=PROMPT,
                                                gen_len=GEN), 512, 0)
            for r in tick]
    for batch in (reqs[:2], reqs[2:]):  # a full batch, then a padded one
        sj = je.run_batch(batch)
        sp = pe.run_batch(batch)
        assert pe.last_tokens.shape == (len(batch), GEN)
        assert np.array_equal(pe.last_tokens, je.last_tokens)
        assert (sp.n_requests, sp.decode_steps, sp.prefill_tokens) == \
               (sj.n_requests, sj.decode_steps, sj.prefill_tokens)


def test_serve_matches_jax_engine(engines):
    je, pe = engines
    tel = je.serve(jax_steady(2, 3, prompt_len=PROMPT, gen_len=GEN), seed=3)
    ptel = pe.serve(steady(2, 3, prompt_len=PROMPT, gen_len=GEN), seed=3)
    assert [e["n_requests"] for e in ptel.events] == [2, 1, 2, 1]
    assert [e["n_requests"] for e in tel.events] == [2, 1, 2, 1]
    assert sum(e["decode_tokens"] for e in ptel.events) == 6 * GEN
    assert tel.n_batches == ptel.n_batches and tel.n_requests == ptel.n_requests
    assert np.array_equal(pe.last_tokens, je.last_tokens)
    assert pe.trace_count == je.trace_count == 1


def test_batch_override_copies_into_one_buffer(engines):
    """A per-batch stack decodes that batch only, copied into the one
    stack buffer the step reads; the live stack is untouched, and the
    exact stack reproduces an exact-table engine."""
    _, pe = engines
    reqs = synth_requests(steady(1, 2, prompt_len=PROMPT, gen_len=GEN), 512, 1)[0]
    pe.run_batch(reqs)
    live = pe.last_tokens
    before = pe._luts.clone()
    ex = (np.arange(16)[:, None] * np.arange(16)[None, :]).astype(np.int32)
    exact = np.stack([ex] * pe.cfg.n_layers)
    buf = pe.static_step.luts
    ptr = buf.data_ptr()
    pe.run_batch(reqs, luts=exact)
    tok_exact = pe.last_tokens
    pe.run_batch(reqs, luts=exact)
    assert pe.static_step.luts is buf and buf.data_ptr() == ptr
    assert np.array_equal(pe.last_tokens, tok_exact)
    assert torch.equal(pe._luts, before) and pe.trace_count == 1
    ref = ServingEngine(pe.cfg, pe.params, batch=2, prompt_len=PROMPT,
                        gen_len=GEN, luts=exact, device="cpu")
    ref.run_batch(reqs)
    assert np.array_equal(ref.last_tokens, tok_exact)
    pe.run_batch(reqs)
    assert np.array_equal(pe.last_tokens, live)
    with pytest.raises(ValueError, match="shape"):
        pe.run_batch(reqs, luts=exact[:1])


# ---------------------------------------------------------------------------
# the engine built from a QoS plan, and its hot swap
# ---------------------------------------------------------------------------
def _pair_models(bits):
    cj = dataclasses.replace(jax_config("qwen3-4b", reduced=True),
                             dtype="float32").with_approx_mlp(bits)
    ct = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                             dtype="float32").with_approx_mlp(bits)
    params = jax_init(cj, jax.random.PRNGKey(0))
    return cj, ct, params, params_from_jax(jax.tree.map(np.asarray, params),
                                           device="cpu")


def _requests():
    return synth_requests(steady(1, 2, prompt_len=PROMPT, gen_len=GEN), 512, 2)[0]


def _same_tokens(pe, je, reqs):
    je.run_batch(reqs)
    pe.run_batch(reqs)
    assert np.array_equal(pe.last_tokens, je.last_tokens)
    return pe.last_tokens


@pytest.mark.parametrize("bits", [4, 8])
def test_plan_engine_matches_jax_engine_across_swaps(two_op_library, bits):
    """W4A4 and W8A8 plans from one store: the port's engine and the
    reference's, built the same way, give the same tokens before and after
    the same swaps; a swap copies into the live buffer in place, and a
    refused one changes nothing."""
    cj, ct, params, pt = _pair_models(bits)
    target = None if bits == 4 else 8
    compiled, exact_area, _ = tload_mul_frontier(two_op_library, target)
    jc, jea, _ = load_mul_frontier(two_op_library, target)
    ladder = PlanLadder.build(compiled, ct.n_layers, exact_area=exact_area, levels=4)
    jladder = JaxPlanLadder.build(jc, cj.n_layers, exact_area=jea, levels=4)
    assert len(ladder) == len(jladder) >= 2
    kw = dict(batch=2, prompt_len=PROMPT, gen_len=GEN)
    pe = ServingEngine(ct, pt, plan=ladder.plan(0), compiled=compiled,
                       exact_area=exact_area, device="cpu", **kw)
    je = JaxEngine(cj, params, plan=jladder.plan(0), compiled=jc,
                   exact_area=jea, **kw)
    assert pe.plan.plan_id == je.plan.plan_id
    assert (pe.width.bits, pe.widths) == (je.width.bits, je.widths) == (bits, (bits,))
    assert np.array_equal(pe._exact_luts.numpy(), np.asarray(je._exact_luts))
    assert np.array_equal(pe._luts.numpy(), np.asarray(je._luts))
    assert pe._mae_by_key == je._mae_by_key
    assert pe._area_hi_by_key == je._area_hi_by_key
    reqs = _requests()
    first = _same_tokens(pe, je, reqs)

    live, ptr = pe._luts, pe._luts.data_ptr()
    top = len(ladder) - 1
    assert pe.swap_plan(ladder.plan(0), ladder.luts(0)) is \
        je.swap_plan(jladder.plan(0), jladder.luts(0)) is False
    got = pe.swap_plan(ladder.plan(top), ladder.luts(top), reason="test", batch_idx=1)
    want = je.swap_plan(jladder.plan(top), jladder.luts(top), reason="test", batch_idx=1)
    assert got is want is True
    assert pe._luts is live and live.data_ptr() == ptr
    assert pe.plan.plan_id == je.plan.plan_id
    assert np.array_equal(live.numpy(), ladder.luts(top))
    swapped = _same_tokens(pe, je, reqs)
    # the ladder's cached stacks are read, never written
    assert np.array_equal(ladder.luts(0), jladder.luts(0))

    side = 16 if bits == 8 else 256   # the other width's table
    before = live.clone()
    with pytest.raises(ValueError, match="refusing"):
        pe.swap_plan(ladder.plan(1), np.zeros((ct.n_layers, side, side), np.int32))
    with pytest.raises(ValueError, match="refusing"):
        pe.swap_plan(ladder.plan(1), ladder.luts(1)[:1])
    assert torch.equal(live, before) and pe.plan.plan_id == ladder.plan(top).plan_id
    pe.run_batch(reqs)
    assert np.array_equal(pe.last_tokens, swapped)
    # back down the ladder: the first level's tokens again
    assert pe.swap_plan(ladder.plan(0), ladder.luts(0)) is True
    pe.run_batch(reqs)
    assert np.array_equal(pe.last_tokens, first) and pe._luts is live


def test_mixed_plan_engine_matches_jax_engine_across_swaps(mixed_library):
    """A mixed-width plan (layer 0 at W4A4, layer 1 at W8A8): one buffer a
    width, the same tokens as the reference's engine before and after a
    swap inside the width map, each buffer copied into in place."""
    cj, ct, params, pt = _pair_models(4)
    mixed = load_mixed_frontier(mixed_library)
    jmixed = jax_load_mixed_frontier(mixed_library)
    wm = (4, 8)
    sens = {b: np.ones(ct.n_layers) for b in mixed.widths}
    ladder = build_mixed_ladder(mixed, wm, sens, levels=4)
    jladder = jax_build_mixed_ladder(jmixed, wm, sens, levels=4)
    assert len(ladder) == len(jladder) >= 2
    kw = dict(batch=2, prompt_len=PROMPT, gen_len=GEN, sensitivities=sens,
              width_map=wm)
    pe = ServingEngine(ct, pt, plan=ladder.plan(0), compiled=mixed.compiled,
                       device="cpu", **kw)
    je = JaxEngine(cj, params, plan=jladder.plan(0), compiled=jmixed.compiled, **kw)
    assert pe.width is None and pe.widths == je.widths == (4, 8)
    assert sorted(pe._exact_luts) == sorted(je._exact_luts) == [4, 8]
    for b in (4, 8):
        assert np.array_equal(pe._exact_luts[b].numpy(), np.asarray(je._exact_luts[b]))
        assert np.array_equal(pe._luts[b].numpy(), np.asarray(je._luts[b]))
    reqs = _requests()
    _same_tokens(pe, je, reqs)

    live = dict(pe._luts)
    ptrs = {b: t.data_ptr() for b, t in live.items()}
    top = len(ladder) - 1
    assert pe.swap_plan(ladder.plan(top), ladder.luts(top)) is \
        je.swap_plan(jladder.plan(top), jladder.luts(top)) is True
    for b in (4, 8):
        assert pe._luts[b] is live[b] and live[b].data_ptr() == ptrs[b]
        assert np.array_equal(live[b].numpy(), ladder.luts(top)[b])
    swapped = _same_tokens(pe, je, reqs)

    before = {b: t.clone() for b, t in live.items()}
    with pytest.raises(ValueError, match="width map is frozen"):
        pe.swap_plan(ladder.plan(0), {4: ladder.luts(0)[4]})
    with pytest.raises(ValueError, match="width map is frozen"):
        pe.swap_plan(ladder.plan(0), ladder.luts(0)[8])
    assert all(torch.equal(live[b], before[b]) for b in live)
    pe.run_batch(reqs)
    assert np.array_equal(pe.last_tokens, swapped)
    # a per-batch {bits: stack} override decodes one batch on another
    # level, copied per width group; the live stack is untouched
    je.run_batch(reqs, luts=jladder.luts(0))
    pe.run_batch(reqs, luts=ladder.luts(0))
    assert np.array_equal(pe.last_tokens, je.last_tokens)
    assert all(torch.equal(live[b], pe._luts[b]) for b in live)
    with pytest.raises(ValueError, match="override"):
        pe.run_batch(reqs, luts=ladder.luts(0)[8])
    with pytest.raises(ValueError, match="override"):
        pe.run_batch(reqs, luts={4: ladder.luts(0)[4]})
    pe.run_batch(reqs)
    assert np.array_equal(pe.last_tokens, swapped) and pe.trace_count == 1


def test_plan_engine_refusals(two_op_library):
    cj, ct, params, pt = _pair_models(4)
    compiled, exact_area, _ = tload_mul_frontier(two_op_library)
    plan = tselect_plan(compiled, np.ones(ct.n_layers), 0.0, exact_area=exact_area)
    kw = dict(batch=2, prompt_len=PROMPT, gen_len=GEN, device="cpu")
    pe = ServingEngine(ct, pt, plan=plan, compiled=compiled, **kw)
    observed = []

    class _Health:      # serve(health=) runs now: one observation a batch
        def observe_step(self, **kw):
            observed.append(kw["step"])

    pe.serve(steady(1, 1, prompt_len=PROMPT, gen_len=GEN), health=_Health())
    assert observed == [0]
    # a sens_profile= engine prices a refreshed frontier by the profile:
    # its measured column where it covers the operator, its linear model
    # elsewhere, as the reference engine does
    doc = {"model": "m", "n_layers": ct.n_layers, "sens": {"4": [3.0, 0.25]},
           "costs": {"4": {"keys": [compiled[0][0].key], "matrix": [[0.0], [9.0]]}}}
    jc, jarea, _ = load_mul_frontier(two_op_library)
    ones = np.ones(ct.n_layers)
    je = JaxEngine(cj, params, batch=2, prompt_len=PROMPT, gen_len=GEN,
                   plan=select_plan(jc, ones, 1.0, exact_area=jarea),
                   compiled=jc, exact_area=jarea,
                   sens_profile=jax_profile.SensitivityProfile.from_doc(doc))
    pe = ServingEngine(ct, pt, plan=tselect_plan(compiled, ones, 1.0, exact_area=exact_area),
                       compiled=compiled, exact_area=exact_area,
                       sens_profile=port_profile.SensitivityProfile.from_doc(doc), **kw)
    want, got = je._uniform_sens(jc), pe._uniform_sens(compiled)
    assert np.array_equal(got, want) and got[1, 0] == 9.0
    assert pe.refresh_library(compiled, exact_area) == je.refresh_library(jc, jarea)
    assert pe.plan.plan_id == je.plan.plan_id
    assert [c.key for c in pe.plan.choices] == [compiled[0][0].key, None]
    with pytest.raises(ValueError, match="not both"):
        ServingEngine(ct, pt, plan=plan, compiled=compiled,
                      luts=tstack_luts(plan, compiled), **kw)
    with pytest.raises(ValueError, match="width_map"):
        ServingEngine(ct, pt, plan=plan, compiled=compiled, width_map=(4,), **kw)
    with pytest.raises(ValueError, match="with_approx_mlp"):
        ServingEngine(get_config("qwen3-4b", reduced=True), pt, plan=plan,
                      compiled=compiled, **kw)
    raw = ServingEngine(ct, pt, luts=tstack_luts(plan, compiled), **kw)
    assert raw.plan is None and raw.widths == (4,) and raw._exact_luts is None
    with pytest.raises(ValueError, match="without a QoS plan"):
        raw.swap_plan(plan, tstack_luts(plan, compiled))


# ---------------------------------------------------------------------------
# the captured step's buffers, and the class-aware mixed-width serve
# ---------------------------------------------------------------------------
def _addresses(pe):
    st = pe.static_step
    out = [st.tok.data_ptr(), st.pos.data_ptr(), st.logits.data_ptr()]
    out += [c[k].data_ptr() for c in st.caches for k in ("k", "v")]
    out += [t.data_ptr() for t in (st.luts.values() if isinstance(st.luts, dict)
                                   else [st.luts])]
    out += [t.data_ptr() for t in (pe._luts.values() if isinstance(pe._luts, dict)
                                   else [pe._luts])]
    return out


def test_step_buffers_keep_their_addresses(two_op_library):
    """The token, position, logits, cache and stack buffers of the one
    built step, and the live stack, keep their addresses across swaps,
    per-batch overrides, shadow steps, short padded batches and batches;
    the shadow step leaves the batch's tokens as they were."""
    _, ct, _, pt = _pair_models(4)
    compiled, exact_area, _ = tload_mul_frontier(two_op_library)
    ladder = PlanLadder.build(compiled, ct.n_layers, exact_area=exact_area, levels=4)
    top = len(ladder) - 1
    pe = ServingEngine(ct, pt, plan=ladder.plan(top), compiled=compiled,
                       exact_area=exact_area, batch=2, prompt_len=PROMPT,
                       gen_len=GEN, device="cpu")
    reqs = _requests()
    st = pe.run_batch(reqs)
    assert st.drift is None
    ptrs = _addresses(pe)
    tokens = pe.last_tokens
    shadowed = pe.run_batch(reqs, shadow=True)
    assert np.array_equal(pe.last_tokens, tokens) and shadowed.drift > 0
    assert pe.swap_plan(ladder.plan(0), ladder.luts(0))
    exact = pe.run_batch(reqs, shadow=True)
    assert exact.drift == 0.0
    pe.run_batch(reqs, luts=ladder.luts(top))
    assert np.array_equal(pe.last_tokens, tokens)
    pe.run_batch(reqs[:1])
    assert pe.last_tokens.shape == (1, GEN)
    pe.run_batch(reqs, luts=ladder.luts(top), shadow=True)
    assert np.array_equal(pe.last_tokens, tokens)
    assert _addresses(pe) == ptrs and pe.trace_count == 1
    assert pe.static_step.replays == 6 * (PROMPT + GEN) + 3   # 3 shadow steps
