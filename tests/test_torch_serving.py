"""PyTorch port: the serving engine against ``repro.serving.ServingEngine``.

The JAX engine serves a plan selected from a two-operator library (exact
and truncated 2-bit multipliers, as tests/test_serving.py builds it); the
port's engine takes the same plan as the stack ``stack_luts`` produces.
In f32, greedy tokens must be identical, for full and zero-padded short
batches and over a served load profile.
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
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.loadgen import steady as jax_steady  # noqa: E402
from repro.serving.loadgen import synth_requests as jax_synth  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import ServingEngine, steady, synth_requests  # noqa: E402
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
    stats = pe.serve(steady(2, 3, prompt_len=PROMPT, gen_len=GEN), seed=3)
    assert [s.n_requests for s in stats] == [2, 1, 2, 1]
    assert sum(s.decode_tokens for s in stats) == 6 * GEN
    assert tel.n_batches == len(stats)
    assert np.array_equal(pe.last_tokens, je.last_tokens)


def test_batch_override_copies_into_one_buffer(engines):
    """A per-batch stack decodes that batch only, through one reused buffer;
    the exact stack reproduces an exact-table engine."""
    _, pe = engines
    reqs = synth_requests(steady(1, 2, prompt_len=PROMPT, gen_len=GEN), 512, 1)[0]
    pe.run_batch(reqs)
    live = pe.last_tokens
    ex = (np.arange(16)[:, None] * np.arange(16)[None, :]).astype(np.int32)
    exact = np.stack([ex] * pe.cfg.n_layers)
    pe.run_batch(reqs, luts=exact)
    buf = pe._override
    tok_exact = pe.last_tokens
    pe.run_batch(reqs, luts=exact)
    assert pe._override is buf and np.array_equal(pe.last_tokens, tok_exact)
    ref = ServingEngine(pe.cfg, pe.params, batch=2, prompt_len=PROMPT,
                        gen_len=GEN, luts=exact, device="cpu")
    ref.run_batch(reqs)
    assert np.array_equal(ref.last_tokens, tok_exact)
    pe.run_batch(reqs)
    assert np.array_equal(pe.last_tokens, live)
    with pytest.raises(ValueError, match="shape"):
        pe.run_batch(reqs, luts=exact[:1])
