"""PyTorch port on a card: the serving engine's decode step, captured once
as a CUDA graph and replayed for every token, every batch and the shadow
step.  Checks that the step is captured once across a plan swap, a
per-batch override and shadow steps; that a replay's logits and tokens
equal the eager kernel route's (``decode_fn`` called directly) bit for
bit, before and after a swap; that a swap takes effect at the next
replay; and that the kernels' launch counts follow the replays.  Imports
no JAX: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_graph_cuda.py``.  Skips without a CUDA device."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.arith import benchmark  # noqa: E402
from repro_torch.core.circuits import Circuit, Op  # noqa: E402
from repro_torch.core.synth import area  # noqa: E402
from repro_torch.kernels import approx_matmul as am  # noqa: E402
from repro_torch.library.compile import load_mul_frontier  # noqa: E402
from repro_torch.library.store import OperatorSignature, OperatorStore  # noqa: E402
from repro_torch.models import decode_fn, init_caches, init_model  # noqa: E402
from repro_torch.serving import (PlanLadder, ServingEngine, steady,  # noqa: E402
                                 synth_requests)

PROMPT, GEN = 4, 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")


def _trunc_mul2() -> Circuit:
    """Exact low 2 product bits, upper bits dropped."""
    c = Circuit.empty(4, "trunc_mul2")
    a0, a1, b0, b1 = 0, 1, 2, 3
    p0 = c.add(Op.AND, a0, b0)
    p1 = c.add(Op.XOR, c.add(Op.AND, a1, b0), c.add(Op.AND, a0, b1))
    z = c.const(False)
    for out in (p0, p1, z, z):
        c.mark_output(out)
    return c


@pytest.fixture
def library(tmp_path):
    store = OperatorStore(tmp_path / "lib")
    exact = benchmark("mul_i4").eval_words().astype(np.int64)
    for circ in (benchmark("mul_i4"), _trunc_mul2()):
        wce = int(np.abs(circ.eval_words().astype(np.int64) - exact).max())
        store.put_circuit(circ, OperatorSignature("mul", 2, "wce", max(1, wce)),
                          area=area(circ), source="test")
    return tmp_path / "lib"


def _engine(cuda, library, bits):
    cfg = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                              dtype="float32").with_approx_mlp(bits)
    params = init_model(cfg, seed=0, device=cuda)
    compiled, exact_area, _ = load_mul_frontier(library, None if bits == 4 else 8)
    ladder = PlanLadder.build(compiled, cfg.n_layers, exact_area=exact_area, levels=4)
    assert len(ladder) >= 2
    eng = ServingEngine(cfg, params, batch=2, prompt_len=PROMPT, gen_len=GEN,
                        plan=ladder.plan(0), compiled=compiled,
                        exact_area=exact_area, device=cuda)
    reqs = synth_requests(steady(1, 2, prompt_len=PROMPT, gen_len=GEN),
                          cfg.vocab_size, 0)[0]
    return eng, ladder, reqs


def _eager(eng, reqs, stack):
    """The batch through ``decode_fn`` called directly, position by
    position, on the kernel route: (tokens, last logits)."""
    cfg, dev = eng.cfg, eng.device
    step = decode_fn(cfg)
    caches = init_caches(cfg, eng.batch, eng.total, device=dev)
    prompts = np.zeros((eng.batch, PROMPT), np.int32)
    for i, r in enumerate(reqs):
        prompts[i, :len(r.tokens)] = r.tokens
    prompts = torch.from_numpy(prompts).to(dev)
    luts = torch.as_tensor(stack, device=dev)
    for t in range(PROMPT):
        logits, _ = step(cfg, eng.params, caches, prompts[:, t:t + 1], t, luts=luts)
    generated = []
    for t in range(PROMPT, eng.total):
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        generated.append(tok)
        logits, _ = step(cfg, eng.params, caches, tok, t, luts=luts)
    return torch.cat(generated, 1)[:len(reqs)].cpu().numpy(), logits


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_replay_equals_the_eager_kernel_route_across_a_swap(cuda, library, bits):
    eng, ladder, reqs = _engine(cuda, library, bits)
    top = len(ladder) - 1
    for level in (0, top):
        if level:
            assert eng.swap_plan(ladder.plan(level), ladder.luts(level))
        eng.run_batch(reqs)
        tokens, logits = _eager(eng, reqs, ladder.luts(level))
        assert np.array_equal(eng.last_tokens, tokens), level
        assert torch.equal(eng.static_step.logits, logits), level
    assert eng.trace_count == 1


@pytest.mark.cuda
def test_captured_once_across_swap_override_and_shadow(cuda, library):
    eng, ladder, reqs = _engine(cuda, library, 4)
    top = len(ladder) - 1
    eng.run_batch(reqs)
    st = eng.static_step
    ptrs = [st.tok.data_ptr(), st.pos.data_ptr(), st.logits.data_ptr(),
            st.luts.data_ptr(), eng._luts.data_ptr()]
    ptrs += [c[k].data_ptr() for c in st.caches for k in ("k", "v")]
    exact_tokens = eng.last_tokens
    assert eng.swap_plan(ladder.plan(top), ladder.luts(top))
    shadowed = eng.run_batch(reqs, shadow=True)
    swapped = eng.last_tokens
    assert shadowed.drift is not None and shadowed.drift > 0
    eng.run_batch(reqs)
    assert np.array_equal(eng.last_tokens, swapped)   # the shadow left no trace
    eng.run_batch(reqs, luts=ladder.luts(0), shadow=True)
    assert np.array_equal(eng.last_tokens, exact_tokens)
    eng.run_batch(reqs[:1])
    assert np.array_equal(eng.last_tokens, swapped[:1])
    now = [st.tok.data_ptr(), st.pos.data_ptr(), st.logits.data_ptr(),
           st.luts.data_ptr(), eng._luts.data_ptr()]
    now += [c[k].data_ptr() for c in st.caches for k in ("k", "v")]
    assert eng.static_step is st and now == ptrs
    assert eng.trace_count == 1


@pytest.mark.cuda
def test_a_swap_takes_effect_at_the_next_replay(cuda, library):
    eng, ladder, reqs = _engine(cuda, library, 4)
    top = len(ladder) - 1
    eng.run_batch(reqs)
    before = eng.static_step.logits.clone()
    eng.swap_plan(ladder.plan(top), ladder.luts(top))
    eng.run_batch(reqs)
    after = eng.static_step.logits.clone()
    _, want = _eager(eng, reqs, ladder.luts(top))
    assert torch.equal(after, want) and not torch.equal(after, before)


@pytest.mark.cuda
def test_launch_counts_follow_the_replays(cuda, library):
    eng, ladder, reqs = _engine(cuda, library, 4)
    eng.static_step                      # capture before counting
    n = am.approx_matmul_w4.launches
    replays = eng.static_step.replays
    eng.run_batch(reqs, shadow=True)
    done = eng.static_step.replays - replays
    assert done == PROMPT + GEN + 1
    assert eng.static_step.launches_per_replay == {
        "approx_matmul_w4": 3 * eng.cfg.n_layers}
    assert am.approx_matmul_w4.launches - n == done * 3 * eng.cfg.n_layers
