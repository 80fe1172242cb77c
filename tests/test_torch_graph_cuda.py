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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.library.compile import load_mul_frontier  # noqa: E402
from repro_torch.library.store import OperatorSignature, OperatorStore  # noqa: E402
from repro_torch.models import (decode_fn, decode_paged_fn, init_caches,  # noqa: E402
                                init_model, init_paged_caches)
from repro_torch.sensitivity import ClassBook, ClassScheduler  # noqa: E402
from repro_torch.serving import (ContinuousServingEngine, PageAllocator,  # noqa: E402
                                 PlanLadder, ServingEngine, Telemetry, make_profile,
                                 steady, synth_requests)

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


def _eager(eng, reqs, stack, caches=None):
    """The batch through ``decode_fn`` called directly, position by
    position, on the kernel route, the stack adopted once
    (``ops.route_luts``): (tokens, last logits).  ``caches``: staged ones
    to start from (zeroed ones by default)."""
    cfg, dev = eng.cfg, eng.device
    step = decode_fn(cfg)
    if caches is None:
        caches = init_caches(cfg, eng.batch, eng.total, device=dev)
    prompts = np.zeros((eng.batch, PROMPT), np.int32)
    for i, r in enumerate(reqs):
        prompts[i, :len(r.tokens)] = r.tokens
    prompts = torch.from_numpy(prompts).to(dev)
    luts = None if stack is None else ops.route_luts(torch.as_tensor(stack, device=dev))
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


@pytest.mark.cuda
def test_a_swap_across_forms_keeps_the_one_capture(cuda, library):
    """Each layer's kernel is fixed when the engine adopts its stack and
    captured with the step.  On a W8A8 plan engine (every layer on the
    W8A8 kernel) a swap or an override that puts the uncomposed 8-bit
    probe on a layer raises ValueError before any write or launch; an
    engine built on the probe routes that layer to the direct kernel,
    whose replays equal the eager kernel route bit for bit on the probe
    and on a composed table put there, with one capture."""
    from repro_torch.sensitivity.profile import truncation_probe

    eng, ladder, reqs = _engine(cuda, library, 8)
    L, top = eng.cfg.n_layers, len(ladder) - 1
    eng.run_batch(reqs)
    probe = ladder.luts(0).copy()
    probe[0] = truncation_probe(8).lut
    live = eng._luts.clone()
    counts = (am.approx_matmul_w8.launches, am.approx_matmul_w8_direct.launches)
    with pytest.raises(ValueError, match="not composed"):
        eng.swap_plan(ladder.plan(top), probe)
    with pytest.raises(ValueError, match="not composed"):
        eng.run_batch(reqs, luts=probe)
    assert torch.equal(eng._luts, live) and eng.trace_count == 1
    assert (am.approx_matmul_w8.launches, am.approx_matmul_w8_direct.launches) == counts

    de = ServingEngine(eng.cfg, eng.params, batch=2, prompt_len=PROMPT,
                       gen_len=GEN, luts=probe, device=cuda)
    for stack in (None, ladder.luts(0)):   # the probe, then a composed table there
        de.run_batch(reqs, luts=stack)
        tokens, logits = _eager(de, reqs, probe if stack is None else stack)
        assert np.array_equal(de.last_tokens, tokens)
        assert torch.equal(de.static_step.logits, logits)
    assert de.static_step.launches_per_replay == {
        "approx_matmul_w8": 3 * (L - 1), "approx_matmul_w8_direct": 3}
    assert de.trace_count == 1


# ---------------------------------------------------------------------------
# the continuous engine's paged step
# ---------------------------------------------------------------------------
def _paged_engine(cuda, library, max_slots=2):
    cfg = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                              dtype="float32").with_approx_mlp(4)
    params = init_model(cfg, seed=0, device=cuda)
    compiled, exact_area, _ = load_mul_frontier(library)
    ladder = PlanLadder.build(compiled, cfg.n_layers, exact_area=exact_area, levels=4)
    eng = ContinuousServingEngine(cfg, params, max_slots=max_slots, prompt_len=8,
                                  gen_len=12, page_size=4, plan=ladder.plan(0),
                                  compiled=compiled, exact_area=exact_area,
                                  device=cuda)
    return eng, ladder


@pytest.mark.cuda
def test_paged_replay_equals_the_eager_paged_step(cuda, library):
    eng, ladder = _paged_engine(cuda, library, max_slots=3)
    eng.start()
    st = eng.static_step
    luts = torch.as_tensor(ladder.luts(len(ladder) - 1), device=cuda)
    st.load(luts)
    cfg, S, T = eng.cfg, eng.max_slots, eng.table_entries
    caches = init_paged_caches(cfg, S, eng.n_pages, eng.page_size, eng.total,
                               device=cuda)
    alloc = PageAllocator(eng.n_pages, eng.page_size)
    rng = np.random.default_rng(0)
    # slot 0 from step 0; slot 2 joins at 1 and leaves after 5 steps; slot 1
    # joins at 7 on the freed pages
    life = {0: (0, 19), 2: (1, 5), 1: (7, 12)}
    pos = {}
    for step in range(19):
        toks = np.zeros((S, 1), np.int32)
        p = np.zeros(S, np.int64)
        act = np.zeros(S, bool)
        tab = np.zeros((S, T), np.int64)
        for slot, (join, n) in life.items():
            if step == join:
                alloc.alloc(slot, eng.total)
                pos[slot] = 0
            if slot in pos:
                toks[slot, 0] = rng.integers(0, cfg.vocab_size)
                p[slot], act[slot] = pos[slot], True
                tab[slot] = alloc.padded_table(slot, T)
                pos[slot] += 1
                if pos[slot] == n:
                    alloc.free(slot)
                    del pos[slot]
        st.write(toks, p, act, tab)
        got = st.replay()
        args = [torch.from_numpy(a).to(cuda) for a in (toks, p, act, tab)]
        want, _ = decode_paged_fn(cfg)(cfg, eng.params, caches, *args, luts=luts)
        rows = torch.from_numpy(np.flatnonzero(act)).to(cuda)
        assert torch.equal(got[rows], want[rows]), step
    assert eng.trace_count == 1


@pytest.mark.cuda
def test_joins_leaves_and_preemptions_never_recapture(cuda, library):
    eng, ladder = _paged_engine(cuda, library)
    book = ClassBook.parse("gold:1e-12@250ms,batch:1e-12")
    prof = make_profile("spike", ticks=6, per_tick=5, prompt_len=8, gen_len=12,
                        class_mix=(("gold", 0.4), ("batch", 0.6)),
                        prompt_dist=("uniform", 3, 8))
    eng.start()
    st = eng.static_step
    ptrs = [st.tok.data_ptr(), st.pos.data_ptr(), st.active.data_ptr(),
            st.tables.data_ptr(), st.logits.data_ptr(), st.luts.data_ptr()]
    ptrs += [c[k].data_ptr() for c in st.caches for k in sorted(c)]
    tel = eng.serve(prof, scheduler=ClassScheduler(book, ladder, shadow_every=4),
                    telemetry=Telemetry(), seed=1, steps_per_tick=5)
    assert tel.preemptions >= 1 and len(eng.completions) == prof.total_requests
    assert eng.static_step is st and eng.trace_count == 1
    now = [st.tok.data_ptr(), st.pos.data_ptr(), st.active.data_ptr(),
           st.tables.data_ptr(), st.logits.data_ptr(), st.luts.data_ptr()]
    now += [c[k].data_ptr() for c in st.caches for k in sorted(c)]
    assert now == ptrs
    # the same requests in a pool that never preempts, at the same
    # max_slots: a larger page pool, the same rows
    roomy, _ = _paged_engine(cuda, library)
    roomy.serve(prof, scheduler=ClassScheduler(ClassBook.parse("gold:1e-12,batch:1e-12"),
                                               ladder, shadow_every=4),
                telemetry=Telemetry(), seed=1, steps_per_tick=5)
    assert roomy.preemption_count == 0
    for rid, gen in roomy.completions.items():
        assert np.array_equal(eng.completions[rid], gen), rid


@pytest.mark.cuda
def test_paged_save_and_restore_round_trip_the_pools(cuda, library):
    eng, _ = _paged_engine(cuda, library)
    eng.start()
    st = eng.static_step
    gen = torch.Generator(device=cuda).manual_seed(0)
    for c in st.caches:
        for buf in c.values():
            buf.copy_(torch.randn(buf.shape, generator=gen, device=cuda))
    want = [{k: v.clone() for k, v in c.items()} for c in st.caches]
    st.save_caches()
    st.reset()
    assert all(float(v.abs().max()) == 0 for c in st.caches for v in c.values())
    st.restore_caches()
    for c, w in zip(st.caches, want):
        assert set(c) == {"kp", "vp"}
        assert all(torch.equal(c[k], w[k]) for k in c)


# ---------------------------------------------------------------------------
# the other decoder-only families (reduced, bf16): MoE, MLA, SSM, RWKV
# ---------------------------------------------------------------------------
def _family_stack(n_layers: int) -> np.ndarray:
    ex = np.arange(16)[:, None] * np.arange(16)[None, :]
    return np.stack([ex if i % 2 == 0 else ex & ~3
                     for i in range(n_layers)]).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x7b",
                                  "hymba-1.5b", "rwkv6-3b"])
def test_family_replay_equals_the_eager_step(cuda, arch):
    """The fixed engine's captured step against ``decode_fn`` called
    eagerly on the kernel route: tokens and final logits bit for bit,
    captured once.  MoE's dispatch (sorts, counts, gathers) keeps every
    shape static and reads nothing back; MLA writes its compressed cache,
    the SSM and RWKV their recurrent state, in place."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="bfloat16").with_approx_mlp(4)
    params = init_model(cfg, seed=0, device=cuda)
    stack = _family_stack(cfg.n_layers)
    eng = ServingEngine(cfg, params, batch=2, prompt_len=PROMPT, gen_len=GEN,
                        luts=stack, device=cuda)
    reqs = synth_requests(steady(1, 2, prompt_len=PROMPT, gen_len=GEN),
                          cfg.vocab_size, 0)[0]
    am.approx_matmul_w4.launches = 0
    eng.run_batch(reqs)
    eng.run_batch(reqs)
    tokens, logits = _eager(eng, reqs, stack)
    assert np.array_equal(eng.last_tokens, tokens)
    assert torch.equal(eng.static_step.logits, logits)
    assert eng.trace_count == 1
    per_replay = eng.static_step.launches_per_replay.get("approx_matmul_w4", 0)
    shared = cfg.moe.n_shared if cfg.moe is not None else 1
    want = 0 if arch in ("mixtral-8x7b", "rwkv6-3b") else 3 * shared * cfg.n_layers
    assert per_replay == want


@pytest.mark.cuda
def test_paged_family_replay_equals_the_eager_paged_step(cuda):
    """Reduced deepseek-v2-lite's paged step (MLA page pools, MoE
    dropless) captured once, against the eager paged step."""
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b", reduced=True),
                              dtype="bfloat16").with_approx_mlp(4)
    params = init_model(cfg, seed=0, device=cuda)
    stack = _family_stack(cfg.n_layers)
    eng = ContinuousServingEngine(cfg, params, max_slots=3, prompt_len=8,
                                  gen_len=8, page_size=4, luts=stack, device=cuda)
    eng.start()
    st = eng.static_step
    S, T = eng.max_slots, eng.table_entries
    caches = init_paged_caches(cfg, S, eng.n_pages, eng.page_size, eng.total,
                               device=cuda)
    alloc = PageAllocator(eng.n_pages, eng.page_size)
    luts = torch.as_tensor(stack, device=cuda)
    rng = np.random.default_rng(0)
    pos = {}
    for step in range(12):
        toks = np.zeros((S, 1), np.int32)
        p = np.zeros(S, np.int64)
        act = np.zeros(S, bool)
        tab = np.zeros((S, T), np.int64)
        for slot, join in ((0, 0), (2, 3)):
            if step == join:
                alloc.alloc(slot, eng.total)
                pos[slot] = 0
            if slot in pos:
                toks[slot, 0] = rng.integers(0, cfg.vocab_size)
                p[slot], act[slot] = pos[slot], True
                tab[slot] = alloc.padded_table(slot, T)
                pos[slot] += 1
        st.write(toks, p, act, tab)
        got = st.replay()
        args = [torch.from_numpy(a).to(cuda) for a in (toks, p, act, tab)]
        want, _ = decode_paged_fn(cfg)(cfg, eng.params, caches, *args, luts=luts)
        rows = torch.from_numpy(np.flatnonzero(act)).to(cuda)
        assert torch.equal(got[rows], want[rows]), step
    assert eng.trace_count == 1


@pytest.mark.cuda
def test_command_r_w8a8_is_refused_before_any_launch(cuda):
    """command-r-plus-104b's ``w2`` contracts over d_ff = 33,792, past
    W8A8's overflow-free depth 29,140: the forward and the engine refuse
    the stack before any kernel launches.  Checked on a 1-layer cut with
    a small vocabulary, at full width."""
    from repro_torch.models.lm import forward_lm
    from repro_torch.precision.compose import tile_to_width

    cfg = dataclasses.replace(get_config("command-r-plus-104b"), n_layers=1,
                              vocab_size=256).with_approx_mlp(8)
    params = init_model(cfg, seed=0, device=cuda)
    ex = np.arange(16)[:, None] * np.arange(16)[None, :]
    stack = tile_to_width(ex)[None].astype(np.int32)
    am.approx_matmul_w8.launches = 0
    with pytest.raises(ValueError, match="33792 exceeds the overflow-free"):
        forward_lm(cfg, params, {"tokens": [[1, 2, 3]]}, lut=stack, device=cuda)
    with pytest.raises(ValueError, match="33792 exceeds the overflow-free"):
        ServingEngine(cfg, params, batch=1, prompt_len=2, gen_len=2, luts=stack,
                      device=cuda)
    assert am.approx_matmul_w8.launches == 0


# ---------------------------------------------------------------------------
# training's gradient guard and the encoder–decoder family's warm-up
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_a_loss_on_parameters_that_require_grad_refuses_the_kernels(cuda):
    """``lm_loss(..., backend="auto")`` on card parameters that require
    grad raises before any launch (the kernels have no backward, so their
    outputs would cut the gradient); the plain route differentiates, and
    a forward under ``no_grad`` or on parameters that do not require grad
    still launches flash."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.train import DataState, synth_batch

    cfg = get_config("stablelm-1.6b", reduced=True)
    params = init_model(cfg, seed=0, device=cuda)
    batch = synth_batch(cfg, 2, 16, DataState(0, 0), device=cuda)
    live = {k: v for k, v in params.items()}
    live["embed"] = params["embed"].detach().requires_grad_(True)
    n = fa.flash_attention.launches
    with pytest.raises(RuntimeError, match="require grad"):
        lm.lm_loss(cfg, live, batch, backend="auto", device=cuda)
    assert fa.flash_attention.launches == n
    loss = lm.lm_loss(cfg, live, batch, backend="ref", device=cuda)
    (g,) = torch.autograd.grad(loss, [live["embed"]])
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    with torch.no_grad():
        lm.lm_loss(cfg, live, batch, backend="auto", device=cuda)
    lm.lm_loss(cfg, params, batch, backend="auto", device=cuda)
    assert fa.flash_attention.launches == n + 2 * cfg.n_layers


@pytest.mark.cuda
def test_whisper_warmup_stages_cross_kv_under_the_captured_graph(cuda):
    """Reduced whisper in the fixed engine: the warm-up writes each layer's
    cross K/V in place into the buffers the captured step reads, after
    the reset that zeroes them, for every batch; the graph is captured
    once, and a batch's tokens and final logits equal the eager
    ``decode_step_encdec`` route's bit for bit, for two sets of frames."""
    from repro_torch.models import encdec
    from repro_torch.train import DataState, synth_batch

    cfg = get_config("whisper-tiny", reduced=True)
    params = init_model(cfg, seed=0, device=cuda)
    frames = {"f": synth_batch(cfg, 2, 1, DataState(0, 0), device=cuda)["frames"]}
    eng = ServingEngine(cfg, params, batch=2, prompt_len=PROMPT, gen_len=GEN,
                        device=cuda, warmup_caches=lambda c: encdec.prefill_cross(
                            cfg, params, frames["f"], c))
    reqs = synth_requests(steady(1, 2, prompt_len=PROMPT, gen_len=GEN),
                          cfg.vocab_size, 0)[0]
    addrs = None
    for seed in (0, 1):
        frames["f"] = synth_batch(cfg, 2, 1, DataState(seed, 0), device=cuda)["frames"]
        eng.run_batch(reqs)
        st = eng.static_step
        now = [c[k].data_ptr() for c in st.caches for k in ("k", "v", "xk", "xv")]
        assert addrs is None or now == addrs
        addrs = now
        want = encdec.prefill_cross(cfg, params, frames["f"],
                                    encdec.init_encdec_caches(cfg, 2, eng.total,
                                                              device=cuda))
        assert all(torch.equal(c["xk"], w["xk"]) and torch.equal(c["xv"], w["xv"])
                   for c, w in zip(st.caches, want))
        tokens, logits = _eager(eng, reqs, None, caches=want)
        assert np.array_equal(eng.last_tokens, tokens)
        assert torch.equal(st.logits, logits)
    assert eng.trace_count == 1
