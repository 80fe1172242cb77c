"""PyTorch port: continuous batching against the JAX package's.

The page allocator, slot pool, weighted-fair queues and load shapes are
own copies of the reference's modules; each case runs the same script on
both and requires the same results.  The paged decode step is held
against ``repro.models.lm.decode_step_paged`` on the same converted
weights, through joins, leaves and page reuse: in f32 at 1e-4 and in bf16
at 8e-2 (the reference compiled with ``xla_allow_excess_precision`` off,
as in ``tests/test_torch_models.py``), on reduced qwen3-4b and on a
windowed config built from the fields of reduced gemma3-1b, so that the
ring path runs.  The engine scenarios of ``tests/test_continuous.py`` run
through both engines in f32 on that windowed config: the same completions
for every rid, the same preemption schedule, the same telemetry counts,
the same provenance ranges, and one capture (trace) on each side.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import sensitivity as jax_sens  # noqa: E402
from repro import serving as jax_serving  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.arith import benchmark  # noqa: E402
from repro.library.compile import load_mul_frontier as jax_load  # noqa: E402
from repro.models import init_model as jax_init  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.obs import provenance as jax_prov  # noqa: E402
from repro.obs import requests as jax_requests  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro.serving import kvcache as jax_kv  # noqa: E402
from repro.serving import loadgen as jax_loadgen  # noqa: E402
from repro.serving import slots as jax_slots  # noqa: E402
from repro_torch import sensitivity as port_sens  # noqa: E402
from repro_torch import serving as port_serving  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.library.compile import load_mul_frontier  # noqa: E402
from repro_torch.models import (decode_fn, decode_paged_fn, init_caches,  # noqa: E402
                                init_paged_caches)
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.obs import provenance as port_prov  # noqa: E402
from repro_torch.obs import requests as port_requests  # noqa: E402
from repro_torch.obs import trace as port_trace  # noqa: E402
from repro_torch.serving import kvcache as port_kv  # noqa: E402
from repro_torch.serving import loadgen as port_loadgen  # noqa: E402
from repro_torch.serving import slots as port_slots  # noqa: E402
from repro_torch.serving.engine import ContinuousServingEngine, PagedStaticStep  # noqa: E402
from repro_torch.serving.staggered import decode_alone, decode_staggered  # noqa: E402
from test_serving import fill_library, trunc_mul2, zero_mul2  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 8e-2}


class _Side:
    """One package's modules, under the names the scripts use."""

    def __init__(self, serving, sens, kv, slots, loadgen, prov, requests,
                 trace):
        self.serving, self.sens, self.kv, self.slots = serving, sens, kv, slots
        self.loadgen, self.prov, self.requests, self.trace = (
            loadgen, prov, requests, trace)


SIDES = {"ref": _Side(jax_serving, jax_sens, jax_kv, jax_slots, jax_loadgen,
                      jax_prov, jax_requests, jax_trace),
         "port": _Side(port_serving, port_sens, port_kv, port_slots,
                       port_loadgen, port_prov, port_requests, port_trace)}


def _both(fn):
    return {name: fn(side) for name, side in SIDES.items()}


def _raises(fn):
    try:
        return ("ok", fn())
    except Exception as e:      # the exception's type and text are compared
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# page allocator, slots, weighted-fair queues, load shapes
# ---------------------------------------------------------------------------
def _alloc_conservation(s):
    a = s.kv.PageAllocator(n_pages=6, page_size=4)
    t1, t2 = a.alloc(1, 10), a.alloc(2, 5)
    a.check_invariants()
    out = [t1, t2, a.used_pages, a.free_pages, a.free(1)]
    a.check_invariants()
    t3 = a.alloc(3, 10)
    a.check_invariants()
    return out + [t3, t3 == t1, s.kv.SCRATCH_PAGE not in t1 + t2]


def _alloc_errors(s):
    a = s.kv.PageAllocator(n_pages=4, page_size=4)
    a.alloc(7, 4)
    out = [_raises(lambda: a.alloc(7, 4)), _raises(lambda: a.free(8)),
           _raises(lambda: s.kv.PageAllocator(0, 4))]
    a.check_invariants()
    return out


def _alloc_out_of_pages(s):
    a = s.kv.PageAllocator(n_pages=2, page_size=4)
    a.alloc(1, 8)
    out = [a.can_alloc(1), _raises(lambda: a.alloc(2, 1))]
    a.check_invariants()
    out += [a.free_pages, a.holds(2)]
    a.free(1)
    return out + [a.can_alloc(8)]


def _padded_table(s):
    a = s.kv.PageAllocator(n_pages=4, page_size=4)
    a.alloc(1, 6)
    row, empty = a.padded_table(1, 4), a.padded_table(None, 4)
    return [row.dtype.name, row.tolist(), a.table(1), empty.tolist(),
            _raises(lambda: a.padded_table(1, 1))]


def _seq(s, rid, cls="std", prompt_len=4, gen_len=4):
    return s.slots.SeqState(rid=rid, cls=cls,
                            prompt=np.arange(prompt_len, dtype=np.int32),
                            gen_len=gen_len, submitted_t=0.0)


def _seqstate(s):
    q = _seq(s, 0, prompt_len=3, gen_len=2)
    outs, fed = [], []
    while not q.done:
        fed.append(q.next_token())
        outs.append(q.advance(100 + q.pos))
    q.admitted_t, q.first_token_t, q.suspended_s = 0.5, 1.0, 0.25
    return outs, fed, q.generated, q.n_tokens, q.breakdown(3.0)


def _pick_victim(s):
    pool = s.slots.SlotPool(4)
    prio = {"gold": 0, "std": 1, "batch": 2}
    for i, (rid, cls) in enumerate([(11, "batch"), (5, "std"), (12, "batch"),
                                    (2, "gold")]):
        pool.place(i, _seq(s, rid, cls))
    out = []
    for evict in (2, 0, 1):
        out.append(pool.pick_victim(lambda c: prio[c], below=0))
        pool.evict(evict)
    out.append(pool.pick_victim(lambda c: prio[c], below=1))
    return out + [pool.n_active, pool.occupancy, pool.free_slot()]


def _weighted_fair(s):
    q = s.slots.WeightedFairQueues(("gold", "batch"), {"gold": 2, "batch": 1})
    for i in range(30):
        q.push("gold", f"g{i}")
        q.push("batch", f"b{i}")
    picks = [q.pick() for _ in range(30)]
    f = s.slots.WeightedFairQueues(("gold", "batch"))
    f.push("gold", 1)
    f.push("batch", 2)
    first = f.pick(admissible=lambda it: it != 1)
    f.push("gold", 3)
    f.push_front("gold", 99)
    return picks, first, f.peek("gold"), len(f), f.pick(), f.depth


def _load_shapes(s):
    lg = s.loadgen
    out = [lg.parse_prompt_dist("uniform:4-16", 16),
           lg.parse_prompt_dist("bimodal:2-8", 8)]
    out += [_raises(lambda b=b: lg.parse_prompt_dist(b, 16))
            for b in ("gauss:4-16", "uniform:0-16", "uniform:9-8",
                      "uniform:4-17", "uniform")]
    profs = [lg.ramp(5, 7), lg.spike(6, 2, 10, at=3, width=1), lg.spike(8, 1, 5),
             lg.make_profile("steady", ticks=3, per_tick=5, prompt_len=16,
                             gen_len=4, prompt_dist=("bimodal", 3, 16)),
             lg.make_profile("ramp", ticks=4, per_tick=4, prompt_len=8,
                             gen_len=8, class_mix=(("gold", 0.4), ("batch", 0.6)),
                             prompt_dist=("uniform", 3, 8)),
             lg.make_profile("spike", ticks=6, per_tick=5)]
    out.append(_raises(lambda: lg.make_profile("wave", ticks=2, per_tick=1)))
    for p in profs:
        out.append((p.name, p.arrivals, p.total_requests))
        out.append([[(r.rid, r.tokens.tolist(), r.arrived_tick, r.qos_class)
                     for r in tick] for tick in lg.synth_requests(p, 128, seed=9)])
    return out


HOST_CASES = [_alloc_conservation, _alloc_errors, _alloc_out_of_pages,
              _padded_table, _seqstate, _pick_victim, _weighted_fair,
              _load_shapes]


@pytest.mark.parametrize("case", HOST_CASES, ids=[c.__name__[1:] for c in HOST_CASES])
def test_host_bookkeeping_matches_reference(case):
    got = _both(case)
    assert got["port"] == got["ref"]
    if case is _alloc_conservation:
        assert got["port"][-2:] == [True, True]
    if case is _weighted_fair:
        assert [c for c, _ in got["port"][0]].count("gold") == 20


# ---------------------------------------------------------------------------
# the paged decode step
# ---------------------------------------------------------------------------
def _configs(arch: str, dtype: str, approx: bool):
    """The reference's reduced config and the port's, in ``dtype``.  The
    windowed one is built from the fields of reduced gemma3-1b (global and
    16-token local layers in turn, tied embeddings)."""
    cj = dataclasses.replace(jax_config(arch, reduced=True), dtype=dtype)
    ct = ModelConfig(**{f.name: getattr(cj, f.name)
                        for f in dataclasses.fields(ModelConfig)})
    if approx:
        cj, ct = cj.with_approx_mlp(), ct.with_approx_mlp()
    return cj, ct


def _weights(cj):
    params = jax_init(cj, jax.random.PRNGKey(0))
    return params, params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


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


SLOTS, PAGE, TOTAL = 3, 4, 20


def _schedule(vocab: int):
    """Step inputs through joins, a leave and page reuse: request A holds
    slot 0 from step 0; B joins slot 2 at step 1 and leaves after 6 steps;
    C joins slot 1 at step 8 on B's freed pages, which still hold B's KV.
    Past 16 positions the windowed layers' rings wrap."""
    alloc = port_kv.PageAllocator(SLOTS * TOTAL // PAGE, PAGE)
    T = TOTAL // PAGE
    plan = {"A": (0, 0, 19), "B": (2, 1, 6), "C": (1, 8, 11)}
    rng = np.random.default_rng(3)
    pos = {}
    steps = []
    for step in range(19):
        toks = np.zeros((SLOTS, 1), np.int32)
        p = np.zeros(SLOTS, np.int64)
        act = np.zeros(SLOTS, bool)
        tab = np.zeros((SLOTS, T), np.int64)
        for rid, (slot, join, n) in plan.items():
            if step == join:
                alloc.alloc(rid, TOTAL)
                pos[rid] = 0
            if rid in pos and join <= step < join + n:
                toks[slot, 0] = rng.integers(0, vocab)
                p[slot], act[slot] = pos[rid], True
                tab[slot] = alloc.padded_table(rid, T)
                pos[rid] += 1
            if rid in pos and step == join + n - 1:
                alloc.free(rid)
                del pos[rid]
        steps.append((toks, p, act, tab))
    return steps


def _stack(approx: bool):
    if not approx:
        return None
    ex = np.arange(16)[:, None] * np.arange(16)[None, :]
    return np.stack([ex, ex & ~3]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approx", [False, True], ids=["exact", "lut"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-1b"])
def test_decode_step_paged_matches_reference(arch, approx, dtype):
    cj, ct = _configs(arch, dtype, approx)
    params, pt = _weights(cj)
    lut = _stack(approx)
    jl = None if lut is None else jnp.asarray(lut)
    tl = None if lut is None else torch.from_numpy(lut)
    n_pages = SLOTS * TOTAL // PAGE
    jc = jlm.init_paged_caches(cj, SLOTS, n_pages, PAGE, TOTAL)
    tc = init_paged_caches(ct, SLOTS, n_pages, PAGE, TOTAL, device="cpu")
    kinds = {tuple(sorted(c)) for c in tc}
    assert kinds == ({("kp", "vp")} if arch == "qwen3-4b"
                     else {("kp", "vp"), ("k", "v")})

    def jstep(caches, tok, pos, act, tab):
        return jlm.decode_step_paged(cj, params, caches, tok, pos, act, tab,
                                     luts=jl)

    jstep = _jit(jstep, dtype)
    worst = 0.0
    for toks, pos, act, tab in _schedule(cj.vocab_size):
        lj, jc = jstep(jc, jnp.asarray(toks), jnp.asarray(pos, jnp.int32),
                       jnp.asarray(act), jnp.asarray(tab, jnp.int32))
        lt, _ = decode_paged_fn(ct)(ct, pt, tc, torch.from_numpy(toks),
                                    torch.from_numpy(pos), torch.from_numpy(act),
                                    torch.from_numpy(tab), luts=tl)
        assert lt.dtype == torch.float32 and lt.shape == (SLOTS, cj.vocab_size)
        worst = max(worst, float(np.abs(lt.numpy()[act]
                                        - np.asarray(lj)[act]).max()))
    assert worst < TOL[dtype], worst


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-1b"])
def test_paged_decode_matches_dense(arch):
    """Two requests staggered into a 3-slot pool, paged KV, against each
    decoded alone in a dense cache: the same tokens (the reference's
    test_paged_decode_matches_dense, on the port)."""
    _, ct = _configs(arch, "bfloat16", False)
    from repro_torch.models import init_model
    params = init_model(ct, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, ct.vocab_size, n).astype(np.int32) for n in (12, 7)]
    joins = [0, 3]
    total, page_size, slots = 16, 4, 3
    n_pages = slots * (total // page_size) + 1

    refs = []
    for p in prompts:
        caches = init_caches(ct, 1, total, device="cpu")

        def dense(tok, t, caches=caches):
            return decode_fn(ct)(ct, params, caches,
                                 torch.tensor([[tok]], dtype=torch.int32), t)[0][0]

        refs.append(decode_alone(dense, p, total)[0])

    caches = init_paged_caches(ct, slots, n_pages, page_size, total, device="cpu")

    def paged(tok, pos, act, tab):
        return decode_paged_fn(ct)(ct, params, caches, torch.from_numpy(tok),
                                   torch.from_numpy(pos), torch.from_numpy(act),
                                   torch.from_numpy(tab))[0]

    outs, _ = decode_staggered(paged, prompts, joins, slots=slots, total=total,
                               page_size=page_size, n_pages=n_pages)
    for i, ref in enumerate(refs):
        assert outs[i] == ref, f"request {i} diverged from dense decode"


def test_paged_static_step_matches_eager():
    """The step over fixed buffers, written with ``write`` each step,
    against ``decode_step_paged`` called on fresh tensors: the same logits
    bit for bit, and the same caches."""
    _, ct = _configs("gemma3-1b", "float32", True)
    from repro_torch.models import init_model
    params = init_model(ct, seed=0, device="cpu")
    luts = torch.from_numpy(_stack(True))
    n_pages = SLOTS * TOTAL // PAGE
    st = PagedStaticStep(ct, params, slots=SLOTS, n_pages=n_pages, page_size=PAGE,
                         table_entries=TOTAL // PAGE, total=TOTAL, luts=luts,
                         width_map=None, backend="auto", device=torch.device("cpu"))
    caches = init_paged_caches(ct, SLOTS, n_pages, PAGE, TOTAL, device="cpu")
    addrs = [st.tok.data_ptr(), st.pos.data_ptr(), st.tables.data_ptr()]
    for toks, pos, act, tab in _schedule(ct.vocab_size):
        st.write(toks, pos, act, tab)
        got = st.replay()
        want, _ = decode_paged_fn(ct)(ct, params, caches, torch.from_numpy(toks),
                                      torch.from_numpy(pos), torch.from_numpy(act),
                                      torch.from_numpy(tab), luts=luts)
        assert torch.equal(got, want)
    for mine, theirs in zip(st.caches, caches):
        assert all(torch.equal(mine[k], theirs[k]) for k in mine)
    assert [st.tok.data_ptr(), st.pos.data_ptr(), st.tables.data_ptr()] == addrs
    # save and restore round-trip the rings and the page pools
    st.save_caches()
    before = [{k: v.clone() for k, v in c.items()} for c in st.caches]
    st.reset()
    st.restore_caches()
    for c, b in zip(st.caches, before):
        assert all(torch.equal(c[k], b[k]) for k in c)


def test_paged_caches_refuse_other_families():
    """The recurrent families (RWKV, the hybrid SSM) have no positional
    cache to page: refused with the reference's words."""
    for arch in ("rwkv6-3b", "hymba-1.5b"):
        cj = jax_config(arch, reduced=True)
        ct = ModelConfig(**{f.name: getattr(cj, f.name)
                            for f in dataclasses.fields(ModelConfig)})
        with pytest.raises(ValueError) as want:
            jlm.init_paged_caches(cj, 2, 4, 4, 8)
        with pytest.raises(ValueError, match="recurrent") as got:
            init_paged_caches(ct, 2, 4, 4, 8, device="cpu")
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the engine, end to end on both sides (f32, windowed config)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("contlib")
    fill_library(root / "lib", [benchmark("mul_i4"), trunc_mul2(), zero_mul2()])
    cj, ct = _configs("gemma3-1b", "float32", True)
    params, pt = _weights(cj)
    out = {"root": root}
    for name, side, load, cfg, p in (("ref", SIDES["ref"], jax_load, cj, params),
                                     ("port", SIDES["port"], load_mul_frontier, ct, pt)):
        compiled, exact_area, _ = load(root / "lib")
        ladder = side.serving.PlanLadder.build(compiled, cfg.n_layers,
                                               exact_area=exact_area, levels=4)
        out[name] = (cfg, p, compiled, exact_area, ladder)
    assert [p.plan_id for p in out["port"][4].plans] == \
        [p.plan_id for p in out["ref"][4].plans]
    return out


def _engine(setup, name, *, max_slots=2, gen_len=8, level=0, **kw):
    cfg, params, compiled, exact_area, ladder = setup[name]
    extra = {"device": "cpu"} if name == "port" else {}
    return SIDES[name].serving.ContinuousServingEngine(
        cfg, params, max_slots=max_slots, prompt_len=8, gen_len=gen_len,
        page_size=4, plan=ladder.plan(level), compiled=compiled,
        exact_area=exact_area, **extra, **kw)


def _profile(s, kind="ramp", ticks=4, per_tick=4, gen_len=8, class_mix=None,
             prompt_dist=("bimodal", 3, 8)):
    return s.loadgen.make_profile(kind, ticks=ticks, per_tick=per_tick,
                                  prompt_len=8, gen_len=gen_len,
                                  class_mix=class_mix, prompt_dist=prompt_dist)


def _counts(d):
    """The integer leaves of a telemetry summary (times and drifts out)."""
    if isinstance(d, dict):
        out = {k: _counts(v) for k, v in d.items()}
        return {k: v for k, v in out.items() if v not in (None, {})}
    return d if isinstance(d, int) else None


def _completions(eng):
    return {rid: g.tolist() for rid, g in sorted(eng.completions.items())}


def _slo_stack(s, ladder, spec="gold:1e9@250ms,batch:1e9"):
    book = s.sens.ClassBook.parse(spec)
    scheduler = s.sens.ClassScheduler(book, ladder, shadow_every=4)
    # an unreachable latency target walks the ladder up one level a step
    # on any machine, so both sides decode on the same levels
    controller = s.serving.QoSController(ladder, s.serving.ControllerConfig(
        target_ms_per_step=1e-6, drift_budget=1e9, patience=1, cooldown=0,
        shadow_every=4, ewma_alpha=1.0))
    return scheduler, controller


class _StubHealth:
    def __init__(self):
        self.noted, self.steps = [], 0

    def observe_step(self, **kw):
        self.steps += 1
        return {"state": "ok"}

    def note_event(self, name, **kw):
        self.noted.append((name, kw.get("step"), kw.get("rid")))

    def record_crash(self, e):
        pass


def _preemption_run(setup, name, *, max_slots=2, spec="gold:1e9@250ms,batch:1e9",
                    controller=True, health=None):
    s = SIDES[name]
    ladder = setup[name][4]
    scheduler, ctrl = _slo_stack(s, ladder, spec)
    prof = _profile(s, kind="spike", ticks=6, per_tick=5, gen_len=12,
                    class_mix=(("gold", 0.4), ("batch", 0.6)),
                    prompt_dist=("uniform", 3, 8))
    eng = _engine(setup, name, max_slots=max_slots, gen_len=12)
    tel = eng.serve(prof, controller=ctrl if controller else None,
                    scheduler=scheduler, telemetry=s.serving.Telemetry(), seed=1,
                    steps_per_tick=5, health=health)
    preempted = [(e["step"], e["preempted_rid"]) for e in tel.events
                 if "preempted_rid" in e]
    return eng, tel, prof, preempted


def _assert_same_serve(got):
    (eng_j, tel_j), (eng_p, tel_p) = got["ref"], got["port"]
    assert _completions(eng_p) == _completions(eng_j)
    assert _counts(tel_p.summary()) == _counts(tel_j.summary())
    assert eng_p.trace_count == eng_j.trace_count == 1
    eng_p._alloc.check_invariants()
    assert eng_p._alloc.used_pages == 0


def test_continuous_completes_all_and_matches_reference(setup):
    def run(name):
        s = SIDES[name]
        prof = _profile(s)
        eng = _engine(setup, name)
        tel = eng.serve(prof, telemetry=s.serving.Telemetry(), seed=0)
        return eng, tel

    got = {name: run(name) for name in SIDES}
    _assert_same_serve(got)
    eng, tel = got["port"]
    prof = _profile(SIDES["port"])
    assert len(eng.completions) == prof.total_requests
    assert all(len(g) == prof.gen_len for g in eng.completions.values())
    s = tel.summary()
    assert s["requests"] == prof.total_requests and s["steps"] > prof.gen_len
    again = _engine(setup, "port")
    again.serve(prof, telemetry=port_serving.Telemetry(), seed=0)
    assert _completions(again) == _completions(eng)


def test_out_of_pages_blocks_admission_and_matches_reference(setup):
    def run(name):
        s = SIDES[name]
        eng = _engine(setup, name, n_pages=5)
        blocked = []

        def on_step(e, step):
            e._alloc.check_invariants()
            if e.queue_depth > 0 and e._pool.n_active < e.max_slots:
                blocked.append(step)

        tel = eng.serve(_profile(s, kind="steady", ticks=2, per_tick=3),
                        telemetry=s.serving.Telemetry(), seed=0, on_step_end=on_step)
        return (eng, tel), blocked

    got = {name: run(name) for name in SIDES}
    _assert_same_serve({n: g[0] for n, g in got.items()})
    assert got["port"][1] and got["port"][1] == got["ref"][1]
    assert len(got["port"][0][0].completions) == 6


def test_slo_preemption_schedule_matches_reference(setup):
    got = {name: _preemption_run(setup, name, health=_StubHealth())
           for name in SIDES}
    _assert_same_serve({n: (g[0], g[1]) for n, g in got.items()})
    eng, tel, prof, preempted = got["port"]
    assert preempted and preempted == got["ref"][3]
    assert eng.preemption_count == len(preempted) == tel.summary()["preemptions"]
    s = tel.summary()
    assert "preemptions" not in s["classes"].get("gold", {})
    assert s["classes"]["gold"]["p95_ttft_ms"] > 0
    # every resume noted into the health plane, paired with its preempt,
    # and the same control events on both sides
    health = {n: g[0]._health for n, g in got.items()}
    assert health["port"].noted == health["ref"].noted
    resumes = sorted(rid for n, _, rid in health["port"].noted if n == "serve.resume")
    assert resumes == sorted(rid for _, rid in preempted)
    assert health["port"].steps == s["steps"]


def test_preempted_request_resumes_uncorrupted(setup):
    """Every level pinned exact: a 2-slot pool that preempts gives each
    request the tokens of an 8-slot pool that never does, on both sides."""
    spec = "gold:1e-12@250ms,batch:1e-12"
    got = {}
    for name in SIDES:
        tight = _preemption_run(setup, name, spec=spec, controller=False)
        roomy = _preemption_run(setup, name, max_slots=8, spec=spec, controller=False)
        assert tight[1].preemptions >= 1 and roomy[0].preemption_count == 0
        assert _completions(tight[0]) == _completions(roomy[0])
        got[name] = _completions(tight[0])
    assert got["port"] == got["ref"]


def test_lifecycle_and_provenance_match_reference(setup, tmp_path):
    """A traced preemption run: every request's req.* chain complete, the
    ledger gap-free, and the same provenance ranges and cost report
    counts as the reference's."""
    out = {}
    for name, s in SIDES.items():
        trace_dir = tmp_path / name
        s.trace.configure(trace_dir, process_tag="serve")
        try:
            eng, tel, prof, preempted = _preemption_run(setup, name)
        finally:
            s.trace.reset()
            s.prov._ledgers.clear()
        assert preempted and eng.trace_count == 1
        tls = s.requests.build_timelines(s.trace.read_trace(trace_dir))
        assert len(tls) == prof.total_requests
        assert not {t.rid: t.problems for t in tls.values() if not t.complete}
        rep = s.prov.audit(s.prov.read_ledger(trace_dir))
        assert rep["n_complete"] == rep["n_done"] == prof.total_requests
        assert rep["n_failed"] == 0
        ranges = {rid: [(r["t0"], r["t1"], r["plan"], r["level"], r["drift_samples"])
                        for r in req["ranges"]]
                  for rid, req in sorted(rep["requests"].items())}
        out[name] = (ranges, sorted((t.rid, t.preempts, t.steps) for t in tls.values()),
                     _completions(eng))
    assert out["port"] == out["ref"]
    from repro.obs.costs import cost_report as jax_costs
    from repro_torch.obs.costs import cost_report
    reps = {"ref": jax_costs(jax_prov.read_ledger(tmp_path / "ref")),
            "port": cost_report(port_prov.read_ledger(tmp_path / "port"))}
    assert reps["port"]["reconciled"] and _counts(reps["port"]) == _counts(reps["ref"])
    assert reps["port"]["totals"]["mlp_macs"] > 0


def test_prov_range_seals_on_plan_change_and_preempt(tmp_path):
    class _Plan:
        def __init__(self, pid):
            self.plan_id, self.choices = pid, []

    eng = ContinuousServingEngine.__new__(ContinuousServingEngine)
    eng._provenance = port_prov.ProvenanceLedger(tmp_path, tag="w")
    eng._prov_open = {}
    eng._width_map = None
    seq = port_slots.SeqState(rid=1, cls="gold", prompt=np.array([1, 2], np.int32),
                              gen_len=6, submitted_t=0.0)
    p0, p1 = _Plan("p0"), _Plan("p1")
    eng._prov_extend(seq, 0, p0, 0)
    eng._prov_extend(seq, 1, p0, 0)
    eng._prov_extend(seq, 2, p1, 1)
    eng._prov_close(1)
    for i in (3, 4, 5):
        eng._prov_extend(seq, i, p1, 1)
    eng._prov_close(1)
    eng._provenance.record_done(rid=1, cls="gold", gen_len=6, steps=7, preempts=1)
    eng._provenance.close()
    req = port_prov.audit(port_prov.read_ledger(tmp_path))["requests"][1]
    assert req["complete"], req["problems"]
    assert [(r["t0"], r["t1"], r["plan"], r["level"]) for r in req["ranges"]] \
        == [(0, 2, "p0", 0), (2, 3, "p1", 1), (3, 6, "p1", 1)]


def test_router_affinity_and_per_replica_plans_match_reference(setup):
    root = setup["root"]

    def run(name):
        s = SIDES[name]
        ladder = setup[name][4]
        with pytest.raises(ValueError, match="at least 2"):
            s.serving.ReplicaRouter([s.serving.Replica("solo", _engine(setup, name))])
        router = s.serving.ReplicaRouter([
            s.serving.Replica("gold-exact", _engine(setup, name), classes=("gold",)),
            s.serving.Replica("batch-deep", _engine(setup, name, level=len(ladder) - 1),
                              classes=("batch",)),
        ], watcher=s.serving.LibraryWatcher(root / "lib", min_poll_s=0.0))
        prof = _profile(s, class_mix=(("gold", 0.5), ("batch", 0.5)),
                        prompt_dist=("uniform", 3, 8))
        out = router.serve(prof, seed=0)
        per = {n: (r["routed"], r["trace_count"], r["plan"], _counts(r))
               for n, r in out["replicas"].items()}
        comps = {r.name: _completions(r.engine) for r in router.replicas}
        for r in router.replicas:
            assert r.engine._alloc.used_pages == 0
        tok = np.arange(4, dtype=np.int32)
        homes = [router.route(s.loadgen.Request(i, tok, qos_class=c)).name
                 for i, c in enumerate(("gold", "batch", "std"))]
        return out["requests"], router.routed, per, comps, homes, prof.total_requests

    got = {name: run(name) for name in SIDES}
    assert got["port"] == got["ref"]
    requests, routed, per, _, homes, total = got["port"]
    assert requests == total == sum(routed.values()) and all(routed.values())
    assert all(p[1] == 1 for p in per.values())
    assert per["gold-exact"][2] != per["batch-deep"][2]
    assert homes == ["gold-exact", "batch-deep", "gold-exact"]


def test_continuous_engine_refusals(setup):
    eng = _engine(setup, "port")
    with pytest.raises(RuntimeError, match="start"):
        eng.step_once()
    with pytest.raises(TypeError, match="serve"):
        eng.run_batch([])
    eng.start()
    assert eng.idle and eng.load_score == 0.0 and eng.occupancy == 0.0
    with pytest.raises(ValueError, match="prompt_len"):
        eng.submit(port_loadgen.Request(0, np.zeros(9, np.int32)))
    assert not eng.step_once()
