"""PyTorch port: request lifecycles, the provenance ledger and the cost
plane against the JAX package's.

``obs/{provenance,requests,costs}`` are own copies of the reference's
modules.  The cases of ``tests/test_provenance.py`` and
``tests/test_costs.py`` that need no CLI, HTTP endpoint or Perfetto export
write the same ledgers and span chains on both sides (deterministic
clocks) and require the same records, audits, timelines and cost reports.
The end-to-end case serves two replicas behind the router on each side
(gold homed on an exact replica, batch on a deep one), traced, and
requires the same reconciled cost report.
"""

import dataclasses
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serving as jax_serving  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.arith import benchmark  # noqa: E402
from repro.library.compile import load_mul_frontier as jax_load  # noqa: E402
from repro.models import init_model as jax_init  # noqa: E402
from repro.obs import costs as jax_costs  # noqa: E402
from repro.obs import provenance as jax_prov  # noqa: E402
from repro.obs import requests as jax_requests  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro_torch import serving as port_serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.library.compile import load_mul_frontier  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.obs import costs as port_costs  # noqa: E402
from repro_torch.obs import provenance as port_prov  # noqa: E402
from repro_torch.obs import requests as port_requests  # noqa: E402
from repro_torch.obs import trace as port_trace  # noqa: E402
from test_serving import fill_library, trunc_mul2, zero_mul2  # noqa: E402


class _Side:
    def __init__(self, prov, requests, costs, trace, serving, load):
        self.prov, self.requests, self.costs, self.trace = prov, requests, costs, trace
        self.serving, self.load = serving, load


SIDES = {"ref": _Side(jax_prov, jax_requests, jax_costs, jax_trace, jax_serving,
                      jax_load),
         "port": _Side(port_prov, port_requests, port_costs, port_trace,
                       port_serving, load_mul_frontier)}


@pytest.fixture(autouse=True)
def _isolate():
    for s in SIDES.values():
        s.trace.reset()
        s.prov._ledgers.clear()
    yield
    for s in SIDES.values():
        s.trace.reset()
        s.prov._ledgers.clear()


def _clock():
    t = [0.0]

    def tick():
        t[0] += 1.0
        return t[0]

    return tick


# ---------------------------------------------------------------------------
# ledger, audit
# ---------------------------------------------------------------------------
def _roundtrip(s, root):
    led = s.prov.ProvenanceLedger(root, tag="w0", clock=_clock())
    led.note_plan("p0", ["exact", "mul2_t1"], width_map=(8, 8))
    led.note_plan("p0", ["exact", "mul2_t1"])
    led.record_range(rid=1, cls="gold", t0=0, t1=4, plan="p0", level=1,
                     drift=[0.01, 0.02])
    led.record_done(rid=1, cls="gold", gen_len=4, steps=7, preempts=0)
    led.close()
    recs = s.prov.read_ledger(root)
    src = root / "prov-w0.jsonl"
    (root / "prov-w0-copy.jsonl").write_text(src.read_text())
    with open(src, "a") as f:
        f.write('{"k": "range", "w": "w0"')
    return recs, s.prov.read_ledger(root) == recs


def _shared_writer(s, root):
    a, b = s.prov.ledger_for(root, "t"), s.prov.ledger_for(root, "t")
    same = (a is b, s.prov.ledger_for(root, "other") is a)
    a.record_done(rid=1, cls="std", gen_len=2, steps=3, preempts=0)
    b.record_done(rid=2, cls="std", gen_len=2, steps=3, preempts=0)
    return same, [r["n"] for r in s.prov.read_ledger(root)]


def _ledger(s, root, *records):
    led = s.prov.ProvenanceLedger(root, tag="w0", clock=_clock())
    for kind, kw in records:
        getattr(led, kind)(**kw)
    led.close()
    return s.prov.read_ledger(root)


def _audits(s, root):
    def rng(rid, cls, t0, t1, plan, level, drift=()):
        return ("record_range", dict(rid=rid, cls=cls, t0=t0, t1=t1, plan=plan,
                                     level=level, drift=list(drift)))

    def done(rid, cls, gen_len, steps, preempts=0):
        return ("record_done", dict(rid=rid, cls=cls, gen_len=gen_len, steps=steps,
                                    preempts=preempts))

    clean = _ledger(s, root / "a",
                    ("note_plan", dict(plan_id="p0", layers=["exact"])),
                    ("note_plan", dict(plan_id="p1", layers=["mul2_t1"])),
                    rng(1, "gold", 0, 3, "p0", 0, [0.01]),
                    rng(1, "gold", 3, 8, "p1", 2, [0.03, 0.05]),
                    done(1, "gold", 8, 11, 1))
    broken = _ledger(s, root / "b",
                     rng(1, "gold", 0, 3, "exact", None),
                     rng(1, "gold", 5, 8, "ghost", 1), done(1, "gold", 8, 9),
                     rng(2, "batch", 0, 4, "exact", None),
                     rng(2, "batch", 2, 6, "exact", None), done(2, "batch", 6, 7),
                     rng(3, "batch", 0, 2, "exact", None))
    short = _ledger(s, root / "c", rng(1, "std", 0, 5, "exact", None),
                    done(1, "std", 8, 9))
    return [s.prov.audit(r) for r in (clean, broken, short)]


# ---------------------------------------------------------------------------
# lifecycle timelines
# ---------------------------------------------------------------------------
def _emit_chain(tr, rid, *, cls="gold", preempts=0, drop=(), replica=""):
    extra = {"replica": replica} if replica else {}
    susp = 2.0 * preempts
    ev = [("req.queued", dict(rid=rid, cls=cls, prompt_len=4)),
          ("req.admitted", dict(rid=rid, cls=cls, slot=0, queue_ms=1.0)),
          ("req.prefill", dict(rid=rid, cls=cls, slot=0, prompt_len=4)),
          ("req.decode", dict(rid=rid, cls=cls, ttft_ms=5.0, prefill_ms=4.0))]
    for _ in range(preempts):
        ev.append(("req.preempt", dict(rid=rid, cls=cls, step=3, by="gold")))
        ev.append(("req.resume", dict(rid=rid, cls=cls, slot=1, suspended_ms=2.0)))
    ev.append(("req.done", dict(rid=rid, cls=cls, steps=8, preempts=preempts,
                                resumes=preempts, queue_ms=1.0, prefill_ms=4.0,
                                decode_ms=10.0, suspension_ms=susp,
                                total_ms=15.0 + susp)))
    for name, attrs in ev:
        if name not in drop:
            tr.event(name, **attrs, **extra)


def _view(tls):
    return {rid: (t.complete, t.cls, t.replica, t.preempts, t.resumes, t.steps,
                  t.total_ms, t.breakdown, t.problems,
                  SIDES["port"].requests.critical_path(t.breakdown) if t.breakdown
                  else None)
            for rid, t in sorted(tls.items())}


def _timelines(s, root):
    tr = s.trace.Tracer(root / "a", clock=_clock(), process_tag="w0")
    _emit_chain(tr, 1, preempts=2, replica="gold-a")
    _emit_chain(tr, 2, cls="batch")
    _emit_chain(tr, 3, preempts=1, drop=("req.resume",))
    tr.event("serve.swap", reason="noise")
    tr.close()
    spans = s.trace.read_trace(root / "a")
    out = [len(s.requests.request_events(spans)), _view(s.requests.build_timelines(spans))]
    tr = s.trace.Tracer(root / "b", clock=_clock(), process_tag="w0")
    _emit_chain(tr, 1, drop=("req.admitted",))
    _emit_chain(tr, 2, drop=("req.done",))
    tr.event("req.queued", rid=3, cls="std", prompt_len=2)
    tr.event("req.admitted", rid=3, cls="std", slot=0, queue_ms=1.0)
    tr.event("req.prefill", rid=3, cls="std", slot=0, prompt_len=2)
    tr.event("req.decode", rid=3, cls="std", ttft_ms=3.0)
    tr.event("req.done", rid=3, cls="std", steps=4, preempts=0, resumes=0,
             queue_ms=1.0, prefill_ms=-2.0, decode_ms=9.0, suspension_ms=0.0,
             total_ms=99.0)
    tr.close()
    out.append(_view(s.requests.build_timelines(s.trace.read_trace(root / "b"))))
    tr = s.trace.Tracer(root / "c", clock=_clock(), process_tag="w0")
    _emit_chain(tr, 4)
    tr.close()
    spans = s.trace.read_trace(root / "c")
    for sp in spans:
        if sp["name"] == "req.done":
            sp["attrs"]["total_ms"] = 40.0
    out.append(_view(s.requests.build_timelines(spans)))
    return out


# ---------------------------------------------------------------------------
# cost plane
# ---------------------------------------------------------------------------
def _plan_cost_rows(s, _root):
    choices = [types.SimpleNamespace(key=None, area=10.0),
               types.SimpleNamespace(key="k1", area=2.0)]
    plan = types.SimpleNamespace(plan_id="p", choices=choices, exact_area=10.0)
    return [s.costs.plan_cost_row(plan, [100, 100],
                                  layer_areas=[(10.0, 10.0), (2.0, 4.0)]),
            s.costs.plan_cost_row(plan, [100, 100]),
            s.costs.plan_cost_row(None, [100, 100])]


def _write_ledger(s, root, *, gap=False, unpriced=False):
    led = s.prov.ProvenanceLedger(root, tag="w0", clock=_clock())
    led.note_model(name="toy", macs=[10, 10])
    if unpriced:
        led.note_plan("p0", ["exact", "k1"])
    else:
        led.note_plan("p0", ["exact", "k1"], areas=[5.0, 2.0], areas_hi=[5.0, 3.0],
                      exact_area=5.0)
    led.record_range(rid=1, cls="gold", t0=0, t1=4, plan="exact", level=None,
                     drift=[])
    led.record_done(rid=1, cls="gold", gen_len=4, steps=5, preempts=0)
    led.record_range(rid=2, cls="batch", t0=0, t1=3 if gap else 4, plan="p0",
                     level=1, drift=[0.01])
    led.record_done(rid=2, cls="batch", gen_len=4, steps=5, preempts=0)
    led.close()
    return s.prov.read_ledger(root)


def _cost_reports(s, root):
    reps = [s.costs.cost_report(_write_ledger(s, root / n, gap=g, unpriced=u))
            for n, g, u in (("ok", False, False), ("gap", True, False),
                            ("unpriced", False, True))]
    led = s.prov.ProvenanceLedger(root / "nomodel", tag="w0", clock=_clock())
    led.record_range(rid=1, cls="std", t0=0, t1=2, plan="exact", level=None,
                     drift=[])
    led.record_done(rid=1, cls="std", gen_len=2, steps=3, preempts=0)
    led.close()
    reps.append(s.costs.cost_report(s.prov.read_ledger(root / "nomodel")))
    return reps


def _two_replicas(s, root):
    led = s.prov.ProvenanceLedger(root, tag="w0", clock=_clock())
    led.note_model(name="toy", macs=[10])
    for name in ("a", "b"):
        led.record_range(rid=7, cls="std", t0=0, t1=4, plan="exact", level=None,
                         drift=[], replica=name)
        led.record_done(rid=7, cls="std", gen_len=4, steps=5, preempts=0,
                        replica=name)
    led.record_range(rid=8, cls="std", t0=0, t1=4, plan="exact", level=None,
                     drift=[], replica="a")
    led.record_done(rid=8, cls="std", gen_len=4, steps=5, preempts=0, replica="a")
    led.close()
    recs = s.prov.read_ledger(root)
    return s.prov.audit(recs), s.costs.cost_report(recs)


CASES = [_roundtrip, _shared_writer, _audits, _timelines, _plan_cost_rows,
         _cost_reports, _two_replicas]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[1:] for c in CASES])
def test_provenance_and_costs_match_reference(case, tmp_path):
    got = {name: case(s, tmp_path / name) for name, s in SIDES.items()}
    assert got["port"] == got["ref"]
    port = got["port"]
    if case is _roundtrip:
        assert [r["k"] for r in port[0]] == ["plan", "range", "done"] and port[1]
    if case is _shared_writer:
        assert port == ((True, False), [0, 1])
    if case is _audits:
        clean, broken, short = port
        assert clean["n_complete"] == 1 and clean["requests"][1]["tokens_covered"] == 8
        assert broken["n_failed"] == 2 and short["n_failed"] == 1
        assert any("gap at tokens [3, 5)" in p for p in broken["requests"][1]["problems"])
    if case is _timelines:
        assert port[1][1][0] and not port[1][3][0]
        assert any("sums to" in p for p in port[3][4][8])
    if case is _cost_reports:
        ok, gap, unpriced, nomodel = port
        assert ok["reconciled"] and ok["requests"][2]["approx_macs"] == 40
        assert not gap["reconciled"] and gap["mac_gap"] == 20
        assert not unpriced["reconciled"] and not nomodel["reconciled"]
    if case is _two_replicas:
        assert set(port[0]["requests"]) == {"7@a", "7@b", 8}
        assert port[1]["reconciled"]


def test_mlp_macs_per_layer():
    for arch in ("qwen3-4b", "stablelm-1.6b"):
        cj, ct = jax_config(arch, reduced=True), get_config(arch, reduced=True)
        m = port_costs.mlp_macs_per_layer(ct)
        assert m == jax_costs.mlp_macs_per_layer(cj)
        assert m == [3 * ct.d_model * ct.d_ff] * ct.n_layers
    with pytest.raises(ValueError, match="not ported"):
        port_costs.mlp_macs_per_layer(dataclasses.replace(ct, family="moe"))


def test_lifecycle_event_overhead_is_negligible_when_off():
    t0 = time.perf_counter()
    for i in range(2000):
        port_trace.event("req.queued", rid=i, cls="gold", prompt_len=8)
    per_call_ms = 1e3 * (time.perf_counter() - t0) / 2000
    assert per_call_ms < 0.05, f"untraced req event {per_call_ms:.4f} ms"


# ---------------------------------------------------------------------------
# end to end: two replicas, traced, on both sides
# ---------------------------------------------------------------------------
def test_router_cost_attribution_matches_reference(tmp_path):
    fill_library(tmp_path / "lib", [benchmark("mul_i4"), trunc_mul2(), zero_mul2()])
    cj = dataclasses.replace(jax_config("gemma3-1b", reduced=True),
                             dtype="float32").with_approx_mlp()
    ct = ModelConfig(**{f.name: getattr(cj, f.name)
                        for f in dataclasses.fields(ModelConfig)})
    params = jax_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    got = {}
    for name, s in SIDES.items():
        compiled, exact_area, _ = s.load(tmp_path / "lib")
        ladder = s.serving.PlanLadder.build(compiled, cj.n_layers,
                                            exact_area=exact_area, levels=4)

        def mk(level, s=s, compiled=compiled, exact_area=exact_area, ladder=ladder):
            extra = {"device": "cpu"} if s is SIDES["port"] else {}
            return s.serving.ContinuousServingEngine(
                ct if extra else cj, pt if extra else params, max_slots=2,
                prompt_len=8, gen_len=8, page_size=4, plan=ladder.plan(level),
                compiled=compiled, exact_area=exact_area, **extra)

        trace_dir = tmp_path / f"trace-{name}"
        s.trace.configure(trace_dir, process_tag="serve")
        try:
            router = s.serving.ReplicaRouter([
                s.serving.Replica("gold-exact", mk(0), classes=("gold",)),
                s.serving.Replica("batch-deep", mk(len(ladder) - 1),
                                  classes=("batch",))])
            prof = s.serving.make_profile(
                "ramp", ticks=4, per_tick=4, prompt_len=8, gen_len=8,
                class_mix=(("gold", 0.5), ("batch", 0.5)),
                prompt_dist=("uniform", 3, 8))
            out = router.serve(prof, seed=0)
        finally:
            s.trace.reset()
            s.prov._ledgers.clear()
        got[name] = (out["costs"], s.costs.cost_report(s.prov.read_ledger(trace_dir)),
                     out["requests"], prof.total_requests)
    assert got["port"][0]["mlp_macs"] == got["ref"][0]["mlp_macs"]
    assert got["port"][0]["approx_macs"] == got["ref"][0]["approx_macs"]
    np.testing.assert_allclose(got["port"][0]["area_mac_saved"],
                               got["ref"][0]["area_mac_saved"], rtol=1e-6)
    rep, ref_rep = got["port"][1], got["ref"][1]
    for key in ("reconciled", "n_done", "n_complete", "mac_gap", "totals",
                "replicas", "classes", "layers", "plans", "problems"):
        assert rep[key] == ref_rep[key], key
    assert rep["reconciled"] and rep["mac_gap"] == 0
    assert got["port"][2] == got["port"][3] == rep["n_done"]
    assert rep["replicas"]["gold-exact"]["area_mac_saved"] == [0.0, 0.0]
    batch = rep["replicas"]["batch-deep"]["area_mac_saved"]
    assert batch[0] > 0 and batch[1] >= batch[0]
    for k in ("tokens", "mlp_macs", "approx_macs"):
        assert sum(r[k] for r in rep["replicas"].values()) == rep["totals"][k]
