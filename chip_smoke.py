#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, each
failing the run on any mismatch:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
2. hold every kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones, and time kernel, plain version
   and a library call of the same function;
3. the search path: the ``template_eval`` kernel bit-equal to its plain
   version at the search's shapes; four tensor searches
   (``get_engine("tensor").run(SearchJob(...))``, 2-bit and full-size
   4-bit multipliers), each run through the kernel and again through the
   plain version on the same device and seed, whose outcomes must be
   identical; their sound results go through ``OperatorStore`` and
   ``load_mul_frontier`` to a 16x16 LUT that full-width qwen3-4b serves at
   W4A4, with tokens and the first position's logits identical to the
   plain LUT matmul's;
4. serve full-width qwen3-4b (random weights from a seed, bf16) at W4A4
   through ``ServingEngine.serve``, then one batch again with the plain LUT
   matmul: the generated tokens must be identical;
5. serve one batch at W8A8 on a composed stack, and again with the plain
   LUT matmul: identical tokens;
6. run ``forward_lm`` at B=2, S=512, W4A4: the first position's logits
   must equal the plain path's bit for bit;
7. print the kernels line (launches on the main path, deviations, times,
   bounds), where a decode step's time goes, the card's name and power
   limit, and a last line of JSON.

Each main path is driven with the launch counters set to 0 just before it
and read just after; a kernel of the path with 0 launches fails the run.
Needs one CUDA card; exits nonzero and prints no result without one.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and
# operations/s for int8 (the LUT products are 8-bit operand MACs) and
# bf16 tensor cores.  int32 is the CUDA-core integer rate: 132 SMs x 64
# INT32 lanes x the 1.98 GHz boost clock, about 16.7 T op/s (the bitwise
# template_eval work has no tensor-core form)
HBM_BPS = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12,
            "int32": 132 * 64 * 1.98e9}

# qwen3-4b MLP matmul shapes: decode (M = batch) and the B=2 x S=512
# forward (M = 1024), for w1/w3 (K=d_model) and w2 (K=d_ff)
MM_SHAPES = [(4, 2560, 9728), (4, 9728, 2560), (1024, 2560, 9728),
             (1024, 9728, 2560)]
MM_RAGGED = [(37, 53, 29), (130, 257, 64), (1, 2560, 9728), (64, 9728, 2560)]
# (B, H, Hkv, Lq, Lk, D, dtype, window)
FLASH_CASES = [
    (2, 32, 8, 512, 512, 128, "bfloat16", None),
    (2, 32, 8, 512, 512, 128, "float32", None),
    (1, 32, 8, 128, 384, 128, "bfloat16", None),
    (1, 32, 8, 128, 384, 128, "float32", None),
    (2, 32, 8, 512, 512, 128, "bfloat16", 128),
    (2, 32, 8, 512, 512, 128, "float32", 128),
    (1, 4, 2, 100, 300, 128, "float32", None),
]
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# template_eval (benchmark, T, P): the cases of
# tests/test_kernels_template_eval.py and the population at and past the
# Pallas block of 256; the search jobs' own shapes (search_shapes) and one
# large population for a device time are checked and timed besides
TE_CASES = [("adder_i4", 4, 16), ("adder_i6", 8, 64), ("mul_i4", 6, 33),
            ("mul_i6", 10, 128), ("mul_i8", 12, 16), ("adder_i4", 4, 256),
            ("adder_i4", 4, 257)]
TE_LARGE = ("mul_i8", 16, 65536)
# the tensor jobs: the smoke sweep's 2-bit multipliers with its tensor
# options (repro/fleet/plan.py), and the 4-bit multiplier at
# tensor_search's defaults with the nightly sweep's ETs 1/8 and 1/4 of 225;
# the budget is a safety net the generation count always beats
SMOKE_TENSOR = {"population": 512, "generations": 24, "elites": 64, "keep": 4}
SEARCH_JOBS = [("mul", 2, 1, SMOKE_TENSOR), ("mul", 2, 2, SMOKE_TENSOR),
               ("mul", 4, 28, {}), ("mul", 4, 56, {})]
SEARCH_BUDGET_S = 600.0


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, peak: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BPS
    t_ops = ops / PEAK_OPS[peak]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def phase_build() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    log(f"[build] nvcc sm_90a, {len(logs)} sources in {secs:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return {"seconds": secs}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def phase_kernels(torch, results: dict) -> None:
    import torch.nn.functional as F

    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.precision.compose import tile_to_width

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[kernels] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def codes(shape, side):
        return torch.randint(0, side, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    lut4 = codes((16, 16), 226)
    tile = codes((16, 16), 256)
    lut8 = torch.as_tensor(tile_to_width(tile.cpu().numpy()), dtype=torch.int32,
                           device=dev)
    rows = []
    for name, side, table, kernel in (("approx_matmul_w4", 16, lut4, am.approx_matmul_w4),
                                      ("approx_matmul_w8", 256, lut8, am.approx_matmul_w8)):
        worst = 0
        for M, K, N in MM_SHAPES + MM_RAGGED:
            a, b = codes((M, K), side), codes((K, N), side)
            got = kernel(a, b, table)
            torch.cuda.synchronize()
            want = ref.approx_matmul(a, b, table)
            diff = int((got.long() - want.long()).abs().max())
            worst = max(worst, diff)
            require(diff == 0, f"{name} {M}x{K}x{N}: differs from the plain "
                               f"version by {diff}")
            if (M, K, N) not in MM_SHAPES:
                continue
            ms = time_ms(torch, lambda: kernel(a, b, table), iters=20)
            plain_ms = time_ms(torch, lambda: ref.approx_matmul(a, b, table),
                               iters=2, warmup=1)
            xa = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            xb = torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
            lib_ms = time_ms(torch, lambda: torch.matmul(xa, xb), iters=20)
            nbytes = 4 * (M * K + K * N + M * N) + 4 * side * side
            bms, by = bound(nbytes, 2.0 * M * K * N, "int8")
            rows.append({"name": name, "shape": [M, K, N], "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bms, "bound_by": by, "max_abs_err": 0})
            log(f"[kernels] {name} {M}x{K}x{N}: bit-equal; kernel {ms:.4f} ms, "
                f"plain {plain_ms:.3f} ms, bf16 matmul {lib_ms:.4f} ms, "
                f"bound {bms:.4f} ms ({by})")
        results["max_err"][name] = worst

    worst = 0.0
    for B, H, Hkv, Lq, Lk, D, dt, window in FLASH_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn((B, H, Lq, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, Hkv, Lk, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, Hkv, Lk, D), generator=gen, device=dev).to(dtype)
        got = fa.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v, causal=True, window=window)
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        tag = f"({B},{H},{Hkv},{Lq},{Lk},{D}) {dt} window={window}"
        require(err < FLASH_TOL[dt], f"flash_attention {tag}: max |err| {err} "
                                     f">= {FLASH_TOL[dt]}")
        log(f"[kernels] flash_attention {tag}: max |err| {err:.3g}")
        if (dt, window, Lq) != ("bfloat16", None, 512):
            continue
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True), iters=20)
        plain_ms = time_ms(torch, lambda: ref.flash_attention(q, k, v, causal=True),
                           iters=5)
        try:
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), iters=20)
        except TypeError:  # a PyTorch without enable_gqa has no one call
            lib_ms = None
        # unmasked (query, key) pairs of this causal run, queries aligned
        # to the end of the keys
        pairs = sum(min(Lk, i + 1 + Lk - Lq) for i in range(Lq))
        ops = 4.0 * B * H * D * pairs
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
        bms, by = bound(nbytes, ops, "bf16")
        rows.append({"name": "flash_attention", "shape": [B, H, Hkv, Lq, Lk, D],
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bms, "bound_by": by})
        log(f"[kernels] flash_attention {tag}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, sdpa {lib_ms} ms, bound {bms:.4f} ms ({by})")
    results["max_err"]["flash_attention"] = worst
    results["timings"] = rows


# ---------------------------------------------------------------------------
# phase 3: the search path
# ---------------------------------------------------------------------------
def template_eval_bound(lits, sel, W: int, S: int) -> tuple[float, str]:
    """The least time for the function on these inputs.  Bytes: the
    parameter rows, the packed words and the exact values read once, two
    int32 results per candidate written once.  Operations, per (candidate,
    word), what this population needs: one AND per literal that is not
    IGNORE in a product some output selects (a NEG's complement folds into
    it), one OR per selected (output, product), and 10 (m + 1) for the
    error of all 32 lanes at once in bit-sliced form: the outputs are
    already the value's bit planes, so subtracting the exact value's
    planes, the conditional negate, the max (a scan from the top plane)
    and the popcount-weighted sum each take 2-3 word operations per plane
    of the (m + 1)-bit difference.  At the int32 rate."""
    P, T, n = lits.shape
    m = sel.shape[1]
    used = (sel != 0).any(dim=1)                                   # (P, T)
    lit_ops = int(((lits != 2) & used[:, :, None]).sum())
    or_ops = int((sel != 0).sum())
    nbytes = P * (T * n + m * T) * 4 + n * W * 4 + S * 4 + 8 * P
    ops = W * (lit_ops + or_ops + P * 10 * (m + 1))
    return bound(nbytes, ops, "int32")


def search_shapes() -> list[tuple[str, int, int]]:
    """(benchmark, T, P) of every search job's template_eval calls: T is
    the job's pit or 2 m, P its population, at tensor_search's defaults
    where the job sets none."""
    from repro_torch.core.engine import SearchJob

    shapes = []
    for kind, bits, et, opts in SEARCH_JOBS:
        exact = SearchJob(kind, bits, et, "tensor").exact()
        opts = search_defaults() | opts
        shape = (exact.name, opts["pit"] or 2 * exact.n_outputs,
                 opts["population"])
        if shape not in shapes:
            shapes.append(shape)
    return shapes


def search_defaults() -> dict:
    import inspect

    from repro_torch.core.tensor_search import tensor_search

    return {k: v.default for k, v in
            inspect.signature(tensor_search).parameters.items()
            if v.default is not inspect.Parameter.empty}


def kernel_device_ms(torch, fn, name: str, iters: int = 20):
    """The device time of one launch of the kernel whose name contains
    ``name``, from ``torch.profiler`` over ``iters`` calls: the kernel
    alone, without the host's launch gaps that CUDA events around a call
    include.  None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if name in e.key and getattr(e, "self_device_time_total", 0) > 0]
    count = sum(e.count for e in rows)
    if not count:
        return None
    return sum(e.self_device_time_total for e in rows) / 1e3 / count


def search_kernel_checks(torch, results: dict) -> None:
    from repro_torch.core.arith import benchmark
    from repro_torch.core.circuits import input_truth_tables
    from repro_torch.kernels import ref
    from repro_torch.kernels import template_eval as te

    gen = torch.Generator(device="cuda").manual_seed(2)
    # largest population first: the kernels line reports the first timed row
    timed = sorted(search_shapes(), key=lambda c: -c[2]) + [TE_LARGE]
    for bench, T, P in TE_CASES + timed:
        exact = benchmark(bench)
        n, m = exact.n_inputs, exact.n_outputs
        lits = torch.randint(0, 3, (P, T, n), generator=gen, device="cuda",
                             dtype=torch.int32)
        sel = (torch.rand((P, m, T), generator=gen, device="cuda") < 0.4).to(torch.int32)
        # the words as int32 with the same bits, converted once, as the
        # search hands them to both versions
        tt = ref.word_bits_int32(torch.from_numpy(input_truth_tables(n))).cuda()
        ev = torch.from_numpy(exact.eval_words().astype("int32")).cuda()
        wce, esum = te.template_eval(lits, sel, tt, ev)
        torch.cuda.synchronize()
        w_ref, s_ref = ref.template_eval(lits, sel, tt, ev)
        require(torch.equal(wce, w_ref) and torch.equal(esum, s_ref),
                f"template_eval {bench} T={T} P={P}: differs from the plain "
                f"version (wce {int((wce - w_ref).abs().max())}, esum "
                f"{int((esum - s_ref).abs().max())})")
        if (bench, T, P) not in timed:
            log(f"[search] template_eval {bench} T={T} P={P}: bit-equal")
            continue
        ms = time_ms(torch, lambda: te.template_eval(lits, sel, tt, ev), iters=50)
        dev_ms = kernel_device_ms(torch, lambda: te.template_eval(lits, sel, tt, ev),
                                  "template_eval_kernel")
        plain_ms = time_ms(torch, lambda: ref.template_eval(lits, sel, tt, ev),
                           iters=5)
        bms, by = template_eval_bound(lits, sel, tt.shape[1], ev.shape[0])
        results["timings"].append({
            "name": "template_eval", "shape": [bench, T, P], "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bms, "bound_by": by, "max_abs_err": 0})
        log(f"[search] template_eval {bench} T={T} P={P}: bit-equal; call "
            f"{ms:.4f} ms (CUDA events), kernel alone {dev_ms} ms (profiler), "
            f"plain {plain_ms:.3f} ms, bound {bms:.6f} ms ({by}), no library "
            f"call")
    results["max_err"]["template_eval"] = 0


def outcome_view(outcome) -> tuple:
    """Everything a search outcome decides: the candidates in order with
    their netlists, params bytes, areas, proxies and fitness, and the
    stats.  Wall times are measurements and stay out."""
    from repro_torch.library.store import circuit_to_dict

    return (outcome.engine, outcome.benchmark, outcome.et, outcome.stats,
            [(c.area, c.proxies, c.meta, c.params.lits.tobytes(),
              c.params.sel.tobytes(), circuit_to_dict(c.circuit))
             for c in outcome.results])


def run_split(torch, eng, job):
    """One search run, its wall time split from outside: the host clock up
    to the harvest, the card synchronised there (the generation loop and
    the final scoring), and over the harvest."""
    from repro_torch.core import tensor_search as ts

    real = ts.harvest_population
    mark = {}

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        mark["harvest"] = time.perf_counter()
        return real(*args, **kwargs)

    ts.harvest_population = timed
    try:
        t0 = time.perf_counter()
        out = eng.run(job)
        t1 = time.perf_counter()
    finally:
        ts.harvest_population = real
    return out, {"loop_s": mark["harvest"] - t0, "harvest_s": t1 - mark["harvest"]}


def kernel_run_device_s(torch, eng, job):
    """A further run through the kernel under ``torch.profiler``: its
    outcome, and the device time of its template_eval kernels (None when
    the profiler records none)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = eng.run(job)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if "template_eval_kernel" in e.key)
    return out, (us / 1e6 if us else None)


def phase_search(torch, results: dict) -> Path:
    """The search path on the card; returns the library it filled."""
    from repro_torch.core.engine import SearchJob, get_engine
    from repro_torch.core.synth import area
    from repro_torch.library.store import OperatorStore

    search_kernel_checks(torch, results)
    library = ROOT / "build" / "search_library"
    shutil.rmtree(library, ignore_errors=True)
    store = OperatorStore(library)
    runs = []
    expected = 0
    reset_counts()
    for kind, bits, et, opts in SEARCH_JOBS:
        job = SearchJob(kind, bits, et, "tensor", budget_s=SEARCH_BUDGET_S)
        eng = get_engine("tensor", backend="auto", **opts)
        out, split = run_split(torch, eng, job)
        plain, plain_split = run_split(
            torch, get_engine("tensor", backend="ref", **opts), job)
        again, kern_s = kernel_run_device_s(torch, eng, job)
        want_gens = (search_defaults() | opts)["generations"]
        require(out.stats["generations"] == want_gens,
                f"{job.describe()}: ran {out.stats['generations']} of "
                f"{want_gens} generations (cut by the budget)")
        require(outcome_view(out) == outcome_view(plain),
                f"{job.describe()}: the outcome through the kernel differs "
                f"from the one through the plain version")
        require(outcome_view(again) == outcome_view(out),
                f"{job.describe()}: a second run through the kernel differs")
        expected += 2 * (out.stats["generations"] + 1)
        for c in out.results:
            store.put_circuit(c.circuit, job.signature(), area=c.area,
                              source="tensor", proxies=c.proxies,
                              params=c.params, meta=c.meta)
        exact_area = area(job.exact())
        best = out.best.area if out.results else None
        rest = None if kern_s is None else split["loop_s"] - kern_s
        kern = ("not measured" if kern_s is None else
                f"{kern_s:.4f} s of device time in a profiled rerun, rest "
                f"{rest:.4f} s")
        log(f"[search] {job.describe()}: {len(out.results)} sound result(s), "
            f"best area {best} vs exact {exact_area}; kernel run "
            f"{out.wall_s:.4f} s = generation loop and final scoring "
            f"{split['loop_s']:.4f} s (template_eval kernels {kern}) "
            f"+ harvest {split['harvest_s']:.4f} s; plain run "
            f"{plain.wall_s:.4f} s (loop {plain_split['loop_s']:.4f} s, "
            f"harvest {plain_split['harvest_s']:.4f} s); outcomes identical")
        runs.append({"job": job.describe(), "results": len(out.results),
                     "best_area": best, "exact_area": exact_area,
                     "stats": out.stats, "wall_s": out.wall_s, **split,
                     "kernel_device_s": kern_s, "rest_of_loop_s": rest,
                     "plain_wall_s": plain.wall_s,
                     "plain_loop_s": plain_split["loop_s"],
                     "plain_harvest_s": plain_split["harvest_s"]})
    counts = read_counts()
    results["launches"]["template_eval"] = counts["template_eval"]
    require(counts["template_eval"] == expected,
            f"template_eval launches {counts['template_eval']} != "
            f"sum of (generations + 1) over the kernel runs = {expected}")
    log(f"[search] template_eval launches over the kernel runs (two a job): "
        f"{counts['template_eval']} = sum of (generations + 1)")
    results["search"] = {"jobs": runs, "library_records": len(store.query())}
    return library


def phase_search_serve(torch, cfg, params, library: Path, results: dict) -> None:
    """Library -> LUT -> serve: the cheapest frontier multiplier, compiled
    to a 16x16 table and stacked over every layer, served at W4A4 through
    the kernels and again through the plain LUT matmul."""
    import numpy as np

    from repro_torch.library.compile import load_mul_frontier
    from repro_torch.models import forward_fn
    from repro_torch.precision.widths import exact_table
    from repro_torch.serving import ServingEngine, steady, synth_requests

    jobs = results["search"]["jobs"]
    found4 = any(j["results"] for j in jobs if j["job"].startswith("mul_i8"))
    compiled, exact_area, bits = load_mul_frontier(library)
    require(bits == (4 if found4 else 2),
            f"frontier block width {bits}, expected {4 if found4 else 2}")
    rec, lut = compiled[0]
    require(lut.lut.shape == (16, 16) and lut.lut.dtype == np.int32,
            f"bad compiled table {lut.lut.shape} {lut.lut.dtype}")
    stack = np.stack([lut.lut] * cfg.n_layers)
    log(f"[search serve] frontier of {len(compiled)} {bits}-bit block(s); "
        f"cheapest {rec.key}: area {rec.area} vs exact {exact_area}, block "
        f"wce {rec.wce}, 16x16 table wce {lut.wce16}, mae {lut.mae16:.3f}")
    last = synth_requests(steady(1, 4, prompt_len=16, gen_len=16),
                          cfg.vocab_size, 0)[-1]
    eng = ServingEngine(cfg.with_approx_mlp(4), params, batch=4, prompt_len=16,
                        gen_len=16, luts=stack)
    reset_counts()
    st = eng.run_batch(last)
    counts = read_counts()
    require(counts["approx_matmul_w4"] > 0,
            "the searched LUT's serve launched no approx_matmul_w4")
    plain = ServingEngine(cfg.with_approx_mlp(4), params, batch=4,
                          prompt_len=16, gen_len=16, luts=stack, backend="ref")
    plain.run_batch(last)
    same = bool((plain.last_tokens == eng.last_tokens).all())
    require(same, "tokens served on the searched LUT differ from the plain path")
    log(f"[search serve] W4A4 on the searched LUT: approx_matmul_w4 launches "
        f"{counts['approx_matmul_w4']}, {st.ms_per_step:.2f} ms/step; tokens "
        f"identical to the plain path: {eng.last_tokens[0].tolist()}")
    # a degenerate output (one token repeated) would hide a wrong table
    # behind equal tokens, so hold the logits too: the LUT path is integer-
    # exact and at position 0 attention returns v on both paths, so the
    # first position's logits must be equal bit for bit; and they must
    # differ from the exact table's, or the searched table was not served
    cfg4 = cfg.with_approx_mlp(4)
    fwd = forward_fn(cfg4)
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                                     device="cuda")}
    got = fwd(cfg4, params, batch, lut=stack)[0][:, 0]
    want = fwd(cfg4, params, batch, lut=stack, backend="ref")[0][:, 0]
    logits_equal = bool(torch.equal(got, want))
    require(logits_equal, "position-0 logits on the searched LUT differ from "
            f"the plain path (max |d| {float((got - want).abs().max()):.3g})")
    exact = np.stack([exact_table("mul", 4).astype(np.int32)] * cfg.n_layers)
    on_exact = fwd(cfg4, params, batch, lut=exact)[0][:, 0]
    d_exact = float((got - on_exact).abs().max())
    require(d_exact > 0 or lut.wce16 == 0,
            "position-0 logits on the searched LUT equal the exact table's")
    log(f"[search serve] position-0 logits (4 x {cfg.vocab_size}) on the "
        f"searched LUT: bit-equal to the plain path; max |d| from the exact "
        f"table's {d_exact:.4g}")
    results["search"]["serve"] = {
        "record": rec.key, "area": rec.area, "exact_area": exact_area,
        "bits": bits, "wce16": lut.wce16, "frontier": len(compiled),
        "approx_matmul_w4_launches": counts["approx_matmul_w4"],
        "ms_per_step": st.ms_per_step, "tokens_identical": same,
        "position0_logits_equal": logits_equal,
        "position0_max_abs_d_from_exact": d_exact}


# ---------------------------------------------------------------------------
# phases 4-6: the main paths at full width
# ---------------------------------------------------------------------------
def reset_counts() -> None:
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import template_eval as te

    am.approx_matmul_w4.launches = 0
    am.approx_matmul_w8.launches = 0
    fa.flash_attention.launches = 0
    te.template_eval.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import template_eval as te

    return {"approx_matmul_w4": am.approx_matmul_w4.launches,
            "approx_matmul_w8": am.approx_matmul_w8.launches,
            "flash_attention": fa.flash_attention.launches,
            "template_eval": te.template_eval.launches}


def stacks(n_layers: int):
    """Per-layer stacks alternating the exact table with a truncated one
    (the exact product with its low 2 bits dropped), at W4A4 and as
    composed W8A8 tables."""
    import numpy as np

    from repro_torch.precision.compose import tile_to_width
    from repro_torch.precision.widths import exact_table

    exact = exact_table("mul", 4)
    trunc = exact & ~3
    w4 = np.stack([exact if i % 2 == 0 else trunc for i in range(n_layers)])
    w8 = np.stack([tile_to_width(t) for t in w4])
    return w4.astype(np.int32), w8.astype(np.int32)


def phase_serve(torch, cfg, params, results: dict) -> None:
    from repro_torch.serving import ServingEngine, steady, synth_requests

    w4, w8 = stacks(cfg.n_layers)
    profile = steady(2, 4, prompt_len=16, gen_len=16)
    eng = ServingEngine(cfg.with_approx_mlp(4), params, batch=4, prompt_len=16,
                        gen_len=16, luts=w4)
    reset_counts()
    stats = eng.serve(profile, seed=0)
    counts = read_counts()
    results["launches"]["approx_matmul_w4"] = counts["approx_matmul_w4"]
    require(counts["approx_matmul_w4"] > 0, "W4A4 serve launched no approx_matmul_w4")
    require(counts["flash_attention"] == 0, "decode ran the flash kernel")
    per_step = 3 * cfg.n_layers
    log(f"[serve w4a4] {len(stats)} batches, approx_matmul_w4 launches "
        f"{counts['approx_matmul_w4']} ({per_step} per step x "
        f"{counts['approx_matmul_w4'] // per_step} steps)")
    for i, s in enumerate(stats):
        log(f"[serve w4a4] batch {i}: prefill {s.prefill_tok_s:.1f} tok/s, "
            f"decode {s.decode_tok_s:.1f} tok/s, {s.ms_per_step:.2f} ms/step")
    results["serve_w4"] = [s.__dict__ | {"ms_per_step": s.ms_per_step,
                                         "decode_tok_s": s.decode_tok_s,
                                         "prefill_tok_s": s.prefill_tok_s}
                           for s in stats]
    tokens = eng.last_tokens
    require(tokens.shape == (4, 16) and (tokens >= 0).all()
            and (tokens < cfg.vocab_size).all(), f"bad tokens {tokens.shape}")

    last = synth_requests(profile, cfg.vocab_size, 0)[-1]
    ref_eng = ServingEngine(cfg.with_approx_mlp(4), params, batch=4,
                            prompt_len=16, gen_len=16, luts=w4, backend="ref")
    t0 = time.perf_counter()
    ref_eng.run_batch(last)
    log(f"[serve w4a4] plain LUT matmul batch in {time.perf_counter() - t0:.1f} s")
    same = bool((ref_eng.last_tokens == tokens).all())
    require(same, "W4A4 tokens through the kernel differ from the plain path")
    log(f"[serve w4a4] tokens identical to the plain path: {tokens[0].tolist()}")

    eng8 = ServingEngine(cfg.with_approx_mlp(8), params, batch=4, prompt_len=16,
                         gen_len=16, luts=w8)
    reset_counts()
    s8 = eng8.run_batch(last)
    counts = read_counts()
    results["launches"]["approx_matmul_w8"] = counts["approx_matmul_w8"]
    require(counts["approx_matmul_w8"] > 0, "W8A8 serve launched no approx_matmul_w8")
    t8 = eng8.last_tokens
    require(t8.shape == (4, 16) and (t8 < cfg.vocab_size).all(), "bad W8A8 tokens")
    log(f"[serve w8a8] 1 batch, approx_matmul_w8 launches "
        f"{counts['approx_matmul_w8']}; prefill {s8.prefill_tok_s:.1f} tok/s, "
        f"decode {s8.decode_tok_s:.1f} tok/s, {s8.ms_per_step:.2f} ms/step")
    ref8 = ServingEngine(cfg.with_approx_mlp(8), params, batch=4, prompt_len=16,
                         gen_len=16, luts=w8, backend="ref")
    ref8.run_batch(last)
    require(bool((ref8.last_tokens == t8).all()),
            "W8A8 tokens through the kernel differ from the plain path")
    log(f"[serve w8a8] tokens identical to the plain path: {t8[0].tolist()}")
    results["serve_w8"] = s8.__dict__ | {"ms_per_step": s8.ms_per_step}
    results["step_breakdown"] = step_breakdown(torch, cfg, params, w4, eng)


def step_breakdown(torch, cfg, params, w4, eng) -> dict:
    """Where one W4A4 decode step's time goes: with CUDA events, the whole
    step, the weight re-quantization alone and the LUT kernels alone on the
    step's shapes; with the host clock, how long the step takes to enqueue;
    with the profiler, the device's busy time by kernel."""
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.models import decode_fn, init_caches
    from repro_torch.quant.int4 import quantize_intb

    caches = init_caches(cfg, eng.batch, eng.total, device="cuda")
    tok = torch.zeros((eng.batch, 1), dtype=torch.int32, device="cuda")
    luts = torch.as_tensor(w4, device="cuda")
    step = decode_fn(eng.cfg)

    def decode():
        step(eng.cfg, params, caches, tok, 3, luts=luts)

    step_ms = time_ms(torch, decode, iters=5)
    mats = [lp["ffn"][w] for lp in params["layers"] for w in ("w1", "w3", "w2")]
    quant_ms = time_ms(torch, lambda: [quantize_intb(w, 4, axis=0) for w in mats],
                       iters=3)
    coded = [quantize_intb(w, 4, axis=0)[0] for w in mats[:3]]
    a_k = torch.randint(0, 16, (eng.batch, cfg.d_model), device="cuda", dtype=torch.int32)
    a_f = torch.randint(0, 16, (eng.batch, cfg.d_ff), device="cuda", dtype=torch.int32)
    lut = luts[0].contiguous()

    def kernels():
        for _ in range(cfg.n_layers):
            am.approx_matmul_w4(a_k, coded[0], lut)
            am.approx_matmul_w4(a_k, coded[1], lut)
            am.approx_matmul_w4(a_f, coded[2], lut)

    kern_ms = time_ms(torch, kernels, iters=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    host_ms = 1e3 * (time.perf_counter() - t0)  # enqueue only, no sync
    torch.cuda.synchronize()
    out = {"step_ms": step_ms, "weight_quant_ms": quant_ms,
           "lut_kernels_ms": kern_ms, "host_enqueue_ms": host_ms,
           "rest_ms": step_ms - quant_ms - kern_ms}
    out.update(profile_step(torch, decode))
    log(f"[step] W4A4 decode step {step_ms:.2f} ms (host enqueue {host_ms:.2f} "
        f"ms): weight re-quantization {quant_ms:.2f} ms "
        f"({100 * quant_ms / step_ms:.0f}%), LUT kernels {kern_ms:.2f} ms "
        f"({100 * kern_ms / step_ms:.0f}%), rest {out['rest_ms']:.2f} ms")
    return out


def profile_step(torch, decode) -> dict:
    """Device time of one decode step by kernel, from ``torch.profiler``.
    The profiler is untried on the card's machine: if it records no device
    time, the breakdown above (CUDA events) is all there is."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [e for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0
            and str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if busy_ms == 0:
        log("[step] profiler recorded no device time: not measured")
        return {"profile": "not measured"}
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    launches = sum(e.count for e in rows)
    log(f"[step] profiled step: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms (idle {100 * (1 - busy_ms / wall_ms):.0f}%), "
        f"{launches} kernel launches")
    for e in top:
        log(f"[step]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    return {"profile": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                        "kernel_launches": launches,
                        "top": [[e.key[:120], e.count,
                                 e.self_device_time_total / 1e3] for e in top]}}


def phase_forward(torch, cfg, params, results: dict) -> None:
    from repro_torch.models import forward_fn

    w4, _ = stacks(cfg.n_layers)
    cfg4 = cfg.with_approx_mlp(4)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device="cuda")
    fwd = forward_fn(cfg4)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = fwd(cfg4, params, {"tokens": tokens}, lut=w4)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    results["launches"]["flash_attention"] = counts["flash_attention"]
    require(counts["flash_attention"] == cfg.n_layers,
            f"flash launches {counts['flash_attention']} != {cfg.n_layers}")
    require(counts["approx_matmul_w4"] == 3 * cfg.n_layers,
            f"approx_matmul_w4 launches {counts['approx_matmul_w4']}")
    require(tuple(logits.shape) == (2, 512, cfg.vocab_size), f"shape {logits.shape}")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    plain, _ = fwd(cfg4, params, {"tokens": tokens}, lut=w4, backend="ref")
    # at position 0 attention returns v exactly on both paths and every
    # other op is row-wise, so the first position's logits must be equal
    # bit for bit; later positions differ by the two attention paths' bf16
    # roundoff, which flips W4 codes and, over 36 random layers, argmaxes
    first_equal = bool(torch.equal(logits[:, 0], plain[:, 0]))
    agree = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    dmax = float((logits - plain).abs().max())
    log(f"[forward] B=2 S=512 W4A4 in {secs:.2f} s: flash launches "
        f"{counts['flash_attention']}, approx_matmul_w4 launches "
        f"{counts['approx_matmul_w4']}; vs plain path: position 0 "
        f"bit-equal {first_equal}, argmax agreement over all positions "
        f"{agree:.3f}, max |dlogit| {dmax:.3g}")
    require(first_equal, "forward position-0 logits differ from the plain path")
    results["forward"] = {"seconds": secs, "argmax_agreement": agree,
                          "max_abs_dlogit": dmax, "position0_equal": first_equal}


# ---------------------------------------------------------------------------
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import init_model

    t_start = time.perf_counter()
    results: dict = {"max_err": {}, "launches": {}}
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    results["build"] = phase_build()
    phase_kernels(torch, results)
    library = phase_search(torch, results)

    cfg = get_config("qwen3-4b")
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_params() / 1e9:.2f} B params in {cfg.dtype}, init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    phase_search_serve(torch, cfg, params, library, results)
    phase_serve(torch, cfg, params, results)
    phase_forward(torch, cfg, params, results)

    sources = {"approx_matmul_w4": ("src/repro_torch/kernels/csrc/approx_matmul.cu",
                                    "src/repro/kernels/approx_matmul.py:74"),
               "approx_matmul_w8": ("src/repro_torch/kernels/csrc/approx_matmul.cu",
                                    "src/repro/kernels/approx_matmul.py:88"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:31"),
               "template_eval": ("src/repro_torch/kernels/csrc/template_eval.cu",
                                 "src/repro/kernels/template_eval.py:30")}
    kernels = []
    for name, (src, replaces) in sources.items():
        t = next(r for r in results["timings"] if r["name"] == name)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": results["launches"][name],
                        "max_abs_err": results["max_err"][name],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"], "shape": t["shape"],
                        **({"device_ms": t["device_ms"]} if "device_ms" in t else {})})
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} was not launched on its main path")
    results["kernels"] = kernels
    results["seconds"] = time.perf_counter() - t_start
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    results["nvidia_smi"] = smi
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    log(f"[done] {results['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
