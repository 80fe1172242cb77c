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
   the QoS read path (``[plans]`` lines): the baseline engines
   (``get_engine("muscat" | "mecals" | "anneal")``) add their results to
   that library, and ``muscat_like`` finds the system test's sound,
   smaller multiplier; a W4A4 ``plan_ladder`` priced by sensitivities
   measured through ``forward_lm`` serves at two levels through
   ``ServingEngine(plan=...)`` with a ``swap_plan`` between them that
   copies into the live stack in place, a W8A8 stack is refused; a W8A8
   plan and a mixed-width plan that holds both widths serve too; every
   batch's tokens, and one decode step's logits, equal the plain route's
   on the same plan;
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
# the tensor-core kernels' tile edges: activation rows around the 8-, 64-
# and 128-row tiles, depths ending inside a 16-deep stage, columns ending
# inside a 128-column block, and rows whose codes are not 16-byte aligned
MM_EDGES = ([(M, 300, 200) for M in (1, 4, 8, 9, 63, 64, 65, 256, 1024)]
            + [(257, 300, 129), (9, 53, 129), (65, 53, 129)])
# W8A8 at its overflow edge: every code and tile entry 255 at K = max_k
# gives 255 * 289 * 29,140 = 2,147,472,300 in every entry
MM_OVERFLOW = (3, 29140, 70)
# (B, H, Hkv, Lq, Lk, D, dtype, window, causal): the main path's prefill
# shape, a kv prefix, windows, head dims 64 and 256, non-causal, ragged
# lengths, and Lk < Lq, whose first rows see no key
FLASH_CASES = [
    (2, 32, 8, 512, 512, 128, "bfloat16", None, True),
    (2, 32, 8, 512, 512, 128, "float32", None, True),
    (1, 32, 8, 128, 384, 128, "bfloat16", None, True),
    (1, 32, 8, 128, 384, 128, "float32", None, True),
    (2, 32, 8, 512, 512, 128, "bfloat16", 128, True),
    (2, 32, 8, 512, 512, 128, "float32", 128, True),
    (2, 32, 8, 512, 512, 128, "bfloat16", 200, True),
    (1, 4, 2, 100, 300, 128, "float32", None, True),
    (1, 4, 2, 100, 300, 128, "bfloat16", None, True),
    (2, 8, 4, 512, 512, 64, "bfloat16", None, True),     # hymba's head dim
    (2, 8, 4, 512, 512, 64, "float32", None, True),
    (2, 8, 1, 512, 512, 256, "bfloat16", None, True),    # gemma3's head dim
    (2, 8, 1, 512, 512, 256, "float32", 200, True),
    (1, 8, 2, 333, 333, 256, "bfloat16", None, False),   # non-causal, ragged
    (1, 8, 2, 333, 333, 128, "float32", None, False),
    (1, 8, 2, 300, 100, 128, "bfloat16", None, True),    # 200 rows see no key
    (1, 8, 2, 300, 100, 64, "float32", 64, True),
]
# timed, in this order (the main bf16 shape first: the kernels line takes
# the first row of each kernel)
FLASH_TIMED = [(2, 32, 8, 512, 512, 128, "bfloat16", None, True),
               (1, 32, 8, 128, 384, 128, "bfloat16", None, True),
               (2, 32, 8, 512, 512, 128, "bfloat16", 128, True),
               (2, 32, 8, 512, 512, 128, "float32", None, True)]
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# template_eval (benchmark, or "n<inputs>m<outputs>" for a made-up function
# on the full truth tables, or "n<inputs>m<outputs>w<words>" on that many
# random packed words; T, P, literals, selections, exact values): the cases of
# tests/test_kernels_template_eval.py and the population at and past the
# Pallas block of 256; the edges of tests/test_torch_kernels_cuda.py's
# TE_EDGES (W = 32 and 128, S < 32 and words with no lane, P = 1 and 255,
# literals past 2 and selections past 1, exact values negative, wider than
# m bits and at the int32 extremes, m = 9, 12 and 31, n = 17, 20, 40 and
# 133: two, three and nine key words); and mul_i8 at the
# persistent loop's edges, "wave" being a full wave of full slabs (blocks x
# slab).  The search jobs' own shapes (search_shapes) and one large
# population for a device time are checked and timed besides.
TE_CASES = [
    *[(b, T, P, "012", "01", "exact") for b, T, P in [
        ("adder_i4", 4, 16), ("adder_i6", 8, 64), ("mul_i4", 6, 33),
        ("mul_i6", 10, 128), ("mul_i8", 12, 16), ("adder_i4", 4, 256),
        ("adder_i4", 4, 257), ("mul_i10", 12, 20), ("adder_i12", 9, 10),
        ("mul_i8", 16, 1), ("mul_i8", 16, 255), ("mul_i8", 16, "wave-1"),
        ("mul_i8", 16, "wave"), ("mul_i8", 16, "wave+1"), ("mul_i8", 16, 65537)]],
    ("n5m5", 6, 30, "012", "01", "S=20"), ("n7m6", 8, 30, "012", "01", "S=50"),
    ("mul_i6", 10, 64, "odd", "odd", "exact"),
    ("mul_i4", 8, 64, "012", "01", "negative"), ("mul_i4", 8, 64, "012", "01", "wide"),
    ("mul_i6", 12, 64, "odd", "01", "extremes"), ("adder_i4", 4, 16, "012", "01", "INT_MIN"),
    ("n5m31", 8, 24, "012", "01", "extremes"), ("n6m12", 12, 24, "odd", "odd", "negative"),
    ("n8m9", 10, 24, "012", "01", "wide"),
    ("n17m5", 6, 12, "012", "01", "exact"), ("n20m6w40", 8, 12, "odd", "01", "negative"),
    ("n40m7w3", 8, 20, "012", "odd", "S=90"), ("n133m9w2", 6, 9, "odd", "01", "wide"),
]
TE_LARGE = ("mul_i8", 16, 65536)
# the tensor jobs: the smoke sweep's 2-bit multipliers with its tensor
# options (repro/fleet/plan.py), and the 4-bit multiplier at
# tensor_search's defaults with the nightly sweep's ETs 1/8 and 1/4 of 225;
# the budget is a safety net the generation count always beats
SMOKE_TENSOR = {"population": 512, "generations": 24, "elites": 64, "keep": 4}
SEARCH_JOBS = [("mul", 2, 1, SMOKE_TENSOR), ("mul", 2, 2, SMOKE_TENSOR),
               ("mul", 4, 28, {}), ("mul", 4, 56, {})]
SEARCH_BUDGET_S = 600.0
# the baseline engines' jobs of the fleet's 8-bit sweep (repro/fleet/plan.py):
# the rewrite engines on the 4-bit multiplier, annealing on the 2-bit one,
# with its step options; the budget is a safety net the steps always beat
BASELINE_JOBS = [(name, 4, et) for name in ("muscat", "mecals") for et in (4, 28, 56)] \
    + [("anneal", 2, 1), ("anneal", 2, 2)]
ANNEAL_OPTS = {"steps": 6000, "restarts": 3, "keep": 3}
BASELINE_BUDGET_S = 600.0


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


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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
        if name == "template_eval":
            continue  # one line per kernel, by template_eval_ptxas
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"[build] {name}: {line.strip()}")
    return {"seconds": secs, "flash_tensor_core_products": flash_sass(_build),
            "template_eval_ptxas": template_eval_ptxas(_build)}


def template_eval_ptxas(_build) -> dict:
    """Registers, static shared memory and spills of each template_eval
    kernel (kMaxM output registers; kGroups input groups of one key word,
    or 0 where the kernel loops over key words), from ptxas -v; the
    dynamic shared memory of a launch is in its plan."""
    import re

    log_text = (_build.BUILD_DIR / "template_eval.log").read_text()
    found = {}
    for part in log_text.split("Compiling entry function")[1:]:
        kind = re.search(r"template_eval_kernelILi(\d+)ELi(\d+)E", part)
        regs = re.search(r"Used (\d+) registers", part)
        smem = re.search(r"(\d+) bytes smem", part)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        if not (kind and regs):
            continue
        row = {"registers": int(regs.group(1)),
               "static_smem_bytes": int(smem.group(1)) if smem else 0,
               "spill_stores": int(spills.group(1)) if spills else 0,
               "spill_loads": int(spills.group(2)) if spills else 0}
        found[f"kMaxM={kind.group(1)} kGroups={kind.group(2)}"] = row
        log(f"[build] template_eval kMaxM={kind.group(1)} kGroups={kind.group(2)}: "
            f"{row['registers']} registers, {row['static_smem_bytes']} B static shared "
            f"memory, spills {row['spill_stores']} B stored / {row['spill_loads']} B loaded")
    require(len(found) == 6, f"ptxas reported {len(found)} of 6 template_eval kernels")
    return found


def flash_sass(_build) -> dict:
    """The tensor-core products each bf16 flash kernel was compiled to,
    from its SASS: HGMMA with A from shared memory (S = Q K^T) and with A
    from registers against a transposed B (O += P V).  Both must be there."""
    import re

    lib = _build.library_path("flash_attention")
    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
                           str(lib)], capture_output=True, text=True, check=True).stdout
    found = {}
    for body in sass.split("Function : ")[1:]:
        head = body.split("\n", 1)[0]
        dim = re.search(r"flash_bf16_kernelILi(\d+)E", head)
        if dim is None:
            continue
        ops = re.findall(r"(HGMMA\.\w+\.F32\.BF16) R\d+, (gdesc|R\d+)", body)
        qk = sum(1 for _, a in ops if a == "gdesc")
        pv = sum(1 for _, a in ops if a != "gdesc")
        shapes = sorted({op for op, _ in ops})
        found[int(dim.group(1))] = {"qk": qk, "pv": pv, "ops": shapes}
        log(f"[build] flash_attention bf16 D={dim.group(1)}: {qk} {'/'.join(shapes)} "
            f"from shared memory (S = Q K^T), {pv} with P from registers (O += P V)")
    require(sorted(found) == [64, 128, 256] and all(f["qk"] and f["pv"] for f in found.values()),
            f"bf16 flash kernels without tensor-core products for both products: {found}")
    return found


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def phase_kernels(torch, results: dict) -> None:
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

    def composed(tile):
        return torch.as_tensor(tile_to_width(tile.cpu().numpy()),
                               dtype=torch.int32, device=dev)

    lut4 = codes((16, 16), 226)
    lut8 = composed(codes((16, 16), 256))
    rows = []
    for name, side, table, kernel in (("approx_matmul_w4", 16, lut4, am.approx_matmul_w4),
                                      ("approx_matmul_w8", 256, lut8, am.approx_matmul_w8)):
        worst = 0
        for M, K, N in MM_SHAPES + MM_RAGGED + MM_EDGES:
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
            # the tensor-core form's own floor: 16 u8 products a lookup,
            # two planes at W8A8
            planes = 1 if side == 16 else 2
            floor_ms, _ = bound(nbytes, planes * 16 * 2.0 * M * K * N, "int8")
            rows.append({"name": name, "shape": [M, K, N], "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bms, "bound_by": by,
                         "form_floor_ms": floor_ms, "max_abs_err": 0})
            log(f"[kernels] {name} {M}x{K}x{N}: bit-equal; kernel {ms:.4f} ms, "
                f"plain {plain_ms:.3f} ms, bf16 matmul {lib_ms:.4f} ms, "
                f"bound {bms:.4f} ms ({by}), form floor {floor_ms:.4f} ms")
        log(f"[kernels] {name}: bit-equal at {len(MM_SHAPES + MM_RAGGED + MM_EDGES)} "
            f"shapes, tile edges included")
        results["max_err"][name] = worst

    M, K, N = MM_OVERFLOW
    full = torch.full((16, 16), 255, dtype=torch.int32, device=dev)
    a = torch.full((M, K), 255, dtype=torch.int32, device=dev)
    b = torch.full((K, N), 255, dtype=torch.int32, device=dev)
    got = am.approx_matmul_w8(a, b, composed(full))
    torch.cuda.synchronize()
    edge = 255 * 289 * K
    require(bool((got == edge).all()),
            f"approx_matmul_w8 {M}x{K}x{N} at the overflow edge: entries "
            f"{int(got.min())}..{int(got.max())}, expected {edge} (saturated?)")
    log(f"[kernels] approx_matmul_w8 {M}x{K}x{N}, all codes and tile entries "
        f"255: every entry {edge}, nothing saturates")

    # entries past a byte take one more pass over K a byte: composed 2-bit
    # blocks reach 375 (two passes); any int32 W4A4 table (four passes) is
    # exact modulo 2^32, as the plain version's int32 sum
    wide = []
    tile = codes((16, 16), 376)
    tile[15, 15] = 375
    anyint = torch.randint(-2**31, 2**31 - 1, (16, 16), generator=gen, device=dev,
                           dtype=torch.int32)
    for name, side, table, kernel, passes in (
            ("approx_matmul_w4", 16, tile, am.approx_matmul_w4, 2),
            ("approx_matmul_w8", 256, composed(tile), am.approx_matmul_w8, 2),
            ("approx_matmul_w4", 16, anyint, am.approx_matmul_w4, 4)):
        for M, K, N in MM_SHAPES + MM_RAGGED[:2]:
            a, b = codes((M, K), side), codes((K, N), side)
            got = kernel(a, b, table)
            torch.cuda.synchronize()
            diff = int((got.long() - ref.approx_matmul(a, b, table).long()).abs().max())
            require(diff == 0, f"{name} {M}x{K}x{N}, {passes}-pass table: differs "
                               f"from the plain version by {diff}")
            if (M, K, N) not in MM_SHAPES[::2] or passes != 2:
                continue
            ms = time_ms(torch, lambda: kernel(a, b, table), iters=20)
            wide.append({"name": name, "shape": [M, K, N], "passes": passes, "ms": ms})
            log(f"[kernels] {name} {M}x{K}x{N}, table past a byte ({passes} passes): "
                f"bit-equal; kernel {ms:.4f} ms")
        log(f"[kernels] {name}: bit-equal with a {passes}-pass table at "
            f"{len(MM_SHAPES) + 2} shapes")
    results["tables_past_a_byte"] = wide

    worst = 0.0
    timed = {}
    for case in FLASH_CASES:
        B, H, Hkv, Lq, Lk, D, dt, window, causal = case
        q, k, v = flash_inputs(torch, gen, case)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        tag = flash_tag(case)
        require(err < FLASH_TOL[dt], f"flash_attention {tag}: max |err| {err} "
                                     f">= {FLASH_TOL[dt]}")
        blind = Lq - Lk if causal and Lk < Lq else 0  # rows that see no key
        require(not bool(got[:, :, :blind].any()),
                f"flash_attention {tag}: a row that sees no key is not 0")
        log(f"[kernels] flash_attention {tag}: max |err| {err:.3g}"
            + (f", the {blind} rows that see no key 0" if blind else ""))
        if case in FLASH_TIMED:
            timed[case] = flash_timing(torch, fa, ref, q, k, v, case) | {
                "max_abs_err": err}
    for case in FLASH_TIMED:
        row = timed[case]
        rows.append(row)
        log(f"[kernels] flash_attention {flash_tag(case)}: kernel {row['ms']:.4f} "
            f"ms a call ({fmt_ms(row['device_ms'])} alone), plain {row['plain_ms']:.3f} "
            f"ms, sdpa ({row['library_call']}) {fmt_ms(row['library_ms'])} a call "
            f"({fmt_ms(row['library_device_ms'])} alone), bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
    results["max_err"]["flash_attention"] = worst
    results["timings"] = rows


def flash_tag(case) -> str:
    B, H, Hkv, Lq, Lk, D, dt, window, causal = case
    return (f"({B},{H},{Hkv},{Lq},{Lk},{D}) {dt} "
            f"{'causal' if causal else 'non-causal'} window={window}")


def flash_inputs(torch, gen, case):
    B, H, Hkv, Lq, Lk, D, dt, _, _ = case
    dtype = getattr(torch, dt)
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in ((B, H, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D))]


def flash_mask(torch, Lq: int, Lk: int, causal: bool, window):
    """(Lq, Lk) booleans: the (query, key) pairs a row sees, queries
    aligned to the end of the keys."""
    qi = torch.arange(Lq, device="cuda")[:, None] + (Lk - Lq)
    ki = torch.arange(Lk, device="cuda")[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device="cuda")
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    return mask


def flash_timing(torch, fa, ref, q, k, v, case) -> dict:
    """Kernel per call (CUDA events) and alone (profiler), the plain
    version, one SDPA call, and the bound over the pairs the mask leaves.
    SDPA's ``is_causal`` aligns the mask to the top left, which equals
    this kernel's end-aligned mask only when Lq == Lk; other shapes give
    SDPA the kernel's mask as an explicit boolean ``attn_mask``."""
    import torch.nn.functional as F

    B, H, Hkv, Lq, Lk, D, dt, window, causal = case
    mask = flash_mask(torch, Lq, Lk, causal, window)
    if window is None and (Lq == Lk or not causal):
        how, kw = ("is_causal" if causal else "no mask"), {"is_causal": causal}
    else:
        how, kw = "attn_mask", {"attn_mask": mask}

    def kernel():
        return fa.flash_attention(q, k, v, causal=causal, window=window)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)

    ms = time_ms(torch, kernel, iters=20)
    dev_ms = kernel_device_ms(torch, kernel, "flash")
    plain_ms = time_ms(torch, lambda: ref.flash_attention(
        q, k, v, causal=causal, window=window), iters=5)
    try:
        lib_ms = time_ms(torch, sdpa, iters=20)
        lib_dev_ms = kernel_device_ms(torch, sdpa, "", per_call=True)
    except TypeError:  # a PyTorch without enable_gqa has no one call
        lib_ms = lib_dev_ms = None
        how = "none"
    pairs = int(mask.sum())
    ops = 4.0 * B * H * D * pairs
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    bms, by = bound(nbytes, ops, "bf16" if dt == "bfloat16" else "f32")
    return {"name": "flash_attention", "shape": [B, H, Hkv, Lq, Lk, D],
            "dtype": dt, "window": window, "causal": causal, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev_ms, "library_call": how, "bound_ms": bms, "bound_by": by,
            "pairs": pairs}


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


def kernel_device_ms(torch, fn, name: str, iters: int = 20, per_call: bool = False):
    """The device time of one launch of the kernel whose name contains
    ``name`` (with ``per_call``, of all such launches of one call), from
    ``torch.profiler`` over ``iters`` calls: the kernels alone, without the
    host's launch gaps that CUDA events around a call include.  None when
    the profiler records no device time."""
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
    return sum(e.self_device_time_total for e in rows) / 1e3 / (iters if per_call else count)


def te_inputs(torch, gen, case, plan):
    """lits, sel, packed words (int32) and exact values of one TE_CASES
    entry on the card, made from ``gen``; ``plan`` resolves a "wave" P."""
    from repro_torch.core.arith import benchmark
    from repro_torch.core.circuits import input_truth_tables
    from repro_torch.kernels import ref

    name, T, P, lit_kind, sel_kind, ev_kind = case
    tt = None
    if name.startswith("n"):
        n, m, *w = (int(x) for x in name[1:].replace("w", "m").split("m"))
        if w:  # random words, as int32 with their bits
            tt = torch.randint(-2**31, 2**31, (n, w[0]), generator=gen, device="cuda",
                               dtype=torch.int64).to(torch.int32)
        ev = torch.randint(0, 1 << m, (1 << n if tt is None else 32 * w[0],),
                           generator=gen, device="cuda")
    else:
        exact = benchmark(name)
        n, m = exact.n_inputs, exact.n_outputs
        ev = torch.from_numpy(exact.eval_words().astype("int64")).cuda()
    if isinstance(P, str):
        full = plan(65536, T, n, m, max(1, (1 << n) // 32), 1 << n)
        wave = full["blocks"] * full["slab"]
        P = wave + {"wave-1": -1, "wave": 0, "wave+1": 1}[P]

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda")

    lits = ints(0, 3, (P, T, n)) if lit_kind == "012" else ints(-3, 7, (P, T, n))
    sel = ((torch.rand((P, m, T), generator=gen, device="cuda") < 0.4)
           if sel_kind == "01" else ints(-2, 4, (P, m, T)))
    if ev_kind == "negative":
        ev = ints(-300, 300, ev.shape)
    elif ev_kind == "wide":
        ev = ints(0, 1 << 20, ev.shape)
    elif ev_kind == "extremes":
        pick = torch.tensor([-2**31, 2**31 - 1, 0, -1, 1, 2**30], device="cuda")
        ev = pick[ints(0, 6, ev.shape)]
    elif ev_kind == "INT_MIN":
        ev = torch.full(ev.shape, -2**31, device="cuda")
    elif ev_kind.startswith("S="):
        ev = ev[:int(ev_kind[2:])]
    # the words as int32 with the same bits, converted once, as the search
    # hands them to both versions
    if tt is None:
        tt = ref.word_bits_int32(torch.from_numpy(input_truth_tables(n))).cuda()
    return (lits.to(torch.int32), sel.to(torch.int32), tt,
            ev.to(torch.int32).contiguous())


def search_kernel_checks(torch, results: dict) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels import template_eval as te

    gen = torch.Generator(device="cuda").manual_seed(2)
    # largest population first: the kernels line reports the first timed row
    timed = [(b, T, P, "012", "01", "exact")
             for b, T, P in sorted(search_shapes(), key=lambda c: -c[2]) + [TE_LARGE]]
    for case in TE_CASES + timed:
        lits, sel, tt, ev = te_inputs(torch, gen, case, te.plan)
        (P, T, n), m = lits.shape, sel.shape[1]
        tag = (f"template_eval {case[0]} T={T} P={P}"
               + ("" if case[3:] == ("012", "01", "exact") else f" ({', '.join(case[3:])})"))
        wce, esum = te.template_eval(lits, sel, tt, ev)
        torch.cuda.synchronize()
        w_ref, s_ref = ref.template_eval(lits, sel, tt, ev)
        require(torch.equal(wce, w_ref) and torch.equal(esum, s_ref),
                f"{tag}: differs from the plain version (wce "
                f"{int((wce.long() - w_ref.long()).abs().max())}, esum "
                f"{int((esum.long() - s_ref.long()).abs().max())})")
        if case not in timed:
            log(f"[search] {tag}: bit-equal")
            continue
        plan = te.plan(P, T, n, m, tt.shape[1], ev.shape[0])
        ms = time_ms(torch, lambda: te.template_eval(lits, sel, tt, ev), iters=50)
        dev_ms = kernel_device_ms(torch, lambda: te.template_eval(lits, sel, tt, ev),
                                  "template_eval_kernel")
        plain_ms = time_ms(torch, lambda: ref.template_eval(lits, sel, tt, ev),
                           iters=5)
        bms, by = template_eval_bound(lits, sel, tt.shape[1], ev.shape[0])
        results["timings"].append({
            "name": "template_eval", "shape": [case[0], T, P], "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bms, "bound_by": by, "max_abs_err": 0, "plan": plan})
        log(f"[search] {tag}: bit-equal; call {ms:.4f} ms (CUDA events), kernel "
            f"alone {fmt_ms(dev_ms)} (profiler), plain {plain_ms:.3f} ms, bound "
            f"{bms:.6f} ms ({by}), no library call; {plan['blocks']} blocks of "
            f"{plan['slab']}-candidate slabs ({plan['slabs']} slabs), "
            f"{plan['smem_bytes']} B shared memory a block")
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
# phase 3b: the QoS read path -- baselines, plans, a plan served and swapped
# ---------------------------------------------------------------------------
def phase_plans(torch, cfg, params, library: Path, results: dict) -> None:
    """The library the search filled, densified by the baseline engines,
    planned over and served at full width: a W4A4 plan ladder priced by
    measured sensitivities, served at two levels with a hot swap between
    them; a W8A8 plan; and a mixed-width plan that holds both widths.
    Every batch's tokens equal the plain route's on the same plan."""
    import numpy as np

    from repro_torch.core.arith import benchmark
    from repro_torch.core.baselines import muscat_like
    from repro_torch.core.engine import SearchJob, get_engine
    from repro_torch.core.miter import worst_case_error
    from repro_torch.core.synth import area
    from repro_torch.library.qos import (measure_sensitivities, plan_ladder,
                                         select_plan, stack_luts)
    from repro_torch.library.store import OperatorStore
    from repro_torch.models import decode_fn, forward_fn, init_caches
    from repro_torch.models.lm import to_device_luts
    from repro_torch.precision.plans import (WidthFrontier, build_mixed_ladder,
                                             choose_mixed_budget, load_frontier,
                                             load_mixed_frontier, select_width_map,
                                             stack_mixed_luts)
    from repro_torch.precision.widths import exact_table, get_width
    from repro_torch.quant.lut import build_lut, exact_mul_lut
    from repro_torch.serving import ServingEngine, steady, synth_requests

    out: dict = {"baselines": []}
    results["plans"] = out

    # 1. the baseline engines' jobs into the library
    store = OperatorStore(library)
    for name, bits, et in BASELINE_JOBS:
        opts = ANNEAL_OPTS if name == "anneal" else {}
        job = SearchJob("mul", bits, et, name, budget_s=BASELINE_BUDGET_S)
        t0 = time.perf_counter()
        res = get_engine(name, **opts).run(job)
        wall = time.perf_counter() - t0
        require(res.ok and wall < BASELINE_BUDGET_S, f"{job.describe()}: {res.error}")
        if name == "anneal":
            steps = ANNEAL_OPTS["steps"] * ANNEAL_OPTS["restarts"]
            require(res.stats["steps"] == steps,
                    f"{job.describe()}: ran {res.stats['steps']} of {steps} steps")
        for c in res.results:
            store.put_circuit(c.circuit, job.signature(), area=c.area,
                              source=name, proxies=c.proxies, params=c.params)
        best = res.best.area if res.results else None
        log(f"[plans] {job.describe()}: {len(res.results)} sound result(s) stored, "
            f"best area {best}, {wall:.3f} s")
        out["baselines"].append({"job": job.describe(), "results": len(res.results),
                                 "best_area": best, "wall_s": wall})
    exact8 = benchmark("mul_i8")
    t0 = time.perf_counter()
    fixture = muscat_like(exact8, et=4, restarts=2)
    lut_err = int(np.abs(build_lut(fixture.circuit) - exact_mul_lut()).max())
    wce = worst_case_error(exact8, fixture.circuit)
    require(wce <= 4 and lut_err <= 4 and fixture.area < area(exact8),
            f"muscat_like(mul_i8, et=4): wce {wce}, LUT error {lut_err}, area "
            f"{fixture.area} vs exact {area(exact8)}")
    log(f"[plans] the system test's multiplier, muscat_like(mul_i8, et=4, "
        f"restarts=2): sound (wce {wce}, 16x16 LUT error {lut_err}), area "
        f"{fixture.area} < exact {area(exact8)}, {time.perf_counter() - t0:.3f} s")
    out["system_multiplier"] = {"wce": wce, "lut_err": lut_err,
                                "area": fixture.area, "exact_area": area(exact8)}

    L = cfg.n_layers
    reqs = synth_requests(steady(1, 4, prompt_len=16, gen_len=8),
                          cfg.vocab_size, 5)[0]

    def engine(c, backend="auto", **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = ServingEngine(c, params, batch=4, prompt_len=16, gen_len=8,
                            backend=backend, **kw)
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    def serve(eng, kernels):
        """One batch, its kernel launches counted; the tokens and times."""
        reset_counts()
        st = eng.run_batch(reqs)
        counts = read_counts()
        for k in kernels:
            require(counts[k] > 0, f"the plan path launched no {k}")
        return eng.last_tokens.copy(), st, counts

    def plain_tokens(c, **kw):
        eng, _ = engine(c, backend="ref", **kw)
        eng.run_batch(reqs)
        return eng.last_tokens

    first = torch.as_tensor(np.stack([r.tokens[:1] for r in reqs]), device="cuda")

    def step_logits(c, eng, stack, tag: str):
        """One decode step at position 0 on the engine's live buffers
        through the kernels, and on the plan's own stack through the plain
        LUT matmul.  Decode runs no flash, so every other op is the same
        on both and the logits must be equal bit for bit: equal tokens
        alone could hide a wrong table behind a degenerate output."""
        step = decode_fn(c)
        got = step(c, params, init_caches(c, 4, 1, device="cuda"), first, 0,
                   luts=eng._luts, width_map=eng._width_map)[0]
        want = step(c, params, init_caches(c, 4, 1, device="cuda"), first, 0,
                    luts=to_device_luts(stack, torch.device("cuda")),
                    width_map=eng._width_map, backend="ref")[0]
        require(torch.equal(got, want), f"{tag}: position-0 decode "
                f"logits differ from the plain route's on the plan's stack")
        return got

    # 2. the W4A4 ladder, priced by measured sensitivities
    cfg4 = cfg.with_approx_mlp(4)
    fr4 = WidthFrontier.load(library, 4)
    _, probe = max(fr4.compiled, key=lambda rc: rc[1].mae)
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                                     device="cuda")}
    fwd = forward_fn(cfg4)
    exact4 = exact_table("mul", 4).astype(np.int32)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = fwd(cfg4, params, batch, lut=np.stack([exact4] * L))[0]

    def eval_drift(per_layer) -> float:
        stack = np.stack([exact4 if t is None else t for t in per_layer])
        return float((fwd(cfg4, params, batch, lut=stack)[0] - base).abs().mean())

    sens = measure_sensitivities(eval_drift, L, probe)
    torch.cuda.synchronize()
    sens_s = time.perf_counter() - t0
    counts = read_counts()
    require(counts["flash_attention"] == (L + 1) * L
            and counts["approx_matmul_w4"] == 3 * (L + 1) * L,
            f"sensitivity pass launches {counts}, expected {L + 1} forwards")
    log(f"[plans] measured sensitivities, B=1 S=256, probe mae16 "
        f"{probe.mae:.3f}: {L + 1} forwards in {sens_s:.2f} s (flash launches "
        f"{counts['flash_attention']}, approx_matmul_w4 {counts['approx_matmul_w4']}); "
        f"per-layer drift per unit mae16 {sens.min():.4g}..{sens.max():.4g}")
    ladder = plan_ladder(fr4.compiled, sens, exact_area=fr4.exact_area, levels=6)
    require(len(ladder) > 4, f"W4A4 ladder of {len(ladder)} levels, need 5")
    out.update(sensitivity_s=sens_s, sensitivities=sens.tolist(),
               ladder=[{"plan_id": p.plan_id, "area_saving": p.area_saving,
                        "budget": p.budget} for p in ladder])
    log("[plans] W4A4 ladder: " + ", ".join(
        f"{p.plan_id} saves {100 * p.area_saving:.1f}%" for p in ladder))

    eng, build_s = engine(cfg4, plan=ladder[1], compiled=fr4.compiled,
                          exact_area=fr4.exact_area, sensitivities=sens)
    live, ptr = eng._luts, eng._luts.data_ptr()
    levels, logits = [], {}
    for level in (1, 4):
        if level == 4:
            stack = stack_luts(ladder[4], fr4.compiled)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            changed = eng.swap_plan(ladder[4], stack, reason="smoke", batch_idx=1)
            torch.cuda.synchronize()
            swap_ms = 1e3 * (time.perf_counter() - t0)
            require(changed, "swap_plan to ladder level 4 returned False")
            require(eng._luts is live and live.data_ptr() == ptr,
                    "swap_plan moved the live stack")
            require(eng.swap_plan(ladder[4], stack) is False,
                    "a swap to the live plan returned True")
            log(f"[plans] swap_plan level 1 -> 4: True in {swap_ms:.3f} ms "
                f"(host clock, synchronised), live stack at the same address "
                f"{ptr:#x}; the same plan again: False")
            out["swap_ms"] = swap_ms
        tokens, st, counts = serve(eng, ["approx_matmul_w4"])
        same = bool((plain_tokens(cfg4, plan=ladder[level],
                                  compiled=fr4.compiled) == tokens).all())
        require(same, f"W4A4 level {level}: tokens differ from the plain route")
        logits[level] = step_logits(cfg4, eng, stack_luts(ladder[level], fr4.compiled),
                                    tag=f"W4A4 level {level}")
        log(f"[plans] W4A4 level {level} ({ladder[level].plan_id}, saves "
            f"{100 * ladder[level].area_saving:.1f}%): approx_matmul_w4 launches "
            f"{counts['approx_matmul_w4']}, {st.ms_per_step:.2f} ms/step, batch "
            f"{st.prefill_s + st.decode_s:.2f} s; tokens identical to the plain "
            f"route: {tokens[0].tolist()}; position-0 logits bit-equal")
        levels.append({"level": level, "plan_id": ladder[level].plan_id,
                       "area_saving": ladder[level].area_saving,
                       "ms_per_step": st.ms_per_step,
                       "batch_s": st.prefill_s + st.decode_s,
                       "launches": counts["approx_matmul_w4"]})
    d_levels = float((logits[1] - logits[4]).abs().max())
    require(d_levels > 0, "levels 1 and 4 serve the same position-0 logits")
    log(f"[plans] position-0 logits, level 1 against level 4: max |d| {d_levels:.4g}")
    out.update(w4_engine_s=build_s, w4_levels=levels, level_logits_max_abs_d=d_levels)

    # a W8A8 stack is refused and changes nothing
    compiled8, exact_area8, _ = load_frontier(library, 8)
    w8_stack = stack_luts(select_plan(compiled8, np.ones(L), 0.0,
                                      exact_area=exact_area8), compiled8)
    try:
        eng.swap_plan(ladder[2], w8_stack)
        refused = False
    except ValueError as e:
        refused = True
        log(f"[plans] a W8A8 stack handed to swap_plan: ValueError ({str(e)[:80]}...)")
    require(refused, "swap_plan took a W8A8 stack into a W4A4 serve")
    again, _, _ = serve(eng, ["approx_matmul_w4"])
    require(bool((again == tokens).all()) and eng.plan is ladder[4],
            "a refused swap changed the served tokens or the plan")
    log("[plans] after the refused swap: the same plan, the same tokens")

    # 3. a W8A8 plan
    cfg8 = cfg.with_approx_mlp(8)
    budget8 = plan_ladder(compiled8, np.ones(L), exact_area=exact_area8,
                          levels=3)[1].budget
    plan8 = select_plan(compiled8, np.ones(L), budget8, exact_area=exact_area8)
    eng8, build8_s = engine(cfg8, plan=plan8, compiled=compiled8,
                            exact_area=exact_area8)
    tokens8, st8, counts8 = serve(eng8, ["approx_matmul_w8"])
    require(bool((plain_tokens(cfg8, plan=plan8, compiled=compiled8) == tokens8).all()),
            "W8A8 plan: tokens differ from the plain route")
    step_logits(cfg8, eng8, stack_luts(plan8, compiled8), tag="W8A8 plan")
    log(f"[plans] W8A8 plan {plan8.plan_id} (frontier of {len(compiled8)}, budget "
        f"{budget8:.4g}, saves {100 * plan8.area_saving:.1f}%): engine built in "
        f"{build8_s:.2f} s, approx_matmul_w8 launches {counts8['approx_matmul_w8']}, "
        f"{st8.ms_per_step:.2f} ms/step; tokens identical to the plain route: "
        f"{tokens8[0].tolist()}; position-0 logits bit-equal")
    out["w8"] = {"plan_id": plan8.plan_id, "area_saving": plan8.area_saving,
                 "budget": budget8, "engine_s": build8_s,
                 "ms_per_step": st8.ms_per_step,
                 "launches": counts8["approx_matmul_w8"]}
    del eng8

    # 4. a mixed-width plan.  Sensitivities are the same for every layer;
    # per unit of table error they scale, from one width to the next, by
    # the square of the ratio of the two widths' quantization steps
    mixed = load_mixed_frontier(library)
    sens_mixed = {b: np.full(L, (get_width(4).qmax / get_width(b).qmax) ** 2)
                  for b in mixed.widths}
    budget = choose_mixed_budget(mixed, sens_mixed, L)
    width_map, plan_m = select_width_map(mixed, sens_mixed, budget, L)
    groups = {b: width_map.count(b) for b in sorted(set(width_map))}
    log(f"[plans] mixed width: budget {budget:.6g}, layers per width {groups}, "
        f"plan {plan_m.plan_id} saves {100 * plan_m.area_saving:.1f}%")
    require(len(groups) == 2, f"the mixed width map holds one width: {groups}")
    stacks = stack_mixed_luts(plan_m, mixed.compiled, width_map)
    engm, buildm_s = engine(cfg4, plan=plan_m, compiled=mixed.compiled,
                            sensitivities=sens_mixed, width_map=width_map)
    tokens_m, st_m, counts_m = serve(engm, ["approx_matmul_w4", "approx_matmul_w8"])
    require(all(np.array_equal(engm._luts[b].cpu().numpy(), a)
                for b, a in stacks.items()), "the mixed engine's stacks differ")
    plain_m = plain_tokens(cfg4, plan=plan_m, compiled=mixed.compiled,
                           width_map=width_map)
    require(bool((plain_m == tokens_m).all()),
            "mixed-width plan: tokens differ from the plain route")
    step_logits(cfg4, engm, stacks, tag="mixed plan")
    log(f"[plans] mixed plan served: engine built in {buildm_s:.2f} s, launches "
        f"approx_matmul_w4 {counts_m['approx_matmul_w4']}, approx_matmul_w8 "
        f"{counts_m['approx_matmul_w8']}, {st_m.ms_per_step:.2f} ms/step; tokens "
        f"identical to the plain route: {tokens_m[0].tolist()}; position-0 "
        f"logits bit-equal")
    mladder = build_mixed_ladder(mixed, width_map, sens_mixed, levels=4)
    target = next(p for p in reversed(mladder.plans) if p.plan_id != plan_m.plan_id)
    live_m = {b: (t, t.data_ptr()) for b, t in engm._luts.items()}
    require(engm.swap_plan(target, stack_mixed_luts(target, mixed.compiled, width_map)),
            "a swap inside the width map returned False")
    want = stack_mixed_luts(target, mixed.compiled, width_map)
    require(all(engm._luts[b] is t and t.data_ptr() == p
                and np.array_equal(t.cpu().numpy(), want[b])
                for b, (t, p) in live_m.items()),
            "a swap inside the width map did not copy into both buffers in place")
    log(f"[plans] swap inside the width map to {target.plan_id}: both buffers "
        f"copied in place ({', '.join(f'{b}-bit at {p:#x}' for b, (_, p) in live_m.items())})")
    out["mixed"] = {"budget": budget, "layers_per_width": groups,
                    "plan_id": plan_m.plan_id, "area_saving": plan_m.area_saving,
                    "engine_s": buildm_s, "ms_per_step": st_m.ms_per_step,
                    "launches": {k: counts_m[k] for k in ("approx_matmul_w4",
                                                          "approx_matmul_w8")},
                    "swapped_to": target.plan_id}


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
    phase_plans(torch, cfg, params, library, results)
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
