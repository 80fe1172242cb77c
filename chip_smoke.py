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
   the fleet (``[fleet]`` lines): ``python -m repro_torch.fleet --sweep
   8bit`` in this process fills that library, its CPU jobs on a spawned
   pool (CUDA is up) and its tensor jobs on the card, each through
   ``template_eval`` (launches = the sum of generations + 1 over them),
   inside a traced ``fleet.job`` span; a second call skips every job; with
   the receipts deleted a third adds no record; ``python -m
   repro_torch.core.search --method tensor`` runs on the card;
   the QoS read path (``[plans]`` lines): the rewrite engines
   (``get_engine("muscat" | "mecals")``) add the 4-bit multipliers at the
   two ETs past the sweep's grid, and ``muscat_like`` finds the system test's sound,
   smaller multiplier; a W4A4 ``plan_ladder`` priced by sensitivities
   measured through ``forward_lm`` serves at two levels through
   ``ServingEngine(plan=...)`` with a ``swap_plan`` between them that
   copies into the live stack in place, a W8A8 stack is refused; a W8A8
   plan and a mixed-width plan that holds both widths serve too; every
   batch's tokens, and one decode step's logits, equal the plain route's
   on the same plan;
   the control plane (``[control]`` lines): every engine captures its
   decode step once as a CUDA graph and replays it for every token; an
   adaptive W4A4 serve whose ``QoSController`` walks a ``PlanLadder``
   while a ``LibraryWatcher`` picks up an operator put into the store
   mid-serve, with a shadow step every batch; a class-aware serve
   (``ClassScheduler``, ``OnlineSensitivity``) over the mixed map; each
   captured once, its last batch bit-equal to the eager kernel route
   (tokens and final logits) and to the plain route (tokens), a replay on
   the final plan bit-equal to an eager step and timed against it;
   the continuous tier (``[continuous]`` lines): a
   ``ContinuousServingEngine`` whose paged decode step is captured once
   serves a spike of 20 requests over 8 slots and a 54-page pool at W4A4
   (ms a step, tok/s at full occupancy, TTFT, peak pages, a replay against
   the eager paged step); SLO preemption under a class scheduler, a QoS
   controller, a health plane and a traced provenance ledger (every
   request's lifecycle chain complete, the ledger gap-free, the cost report
   reconciled, every page returned); two replicas behind the router; the
   kernel route's completions and one step's logits equal the plain
   route's, paged decode's tokens equal the dense step's, a preempted
   request's tokens equal a non-preempting run's; a W8A8 serve equal to
   its plain route;
4. serve full-width qwen3-4b (random weights from a seed, bf16) at W4A4
   through ``ServingEngine.serve``, then one batch again with the plain LUT
   matmul: the generated tokens must be identical;
5. serve one batch at W8A8 on a composed stack, and again with the plain
   LUT matmul: identical tokens;
6. run ``forward_lm`` at B=2, S=512, W4A4: the first position's logits
   must equal the plain path's bit for bit;
7. call the system's entry points in this process (``[cli]`` lines): the
   profiler's ``main`` at W4A4 over the searched library (36 flash and 108
   W4A4 launches a forward), then at its default widths 4 and 8 (the
   8-bit probe's layer through the direct kernel, 3 launches a probe
   forward), with width 8's sensitivities bit-equal to the plain route's
   on the model cut to 4 layers at 128 rows of one token, the serve
   launcher's ``main`` on the continuous traffic with classes, a
   controller, the profile, a trace and the health plane (one capture,
   every request chain complete, launches 108 a replay) and at W8A8 priced
   by the width-8 profile, and the inspector's gates over that trace, each
   exiting 0;
8. serve gemma3-1b, the reference's default model, at full width from the
   fleet's library (``[gemma3]`` lines): ``forward_lm`` at B=2 S=1024 on
   the cheapest sound operator at W4A4, 26 flash launches (its 22 local
   layers at window 512) and 78 W4A4 ones, position 0 bit-equal to the
   plain route; one local layer's attention within 2e-2 of the plain
   version; the launcher at W8A8 (78 launches a replay, captured once); a
   continuous W4A4 serve over 22 rings and 4 paged layers, captured once,
   equal to the plain route; the profiler's ``main`` with its default
   arch; and ``python -m repro_torch.examples.{approx_inference,
   serve_batch}``;
9. run every other decoder-only family at full width, one model at a
   time with random weights from seed 0 (``[families]`` lines):
   deepseek-v2-lite-16b through ``python -m repro_torch.launch.serve
   --continuous`` at W4A4 on the fleet's library (one capture, 162 W4A4
   launches a replay: 2 shared experts x 3 linears x 27 layers); then
   deepseek-v2-lite-16b (MoE + MLA), internvl2-1b (256 patches), hymba-1.5b
   (attention + SSM, window 1024), rwkv6-3b, mixtral-8x7b cut to 8 of 32
   layers and command-r-plus-104b cut to 2 of 64 (so that their weights fit
   the card): ``forward_lm`` held against the plain route (every logit
   where no layer takes flash, else position 0) and timed with its
   launches and flash windows; decode against the teacher-forced forward
   (exact MLP, MoE capacity raised, as the reference's test); a serve on
   the kernel and the plain route (continuous where the reference pages
   the family, fixed-batch for the recurrent ones and command-r), captured
   once, identical tokens and one step's logits bit-equal; command-r's
   W8A8 stack refused before any launch;
10. the encoder–decoder family and training (``[train]`` lines):
   whisper-tiny at full width (``forward_encdec`` at B=2 S=448 timed,
   decode at position 0 within 2e-2 of the teacher-forced forward,
   ``python -m repro_torch.launch.serve --arch whisper-tiny`` with the
   warm-up staging cross K/V, captured once, ``--library`` and
   ``--continuous`` refused, a replay bit-equal to the eager step);
   stablelm-1.6b trained 5 steps at batch 8x128 through
   ``repro_torch.launch.train.main`` (loss finite, grad norm > 0, every
   parameter changed, ms a step by CUDA events, tokens/s, peak memory, no
   kernel launched: the step differentiates the plain route); rwkv6-3b
   at full width cut to 2 layers, in float32 at 4x1,024 tokens, its loss
   and gradients through the WKV scan's autograd function (one state a
   step saved) and through autograd over the plain loop (three), equal
   within the float32 tolerance, each with its ms a step and peak memory;
   the gradient guard raising before any launch; microbatches 2 against 1; a
   step bit-equal with and without deterministic algorithms; resume bit
   for bit through the launcher for whisper-tiny and reduced mixtral; and
   ``python -m repro_torch.examples.train_small`` exiting 0;
11. the roofline and the dry-run (``[roofline]`` and ``[dryrun]`` lines):
   ``analysis.analyze`` under ``parallel.activate(make_smoke_mesh())`` on
   a world of one, with the parameters (and caches, optimizer state) as
   replicated DTensors, over (a) the W4A4 decode step at 8 rows, (b)
   ``forward_lm`` at B=2 S=512 through flash and (c) stablelm-1.6b's train
   step at 8x128: counted FLOPs and bytes a device, t*, the modelled step,
   the measured ms of the plain step and the share t*/measured; the
   counted FLOPs equal to an independent count from the config (and the
   kernel route's to the plain route's), the DTensor logits (and loss)
   bit-equal to the plain step's, both kernels launched on local shards;
   then ``python -m
   repro_torch.launch.dryrun`` in seven processes started together and
   seeing no card, qwen3-4b at full width on a fake world (train, prefill
   and decode on 16x16, long_500k's skip record, the 2x16x16 train step)
   and the MoE train steps of mixtral-8x7b and deepseek-v2-lite-16b and
   rwkv6-3b's (which must fit the card) on 16x16, each exiting 0, with its
   temporary and argument bytes a device against the card's 80 GB; with them the hill-climb (``[hillclimb]``
   lines): ``python -m repro_torch.experiments.hillclimb --step TAG``, one
   process a step, its nine iterations at full width, each ``ok``, and
   each pair's Pareto iterations and fastest
   (``repro_torch.experiments.hillclimb.picks``);
12. print the kernels line (launches on the main path, deviations, times,
   bounds), where a decode step's time goes, the card's name and power
   limit, and a last line of JSON.

Each main path is driven with the launch counters set to 0 just before it
and read just after; a kernel of the path with 0 launches fails the run.
A graph replay credits each kernel's counter with the launches it makes
(``StaticStep.launches_per_replay``), so the counts are the kernels'
launches on the card, the warm-up before the capture included.
Needs one CUDA card; exits nonzero and prints no result without one.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
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

# qwen3-4b MLP matmul shapes: decode (M = the fixed engine's batch of 4
# and the continuous engine's 8 slots), the profiler's B=4 x S=32 forwards
# (M = 128) and the B=2 x S=512 forward (M = 1024), for w1/w3 (K=d_model)
# and w2 (K=d_ff); then gemma3-1b's (d_model 1152, d_ff 6912): its W8A8
# serve at batch 4 and its B=2 x S=1024 forward (M = 2048)
MM_SHAPES = [(4, 2560, 9728), (4, 9728, 2560), (8, 2560, 9728),
             (8, 9728, 2560), (128, 2560, 9728), (128, 9728, 2560),
             (1024, 2560, 9728), (1024, 9728, 2560),
             (4, 1152, 6912), (4, 6912, 1152), (2048, 1152, 6912),
             (2048, 6912, 1152)]
# the W4A4 shapes the other decoder-only families run ([families]), each
# at its serve's rows and its forward's: deepseek-v2-lite-16b's shared
# experts (d_model 2048, d_ff_expert 1408) at 8 slots and B=2 x S=512;
# internvl2-1b's FFN (896, 4864) at 8 slots and B=2 x (256 patches + 256
# tokens); hymba-1.5b's (1600, 5504) at batch 4 and B=2 x S=2048;
# command-r-plus-104b's (12288, 33792) at batch 8 and B=1 x S=1024.  The
# families serve W4A4 only, and W8A8 refuses command-r's w2 (K = 33,792 past
# its max_k of 29,140: MM_W8_REFUSED), so these run the W4A4 kernel only
MM_FAMILIES = [(8, 2048, 1408), (8, 1408, 2048), (1024, 2048, 1408),
               (1024, 1408, 2048), (8, 896, 4864), (8, 4864, 896),
               (1024, 896, 4864), (1024, 4864, 896), (4, 1600, 5504),
               (4, 5504, 1600), (4096, 1600, 5504), (4096, 5504, 1600),
               (8, 12288, 33792), (8, 33792, 12288), (1024, 12288, 33792),
               (1024, 33792, 12288)]
MM_W8_REFUSED = (8, 33792, 12288)
# the kernels line reports each LUT matmul at the rows of the paths that
# launch it most: the continuous serve's 8 slots at W4A4; at W8A8 both
# paths (the fixed batch and the continuous serve) run 4 rows
LINE_SHAPES = {"approx_matmul_w4": [8, 2560, 9728],
               "approx_matmul_w8": [4, 2560, 9728],
               "approx_matmul_w8_direct": [128, 2560, 9728]}
# the direct kernel (any (256, 256) table) where its launches come from: the
# profiler's width-8 probe layer at B=4 x S=32 (M = 128) on qwen3-4b's w1/w3
# and w2, and decode's 4 rows; each on the probe, random u16 entries,
# negative entries (one plane, and any int32: two), a composed table; the
# ragged shapes around its 8- and 32-row tiles with the probe
DIRECT_SHAPES = [(128, 2560, 9728), (128, 9728, 2560), (4, 2560, 9728)]
DIRECT_RAGGED = [(1, 64, 40), (8, 300, 200), (9, 53, 129), (37, 53, 29),
                 (130, 257, 64), (257, 300, 129)]
DIRECT_TABLES = ("probe", "u16", "negative", "int32", "composed")
# [cli]'s width-8 profile held against the plain route on qwen3-4b cut to
# this many layers: the plain gather takes about 40 ms a product at 128 rows
PROFILE_PLAIN_LAYERS = 4
MM_RAGGED = [(37, 53, 29), (130, 257, 64), (1, 2560, 9728), (64, 9728, 2560)]
# the tensor-core kernels' tile edges: activation rows around the 8-, 64-
# and 128-row tiles, depths ending inside a 16-deep stage, columns ending
# inside a 128-column block, and rows whose codes are not 16-byte aligned
MM_EDGES = ([(M, 300, 200) for M in (1, 4, 8, 9, 63, 64, 65, 256, 1024)]
            + [(257, 300, 129), (9, 53, 129), (65, 53, 129)])
# W8A8 at its overflow edge: every code and tile entry 255 at K = max_k
# gives 255 * 289 * 29,140 = 2,147,472,300 in every entry
MM_OVERFLOW = (3, 29140, 70)
# (B, H, Hkv, Lq, Lk, D, dtype, window, causal): the profiler's forward
# (the whole sequence inside one partial key tile and one partial query
# block), the main path's prefill shape, a kv prefix, windows, gemma3-1b's
# forward (its local layers at window 512 and its global ones), head dims
# 64 and 256, non-causal, ragged lengths, Lk < Lq, whose first rows see no
# key, and the reduced models' head dims 16 and 32
FLASH_CASES = [
    (4, 32, 8, 32, 32, 128, "bfloat16", None, True),
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
    (2, 4, 1, 1024, 1024, 256, "bfloat16", 512, True),   # gemma3-1b's forward:
    (2, 4, 1, 1024, 1024, 256, "bfloat16", None, True),  # local and global
    (2, 8, 1, 512, 512, 256, "bfloat16", None, True),    # gemma3's head dim
    (2, 8, 1, 512, 512, 256, "float32", 200, True),
    (1, 8, 2, 333, 333, 256, "bfloat16", None, False),   # non-causal, ragged
    (1, 8, 2, 333, 333, 128, "float32", None, False),
    (1, 8, 2, 300, 100, 128, "bfloat16", None, True),    # 200 rows see no key
    (1, 8, 2, 300, 100, 64, "float32", 64, True),
    (4, 4, 2, 32, 32, 16, "bfloat16", None, True),       # the reduced models'
    (4, 4, 2, 32, 32, 16, "float32", None, True),        # head dims, run
    (4, 2, 1, 32, 32, 32, "bfloat16", 16, True),         # zero-padded on the
    (4, 2, 1, 32, 32, 32, "float32", None, True),        # D = 64 kernel
]
# the families' forwards ([families]): internvl2-1b (GQA 14/2, D 64, 256
# patches + 256 tokens), hymba-1.5b (25/5, D 64, S 2048: its local layers at
# window 1024 and its global ones), mixtral-8x7b (32/8, D 128, S 8192,
# window 4096) and command-r-plus-104b (96/8, D 128, S 1024); bf16 causal,
# each checked and timed
FLASH_FAMILIES = [(2, 14, 2, 512, 512, 64, "bfloat16", None, True),
                  (2, 25, 5, 2048, 2048, 64, "bfloat16", 1024, True),
                  (2, 25, 5, 2048, 2048, 64, "bfloat16", None, True),
                  (1, 32, 8, 8192, 8192, 128, "bfloat16", 4096, True),
                  (1, 96, 8, 1024, 1024, 128, "bfloat16", None, True)]
FLASH_CASES += FLASH_FAMILIES
# timed, in this order (the profiler's shape first, which carries most of
# flash's launches: the kernels line takes the first row of each kernel)
FLASH_TIMED = [(4, 32, 8, 32, 32, 128, "bfloat16", None, True),
               (2, 32, 8, 512, 512, 128, "bfloat16", None, True),
               (1, 32, 8, 128, 384, 128, "bfloat16", None, True),
               (2, 32, 8, 512, 512, 128, "bfloat16", 128, True),
               (2, 32, 8, 512, 512, 128, "float32", None, True),
               (2, 4, 1, 1024, 1024, 256, "bfloat16", 512, True),
               (2, 4, 1, 1024, 1024, 256, "bfloat16", None, True),
               *FLASH_FAMILIES]
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
# the fleet's 8-bit sweep fills the library through its CLI ([fleet]); the
# rewrite engines on the 4-bit multiplier at the two ETs of the tensor
# jobs past its grid (1, 2, 4, 8) add to it ([plans]); the budget is a
# safety net the rewrites always beat
FLEET_SWEEP = "8bit"
BASELINE_JOBS = [(name, 4, et) for name in ("muscat", "mecals") for et in (28, 56)]
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


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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
    for name, side, table, kernel, extra in (
            ("approx_matmul_w4", 16, lut4, am.approx_matmul_w4, MM_FAMILIES),
            ("approx_matmul_w8", 256, lut8, am.approx_matmul_w8, [])):
        worst = 0
        timed = MM_SHAPES + extra
        for M, K, N in MM_SHAPES + extra + MM_RAGGED + MM_EDGES:
            a, b = codes((M, K), side), codes((K, N), side)
            got = kernel(a, b, table)
            torch.cuda.synchronize()
            want = ref.approx_matmul(a, b, table)
            diff = int((got.long() - want.long()).abs().max())
            worst = max(worst, diff)
            require(diff == 0, f"{name} {M}x{K}x{N}: differs from the plain "
                               f"version by {diff}")
            if (M, K, N) not in timed:
                continue
            ms = time_ms(torch, lambda: kernel(a, b, table), iters=20)
            # the plain gather takes about 12 ms a G products: one timed
            # call past 1e11 (command-r's forward, about 5 s a call)
            heavy = M * K * N > 1e11
            plain_ms = time_ms(torch, lambda: ref.approx_matmul(a, b, table),
                               iters=1 if heavy else 2, warmup=0 if heavy else 1)
            xa = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            xb = torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
            lib_ms = time_ms(torch, lambda: torch.matmul(xa, xb), iters=20)
            nbytes = 4 * (M * K + K * N + M * N) + 4 * side * side
            bms, by = bound(nbytes, 2.0 * M * K * N, "int8")
            # the tensor-core form's own floor: 16 u8 products a lookup,
            # two planes at W8A8
            planes = 1 if side == 16 else 2
            floor_ms, _ = bound(nbytes, planes * 16 * 2.0 * M * K * N, "int8")
            row = {"name": name, "shape": [M, K, N], "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bms, "bound_by": by,
                   "form_floor_ms": floor_ms, "max_abs_err": 0}
            if (M, K, N) in extra:   # the families' shapes: the kernel alone too
                row["device_ms"] = kernel_device_ms(
                    torch, lambda: kernel(a, b, table), "lut_mma", per_call=True)
            rows.append(row)
            log(f"[kernels] {name} {M}x{K}x{N}: bit-equal; kernel {ms:.4f} ms"
                + (f" ({fmt_ms(row['device_ms'])} alone)" if "device_ms" in row else "")
                + f", plain {plain_ms:.3f} ms, bf16 matmul {lib_ms:.4f} ms, "
                f"bound {bms:.4f} ms ({by}), form floor {floor_ms:.4f} ms")
            del a, b
        log(f"[kernels] {name}: bit-equal at "
            f"{len(MM_SHAPES + extra + MM_RAGGED + MM_EDGES)} shapes, tile edges included")
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
    # past max_k W8A8 is refused before its launch: command-r's w2
    M, K, N = MM_W8_REFUSED
    a, b = codes((M, K), 256), codes((K, N), 256)
    before = am.approx_matmul_w8.launches
    try:
        am.approx_matmul_w8(a, b, lut8)
        refused = None
    except ValueError as e:
        refused = str(e)
    require(refused is not None and "exceeds the overflow-free" in refused
            and am.approx_matmul_w8.launches == before,
            f"approx_matmul_w8 {M}x{K}x{N}: not refused ({refused!r})")
    log(f"[kernels] approx_matmul_w8 {M}x{K}x{N} (command-r's w2 at batch 8) "
        f"refused before a launch: {refused}")
    del a, b

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
    direct_kernel(torch, gen, codes, composed, rows, results)

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


def direct_table(torch, gen, kind: str, composed):
    """A (256, 256) int32 table of ``DIRECT_TABLES`` on the card."""
    import numpy as np

    from repro_torch.precision.widths import exact_table

    dev = "cuda"
    if kind == "probe":   # the profiler's 8-bit truncation probe
        return torch.as_tensor(((exact_table("mul", 8) >> 8) << 8).astype(np.int32),
                               device=dev)
    if kind == "composed":
        return composed(torch.randint(0, 256, (16, 16), generator=gen, device=dev,
                                      dtype=torch.int32))
    lo, hi = {"u16": (0, 65536), "negative": (-30_000, 30_000),
              "int32": (-2**31, 2**31 - 1)}[kind]
    return torch.randint(lo, hi, (256, 256), generator=gen, device=dev,
                         dtype=torch.int32)


def direct_kernel(torch, gen, codes, composed, rows: list, results: dict) -> None:
    """The direct kernel (any (256, 256) table) bit-equal to the plain
    version at ``DIRECT_SHAPES`` on every table of ``DIRECT_TABLES`` and at
    the ragged shapes on the probe; timed on the probe by CUDA events,
    beside the plain version, the bound and the W8A8 kernel on a composed
    table at the same shape.  No PyTorch call computes a table's sum, so
    the library time is null."""
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import ref

    name, kernel = "approx_matmul_w8_direct", am.approx_matmul_w8_direct
    worst, checked = 0, 0
    tables = {kind: direct_table(torch, gen, kind, composed) for kind in DIRECT_TABLES}
    lut8 = tables["composed"]
    for M, K, N in DIRECT_SHAPES + DIRECT_RAGGED:
        a, b = codes((M, K), 256), codes((K, N), 256)
        for kind in DIRECT_TABLES if (M, K, N) in DIRECT_SHAPES else ("probe",):
            table = tables[kind]
            got = kernel(a, b, table)
            torch.cuda.synchronize()
            diff = int((got.long() - ref.approx_matmul(a, b, table).long()).abs().max())
            worst = max(worst, diff)
            checked += 1
            require(diff == 0, f"{name} {M}x{K}x{N} on the {kind} table: differs "
                               f"from the plain version by {diff}")
        if (M, K, N) not in DIRECT_SHAPES:
            continue
        table = tables["probe"]
        ms = time_ms(torch, lambda: kernel(a, b, table), iters=10)
        two = time_ms(torch, lambda: kernel(a, b, tables["int32"]), iters=5)
        plain_ms = time_ms(torch, lambda: ref.approx_matmul(a, b, table), iters=2, warmup=1)
        w8_ms = time_ms(torch, lambda: am.approx_matmul_w8(a, b, lut8), iters=20)
        nbytes = 4 * (M * K + K * N + M * N) + 4 * 256 * 256
        bms, by = bound(nbytes, 2.0 * M * K * N, "int8")
        rows.append({"name": name, "shape": [M, K, N], "ms": ms, "plain_ms": plain_ms,
                     "library_ms": None, "bound_ms": bms, "bound_by": by,
                     "two_plane_ms": two, "w8_composed_ms": w8_ms,
                     "lookups_per_s": M * K * N / (ms / 1e3), "max_abs_err": 0})
        log(f"[kernels] {name} {M}x{K}x{N}: bit-equal on the "
            f"{', '.join(DIRECT_TABLES)} tables; kernel {ms:.4f} ms on the probe "
            f"(one plane, {M * K * N / (ms / 1e3) / 1e12:.3f} T lookups/s), "
            f"{two:.4f} ms on the int32 table (two planes), plain {plain_ms:.3f} ms, "
            f"bound {bms:.4f} ms ({by}); the W8A8 kernel on a composed table "
            f"{w8_ms:.4f} ms")
        del a, b
    log(f"[kernels] {name}: bit-equal in {checked} checks at "
        f"{len(DIRECT_SHAPES + DIRECT_RAGGED)} shapes")
    results["max_err"][name] = worst


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
    """(benchmark, T, P) of every search job's template_eval calls, those
    of [search] and the tensor jobs of the fleet's sweep: T is the job's
    pit or 2 m, P its population, at tensor_search's defaults where the
    job sets none."""
    from repro_torch.core.engine import SearchJob
    from repro_torch.fleet.plan import SWEEPS, plan_jobs

    sweep = SWEEPS[FLEET_SWEEP]
    fleet = [(j.benchmark, j.bits, j.et, sweep.engine_opts["tensor"])
             for j in plan_jobs(sweep) if j.engine == "tensor"]
    shapes = []
    for kind, bits, et, opts in SEARCH_JOBS + fleet:
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
    credit(results, "search", counts, "template_eval")
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
# phase 3a: the fleet fills the library through its CLI
# ---------------------------------------------------------------------------
def phase_fleet(torch, library: Path, results: dict) -> None:
    """``python -m repro_torch.fleet --sweep 8bit`` in this process, into the
    library [search] filled: CUDA is up, so its CPU jobs run on a spawned
    pool while its tensor jobs run here on the card; a second call resumes
    with every job skipped; with the receipts deleted, a third call re-runs
    every job and adds no record (the searches are deterministic on the
    card too).  Then ``python -m repro_torch.core.search --method tensor``
    on the card, into a library of its own."""
    import re

    from repro_torch.core.search import main as search_main
    from repro_torch.fleet import __main__ as fleet_cli
    from repro_torch.fleet.plan import SWEEPS, plan_jobs
    from repro_torch.fleet.worker import RECEIPT_DIR
    from repro_torch.library.store import OperatorStore
    from repro_torch.obs.trace import read_trace

    out: dict = {}
    results["fleet"] = out
    spec = SWEEPS[FLEET_SWEEP]
    jobs = plan_jobs(spec)
    tensor_opts = spec.engine_opts["tensor"]
    anneal_opts = spec.engine_opts["anneal"]
    trace_dir = ROOT / "build" / "fleet_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    store = OperatorStore(library)
    report = re.compile(r"jobs: (\d+) ok, (\d+) resumed/skipped, (\d+) failed; "
                        r"(\d+) operator\(s\) added under (\d+) signature\(s\)")

    def sweep(n: int, *extra):
        n_before = len(store)
        reset_counts()
        rc, text, secs = run_cli(torch, f"fleet_{n}", fleet_cli.main, [
            "--library", library, "--sweep", FLEET_SWEEP, *extra])
        counts = read_counts()
        m = report.search(text)
        require(m is not None, f"fleet call {n}: no report line:\n{text[-2000:]}")
        ok, skipped, failed, added, sigs = (int(x) for x in m.groups())
        pool = re.search(r"fleet: (\d+) CPU job\(s\) on a (\w+) pool", text)
        wall = re.search(r"frontier densification \(([\d.]+)s wall\)", text)
        return {"rc": rc, "ok": ok, "skipped": skipped, "failed": failed,
                "added": added, "signatures": sigs, "stored": len(store) - n_before,
                "pool": pool.group(2) if pool else None, "seconds": secs,
                "report_wall_s": float(wall.group(1)), "counts": counts, "text": text}

    # 1. the sweep
    first = sweep(1, "--min-new", 1, "--trace", trace_dir)
    receipts = [json.loads(p.read_text())
                for p in sorted((library / RECEIPT_DIR).glob("*.json"))
                if p.name != "last_update.json"]
    tensor_r = [r for r in receipts if r["job"]["engine"] == "tensor"]
    anneal_r = [r for r in receipts if r["job"]["engine"] == "anneal"]
    expected = sum(r["stats"]["generations"] + 1 for r in tensor_r)
    require(first["rc"] == 0 and first["ok"] == len(jobs) == len(receipts)
            and first["failed"] == 0 and first["added"] >= 1,
            f"fleet call 1: {({k: v for k, v in first.items() if k != 'text'})}")
    require(first["pool"] == "spawn", f"fleet call 1 ran its CPU jobs on a "
            f"{first['pool']} pool, not a spawned one (CUDA is up)")
    require(all(r["status"] == "ok" for r in receipts)
            and all(r["stats"]["generations"] == tensor_opts["generations"] for r in tensor_r)
            and all(r["stats"]["steps"] == anneal_opts["steps"] * anneal_opts["restarts"]
                    for r in anneal_r),
            "fleet call 1: a job was cut by its budget (tensor generations "
            f"{[r['stats']['generations'] for r in tensor_r]}, anneal steps "
            f"{[r['stats']['steps'] for r in anneal_r]})")
    c = first["counts"]
    require(c["template_eval"] == expected and expected > 0
            and not any(c[k] for k in c if k != "template_eval"),
            f"fleet call 1 launches {c}, expected template_eval {expected} = sum of "
            f"(generations + 1) over {len(tensor_r)} tensor jobs")
    credit(results, "fleet", c, "template_eval")
    spans = read_trace(trace_dir)
    fleet_spans = {s_["id"]: s_ for s_ in spans if s_["name"] == "fleet.job"}
    runs = [s_ for s_ in spans if s_["name"] == "search.run"]
    require(len(fleet_spans) == len(jobs) and len(runs) == len(jobs)
            and all(s_["parent"] in fleet_spans
                    and fleet_spans[s_["parent"]]["attrs"]["engine"] == s_["attrs"]["engine"]
                    for s_ in runs),
            f"fleet trace: {len(fleet_spans)} fleet.job spans, {len(runs)} search.run "
            f"spans, for {len(jobs)} jobs")
    engine_s = {}
    for r in receipts:
        engine_s.setdefault(r["job"]["engine"], []).append(r["engine_s"])
    log(f"[fleet] python -m repro_torch.fleet --sweep {FLEET_SWEEP} --min-new 1 "
        f"--trace: {first['ok']} jobs ok, {first['skipped']} skipped, "
        f"{first['failed']} failed; {first['added']} operators added under "
        f"{first['signatures']} signatures ({len(store)} records in the library); "
        f"CPU jobs on a {first['pool']} pool; sweep {first['report_wall_s']:.1f} s "
        f"(its report), call {first['seconds']:.2f} s; template_eval launches "
        f"{c['template_eval']} = sum of (generations + 1) over {len(tensor_r)} "
        f"tensor jobs; engine seconds by engine "
        + ", ".join(f"{e} {sum(v):.2f} ({len(v)} jobs)" for e, v in engine_s.items())
        + f"; trace: {len(runs)} search.run spans, each inside its fleet.job span")
    for line in first["text"].splitlines():
        if line.startswith("  signature") or re.match(r"  mul\db_", line):
            log(f"[fleet]   {line.strip()}")

    # 2. resumed: every job skipped
    second = sweep(2)
    require(second["rc"] == 0 and second["skipped"] == len(jobs) and second["ok"] == 0
            and second["added"] == 0 and second["stored"] == 0
            and not any(second["counts"].values()),
            f"fleet call 2: {({k: v for k, v in second.items() if k != 'text'})}")
    log(f"[fleet] resumed: {second['skipped']} jobs skipped, {second['added']} added, "
        f"no kernel launched, {second['seconds']:.2f} s")

    # 3. the receipts deleted: every job runs again and adds nothing
    for p in (library / RECEIPT_DIR).glob("*.json"):
        p.unlink()
    third = sweep(3)
    c3 = third["counts"]
    require(third["rc"] == 0 and third["ok"] == len(jobs) and third["added"] == 0
            and third["stored"] == 0 and c3["template_eval"] == expected,
            f"fleet call 3 (receipts deleted): "
            f"{({k: v for k, v in third.items() if k != 'text'})}")
    credit(results, "fleet rerun", c3, "template_eval")
    log(f"[fleet] receipts deleted: {third['ok']} jobs ran again, {third['added']} "
        f"added, {third['stored']} new records: deterministic on the card; "
        f"sweep {third['report_wall_s']:.1f} s, template_eval launches "
        f"{c3['template_eval']}")

    # 4. the search CLI's tensor engine on the card
    own = ROOT / "build" / "search_cli_library"
    shutil.rmtree(own, ignore_errors=True)
    ets = (1, 2)
    reset_counts()
    rc, text, secs = run_cli(torch, "search", search_main, [
        "--benchmark", "mul_i4", "--et", *ets, "--method", "tensor",
        "--library", own])
    counts = read_counts()
    gens = search_defaults()["generations"]
    lines = [line for line in text.splitlines() if " ET=" in line]
    require(len(lines) == len(ets) and all("[tensor]" in line for line in lines)
            and len(OperatorStore(own)) > 0
            and counts["template_eval"] == len(ets) * (gens + 1),
            f"python -m repro_torch.core.search --method tensor: {text[-800:]}, "
            f"launches {counts}")
    credit(results, "core.search", counts, "template_eval")
    for line in lines:
        log(f"[fleet] python -m repro_torch.core.search --method tensor: {line}")
    log(f"[fleet] core.search: {len(OperatorStore(own))} records in {secs:.2f} s, "
        f"template_eval launches {counts['template_eval']} = {len(ets)} x "
        f"({gens} generations + 1)")
    out.update({k: {x: v for x, v in d.items() if x != "text"}
                for k, d in (("first", first), ("resumed", second), ("rerun", third))})
    out["search_cli"] = {"seconds": secs, "lines": lines,
                         "launches": counts["template_eval"]}
    out["records"] = len(store)
    out["mesh"] = fleet_mesh_job(torch, results)


def fleet_mesh_job(torch, results: dict) -> dict:
    """One ``mul_i4`` tensor job (ET 2, which finds sound results) through
    ``TensorEngine(mesh=make_fleet_mesh())``, every visible card on the
    ``data`` axis (one on a one-card host), held equal to the meshless
    job's outcome at the population rounded to the mesh; its launches are
    one a shard a generation and at the harvest."""
    from repro_torch.core.engine import SearchJob, TensorEngine
    from repro_torch.launch.mesh import make_fleet_mesh

    mesh = make_fleet_mesh()
    n = mesh.shape["data"]
    kind, bits, et, opts = SEARCH_JOBS[1]
    job = SearchJob(kind, bits, et, "tensor", budget_s=SEARCH_BUDGET_S)
    reset_counts()
    t0 = time.perf_counter()
    got = TensorEngine(mesh=mesh, **opts).run(job)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    rounded = opts["population"] + (-opts["population"]) % n
    want = TensorEngine(**{**opts, "population": rounded}).run(job)
    gens = opts["generations"]
    require(got.stats["generations"] == gens,
            f"fleet mesh: ran {got.stats['generations']} of {gens} generations")
    require(got.results and outcome_view(got) == outcome_view(want),
            f"fleet mesh: {job.describe()} on a mesh of {n}: {len(got.results)} "
            f"results, or it differs from the meshless job at population {rounded}")
    require(counts["template_eval"] == n * (gens + 1)
            and not any(counts[k] for k in counts if k != "template_eval"),
            f"fleet mesh launches {counts}, expected template_eval {n} x ({gens} + 1)")
    credit(results, "fleet mesh", counts, "template_eval")
    log(f"[fleet] TensorEngine(mesh=make_fleet_mesh()): {n} device(s) on the data "
        f"axis ({', '.join(str(d) for d in mesh.devices)}); {job.describe()} at "
        f"population {rounded}: {len(got.results)} sound result(s), best area "
        f"{got.best.area if got.results else None}, {got.stats['evaluations']} "
        f"evaluations; outcome identical to the meshless job's; {secs:.3f} s; "
        f"template_eval launches {counts['template_eval']} = {n} x ({gens} + 1)")
    return {"devices": n, "population": rounded, "seconds": secs,
            "results": len(got.results), "launches": counts["template_eval"],
            "identical": True}


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
    from repro_torch.models import decode_fn, init_caches
    from repro_torch.models.lm import to_device_luts
    from repro_torch.precision.plans import (WidthFrontier, build_mixed_ladder,
                                             choose_mixed_budget, load_frontier,
                                             load_mixed_frontier, select_width_map,
                                             stack_mixed_luts)
    from repro_torch.precision.widths import get_width
    from repro_torch.quant.lut import build_lut, exact_mul_lut
    from repro_torch.sensitivity.profile import model_eval_drift
    from repro_torch.serving import ServingEngine, steady, synth_requests

    out: dict = {"baselines": []}
    results["plans"] = out

    # 1. the baseline engines' jobs past the fleet's grid into the library
    store = OperatorStore(library)
    for name, bits, et in BASELINE_JOBS:
        job = SearchJob("mul", bits, et, name, budget_s=BASELINE_BUDGET_S)
        t0 = time.perf_counter()
        res = get_engine(name).run(job)
        wall = time.perf_counter() - t0
        require(res.ok and wall < BASELINE_BUDGET_S, f"{job.describe()}: {res.error}")
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
                   luts=eng._routed, width_map=eng._width_map)[0]
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
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sens = measure_sensitivities(model_eval_drift(cfg4, params, batch, 4), L, probe)
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
    # the square of the ratio of the two widths' quantization steps.  The
    # budget is scanned over a ladder of 4 L levels: the fleet's dense
    # W8A8 frontier leaves the both-widths budgets between the 9 levels of
    # the default scan, which then serves every layer at one width
    mixed = load_mixed_frontier(library)
    sens_mixed = {b: np.full(L, (get_width(4).qmax / get_width(b).qmax) ** 2)
                  for b in mixed.widths}
    budget = choose_mixed_budget(mixed, sens_mixed, L, levels=4 * L)
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
                    "width_map": list(width_map),
                    "plan_id": plan_m.plan_id, "area_saving": plan_m.area_saving,
                    "engine_s": buildm_s, "ms_per_step": st_m.ms_per_step,
                    "launches": {k: counts_m[k] for k in ("approx_matmul_w4",
                                                          "approx_matmul_w8")},
                    "swapped_to": target.plan_id}


# ---------------------------------------------------------------------------
# phase 3c: the serving control plane over the captured decode step
# ---------------------------------------------------------------------------
def zero_mul(bits: int):
    """The constant-zero ``bits``-bit multiplier: area about 0, the
    cheapest operator a sweep could land."""
    from repro_torch.core.circuits import Circuit

    c = Circuit.empty(2 * bits, f"zero_mul{bits}")
    z = c.const(False)
    for _ in range(2 * bits):
        c.mark_output(z)
    return c


def drain_order(per_tick, book, batch: int) -> list:
    """The batches a class-aware serve drains, in order: each tick's
    arrivals join their class's queue, drained by priority in batches of
    up to ``batch`` (``ServingEngine.serve``'s own order, which depends
    on the arrivals only)."""
    from collections import deque

    queues = {n: deque() for n in book.names}
    out = []
    for tick in per_tick:
        for r in tick:
            queues[book.route(r.qos_class)].append(r)
        while any(queues.values()):
            q = next(queues[n] for n in book.names if queues[n])
            out.append([q.popleft() for _ in range(min(batch, len(q)))])
    return out


def eager_batch(torch, eng, reqs, luts, backend="auto", warmup=None):
    """One batch through ``decode_fn`` called directly, position by
    position, on fresh caches (staged by ``warmup`` if given): the eager
    route the engine's captured step must reproduce.  Returns (tokens,
    the last step's logits)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import decode_fn, init_caches
    from repro_torch.models.lm import to_device_luts

    cfg, dev = eng.cfg, torch.device("cuda")
    step = decode_fn(cfg)
    caches = init_caches(cfg, eng.batch, eng.total, device=dev)
    if warmup is not None:
        warmup(caches)
    prompts = np.zeros((eng.batch, eng.prompt_len), np.int32)
    for i, r in enumerate(reqs):
        prompts[i, :len(r.tokens)] = r.tokens
    prompts = torch.from_numpy(prompts).to(dev)
    stack = (None if luts is None
             else ops.route_luts(to_device_luts(luts, dev), backend=backend))

    def run(tok, t):
        return step(cfg, eng.params, caches, tok, t, luts=stack,
                    width_map=eng._width_map, backend=backend)[0]

    for t in range(eng.prompt_len):
        logits = run(prompts[:, t:t + 1], t)
    generated = []
    for t in range(eng.prompt_len, eng.total):
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        generated.append(tok)
        logits = run(tok, t)
    return torch.cat(generated, 1)[:len(reqs)].cpu().numpy(), logits


def release(torch) -> None:
    """Free what dropped engines held: their graphs' pools included."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_control(torch, cfg, params, library: Path, results: dict) -> None:
    """The control plane at full width over the captured step: an
    adaptive W4A4 serve whose controller walks a plan ladder while the
    watcher picks up an operator put into the store mid-serve, and a
    class-aware serve over the ``[plans]`` mixed map with online
    sensitivity.  Each keeps one capture; the last batch's tokens and
    final logits equal the eager kernel route's, its tokens the plain
    route's; a replay on the final plan equals an eager step bit for bit,
    and the two are timed."""
    import numpy as np

    from repro_torch.core.synth import area
    from repro_torch.library.compile import load_mul_frontier
    from repro_torch.library.store import OperatorSignature, OperatorStore
    from repro_torch.models import decode_fn, init_caches
    from repro_torch.precision.plans import build_mixed_ladder, load_mixed_frontier
    from repro_torch.precision.widths import get_width
    from repro_torch.sensitivity import ClassBook, ClassScheduler, OnlineSensitivity
    from repro_torch.serving import (ControllerConfig, LibraryWatcher, PlanLadder,
                                     QoSController, ServingEngine, Telemetry,
                                     steady, synth_requests)

    out: dict = {}
    results["control"] = out
    L = cfg.n_layers
    cfg4 = cfg.with_approx_mlp(4)
    geometry = dict(batch=4, prompt_len=16, gen_len=8)
    # an unreachable latency target: the controller walks up on any card;
    # an unbounded drift budget keeps drift from holding it back
    conf = ControllerConfig(target_ms_per_step=1e-6, drift_budget=1e9, patience=1,
                            cooldown=0, shadow_every=1, ewma_alpha=1.0)

    def serve(tag, eng, profile, kernels, on_end=None, **kw):
        """Serve ``profile``; each batch's tokens, the stack the captured
        step read and its final logits, copied at the batch's end.
        ``kernels``: each LUT kernel of the step, with its layers."""
        trail = []

        def on_batch_end(engine, b):
            st = engine.static_step
            stack = ({k: v.clone() for k, v in st.luts.items()}
                     if isinstance(st.luts, dict) else st.luts.clone())
            trail.append((engine.last_tokens.copy(), stack, st.logits.clone()))
            if on_end is not None:
                on_end(engine, b)

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tel = eng.serve(profile, telemetry=Telemetry(), on_batch_end=on_batch_end,
                        log=lambda m: log(f"[control] {tag}: {m}"), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        st = eng.static_step
        require(eng.trace_count == 1, f"{tag}: the step was captured "
                f"{eng.trace_count} times")
        for k in kernels:
            require(counts[k] > 0, f"{tag}: no {k} launched under replay")
        require(st.launches_per_replay == {k: 3 * n for k, n in kernels.items()},
                f"{tag}: launches a replay {st.launches_per_replay}, expected "
                f"3 for each of the layers {kernels}")
        s = tel.summary()
        for i, e in enumerate(tel.events):
            log(f"[control] {tag} batch {i}: class {e['class'] or '-'}, "
                f"{e['n_requests']} requests, plan {e['plan']}, "
                f"{e['ms_per_step']:.2f} ms/step, drift {e['drift']}")
        launched = ", ".join(
            f"{k} {counts[k]} ({st.launches_per_replay[k]} a replay x "
            f"{st.replays} replays + {counts[k] - st.launches_per_replay[k] * st.replays} "
            f"in the warm-up)" for k in kernels)
        log(f"[control] {tag}: {s['batches']} batches in {wall:.2f} s, swaps "
            f"{s['swaps_by_reason']}, decode step captured {eng.trace_count}x in "
            f"{st.capture_s:.3f} s (graph pool {st.pool_bytes / 2**20:.1f} MiB), "
            f"{st.replays} replays; launches {launched}")
        row = {"summary": s, "swaps": tel.swaps, "events": list(tel.events),
               "wall_s": wall, "trace_count": eng.trace_count,
               "capture_s": st.capture_s, "pool_bytes": st.pool_bytes,
               "replays": st.replays, "launches": {k: counts[k] for k in kernels},
               "launches_per_replay": st.launches_per_replay}
        return tel, trail, row

    def hold_last(tag, eng, reqs, trail, **plain_kw):
        """The last batch again through the eager kernel route (tokens
        and final logits bit-equal) and the plain route (tokens)."""
        tokens, stack, logits = trail[-1]
        got_t, got_l = eager_batch(torch, eng, reqs, stack)
        require(np.array_equal(got_t, tokens), f"{tag}: the last batch's tokens "
                f"differ from the eager kernel route's")
        require(torch.equal(got_l, logits), f"{tag}: the last batch's final logits "
                f"differ from the eager kernel route's")
        plain = ServingEngine(cfg4, params, backend="ref", **geometry, **plain_kw)
        plain.run_batch(reqs, **({"luts": stack} if "plan" in plain_kw else {}))
        require(np.array_equal(plain.last_tokens, tokens),
                f"{tag}: the last batch's tokens differ from the plain route's")
        log(f"[control] {tag}: last batch bit-equal to the eager kernel route "
            f"(tokens and final logits) and to the plain route (tokens): "
            f"{tokens[0].tolist()}")
        del plain
        release(torch)

    # 1. the adaptive uniform W4A4 serve
    sens = np.asarray(results["plans"]["sensitivities"])
    compiled, exact_area, _ = load_mul_frontier(library)
    ladder = PlanLadder.build(compiled, L, exact_area=exact_area, sensitivities=sens,
                              levels=6)
    require(len(ladder) >= 4, f"a W4A4 ladder of {len(ladder)} levels, need 4")
    store = OperatorStore(library)

    def densify(engine, b):
        if b == 1:   # a sweep lands the cheapest possible operator mid-serve
            circ = zero_mul(4)
            store.put_circuit(circ, OperatorSignature("mul", 4, "wce", 225),
                              area=area(circ), source="chip_smoke")

    eng = ServingEngine(cfg4, params, plan=ladder.plan(0), compiled=compiled,
                        exact_area=exact_area, sensitivities=sens, **geometry)
    profile = steady(4, 4, prompt_len=16, gen_len=8)
    watcher = LibraryWatcher(library, min_poll_s=0.0)
    tel, trail, row = serve("uniform", eng, profile, {"approx_matmul_w4": L},
                            on_end=densify, controller=QoSController(ladder, conf),
                            watcher=watcher)
    reasons = [sw["reason"] for sw in tel.swaps]
    require(any(r.startswith("qos-") for r in reasons) and "library" in reasons,
            f"uniform serve swaps {tel.swaps}: need a qos-* and a library swap")
    drifts = [e["drift"] for e in tel.events]
    require(all(d is not None and np.isfinite(d) for d in drifts),
            f"uniform serve drift samples {drifts}")
    for sw in tel.swaps:
        log(f"[control] uniform swap at batch {sw['batch']}: {sw['reason']} "
            f"{sw['from']} -> {sw['to']}")
    log(f"[control] uniform: watcher refreshes {watcher.refreshes}, drift samples "
        f"{drifts}, ms/step {[e['ms_per_step'] for e in tel.events]}")
    last = synth_requests(profile, cfg.vocab_size, 0)[-1]
    hold_last("uniform", eng, last, trail, luts=trail[-1][1])

    # one decode step on the final plan: a replay against an eager step
    eng.run_batch(last)
    want_t, want_l = eager_batch(torch, eng, last, eng._luts)
    st = eng.static_step
    require(np.array_equal(eng.last_tokens, want_t) and torch.equal(st.logits, want_l),
            "final plan: the replayed step differs from the eager kernel route")
    step, caches = decode_fn(cfg4), init_caches(cfg4, 4, eng.total, device="cuda")
    tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")

    def eager_step():
        step(cfg4, params, caches, tok, 3, luts=eng._luts)

    graph_ms = time_ms(torch, st.replay, iters=20)
    eager_ms = time_ms(torch, eager_step, iters=5)

    def host_ms(fn, n):
        """The host's time to return from ``fn`` on an idle card, median."""
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        return float(np.median(times))

    host_replay_ms = host_ms(st.replay, 10)
    host_eager_ms = host_ms(eager_step, 3)
    profiled = profile_step(torch, st.replay, tag="[control] replay")
    log(f"[control] final plan {eng.plan.plan_id}: a replay's logits bit-equal to "
        f"the eager kernel route's; W4A4 decode step, batch 4: graph replay "
        f"{graph_ms:.3f} ms, eager {eager_ms:.3f} ms (CUDA events); host time to "
        f"launch one replay {host_replay_ms:.4f} ms, to enqueue one eager step "
        f"{host_eager_ms:.2f} ms (medians, idle card); capture {st.capture_s:.3f} s, "
        f"graph pool {st.pool_bytes / 2**20:.1f} MiB")
    out["uniform"] = row | {"final_plan": eng.plan.plan_id, "graph_ms": graph_ms,
                            "eager_ms": eager_ms, "host_replay_ms": host_replay_ms,
                            "host_eager_ms": host_eager_ms,
                            "watcher_refreshes": watcher.refreshes,
                            "replay_profile": profiled}
    del eng, st, caches
    release(torch)

    # 2. the class-aware serve over the [plans] mixed map
    width_map = tuple(results["plans"]["mixed"]["width_map"])
    mixed = load_mixed_frontier(library)
    sens_mixed = {b: np.full(L, (get_width(4).qmax / get_width(b).qmax) ** 2)
                  for b in mixed.widths}
    mladder = build_mixed_ladder(mixed, width_map, sens_mixed, levels=4)
    book = ClassBook.parse("gold:1.0,batch:1e9")
    scheduler = ClassScheduler(book, mladder, shadow_every=1)
    online = OnlineSensitivity(L)
    mkw = dict(plan=mladder.plan(0), compiled=mixed.compiled,
               sensitivities=sens_mixed, width_map=width_map)
    engm = ServingEngine(cfg4, params, **mkw, **geometry)
    profile_m = steady(4, 4, prompt_len=16, gen_len=8,
                       class_mix=(("gold", 0.5), ("batch", 0.5)))
    tel_m, trail_m, row_m = serve(
        "mixed", engm, profile_m,
        {"approx_matmul_w4": width_map.count(4), "approx_matmul_w8": width_map.count(8)},
        controller=QoSController(mladder, conf), scheduler=scheduler, online=online)
    classes = tel_m.summary()["classes"]
    require(set(classes) == {"gold", "batch"}, f"classes served {set(classes)}")
    require(all(r["drift_samples"] >= 1 for r in classes.values()),
            f"class drift samples {classes}")
    require(classes["gold"]["mean_drift"] <= classes["batch"]["mean_drift"],
            f"gold mean drift {classes['gold']['mean_drift']} > batch's "
            f"{classes['batch']['mean_drift']}")
    require(online.n_updates >= 1, "the online estimate took no sample")
    log(f"[control] mixed map {dict((b, width_map.count(b)) for b in sorted(set(width_map)))}: "
        + "; ".join(f"{n} mean drift {r['mean_drift']} over {r['drift_samples']} "
                    f"samples, {r['ms_per_step']} ms/step" for n, r in classes.items())
        + f"; class caps {scheduler.snapshot()}; online estimate over "
          f"{online.n_updates} samples, per-layer "
          f"{online.sensitivities().min():.4g}..{online.sensitivities().max():.4g}")
    batches = drain_order(synth_requests(profile_m, cfg.vocab_size, 0), book, 4)
    require(len(batches) == len(trail_m), "the drain order differs from the serve's")
    hold_last("mixed", engm, batches[-1], trail_m, **mkw)
    out["mixed"] = row_m | {"classes": classes,
                            "online": online.sensitivities().tolist()}
    del engm
    release(torch)


# ---------------------------------------------------------------------------
# the continuous tier: paged decode captured once, SLO preemption, router
# ---------------------------------------------------------------------------
def phase_continuous(torch, cfg, params, library: Path, results: dict) -> None:
    """The continuous engine at full width over the W4A4 ladder of
    ``[plans]``: (1) the main serve, 8 slots over a 54-page pool, a spike
    of 20 requests of 16-64 prompt tokens; (2) SLO preemption under a
    class scheduler, a QoS controller, a health plane and a traced
    provenance ledger; (3) two replicas behind the router; (4) exactness:
    kernel route against the plain route, paged against dense decode, a
    preempting run against a non-preempting one; (5) W8A8, kernel against
    plain.  Every engine captures its paged step once."""
    import numpy as np

    from repro_torch.library.compile import load_mul_frontier
    from repro_torch.models import decode_paged_fn, init_paged_caches
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.costs import cost_report
    from repro_torch.obs.health import HealthPlane
    from repro_torch.obs.provenance import _ledgers, audit, read_ledger
    from repro_torch.obs.requests import build_timelines
    from repro_torch.sensitivity import ClassBook, ClassScheduler
    from repro_torch.serving import (ContinuousServingEngine, ControllerConfig,
                                     PageAllocator, PlanLadder, QoSController,
                                     Replica, ReplicaRouter, ServingEngine,
                                     Telemetry, parse_prompt_dist, spike, steady)
    from repro_torch.serving.loadgen import make_profile
    from repro_torch.serving.staggered import decode_alone, decode_staggered

    dev = torch.device("cuda")
    out: dict = {}
    results["continuous"] = out
    L = cfg.n_layers
    cfg4 = cfg.with_approx_mlp(4)
    sens = np.asarray(results["plans"]["sensitivities"])
    compiled, exact_area, _ = load_mul_frontier(library)
    ladder = PlanLadder.build(compiled, L, exact_area=exact_area, sensitivities=sens,
                              levels=6)
    require(len(ladder) >= 4, f"a W4A4 ladder of {len(ladder)} levels, need 4")
    plan_kw = dict(compiled=compiled, exact_area=exact_area, sensitivities=sens)
    # the geometry of parts 2-5: prompts up to 16 tokens, 8 generated,
    # pages of 16
    sp, sg, ps = 16, 8, 16

    def engine(max_slots, prompt_len, gen_len, page_size, level=1, cfg_=cfg4,
               **kw):
        if "luts" not in kw:
            kw = dict(plan=ladder.plan(level), **plan_kw) | kw
        return ContinuousServingEngine(cfg_, params, max_slots=max_slots,
                                       prompt_len=prompt_len, gen_len=gen_len,
                                       page_size=page_size, device=dev, **kw)

    def captured_once(tag, eng):
        st = eng.static_step
        require(eng.trace_count == 1, f"{tag}: the paged step was captured "
                f"{eng.trace_count} times")
        return st

    def completions(eng):
        return {rid: g.tolist() for rid, g in sorted(eng.completions.items())}

    # 1. the main serve --------------------------------------------------
    S, P, G = 8, 64, 32
    eng = engine(S, P, G, 16)
    profile = spike(6, 2, 10, at=3, width=1, prompt_len=P, gen_len=G,
                    prompt_dist=parse_prompt_dist(f"uniform:16-{P}", P))
    peak_pages = [0]

    def on_step(e, _):
        peak_pages[0] = max(peak_pages[0], e._alloc.used_pages)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tel = eng.serve(profile, telemetry=Telemetry(), seed=0, steps_per_tick=16,
                    on_step_end=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    st = captured_once("main serve", eng)
    require(len(eng.completions) == profile.total_requests
            and all(len(g) == G for g in eng.completions.values()),
            f"main serve completed {len(eng.completions)} of "
            f"{profile.total_requests} requests")
    require(eng._alloc.used_pages == 0, "main serve kept pages")
    eng._alloc.check_invariants()
    toks = np.concatenate(list(eng.completions.values()))
    require(((toks >= 0) & (toks < cfg.vocab_size)).all(), "tokens out of the vocabulary")
    s = tel.summary()
    events = list(tel.events)
    steps = [e for e in events if "active" in e]       # not the preemptions
    full = [e for e in steps if sum(e["active"].values()) == S]
    full_s = sum(e["step_ms"] for e in full) / 1e3
    full_tok_s = sum(e["decode_tokens"] for e in full) / full_s if full_s else 0.0
    full_rows_s = S * len(full) / full_s if full_s else 0.0
    occ = float(np.mean([sum(e["active"].values()) / S for e in events]))
    lat, ttft = s["latency_ms_per_step"], s["ttft_ms"]
    require(counts["approx_matmul_w4"] > 0, "the continuous serve launched no "
            "approx_matmul_w4")
    require(st.launches_per_replay == {"approx_matmul_w4": 3 * L},
            f"launches a replay {st.launches_per_replay}")
    credit(results, "continuous serve", counts, "approx_matmul_w4")
    log(f"[continuous] main serve: {len(eng.completions)} requests completed in "
        f"{s['steps']} steps, {wall:.2f} s; ms a step p50 {lat['p50']} p95 "
        f"{lat['p95']} (host clock after the argmax read); decode "
        f"{s['decode_tok_s']} tok/s overall; {len(full)} steps at full "
        f"occupancy: {full_tok_s:.2f} decode tok/s, {full_rows_s:.2f} rows/s; mean "
        f"occupancy {occ:.3f}; TTFT p50 {ttft['p50']} p95 {ttft['p95']} ms; pages "
        f"at the peak {peak_pages[0]} of {eng.n_pages}; approx_matmul_w4 launches "
        f"{counts['approx_matmul_w4']}")

    # a replay against the eager paged step at full occupancy
    alloc = PageAllocator(eng.n_pages, eng.page_size)
    rng = np.random.default_rng(0)
    T = eng.table_entries
    tok = rng.integers(0, cfg.vocab_size, (S, 1)).astype(np.int32)
    pos = rng.integers(0, P + G - 1, S).astype(np.int64)
    for i in range(S):
        alloc.alloc(i, P + G)
    tab = np.stack([alloc.padded_table(i, T) for i in range(S)]).astype(np.int64)
    act = np.ones(S, bool)
    st.write(tok, pos, act, tab)
    got = st.replay().clone()
    caches = init_paged_caches(cfg4, S, eng.n_pages, eng.page_size, eng.total,
                               device=dev)
    for c, mine in zip(caches, st.caches):
        for k in c:
            c[k].copy_(mine[k])
    step = decode_paged_fn(cfg4)
    args = [torch.from_numpy(a).to(dev) for a in (tok, pos, act, tab)]

    def eager():
        return step(cfg4, params, caches, *args, luts=st.luts)[0]

    want = eager()
    require(torch.equal(got, want), "a paged replay differs from the eager paged step")
    row = {"summary": s, "wall_s": wall, "steps_full": len(full),
           "full_decode_tok_s": full_tok_s, "full_rows_s": full_rows_s,
           "mean_occupancy": occ, "peak_pages": peak_pages[0], "n_pages": eng.n_pages,
           "launches": counts["approx_matmul_w4"], "capture_s": st.capture_s,
           "pool_bytes": st.pool_bytes, "trace_count": eng.trace_count,
           "step_ms": [e["step_ms"] for e in events]}
    graph_ms = time_ms(torch, st.replay, iters=20)
    eager_ms = time_ms(torch, eager, iters=5)
    row |= {"graph_ms": graph_ms, "eager_ms": eager_ms}
    log(f"[continuous] paged step, {S} slots at full occupancy: graph replay "
        f"{graph_ms:.3f} ms, eager {eager_ms:.3f} ms (CUDA events), replay "
        f"bit-equal to the eager step; captured {eng.trace_count}x in "
        f"{st.capture_s:.3f} s, graph pool {st.pool_bytes / 2**20:.1f} MiB")
    out["main"] = row
    del eng, st, caches, got, want
    release(torch)

    # 2. SLO preemption with the whole control plane ----------------------
    trace_dir = ROOT / "build" / "continuous_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    book = ClassBook.parse("gold:1e9@250ms,batch:1e9")
    hp = HealthPlane(book, postmortem_dir=trace_dir / "pm", tag="continuous")
    prof2 = make_profile("spike", ticks=6, per_tick=5, prompt_len=sp, gen_len=sg,
                         class_mix=(("gold", 0.4), ("batch", 0.6)),
                         prompt_dist=("uniform", 3, sp))
    eng = engine(4, sp, sg, ps)
    obs_trace.configure(trace_dir, process_tag="continuous")
    try:
        tel = eng.serve(prof2, scheduler=ClassScheduler(book, ladder, shadow_every=4),
                        controller=QoSController(ladder, ControllerConfig(
                            target_ms_per_step=50.0, drift_budget=1e9,
                            shadow_every=4)),
                        telemetry=Telemetry(), seed=1, steps_per_tick=5, health=hp,
                        log=lambda m: log(f"[continuous] slo: {m}"))
    finally:
        obs_trace.reset(clear_env=True)
        _ledgers.clear()
    captured_once("slo", eng)
    s = tel.summary()
    require(eng.preemption_count >= 1, "the SLO serve never preempted")
    tls = build_timelines(obs_trace.read_trace(trace_dir))
    broken = {t.rid: t.problems for t in tls.values() if not t.complete}
    require(len(tls) == prof2.total_requests and not broken,
            f"req.* chains: {len(tls)} of {prof2.total_requests}, broken {broken}")
    records = read_ledger(trace_dir)
    aud = audit(records)
    require(aud["n_complete"] == aud["n_done"] == prof2.total_requests
            and aud["n_failed"] == 0, f"provenance audit {aud['n_complete']} "
            f"complete of {aud['n_done']} done, {aud['n_failed']} failed")
    costs = cost_report(records)
    require(costs["reconciled"] and costs["totals"]["mlp_macs"] > 0,
            f"cost report: reconciled {costs['reconciled']}, "
            f"{costs['totals'].get('mlp_macs')} MACs; {costs['problems']}")
    eng._alloc.check_invariants()
    require(eng._alloc.used_pages == 0, "the SLO serve kept pages")
    classes = s["classes"]
    log(f"[continuous] slo: {len(eng.completions)} requests, {s['steps']} steps, "
        f"{eng.preemption_count} preemptions, "
        + "; ".join(f"{n} p95 {r.get('p95_ms_per_step')} ms/step, TTFT p95 "
                    f"{r.get('p95_ttft_ms')} ms" for n, r in classes.items())
        + f"; health {hp.report()['state']}, {hp.anomalies_fired} anomalies; "
          f"{len(tls)} req.* chains complete; provenance gap-free over "
          f"{aud['n_complete']} requests; costs reconciled, "
          f"{costs['totals']['mlp_macs']} MLP MACs, {costs['totals']['approx_macs']} "
          f"approximate, area*MAC saved {costs['totals']['area_mac_saved']}; pages "
          f"all returned; captured {eng.trace_count}x")
    out["slo"] = {"summary": s, "preemptions": eng.preemption_count,
                  "health": hp.report(), "costs_totals": costs["totals"],
                  "trace_count": eng.trace_count}
    del eng
    release(torch)

    # 3. two replicas behind the router -----------------------------------
    router = ReplicaRouter([
        Replica("gold-exact", engine(4, sp, sg, ps, level=0), classes=("gold",)),
        Replica("batch-deep", engine(4, sp, sg, ps, level=len(ladder) - 1),
                classes=("batch",))])
    prof3 = steady(3, 2, prompt_len=sp, gen_len=sg,
                   class_mix=(("gold", 0.5), ("batch", 0.5)))
    summary = router.serve(prof3, seed=0)
    per = summary["replicas"]
    require(summary["requests"] == prof3.total_requests, "router lost requests")
    require(all(r["trace_count"] == 1 for r in per.values()),
            f"replica captures {[r['trace_count'] for r in per.values()]}")
    log("[continuous] router: " + "; ".join(
        f"{n} routed {r['routed']}, plan {r['plan']}, captured {r['trace_count']}x"
        for n, r in per.items()))
    out["router"] = {n: {"routed": r["routed"], "trace_count": r["trace_count"],
                         "plan": r["plan"]} for n, r in per.items()}
    del router
    release(torch)

    # 4a. kernel route against the plain route, at the main serve's 8 rows
    prof4 = steady(2, 4, prompt_len=sp, gen_len=sg)
    runs = {}
    for backend in ("auto", "ref"):
        e = engine(S, sp, sg, ps, backend=backend)
        snap = {}

        def keep(e, step, snap=snap):
            if step == 10:   # both ticks' requests are in their slots
                rows = [i for i, _ in e._pool]
                snap["logits"] = e.static_step.logits[rows].clone()

        e.serve(prof4, telemetry=Telemetry(), seed=0, on_step_end=keep)
        captured_once(f"exactness {backend}", e)
        runs[backend] = (completions(e), snap["logits"])
        del e
        release(torch)
    require(len(runs["auto"][1]) == S, f"step 10 held {len(runs['auto'][1])} "
            f"requests, not {S}")
    require(runs["auto"][0] == runs["ref"][0],
            "continuous W4A4 completions differ between kernel and plain route")
    require(torch.equal(runs["auto"][1], runs["ref"][1]),
            "a continuous step's logits differ between kernel and plain route")
    log(f"[continuous] exactness: W4A4 kernel route and plain route at {S} slots, "
        f"{len(runs['auto'][0])} requests: completions identical, step 10's logits "
        f"of all {S} rows bit-equal")

    # 4b. paged decode against dense decode (serving/staggered.py), both
    # steps captured at 3 rows
    rng = np.random.default_rng(1)
    stack = ladder.luts(1)
    total = 2 * ps
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (12, 7)]
    dense = ServingEngine(cfg4, params, batch=3, prompt_len=ps, gen_len=ps,
                          luts=stack, device=dev)
    dst = dense.static_step

    def dense_step(tok, t):
        dst.tok.zero_()
        dst.tok[0, 0] = tok
        dst.pos.fill_(t)
        return dst.replay()[0]

    refs = []
    for p in prompts:
        dst.reset()
        refs.append(decode_alone(dense_step, p, total))
    require(dense.trace_count == 1, "the dense step was captured more than once")
    paged = engine(3, ps, ps, ps, luts=stack)
    paged.start()
    pst = paged.static_step

    def paged_step(*inputs):
        pst.write(*inputs)
        return pst.replay()

    pouts, prows = decode_staggered(paged_step, prompts, [0, 3], slots=3,
                                    total=total, page_size=ps, n_pages=paged.n_pages)
    require(pouts == [r[0] for r in refs],
            "paged decode's tokens differ from the dense step's")
    require(paged.trace_count == 1, "the paged step was captured more than once")
    dmax = max(float((x - y).abs().max())
               for (_, ref_rows), rows in zip(refs, prows)
               for x, y in zip(ref_rows, rows))
    log(f"[continuous] exactness: two requests staggered into a 3-slot paged pool "
        f"against each decoded alone through the fixed engine's dense step at batch "
        f"3: tokens identical ({len(pouts[0])} + {len(pouts[1])}), max |dlogit| {dmax:.4g}")
    out["paged_vs_dense_max_dlogit"] = dmax
    del dense, dst, paged, pst, refs, prows
    release(torch)

    # 4c. a preempting run against a non-preempting one, every level exact:
    # the completions, and the logits row of every generated token but a
    # request's last (the row is gone from the pool when it completes)
    prof5 = make_profile("spike", ticks=6, per_tick=5, prompt_len=sp, gen_len=sg,
                         class_mix=(("gold", 0.4), ("batch", 0.6)),
                         prompt_dist=("uniform", 3, sp))
    pre = {}
    for spec in ("gold:1e-12@250ms,batch:1e-12", "gold:1e-12,batch:1e-12"):
        e = engine(2, sp, sg, ps)
        seen, resumed = {}, set()

        def keep(e, _, seen=seen, resumed=resumed):
            for i, seq in e._pool:
                if seq.generated:
                    seen[(seq.rid, seq.pos)] = e.static_step.logits[i].clone()
                    if seq.preempted:
                        resumed.add((seq.rid, seq.pos))

        e.serve(prof5, scheduler=ClassScheduler(ClassBook.parse(spec), ladder,
                                                shadow_every=4),
                telemetry=Telemetry(), seed=1, steps_per_tick=5, on_step_end=keep)
        captured_once("preemption exactness", e)
        pre[spec] = (e.preemption_count, completions(e), seen, resumed)
        del e
        release(torch)
    (n_pre, with_pre, seen_pre, resumed), (n_none, without, seen_none, _) = pre.values()
    require(n_pre >= 1 and n_none == 0, f"preemptions {n_pre} and {n_none}, "
            f"need >= 1 and 0")
    require(with_pre == without, "a preempted request's tokens differ from the "
            "non-preempting run's at the same max_slots")
    require(resumed, "no generated token of a resumed request was seen")
    require(seen_pre.keys() == seen_none.keys()
            and all(torch.equal(seen_pre[k], seen_none[k]) for k in seen_pre),
            "a generated token's logits differ between the preempting and the "
            "non-preempting run")
    log(f"[continuous] exactness: {n_pre} preemptions at 2 slots, every level "
        f"exact: all {len(with_pre)} completions identical to a run at 2 slots "
        f"that never preempts, and {len(seen_pre)} generated tokens' logits "
        f"bit-equal, {len(resumed)} of them after a resume")
    del pre, seen_pre, seen_none
    release(torch)

    # 5. W8A8, kernel against plain ---------------------------------------
    _, w8 = stacks(L)
    cfg8 = cfg.with_approx_mlp(8)
    prof6 = steady(1, 4, prompt_len=sp, gen_len=sg)
    runs8 = {}
    for backend in ("auto", "ref"):
        e = engine(4, sp, sg, ps, cfg_=cfg8, luts=w8, backend=backend)
        snap = {}

        def keep(e, step, snap=snap):
            if step == 3:   # all four requests are in their slots
                rows = [i for i, _ in e._pool]
                snap["logits"] = e.static_step.logits[rows].clone()

        if backend == "auto":
            reset_counts()
        e.serve(prof6, telemetry=Telemetry(), seed=0, on_step_end=keep)
        torch.cuda.synchronize()
        st = captured_once(f"W8A8 {backend}", e)
        if backend == "auto":
            counts = read_counts()
            c8 = counts["approx_matmul_w8"]
            require(c8 > 0, "the W8A8 continuous serve launched no approx_matmul_w8")
            require(st.launches_per_replay == {"approx_matmul_w8": 3 * L},
                    f"W8A8 launches a replay {st.launches_per_replay}")
            credit(results, "continuous W8A8 serve", counts, "approx_matmul_w8")
        runs8[backend] = (completions(e), snap["logits"])
        del e, st
        release(torch)
    require(runs8["auto"][0] == runs8["ref"][0],
            "continuous W8A8 completions differ between kernel and plain route")
    require(torch.equal(runs8["auto"][1], runs8["ref"][1]),
            "a continuous W8A8 step's logits differ between kernel and plain route")
    log(f"[continuous] W8A8: {len(runs8['auto'][0])} requests, kernel route and "
        f"plain route completions identical, step 3's logits bit-equal; "
        f"approx_matmul_w8 launches {c8} ({3 * L} a replay)")
    out["w8_launches"] = c8



# ---------------------------------------------------------------------------
# phase 7: the system's own entry points
# ---------------------------------------------------------------------------
def run_cli(torch, name: str, main, argv: list) -> tuple:
    """One entry point's ``main(argv)`` in this process: its exit code,
    standard output (also written to ``chiprun_out/cli_<name>.log``) and
    seconds, the card synchronised.  The tracer and the metric registry
    are reset after it, as a new process would start without them."""
    import contextlib
    import io

    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace

    log_dir = ROOT / "chiprun_out"
    log_dir.mkdir(exist_ok=True)
    buf = io.StringIO()
    obs_metrics.set_registry(obs_metrics.MetricRegistry())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main([str(a) for a in argv])
        torch.cuda.synchronize()
    finally:
        obs_trace.reset(clear_env=True)
        obs_metrics.set_registry(obs_metrics.MetricRegistry())
        (log_dir / f"cli_{name}.log").write_text(buf.getvalue())
    return rc, buf.getvalue(), time.perf_counter() - t0


def phase_cli(torch, cfg, params, library: Path, results: dict) -> None:
    """The entry points a user calls, in this process, at full width: the
    profiler (``python -m repro_torch.sensitivity.profile``) at W4A4 over
    the searched library and at its default widths 4 and 8 (the 8-bit
    probe through the direct kernel, held against the plain route on a
    cut model), the serve launcher (``python -m repro_torch.launch.serve``)
    on the ``[continuous]`` traffic with classes, a controller, the
    profile, a trace and the health plane, a W8A8 serve priced by the
    width-8 profile, and the inspector
    (``python -m repro_torch.obs``) over the serve's trace.  Each call's
    standard output goes to ``chiprun_out/cli_<name>.log``; the tracer and
    the process's metric registry are reset after each, as a new process
    would start without them."""
    import numpy as np

    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import forward_fn
    from repro_torch.obs import __main__ as inspect_cli
    from repro_torch.precision.plans import load_frontier
    from repro_torch.precision.widths import exact_table
    from repro_torch.sensitivity import profile as profile_cli
    from repro_torch.serving.engine import _WARMUP

    out: dict = {}
    results["cli"] = out
    L = cfg.n_layers
    tmp = ROOT / "build" / "cli"
    shutil.rmtree(tmp, ignore_errors=True)
    (tmp / "base").mkdir(parents=True)

    def call(name: str, main, argv: list[str]):
        return run_cli(torch, name, main, argv)

    # 1. the profiler at W4A4: 1 + L + L*O forwards, each through flash once
    # a layer and the W4A4 kernel three times a layer
    compiled = load_frontier(library, 4)[0]
    O = len(compiled)
    forwards = 1 + L + L * O
    reset_counts()
    _, text, secs = call("profile", profile_cli.main, [
        "--arch", "qwen3-4b", "--widths", "4", "--library", library,
        "--batch", 4, "--seq", 32, "--out", tmp / "p.json"])
    counts = read_counts()
    require(counts["flash_attention"] == forwards * L
            and counts["approx_matmul_w4"] == 3 * forwards * L
            and counts["approx_matmul_w8"] == 0,
            f"cli profile launches {counts}, expected {forwards} forwards")
    prof = profile_cli.load_profile(tmp / "p.json")
    sens = prof.sensitivities(4)
    keys, matrix = prof.costs[4]
    require(prof.n_layers == L and np.isfinite(sens).all() and (sens > 0).all(),
            f"cli profile sensitivities {sens}")
    require(matrix.shape == (L, O) and keys == [rec.key for rec, _ in compiled]
            and np.isfinite(matrix).all(),
            f"cli profile cost matrix {matrix.shape}, expected {(L, O)}")
    credit(results, "cli profile", counts, "approx_matmul_w4", "flash_attention")
    out["profile"] = {"operators": O, "forwards": forwards, "seconds": secs,
                      "sensitivities": sens.tolist(), "launches": counts}
    log(f"[cli] profile (--widths 4, B=4 S=32): a frontier of {O} operator(s), "
        f"{forwards} forwards in {secs:.2f} s ({1e3 * secs / forwards:.1f} ms a "
        f"forward, weights' init included); flash launches "
        f"{counts['flash_attention']}, approx_matmul_w4 {counts['approx_matmul_w4']}; "
        f"drift per unit mae {sens.min():.4g}..{sens.max():.4g}; cost matrix "
        f"{matrix.shape}, drift {matrix.min():.4g}..{matrix.max():.4g}")

    # 1b. the profile's forwards held against the plain route, on the CLI's
    # own weights and tokens (seed 0, as the smoke's params).  Two entries
    # of the cost matrix -- the mildest operator at the least sensitive
    # layer and the harshest at the most sensitive -- are recomputed
    # through the kernels, which must give the profile's numbers, and
    # through the plain version, whose position-0 logits must be equal bit
    # for bit (attention there returns v exactly on both routes and every
    # other op is row-wise; later positions differ by the two attention
    # paths' bf16 roundoff, as in [forward]).  Beside them: each operator's
    # mae and mean signed error, and the drift at which the output
    # saturates, between the exact logits of the profile's tokens and of
    # unrelated ones
    fwd = forward_fn(cfg.with_approx_mlp())
    exact = np.broadcast_to(exact_table("mul", 4).astype(np.int32),
                            (L, 16, 16)).copy()

    def tokens_of(seed: int):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randint(0, cfg.vocab_size, (4, 32), generator=g, device="cuda")

    def logits(stack, tokens, backend="auto"):
        with torch.no_grad():
            return fwd(cfg.with_approx_mlp(), params, {"tokens": tokens},
                       lut=stack, backend=backend)[0]

    toks = tokens_of(0)
    ker_e, ref_e = logits(exact, toks), logits(exact, toks, "ref")
    require(torch.equal(ker_e[:, 0], ref_e[:, 0]),
            "cli profile: the exact forward's position-0 logits differ from "
            "the plain route's")
    saturated = float((logits(exact, tokens_of(1)) - ker_e).abs().mean())
    maes = [comp.mae for _, comp in compiled]
    bias = [float((comp.lut.astype(np.int64) - exact[0]).mean())
            for _, comp in compiled]
    mildest = min((m, o) for o, m in enumerate(maes) if m > 0)[1]
    entries = []
    for l, o in ((int(np.argmin(sens)), mildest),
                 (int(np.argmax(sens)), int(np.argmax(maes)))):
        stack = exact.copy()
        stack[l] = compiled[o][1].lut
        k, r = logits(stack, toks), logits(stack, toks, "ref")
        drift = float((k - ker_e).abs().mean())
        d0 = float((k[:, 0] - ker_e[:, 0]).abs().mean())
        require(abs(drift - matrix[l, o]) <= 1e-4,
                f"cli profile: entry ({l}, {keys[o]}) recomputed {drift}, the "
                f"profile's {matrix[l, o]}")
        require(torch.equal(k[:, 0], r[:, 0]) and d0 > 0,
                f"cli profile: entry ({l}, {keys[o]}): position-0 logits "
                f"differ from the plain route's, or the table moved nothing "
                f"(drift {d0})")
        entries.append({"layer": l, "operator": keys[o], "mae": maes[o],
                        "drift": drift, "profile_drift": float(matrix[l, o]),
                        "plain_drift": float((r - ref_e).abs().mean()),
                        "position0_drift": d0,
                        "route_gap": float((k - r).abs().mean())})
        log(f"[cli] profile entry (layer {l}, operator mae {maes[o]:.3f}): "
            f"kernel route {drift:.6g} (the profile's {matrix[l, o]:.6g}), "
            f"plain route {entries[-1]['plain_drift']:.6g}; position-0 logits "
            f"bit-equal across routes, drift there {d0:.4g}; mean |kernel - "
            f"plain| {entries[-1]['route_gap']:.4g}")
    noise = float((ker_e - ref_e).abs().mean())
    pmae = prof.probe_mae[4]
    out["profile"].update(entries=entries, saturated_drift=saturated,
                          exact_route_gap=noise, operator_mae=maes,
                          operator_bias=bias, probe_mae=pmae)
    log(f"[cli] profile against saturation: exact logits of unrelated tokens "
        f"differ by {saturated:.6g} mean |dlogit|; the exact forward's mean "
        f"|kernel - plain| {noise:.4g}; operators' mae "
        + ", ".join(f"{m:.3f}" for m in maes) + " (mean signed error "
        + ", ".join(f"{b:+.3f}" for b in bias) + f"), the probe's mae "
        f"{pmae:.3f}, so probe drifts {pmae * sens.min():.4g}..{pmae * sens.max():.4g}")
    del ker_e, ref_e, k, r
    release(torch)

    # 2. the profiler at its default widths, 4 and 8, without a library: 1 +
    # L forwards a width.  The width-8 probe (the exact 8-bit product with
    # its low 8 bits dropped) is not composed from a tile, so each probe
    # forward sends its layer's three products to the direct kernel and the
    # other layers' to W8A8; the exact baseline runs W8A8 alone
    p48 = tmp / "p48.json"
    reset_counts()
    _, text, secs48 = call("profile_w48", profile_cli.main, [
        "--arch", "qwen3-4b", "--batch", 4, "--seq", 32, "--out", p48])
    counts = read_counts()
    forwards = 1 + L
    require(counts["approx_matmul_w8_direct"] == 3 * L
            and counts["approx_matmul_w8"] == 3 * L * forwards - 3 * L
            and counts["approx_matmul_w4"] == 3 * L * forwards
            and counts["flash_attention"] == 2 * forwards * L,
            f"cli profile --widths 4,8 launches {counts}, expected {forwards} "
            f"forwards a width")
    prof48 = profile_cli.load_profile(p48)
    sens8 = prof48.sensitivities(8)
    require(prof48.widths == (4, 8) and np.isfinite(sens8).all() and (sens8 > 0).all()
            and prof48.probe_mae[8] == profile_cli.truncation_probe(8).mae,
            f"cli profile --widths 4,8: widths {prof48.widths}, sens[8] {sens8}")
    credit(results, "cli profile 4,8", counts, "approx_matmul_w8_direct",
           "approx_matmul_w8", "approx_matmul_w4", "flash_attention")
    out["profile_w48"] = {"forwards": 2 * forwards, "seconds": secs48,
                          "sens8": sens8.tolist(), "probe_mae8": prof48.probe_mae[8],
                          "launches": counts}
    log(f"[cli] profile (--widths 4,8 by default, B=4 S=32): {2 * forwards} "
        f"forwards in {secs48:.2f} s (weights' init included); approx_matmul_w8_direct "
        f"launches {counts['approx_matmul_w8_direct']} (3 a probe forward), "
        f"approx_matmul_w8 {counts['approx_matmul_w8']}, approx_matmul_w4 "
        f"{counts['approx_matmul_w4']}, flash {counts['flash_attention']}; sens[8] "
        f"{sens8.min():.4g}..{sens8.max():.4g} (probe mae {prof48.probe_mae[8]})")

    # 2b. sens[8] on the kernel route equal to the plain route's, at a size
    # the plain gather affords: qwen3-4b cut to PROFILE_PLAIN_LAYERS of its
    # layers (the smoke's weights), 128 rows of one token each (the
    # profiler's 128 rows; with one position attention returns v exactly on
    # both routes, so the logits, and the drifts, are bit-equal)
    depth = PROFILE_PLAIN_LAYERS
    cut = dataclasses.replace(cfg, n_layers=depth).with_approx_mlp(8)
    cut_params = {**params, "layers": params["layers"][:depth]}
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (128, 1), generator=gen,
                                     device="cuda")}
    reset_counts()
    t0 = time.perf_counter()
    ker = profile_cli.measure_profile(cut, cut_params, batch, widths=(8,))
    torch.cuda.synchronize()
    ker_s = time.perf_counter() - t0
    counts = read_counts()
    t0 = time.perf_counter()
    plain = profile_cli.measure_profile(cut, cut_params, batch, widths=(8,), backend="ref")
    plain_s = time.perf_counter() - t0
    require(np.array_equal(ker.sens[8], plain.sens[8]) and (ker.sens[8] > 0).all()
            and counts["approx_matmul_w8_direct"] == 3 * depth,
            f"cli profile width 8 at {depth} layers: kernel route {ker.sens[8]}, "
            f"plain route {plain.sens[8]}, launches {counts}")
    out["profile_w8_plain"] = {"layers": depth, "rows": 128, "sens8": ker.sens[8].tolist(),
                               "kernel_s": ker_s, "plain_s": plain_s, "launches": counts}
    log(f"[cli] profile width 8 on qwen3-4b cut to {depth} layers, 128 rows of one "
        f"token: sens[8] {', '.join(f'{v:.6g}' for v in ker.sens[8])} on the kernel "
        f"route ({ker_s:.2f} s, approx_matmul_w8_direct launches "
        f"{counts['approx_matmul_w8_direct']}), bit-equal to the plain route's "
        f"({plain_s:.2f} s)")
    release(torch)

    # 3. the continuous serve through the launcher: the [continuous] traffic
    # (its spike's base is 1 arrival a tick, the phase's 2); as in [control],
    # an unreachable latency target and an unbounded drift budget make the
    # controller walk the ladder up, so the serve ends on an approximate plan
    # The launcher keeps its engines to itself, so the launches are held
    # against what it reports: one capture (trace_count), whose warm-up
    # launches for real, then one replay a decode step and one a shadow
    # step (the telemetry's steps, those with a drift reading shadowed)
    S = 8
    serve_json = tmp / "serve.json"
    reset_counts()
    _, text, secs = call("serve", serve_cli.main, [
        "--arch", "qwen3-4b", "--library", library, "--profile", tmp / "p.json",
        "--continuous", "--adaptive", "--qos-class", "gold:1e9@250ms,batch:1e9",
        "--target-ms-per-step", "1e-6", "--drift-budget", "1e9",
        "--max-slots", S, "--page-size", 16,
        "--pages", 54, "--schedule", "spike", "--ticks", 6, "--per-tick", 10,
        "--steps-per-tick", 16, "--prompt-len", 64, "--prompt-dist",
        "uniform:16-64", "--gen-len", 32, "--trace", tmp / "trace", "--health",
        "--telemetry", tmp / "telemetry.json", "--bench-json", serve_json])
    counts = read_counts()
    s = json.loads(serve_json.read_text())
    require(s["trace_count"] == 1 and s["mode"] == "continuous"
            and "approx_layers" in s
            and s["requests_complete"] == s["requests_traced"] == s["requests"],
            "cli serve: " + json.dumps({k: s.get(k) for k in (
                "trace_count", "mode", "approx_layers", "requests",
                "requests_traced", "requests_complete")}))
    tel = json.loads((tmp / "telemetry.json").read_text())
    steps = [e for e in tel["events"] if "active" in e]   # not the preemptions
    shadows = sum(e["drift"] is not None for e in steps)
    replays = len(steps) + shadows
    require(len(steps) == s["steps"] and shadows >= 1
            and counts["approx_matmul_w4"] == 3 * L * (replays + _WARMUP)
            and not any(counts[n] for n in counts if n != "approx_matmul_w4"),
            f"cli serve launches {counts}, {len(steps)} steps (the summary's "
            f"{s['steps']}) and {shadows} shadow steps")
    credit(results, "cli serve", counts, "approx_matmul_w4")
    # the bench summary's approx_layers counts the engine's startup plan
    # (ladder level 0, exact), which a class-aware serve keeps, as the
    # reference does: its steps decode on the classes' levels.  So the
    # steps' own plans must hold approximate layers
    approx = [sum(k != "exact" for k in tel["plans"][e["plan"]]["layers"])
              for e in steps]
    require(max(approx) >= 1, f"no step of the cli serve decoded on an "
            f"approximate plan: {sorted(set(approx))}")
    full = [e for e in steps if sum(e["active"].values()) == S]
    full_s = sum(e["step_ms"] for e in full) / 1e3
    rows_s = S * len(full) / full_s if full_s else 0.0
    lat, ttft = s["latency_ms_per_step"], s["ttft_ms"]
    main_row = results["continuous"]["main"]
    ref = main_row["summary"]
    gap = 100 * (lat["p50"] / ref["latency_ms_per_step"]["p50"] - 1)
    out["serve"] = {"summary": s, "seconds": secs, "replays": replays,
                    "shadow_steps": shadows,
                    "launches": counts["approx_matmul_w4"], "steps_full": len(full),
                    "full_rows_s": rows_s, "p50_gap_pct": gap}
    log(f"[cli] serve (--continuous --adaptive, 8 slots, 54 pages of 16, "
        f"spike 6x10, prompts 16-64, gen 32): {s['requests']} requests, "
        f"{s['steps']} steps in {secs:.2f} s (init and capture included); ms a "
        f"step p50 {lat['p50']} p95 {lat['p95']}; decode {s['decode_tok_s']} "
        f"tok/s; {len(full)} steps at full occupancy, {rows_s:.2f} rows/s; TTFT "
        f"p50 {ttft['p50']} p95 {ttft['p95']} ms; swaps {s['swaps']} "
        f"{s['swaps_by_reason']}; {sum(a > 0 for a in approx)} steps on an "
        f"approximate plan, up to {max(approx)} approx layers (the startup "
        f"plan's approx_layers {s['approx_layers']}); captured "
        f"{s['trace_count']}x, approx_matmul_w4 launches "
        f"{counts['approx_matmul_w4']} = {3 * L} x ({len(steps)} steps + "
        f"{shadows} shadow steps + {_WARMUP} warm-up); request chains "
        f"{s['requests_complete']}/{s['requests_traced']}; health "
        f"{s['health']['state']}")
    log(f"[cli] beside [continuous]'s engine-level serve of this run: ms a step "
        f"p50 {ref['latency_ms_per_step']['p50']} p95 "
        f"{ref['latency_ms_per_step']['p95']} (the launcher's p50 {gap:+.2f}%), "
        f"decode {ref['decode_tok_s']} tok/s, {main_row['full_rows_s']:.2f} "
        f"rows/s at full occupancy, TTFT p50 {ref['ttft_ms']['p50']} p95 "
        f"{ref['ttft_ms']['p95']} ms")
    release(torch)

    # 4. a W8A8 serve through the launcher, priced by the width-8 profile
    # measured on the card in step 2: no controller, so no shadow step; a
    # fixed batch replays the step once a position, prompt and generation
    # alike
    w8_json = tmp / "w8.json"
    reset_counts()
    _, text, secs = call("serve_w8", serve_cli.main, [
        "--arch", "qwen3-4b", "--width", 8, "--library", library,
        "--profile", p48, "--qos-budget", "1e9", "--batch", 4, "--prompt-len", 16,
        "--gen-len", 16, "--bench-json", w8_json])
    counts = read_counts()
    w8 = json.loads(w8_json.read_text())
    require(w8["width_bits"] == 8 and w8["approx_layers"] >= 1
            and w8["trace_count"] == 1 and "serving W8A8" in text,
            "cli serve w8: " + json.dumps({k: w8.get(k) for k in (
                "width_bits", "approx_layers", "trace_count")}))
    replays = w8["batches"] * (16 + 16)
    require(counts["approx_matmul_w8"] == 3 * L * (replays + _WARMUP)
            and not any(counts[n] for n in counts if n != "approx_matmul_w8"),
            f"cli serve w8 launches {counts}, {w8['batches']} batch(es) of "
            f"32 replays")
    credit(results, "cli serve w8", counts, "approx_matmul_w8")
    out["serve_w8"] = {"summary": w8, "seconds": secs, "replays": replays,
                       "launches": counts["approx_matmul_w8"]}
    log(f"[cli] serve --width 8 (batch 4, prompt 16, gen 16): {w8['approx_layers']} "
        f"approx layers, {w8['ms_per_step']:.2f} ms a step, decode "
        f"{w8['decode_tok_s']:.2f} tok/s, {secs:.2f} s; captured "
        f"{w8['trace_count']}x, approx_matmul_w8 launches "
        f"{counts['approx_matmul_w8']} = {3 * L} x ({replays} replays + {_WARMUP} "
        f"warm-up)")
    release(torch)

    # 5. the inspector over the serve's trace: every gate exits 0
    shutil.copy(serve_json, tmp / "base" / "serve.json")
    trace = ["--trace", tmp / "trace"]
    rcs = {}
    for name, argv in [
            ("summary", ["summary", *trace]),
            ("requests", ["requests", *trace, "--require-complete"]),
            ("provenance", ["provenance", *trace]),
            ("costs", ["costs", *trace, "--require-reconciled"]),
            ("health", ["health", "--bench", serve_json, "--max-state", "page"]),
            ("export", ["export", *trace, "--format", "chrome",
                        "--out", tmp / "chrome.json"]),
            ("diff", ["diff", "--bench", serve_json, "--baseline-dir", tmp / "base"])]:
        rcs[name], text, _ = call(f"obs_{name}", inspect_cli.main, argv)
        require(rcs[name] == 0, f"python -m repro_torch.obs {name} exited "
                f"{rcs[name]}: {text[-500:]}")
    n_events = len(json.loads((tmp / "chrome.json").read_text())["traceEvents"])
    out["obs"] = {"rcs": rcs, "chrome_events": n_events}
    log(f"[cli] python -m repro_torch.obs over the serve's trace: "
        + ", ".join(f"{n} {rc}" for n, rc in rcs.items())
        + f" (exit codes); {n_events} Chrome trace events")


# ---------------------------------------------------------------------------
# phase 8: gemma3-1b, the reference's default model, at full width
# ---------------------------------------------------------------------------
def phase_gemma3(torch, library: Path, results: dict) -> None:
    """Full-width gemma3-1b (bf16, random weights from seed 0) served from
    the library [fleet] filled: ``forward_lm`` at B=2 S=1024 through flash
    on every layer (its 22 local layers at window 512) and W4A4 on the
    cheapest sound operator, held against the plain route; one local
    layer's attention through the kernel against the plain version; the
    launcher's W8A8 serve; a continuous W4A4 serve (22 rings and 4 paged
    layers) captured once, against the plain route; the profiler's
    ``main`` with its default arch; and the two examples."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.examples import approx_inference, serve_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import forward_fn, init_model
    from repro_torch.models import layers as Lyr
    from repro_torch.models.lm import layer_window, window_schedule
    from repro_torch.precision.plans import load_frontier
    from repro_torch.sensitivity import profile as profile_cli
    from repro_torch.serving import ContinuousServingEngine, Telemetry, steady
    from repro_torch.serving.engine import _WARMUP

    out: dict = {}
    results["gemma3"] = out
    dev = torch.device("cuda")
    cfg = get_config("gemma3-1b")
    L = cfg.n_layers
    win = window_schedule(cfg)
    local = sum(layer_window(win, i) is not None for i in range(L))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"[gemma3] {cfg.name}: {L} layers ({local} local at window "
        f"{cfg.local_window}, {L - local} global), d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} of dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.n_params() / 1e9:.2f} B params in {cfg.dtype}, "
        f"init {time.perf_counter() - t0:.1f} s")
    tmp = ROOT / "build" / "gemma3"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)

    # 1. forward_lm at B=2 S=1024, W4A4 on the cheapest sound operator the
    # fleet's sweep found (the library also holds [control]'s constant-zero
    # multiplier, whose MLP output drowns every other difference)
    rec, comp, exact_area, bits = sweep_operator(library)
    stack = np.stack([comp.lut] * L)
    cfg4 = cfg.with_approx_mlp(4)
    fwd = forward_fn(cfg4)
    gen = torch.Generator(device=dev).manual_seed(1)
    B, S = 2, 1024
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)}
    real = ops.flash_attention
    windows = []

    def spy(q, k, v, *, window=None, **kw):
        windows.append(window)
        return real(q, k, v, window=window, **kw)

    def forward(backend="auto"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = fwd(cfg4, params, batch, lut=stack, backend=backend)[0]
        torch.cuda.synchronize()
        return logits, time.perf_counter() - t0

    forward()   # warm: the first call builds the tables' device copies
    reset_counts()
    ops.flash_attention = spy
    try:
        logits, secs = forward()
    finally:
        ops.flash_attention = real
    counts = read_counts()
    n512 = windows.count(cfg.local_window)
    require(counts["flash_attention"] == L and n512 == local
            and windows.count(None) == L - local
            and counts["approx_matmul_w4"] == 3 * L
            and counts["approx_matmul_w8"] == counts["template_eval"] == 0,
            f"gemma3 forward launches {counts}, windows {windows}")
    credit(results, "gemma3 forward_lm", counts, "flash_attention", "approx_matmul_w4")
    require(tuple(logits.shape) == (B, S, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), f"gemma3 logits {logits.shape}")
    plain, plain_s = forward("ref")
    first_equal = bool(torch.equal(logits[:, 0], plain[:, 0]))
    gap = (logits - plain).abs()
    mean_gap, max_gap = float(gap.mean()), float(gap.max())
    agree = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    del gap
    require(first_equal, "gemma3 forward: position-0 logits differ from the plain route")
    log(f"[gemma3] forward_lm B={B} S={S} W4A4 on {rec.key} ({rec.source}, area "
        f"{rec.area} of {exact_area}, {bits}-bit block, 16x16 wce {comp.wce16}, "
        f"mae {comp.mae16:.3f}): {secs:.3f} s "
        f"(host clock, synchronised, warm); flash launches {counts['flash_attention']} "
        f"({n512} at window {cfg.local_window}, {windows.count(None)} global), "
        f"approx_matmul_w4 launches {counts['approx_matmul_w4']}; plain route "
        f"{plain_s:.2f} s; position-0 logits bit-equal; mean |kernel - plain| "
        f"{mean_gap:.4g} over all positions (max {max_gap:.4g}, argmax agreement "
        f"{agree:.3f})")
    out["forward"] = {"seconds": secs, "plain_s": plain_s, "record": rec.key,
                      "launches": counts, "windows_512": n512,
                      "mean_abs_gap": mean_gap, "max_abs_gap": max_gap,
                      "argmax_agreement": agree, "position0_equal": first_equal}
    del logits, plain
    release(torch)

    # 2. one local layer's attention through the kernel and the plain version
    lp = params["layers"][0]
    with torch.no_grad():
        x = params["embed"][batch["tokens"]].to(cfg.torch_dtype)
        h = Lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = Lyr._qkv(cfg, lp["attn"], h)
        cos, sin = Lyr.rope_tables(torch.arange(S, device=dev), cfg.hd, cfg.rope_theta)
        q, k = Lyr.apply_rope(q, cos, sin), Lyr.apply_rope(k, cos, sin)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        got = ops.flash_attention(qt, kt, vt, causal=True, window=cfg.local_window)
        want = ref.flash_attention(qt, kt, vt, causal=True, window=cfg.local_window)
        err = float((got.float() - want.float()).abs().max())
        o_k = Lyr.attention_full(cfg, lp["attn"], h, cfg.local_window)
        o_p = Lyr.attention_full(cfg, lp["attn"], h, cfg.local_window, backend="ref")
        o_err = float((o_k.float() - o_p.float()).abs().max())
    require(err < FLASH_TOL["bfloat16"], f"gemma3 layer 0 attention: kernel against "
            f"the plain version max |err| {err}")
    log(f"[gemma3] layer 0 (local) attention on the model's q, k, v "
        f"{tuple(qt.shape)}: kernel against the plain version max |err| {err:.3g} "
        f"(< {FLASH_TOL['bfloat16']}); after wo, attention_full against the masked "
        f"path {o_err:.3g}")
    out["layer0_attention"] = {"max_abs_err": err, "attention_full_max_abs_err": o_err}
    del x, h, q, k, v, qt, kt, vt, got, want, o_k, o_p

    # 3. the launcher at W8A8 on the fleet's library
    w8_json = tmp / "w8.json"
    reset_counts()
    _, text, w8_secs = run_cli(torch, "gemma3_serve_w8", serve_cli.main, [
        "--arch", "gemma3-1b", "--width", 8, "--library", library,
        "--qos-budget", "1e9", "--batch", 4, "--prompt-len", 16, "--gen-len", 16,
        "--bench-json", w8_json])
    counts = read_counts()
    w8 = json.loads(w8_json.read_text())
    replays = w8["batches"] * (16 + 16)
    require(w8["width_bits"] == 8 and w8["approx_layers"] >= 1
            and w8["trace_count"] == 1 and "serving W8A8" in text,
            "gemma3 serve w8: " + json.dumps({k: w8.get(k) for k in (
                "width_bits", "approx_layers", "trace_count")}))
    require(counts["approx_matmul_w8"] == 3 * L * (replays + _WARMUP)
            and not any(counts[n] for n in counts if n != "approx_matmul_w8"),
            f"gemma3 serve w8 launches {counts}, {w8['batches']} batch(es) of 32 replays")
    credit(results, "gemma3 serve w8", counts, "approx_matmul_w8")
    log(f"[gemma3] python -m repro_torch.launch.serve --arch gemma3-1b --width 8 "
        f"(batch 4, prompt 16, gen 16): {w8['approx_layers']} approx layers, "
        f"{w8['ms_per_step']:.2f} ms a step, decode {w8['decode_tok_s']:.2f} tok/s, "
        f"prefill {w8['prefill_tok_s']:.2f} tok/s, {w8_secs:.2f} s; captured "
        f"{w8['trace_count']}x, approx_matmul_w8 launches {counts['approx_matmul_w8']} "
        f"= {3 * L} x ({replays} replays + {_WARMUP} warm-up)")
    out["serve_w8"] = {"summary": w8, "seconds": w8_secs,
                       "launches": counts["approx_matmul_w8"]}
    release(torch)

    # 4. a continuous W4A4 serve: rings for the local layers, page pools for
    # the global ones; the kernel route against the plain route
    slots, sp, sg = 8, 16, 16
    prof = steady(2, 4, prompt_len=sp, gen_len=sg)
    runs = {}
    for backend in ("auto", "ref"):
        e = ContinuousServingEngine(cfg4, params, max_slots=slots, prompt_len=sp,
                                    gen_len=sg, page_size=16, luts=stack,
                                    backend=backend, device=dev)
        snap = {"logits": ()}

        def keep(e, step, snap=snap):
            # the first step that holds the most requests
            rows = [i for i, _ in e._pool]
            if len(rows) > len(snap["logits"]):
                snap["logits"] = e.static_step.logits[rows].clone()
                snap["step"] = step

        reset_counts()
        tel = e.serve(prof, telemetry=Telemetry(), seed=0, on_step_end=keep)
        counts = read_counts()
        st = e.static_step
        rings = sum("k" in c for c in st.caches)
        require(e.trace_count == 1 and rings == local
                and sum("kp" in c for c in st.caches) == L - local,
                f"gemma3 continuous {backend}: captured {e.trace_count}x, "
                f"{rings} rings")
        runs[backend] = ({rid: g.tolist() for rid, g in sorted(e.completions.items())},
                         snap["logits"], tel.summary(), counts, st.replays,
                         snap["step"])
        del e
        release(torch)
    done, held, summ, counts, replays, step = runs["auto"]
    require(len(done) == prof.total_requests and done == runs["ref"][0],
            "gemma3 continuous: completions differ between kernel and plain route")
    require(step == runs["ref"][5] and torch.equal(held, runs["ref"][1]),
            f"gemma3 continuous: step {step}'s logits differ between kernel and "
            f"plain route")
    require(counts["approx_matmul_w4"] == 3 * L * (replays + _WARMUP)
            and not any(counts[n] for n in counts if n != "approx_matmul_w4"),
            f"gemma3 continuous launches {counts}, {replays} replays")
    credit(results, "gemma3 continuous", counts, "approx_matmul_w4")
    lat = summ["latency_ms_per_step"]
    log(f"[gemma3] continuous W4A4 serve ({slots} slots, {local} rings + "
        f"{L - local} paged layers, steady 2x4, prompt {sp}, gen {sg}): "
        f"{len(done)} requests in {summ['steps']} steps, ms a step p50 {lat['p50']} "
        f"p95 {lat['p95']}, decode {summ['decode_tok_s']} tok/s; captured once; "
        f"approx_matmul_w4 launches {counts['approx_matmul_w4']} = {3 * L} x "
        f"({replays} replays + {_WARMUP} warm-up); completions identical to the "
        f"plain route's, step {step}'s logits of {len(held)} rows bit-equal")
    out["continuous"] = {"summary": summ, "replays": replays,
                         "launches": counts["approx_matmul_w4"]}

    # 5. the profiler with its default arch (gemma3-1b)
    O = len(load_frontier(library, 4)[0])
    forwards = 1 + L + L * O
    reset_counts()
    _, text, p_secs = run_cli(torch, "gemma3_profile", profile_cli.main, [
        "--widths", "4", "--library", library, "--batch", 4, "--seq", 32,
        "--out", tmp / "p.json"])
    counts = read_counts()
    prof_g = profile_cli.load_profile(tmp / "p.json")
    require(prof_g.model == cfg.name and prof_g.n_layers == L
            and counts["flash_attention"] == forwards * L
            and counts["approx_matmul_w4"] == 3 * forwards * L
            and counts["approx_matmul_w8"] == 0
            and np.isfinite(prof_g.sensitivities(4)).all(),
            f"gemma3 profile: model {prof_g.model}, launches {counts}, expected "
            f"{forwards} forwards")
    credit(results, "gemma3 profile", counts, "flash_attention", "approx_matmul_w4")
    log(f"[gemma3] python -m repro_torch.sensitivity.profile (no --arch: "
        f"{prof_g.model}) --widths 4, B=4 S=32: a frontier of {O}, {forwards} "
        f"forwards in {p_secs:.2f} s ({1e3 * p_secs / forwards:.1f} ms a forward, "
        f"init included); flash launches {counts['flash_attention']} = {L} a "
        f"forward, approx_matmul_w4 {counts['approx_matmul_w4']} = {3 * L} a forward")
    out["profile"] = {"operators": O, "forwards": forwards, "seconds": p_secs,
                      "launches": counts}

    # 6. the examples, each as its user calls it
    reset_counts()
    rc, text, a_secs = run_cli(torch, "example_approx_inference",
                               approx_inference.main, ["--library", library])
    counts = read_counts()
    require(rc is None and "-> per-layer operators selected" in text
            and counts["approx_matmul_w4"] > 0 and counts["flash_attention"] > 0,
            f"approx_inference: launches {counts}\n{text[-800:]}")
    credit(results, "example approx_inference", counts, "approx_matmul_w4",
           "flash_attention")
    drift = next(line for line in text.splitlines() if line.startswith("measured drift"))
    log(f"[gemma3] python -m repro_torch.examples.approx_inference --library "
        f"(qwen3-4b reduced): exit 0 in {a_secs:.2f} s; {drift}; launches "
        f"approx_matmul_w4 {counts['approx_matmul_w4']}, flash "
        f"{counts['flash_attention']} (head dim 16 on the D = 64 kernel)")
    sb_json = tmp / "serve_batch.json"
    reset_counts()
    rc, text, b_secs = run_cli(torch, "example_serve_batch", serve_batch.main,
                               ["--arch", "gemma3-1b", "--bench-json", sb_json])
    sb = json.loads(sb_json.read_text())
    require(rc is None and sb["trace_count"] == 1 and "arch=gemma3-1b-reduced" in text,
            f"serve_batch: {sb}")
    log(f"[gemma3] python -m repro_torch.examples.serve_batch --arch gemma3-1b: "
        f"exit 0 in {b_secs:.2f} s, {sb['requests']} requests, {sb['ms_per_step']} "
        f"ms a step, captured {sb['trace_count']}x")
    out["examples"] = {"approx_inference_s": a_secs, "serve_batch_s": b_secs,
                       "serve_batch": sb}


# ---------------------------------------------------------------------------
# phase 9: every other decoder-only family at full width
# ---------------------------------------------------------------------------
def sweep_operator(library: Path):
    """The cheapest sound operator the fleet's sweep put into the library
    (it also holds [control]'s constant-zero multiplier, whose MLP output
    drowns every other difference): (record, compiled operator, exact
    area, block bits)."""
    from repro_torch.fleet.plan import SWEEPS, plan_jobs
    from repro_torch.library.compile import load_mul_frontier

    compiled, exact_area, bits = load_mul_frontier(library)
    swept = {j.key() for j in plan_jobs(SWEEPS[FLEET_SWEEP])}
    rec, comp = next((r, c) for r, c in compiled if r.meta.get("job") in swept)
    return rec, comp, exact_area, bits


# (arch, layers kept (None: uncut), timed forward (B, S), the forward held
# against the plain route (B, S), the serve, W4A4 or exact MLP).  The plain
# route's LUT gather costs about 12 ms a G products, so hymba and
# command-r hold a shorter forward than the one timed; deepseek and
# mixtral cut nothing from the timed one but mixtral's length (past its
# window either way); mixtral and command-r keep 8 of 32 and 2 of 64 layers
# so that their weights fit the card
FAMILIES = [
    ("deepseek-v2-lite-16b", None, (2, 512), (2, 512), "continuous", True),
    ("internvl2-1b", None, (2, 256), (2, 256), "continuous", True),
    ("hymba-1.5b", None, (2, 2048), (2, 256), "fixed", True),
    ("rwkv6-3b", None, (2, 512), (2, 512), "fixed", False),
    ("mixtral-8x7b", 8, (1, 8192), (1, 4608), "continuous", False),
    ("command-r-plus-104b", 2, (1, 1024), (1, 128), "fixed", True),
]
FAMILY_SERVE = {"slots": 8, "prompt": 16, "gen": 16, "fixed_batch": {
    "hymba-1.5b": 4, "rwkv6-3b": 4, "command-r-plus-104b": 8}}


def family_layout(cfg) -> tuple[list, int]:
    """The flash windows a forward passes (one a flash layer: an int or
    None) and the W4A4 launches a forward or a decode step makes."""
    from repro_torch.models.lm import layer_window, window_schedule

    win = window_schedule(cfg)
    flash = ([] if cfg.mla is not None or cfg.rwkv is not None else
             [layer_window(win, i) for i in range(cfg.n_layers)])
    if cfg.rwkv is not None:
        lut = 0
    elif cfg.moe is not None:
        lut = 3 * cfg.moe.n_shared * cfg.n_layers
    else:
        lut = 3 * cfg.n_layers
    return flash, lut


def family_batch(torch, cfg, B: int, S: int, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device="cuda")}
    if cfg.vision is not None:
        v = cfg.vision
        batch["patches"] = torch.randn((B, v.n_patches, v.d_vision), generator=gen,
                                       device="cuda").to(cfg.torch_dtype)
    return batch


def family_forward(torch, cfg, params, stack, spec, results: dict) -> dict:
    """The plain route against the kernel route on one forward (every
    logit bit-equal where no layer takes flash, else position 0, where
    attention returns v exactly on both routes), then the timed forward
    (the second of two calls) with its launches and flash windows."""
    from repro_torch.kernels import ops
    from repro_torch.models.lm import forward_lm

    arch, _, (B, S), (Bc, Sc), _, _ = spec
    flash, lut = family_layout(cfg)

    def forward(batch, backend="auto"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, aux = forward_lm(cfg, params, batch, lut=stack, backend=backend)
        torch.cuda.synchronize()
        return logits, float(aux), time.perf_counter() - t0

    check = family_batch(torch, cfg, Bc, Sc, 1)
    k_logits, k_aux, _ = forward(check)
    p_logits, p_aux, plain_s = forward(check, "ref")
    if flash:
        equal = bool(torch.equal(k_logits[:, 0], p_logits[:, 0]))
        what = "position-0 logits"
    else:
        equal = bool(torch.equal(k_logits, p_logits)) and k_aux == p_aux
        what = "every logit and the aux loss"
    gap = float((k_logits - p_logits).abs().mean())
    del k_logits, p_logits
    require(equal, f"{arch} forward B={Bc} S={Sc}: {what} differ between the "
                   f"kernel and the plain route")

    batch = family_batch(torch, cfg, B, S, 2)
    forward(batch)
    real = ops.flash_attention
    windows = []

    def spy(q, k, v, *, window=None, **kw):
        windows.append(window)
        return real(q, k, v, window=window, **kw)

    reset_counts()
    ops.flash_attention = spy
    try:
        logits, aux, secs = forward(batch)
    finally:
        ops.flash_attention = real
    counts = read_counts()
    P = cfg.vision.n_patches if cfg.vision is not None else 0
    require(tuple(logits.shape) == (B, P + S, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()) and aux == aux,
            f"{arch} forward: logits {tuple(logits.shape)}, aux {aux}")
    require(windows == flash and counts["flash_attention"] == len(flash)
            and counts["approx_matmul_w4"] == (lut if stack is not None else 0)
            and counts["approx_matmul_w8"] == counts["template_eval"] == 0,
            f"{arch} forward launches {counts}, windows {windows}, expected "
            f"{len(flash)} flash and {lut} W4A4")
    ran = [n for n in ("flash_attention", "approx_matmul_w4") if counts[n]]
    credit(results, f"{arch} forward_lm", counts, *ran)
    tally = ", ".join(f"{n} {counts[n]}" for n in ran) or "no kernel"
    wins = sorted({str(w) for w in windows})
    log(f"[families] {arch} forward_lm B={B} S={S}"
        + (f" (+ {P} patches)" if P else "")
        + f": {secs:.3f} s (host clock, synchronised, the second call), aux "
        f"{aux:.4g}; launches {tally}"
        + (f" (windows {', '.join(wins)})" if windows else "")
        + f"; held at B={Bc} S={Sc}: {what} bit-equal to the plain route "
        f"({plain_s:.2f} s), mean |kernel - plain| {gap:.4g}")
    return {"forward_s": secs, "shape": [B, S], "aux": aux, "launches": counts,
            "windows": [w for w in windows], "check_shape": [Bc, Sc],
            "plain_s": plain_s, "equal": what, "mean_abs_gap": gap}


def family_teacher_forced(torch, cfg, params) -> dict:
    """Decoding token by token against the teacher-forced forward, as the
    reference's tests/test_models.py::test_decode_matches_forward: exact
    MLP, the MoE capacity raised so that no token drops (decode is
    dropless), B=2 and 8 tokens; VLM with no patches, so that positions
    agree.  That test's models have 2 layers, and so does the cut held to
    its bounds here (max |dlogit| < 8e-2, argmax agreement >= 0.6): the
    full width, the first 2 layers, embedding and head.  The whole depth
    is reported: in bf16 with random weights the two orders of rounding
    drift apart layer by layer (rwkv6-3b, which launches no kernel,
    reached 0.27 at 32 layers)."""
    import dataclasses

    from repro_torch.models import decode_fn, init_caches
    from repro_torch.models.lm import forward_lm

    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    cfg = dataclasses.replace(cfg, approx_mlp=False)
    B, S = 2, 8
    batch = family_batch(torch, cfg, B, S, 3)
    if cfg.vision is not None:
        batch["patches"] = batch["patches"][:, :0]
    out = {}
    for depth in (2, cfg.n_layers):
        c = dataclasses.replace(cfg, n_layers=depth)
        p = dict(params, layers=params["layers"][:depth])
        with torch.no_grad():
            full = forward_lm(c, p, batch)[0]
            caches = init_caches(c, B, S)
            step = decode_fn(c)
            got = torch.stack([step(c, p, caches, batch["tokens"][:, t:t + 1], t)[0]
                               for t in range(S)], dim=1)
        out[depth] = {"max_abs_dlogit": float((got - full).abs().max()),
                      "argmax_agreement": float((got.argmax(-1) == full.argmax(-1))
                                                .float().mean())}
    return out


def family_serve(torch, cfg, params, stack, spec, results: dict) -> dict:
    """The serve on the kernel route and on the plain route: captured once
    each, the same tokens (completions), one decode step's logits
    bit-equal (attention in decode takes no kernel, and the LUT kernel is
    bit-exact), launches a replay x (replays + warm-up)."""
    from repro_torch.serving import (ContinuousServingEngine, ServingEngine,
                                     Telemetry, steady, synth_requests)
    from repro_torch.serving.engine import _WARMUP

    arch, _, _, _, kind, _ = spec
    sv = FAMILY_SERVE
    _, lut = family_layout(cfg)
    lut = lut if stack is not None else 0
    prof = steady(2, 4, prompt_len=sv["prompt"], gen_len=sv["gen"])
    runs = {}
    for backend in ("auto", "ref"):
        reset_counts()
        if kind == "continuous":
            e = ContinuousServingEngine(cfg, params, max_slots=sv["slots"],
                                        prompt_len=sv["prompt"], gen_len=sv["gen"],
                                        page_size=16, luts=stack, backend=backend,
                                        device="cuda")
            snap = {"logits": ()}

            def keep(e, step, snap=snap):
                rows = [i for i, _ in e._pool]
                if len(rows) > len(snap["logits"]):
                    snap["logits"] = e.static_step.logits[rows].clone()
                    snap["step"] = step

            summ = e.serve(prof, telemetry=Telemetry(), seed=0,
                           on_step_end=keep).summary()
            tokens = {rid: g.tolist() for rid, g in sorted(e.completions.items())}
            held, at = snap["logits"], f"step {snap['step']}"
            ms = summ["latency_ms_per_step"]["p50"]
            caches = sorted({tuple(sorted(c)) for c in e.static_step.caches})
        else:
            batch = sv["fixed_batch"][arch]
            e = ServingEngine(cfg, params, batch=batch, prompt_len=sv["prompt"],
                              gen_len=sv["gen"], luts=stack, backend=backend,
                              device="cuda")
            reqs = synth_requests(steady(1, batch, prompt_len=sv["prompt"],
                                         gen_len=sv["gen"]), cfg.vocab_size, 0)[0]
            stats = e.run_batch(reqs)
            summ = {"ms_per_step": stats.ms_per_step,
                    "decode_tok_s": stats.decode_tok_s,
                    "prefill_tok_s": stats.prefill_tok_s}
            tokens = e.last_tokens.tolist()
            held, at = e.static_step.logits.clone(), "the last step"
            ms = stats.ms_per_step
            caches = sorted({tuple(sorted(c)) for c in e.static_step.caches})
        counts = read_counts()
        st = e.static_step
        want = lut * (st.replays + _WARMUP) if backend == "auto" else 0
        require(e.trace_count == 1 and counts["approx_matmul_w4"] == want
                and counts["flash_attention"] == counts["approx_matmul_w8"] == 0,
                f"{arch} {kind} serve ({backend}): captured {e.trace_count}x, "
                f"launches {counts}, {st.replays} replays, {want} expected")
        runs[backend] = (tokens, held, at, summ, counts, st.replays, ms,
                         st.capture_s, caches)
        del e, st
        release(torch)
    tokens, held, at, summ, counts, replays, ms, cap_s, caches = runs["auto"]
    require(tokens == runs["ref"][0], f"{arch} {kind} serve: tokens differ "
                                      f"between the kernel and the plain route")
    require(at == runs["ref"][2] and torch.equal(held, runs["ref"][1]),
            f"{arch} {kind} serve: {at}'s logits differ between the kernel and "
            f"the plain route")
    if lut:
        credit(results, f"{arch} {kind} serve", counts, "approx_matmul_w4")
    log(f"[families] {arch} {kind} serve"
        + (f" ({sv['slots']} slots, steady 2x4" if kind == "continuous"
           else f" (batch {sv['fixed_batch'][arch]}, one batch")
        + f", prompt {sv['prompt']}, gen {sv['gen']}; caches "
        + " | ".join("+".join(c) for c in caches)
        + f"): ms a step {ms:.2f} ("
        + ("p50 over the serve, host clock after the argmax read"
           if kind == "continuous" else "host clock, synchronised")
        + f"), plain route {runs['ref'][6]:.2f}; captured once ({cap_s:.2f} s); "
        f"approx_matmul_w4 launches {counts['approx_matmul_w4']} = {lut} x "
        f"({replays} replays + {_WARMUP} warm-up); tokens identical to the plain "
        f"route's, {at}'s logits of {len(held)} rows bit-equal")
    return {"kind": kind, "ms_per_step": ms, "plain_ms_per_step": runs["ref"][6],
            "summary": summ, "replays": replays, "launches": counts,
            "capture_s": cap_s, "caches": caches}


def family_step_profile(torch, cfg, params, stack, arch: str) -> dict:
    """Where one eager decode step's device time goes, at 8 rows
    (``torch.profiler``, the top kernels by device time)."""
    from repro_torch.kernels import ops
    from repro_torch.models import decode_fn, init_caches

    caches = init_caches(cfg, 8, 32)
    tok = torch.zeros((8, 1), dtype=torch.int32, device="cuda")
    luts = None if stack is None else ops.route_luts(torch.as_tensor(stack, device="cuda"))
    step = decode_fn(cfg)

    def decode():
        with torch.no_grad():
            step(cfg, params, caches, tok, 3, luts=luts)

    decode()
    out = profile_step(torch, decode, tag=f"[families] {arch} step:")
    del caches
    return out


def family_launcher(torch, library: Path, results: dict) -> dict:
    """``python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    --continuous`` at W4A4 on the fleet's library (the launcher's default
    budget), in this process: one capture, 2 shared experts x 3 linears x
    27 layers = 162 W4A4 launches a replay."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serving.engine import _WARMUP

    arch = "deepseek-v2-lite-16b"
    cfg = get_config(arch)
    _, lut = family_layout(cfg)
    tmp = ROOT / "build" / "families"
    tmp.mkdir(parents=True, exist_ok=True)
    sv = FAMILY_SERVE
    bench = tmp / "deepseek_serve.json"
    reset_counts()
    _, text, secs = run_cli(torch, "families_deepseek_serve", serve_cli.main, [
        "--arch", arch, "--continuous", "--library", library,
        "--max-slots", sv["slots"], "--page-size", 16, "--schedule", "steady",
        "--ticks", 2, "--per-tick", 4, "--prompt-len", sv["prompt"],
        "--gen-len", sv["gen"], "--bench-json", bench])
    counts = read_counts()
    s = json.loads(bench.read_text())
    require(s["trace_count"] == 1 and s["mode"] == "continuous" and lut == 162
            and counts["approx_matmul_w4"] == lut * (s["steps"] + _WARMUP)
            and not any(counts[n] for n in counts if n != "approx_matmul_w4"),
            f"{arch} launcher: " + json.dumps({k: s.get(k) for k in (
                "trace_count", "mode", "steps", "approx_layers")}) + f", launches {counts}")
    credit(results, f"{arch} cli serve --continuous", counts, "approx_matmul_w4")
    lat = s["latency_ms_per_step"]
    log(f"[families] python -m repro_torch.launch.serve --arch {arch} --continuous "
        f"--library (8 slots, steady 2x4, prompt 16, gen 16): {s['requests']} requests "
        f"in {s['steps']} steps, {s['approx_layers']} approx layers, ms a step p50 "
        f"{lat['p50']} p95 {lat['p95']}, decode {s['decode_tok_s']} tok/s, {secs:.1f} s "
        f"in all (init included); captured {s['trace_count']}x; approx_matmul_w4 "
        f"launches {counts['approx_matmul_w4']} = {lut} x ({s['steps']} replays + "
        f"{_WARMUP} warm-up)")
    return {"summary": s, "seconds": secs, "launches": counts}


def family_w8_refused(torch, cfg, params) -> str:
    """A W8A8 stack on command-r is refused before any launch: its w2
    contracts over d_ff = 33,792, past W8A8's max_k of 29,140."""
    import numpy as np

    from repro_torch.models.lm import forward_lm
    from repro_torch.precision.compose import tile_to_width

    ex = np.arange(16)[:, None] * np.arange(16)[None, :]
    w8 = np.stack([tile_to_width(ex)] * cfg.n_layers).astype(np.int32)
    reset_counts()
    try:
        forward_lm(cfg.with_approx_mlp(8), params, family_batch(torch, cfg, 1, 8, 4),
                   lut=w8)
        refused = None
    except ValueError as e:
        refused = str(e)
    counts = read_counts()
    require(refused is not None and "exceeds the overflow-free" in refused
            and not any(counts.values()),
            f"command-r W8A8: refused {refused!r}, launches {counts}")
    return refused


def phase_families(torch, library: Path, results: dict) -> None:
    """The other decoder-only families, one model at a time with random
    weights from seed 0 in bf16, released before the next: the forward
    held against the plain route and timed, decode against the
    teacher-forced forward, a serve on both routes (continuous where the
    reference pages the family, fixed-batch for the recurrent ones and
    command-r), and deepseek-v2-lite through the launcher."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_model

    out: dict = {}
    results["families"] = out
    rec, comp, exact_area, bits = sweep_operator(library)
    log(f"[families] W4A4 on {rec.key} ({rec.source}, area {rec.area} of "
        f"{exact_area}, {bits}-bit block, mae {comp.mae16:.3f})")
    out["deepseek_launcher"] = family_launcher(torch, library, results)
    release(torch)
    for spec in FAMILIES:
        arch, cut, _, _, _, approx = spec
        cfg = get_config(arch)
        if cut is not None:
            cfg = dataclasses.replace(cfg, n_layers=cut)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = init_model(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gib = cfg.n_params() * 2 / 2**30
        log(f"[families] {arch}: {cfg.n_layers} layers"
            + (f" of {get_config(arch).n_layers}" if cut else "")
            + f", family {cfg.family}, d_model {cfg.d_model}, {cfg.n_params() / 1e9:.2f} B "
            f"params ({gib:.1f} GiB in bf16; {torch.cuda.memory_allocated() / 2**30:.1f} "
            f"GiB on the card), init {init_s:.1f} s")
        row = {"layers": cfg.n_layers, "cut_from": get_config(arch).n_layers if cut else None,
               "params_gib": gib, "init_s": init_s}
        stack = None
        if approx:
            cfg = cfg.with_approx_mlp(4)
            stack = np.stack([comp.lut] * cfg.n_layers).astype(np.int32)
        row["forward"] = family_forward(torch, cfg, params, stack, spec, results)
        release(torch)
        tf = family_teacher_forced(torch, cfg, params)
        # MLA's absorbed decode drifts from the expanded forward in bf16 in
        # the reference itself: its test_decode_matches_forward is xfail for
        # deepseek-v2-lite-16b, so only the argmax bound holds MLA here
        bound = None if cfg.mla is not None else 8e-2
        two, whole = tf[2], tf[cfg.n_layers]
        log(f"[families] {arch} decode against the teacher-forced forward (exact "
            f"MLP, B=2, 8 tokens), at 2 layers: max |dlogit| "
            f"{two['max_abs_dlogit']:.4g} "
            + (f"(< {bound})" if bound else "(unbounded for MLA, xfail in the "
               "reference's own test)")
            + f", argmax agreement {two['argmax_agreement']:.3f} (>= 0.6); at all "
            f"{cfg.n_layers}: {whole['max_abs_dlogit']:.4g}, "
            f"{whole['argmax_agreement']:.3f}")
        require(two["argmax_agreement"] >= 0.6
                and (bound is None or two["max_abs_dlogit"] < bound),
                f"{arch} decode against the teacher-forced forward: {tf}")
        row["teacher_forced"] = tf
        row["serve"] = family_serve(torch, cfg, params, stack, spec, results)
        row["step_profile"] = family_step_profile(torch, cfg, params, stack, arch)
        if arch == "command-r-plus-104b":
            row["w8_refused"] = family_w8_refused(torch, cfg, params)
            log(f"[families] {arch} W8A8: refused before any launch: {row['w8_refused']}")
        out[arch] = row
        del params
        release(torch)


# ---------------------------------------------------------------------------
# phase 10: the encoder–decoder family and training
# ---------------------------------------------------------------------------
# whisper-tiny's forward and serve; stablelm-1.6b's training run through
# the launcher; the resume runs (arch, reduced, launcher flags)
WHISPER_FWD = (2, 448)
WHISPER_SERVE = {"batch": 4, "prompt": 8, "gen": 24}
TRAIN_RUN = ["--arch", "stablelm-1.6b", "--steps", 5, "--batch", 8, "--seq", 128,
             "--log-every", 1]
RESUME_RUNS = [("whisper-tiny", False, ["--batch", 4, "--seq", 64]),
               ("mixtral-8x7b", True, ["--batch", 4, "--seq", 32])]
TRAIN_SMALL_STEPS = 300
# rwkv6-3b at full width, depth cut to 2 layers, in float32 so that the
# two scans' gradients compare at the float32 tolerance; 4 x 1,024 tokens
RWKV_TRAIN = {"layers": 2, "batch": 4, "seq": 1024, "seed": 0}
RWKV_RTOL, RWKV_ATOL = 2e-5, 1e-6


def phase_train(torch, results: dict) -> None:
    """The encoder–decoder family at full width (forward, decode against
    the forward at position 0, the serve launcher with its warm-up, a
    replay bit-equal to the eager step, the two refusals), then training:
    stablelm-1.6b through ``repro_torch.launch.train.main``, the gradient
    guard, microbatches, a default step against one under
    ``torch.use_deterministic_algorithms``, resume bit for bit through the
    launcher, and the ``train_small`` example.  The train step
    differentiates the plain route: no kernel launches while training."""
    import tempfile

    out: dict = {}
    results["train"] = out
    work = ROOT / "build" / "train"
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        tmp = Path(tmp)
        out["whisper"] = train_whisper(torch, tmp)
        release(torch)
        out["stablelm"] = train_stablelm(torch)
        release(torch)
        out["rwkv6"] = train_rwkv(torch)
        release(torch)
        out["microbatches"] = train_microbatches(torch)
        out["deterministic"] = {arch: train_deterministic(torch, arch, reduced)
                                for arch, reduced, _ in RESUME_RUNS}
        release(torch)
        out["resume"] = {arch: train_resume(torch, arch, reduced, extra, tmp)
                         for arch, reduced, extra in RESUME_RUNS}
        release(torch)
        out["train_small"] = train_small_run(torch, tmp)
    # the training path launches no kernel: each kernel's count there is 0
    credit(results, "training", out["stablelm"]["launches"],
           *out["stablelm"]["launches"])


def tree_leaves(tree) -> list:
    from repro_torch.train.optim import tree_leaves as leaves

    return leaves(tree)


def train_whisper(torch, tmp: Path) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import encdec, init_model
    from repro_torch.serving import ServingEngine, steady, synth_requests
    from repro_torch.train import DataState, synth_batch

    arch = "whisper-tiny"
    cfg = get_config(arch)
    params = init_model(cfg, seed=0, device="cuda")
    n = sum(t.numel() for t in tree_leaves(params))
    B, S = WHISPER_FWD
    batch = synth_batch(cfg, B, S, DataState(0, 0), device="cuda")
    reset_counts()
    with torch.no_grad():
        logits = encdec.forward_encdec(cfg, params, batch)[0]
        ms = time_ms(torch, lambda: encdec.forward_encdec(cfg, params, batch), iters=5)
    counts = read_counts()
    require(tuple(logits.shape) == (B, S, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()) and not any(counts.values()),
            f"{arch} forward: shape {tuple(logits.shape)}, launches {counts}")
    log(f"[train] {arch}: {n / 1e6:.1f} M parameters ({cfg.n_params() / 1e6:.1f} M by "
        f"the config's count), {cfg.encoder.n_frames} frames, vocab {cfg.vocab_size}; "
        f"forward_encdec B={B} S={S}: {ms:.3f} ms (CUDA events, 5 calls), logits finite, "
        f"no kernel launched (every attention takes the masked-softmax path, the "
        f"GELU FFNs no LUT)")

    with torch.no_grad():
        caches = encdec.prefill_cross(cfg, params, batch["frames"],
                                      encdec.init_encdec_caches(cfg, B, S))
        dlogit = [float((encdec.decode_step_encdec(
            cfg, params, caches, batch["tokens"][:, t:t + 1], t)[0]
            - logits[:, t]).abs().max()) for t in range(8)]
    require(dlogit[0] < 2e-2, f"{arch} decode at position 0: {dlogit}")
    log(f"[train] {arch} decode against the teacher-forced forward: position 0 "
        f"max |dlogit| {dlogit[0]:.4g} (< 2e-2); positions 1-7 "
        f"{', '.join(f'{d:.3g}' for d in dlogit[1:])} (decode applies RoPE, the "
        f"forward does not, as in the reference)")

    sv = WHISPER_SERVE
    bench = tmp / "whisper_serve.json"
    argv = ["--arch", arch, "--batch", sv["batch"], "--prompt-len", sv["prompt"],
            "--gen-len", sv["gen"], "--ticks", 2]
    reset_counts()
    _, text, secs = run_cli(torch, "train_whisper_serve", serve_cli.main,
                            argv + ["--bench-json", bench])
    s = json.loads(bench.read_text())
    counts = read_counts()
    require(s["trace_count"] == 1 and s["requests"] == 2 * sv["batch"]
            and not any(counts.values()),
            f"{arch} launcher: {json.dumps(s)[:400]}, launches {counts}")
    log(f"[train] python -m repro_torch.launch.serve --arch {arch} (batch {sv['batch']}, "
        f"prompt {sv['prompt']}, gen {sv['gen']}, 2 batches, cross K/V staged by the "
        f"warm-up): {s['requests']} requests, {s['ms_per_step']:.3f} ms a step, "
        f"decode {s['decode_tok_s']:.1f} tok/s, captured {s['trace_count']}x, "
        f"{secs:.1f} s in all (init included)")
    refused = {}
    for name, flag in (("library", ["--library", tmp / "no_library"]),
                       ("continuous", ["--continuous"])):
        try:
            serve_cli.main([str(a) for a in argv + flag])
            refused[name] = None
        except SystemExit as e:
            refused[name] = str(e)
        require(refused[name] is not None and "LM families only" in refused[name],
                f"{arch} --{name} not refused: {refused[name]}")
    log(f"[train] {arch} refused: --library ({refused['library']!r}), --continuous "
        f"({refused['continuous']!r})")

    frames = synth_batch(cfg, sv["batch"], 1, DataState(1, 0), device="cuda")["frames"]

    def warm(c):
        return encdec.prefill_cross(cfg, params, frames, c)

    eng = ServingEngine(cfg, params, batch=sv["batch"], prompt_len=sv["prompt"],
                        gen_len=sv["gen"], warmup_caches=warm, device="cuda")
    reqs = synth_requests(steady(1, sv["batch"], prompt_len=sv["prompt"],
                                 gen_len=sv["gen"]), cfg.vocab_size, 0)[0]
    stats = eng.run_batch(reqs)
    with torch.no_grad():
        tokens, eager_logits = eager_batch(torch, eng, reqs, None, warmup=warm)
    require(np.array_equal(eng.last_tokens, tokens)
            and torch.equal(eng.static_step.logits, eager_logits)
            and eng.trace_count == 1,
            f"{arch}: the replay differs from the eager decode step")
    log(f"[train] {arch} engine: the last replay's logits bit-equal to the eager "
        f"decode_step_encdec route's, tokens identical, captured once "
        f"({eng.static_step.capture_s:.2f} s); {stats.ms_per_step:.3f} ms a step")
    return {"n_params": n, "forward_ms": ms, "decode_dlogit": dlogit,
            "serve": s, "serve_seconds": secs, "refused": refused,
            "engine_ms_per_step": stats.ms_per_step}


def train_stablelm(torch) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models import init_model, lm
    from repro_torch.train import DataState, synth_batch

    argv = TRAIN_RUN
    steps, B, S = (argv[argv.index(k) + 1] for k in ("--steps", "--batch", "--seq"))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    run, text, secs = run_cli(torch, "train_stablelm", train_cli.main, argv)
    counts = read_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    cfg = get_config("stablelm-1.6b")
    params = run["params"]
    before = init_model(cfg, seed=0, device="cuda")    # the launcher's init
    leaves = tree_leaves(params)
    changed = sum(not torch.equal(a, b) for a, b in zip(leaves, tree_leaves(before)))
    del before
    losses, gnorms, step_ms = run["losses"], run["grad_norms"], run["step_ms"]
    ms = float(np.mean(step_ms[1:]))
    tok_s = B * S / (ms / 1e3)
    require(len(losses) == steps and all(np.isfinite(losses)) and min(gnorms) > 0
            and changed == len(leaves) and not any(counts.values()),
            f"stablelm-1.6b training: losses {losses}, grad norms {gnorms}, "
            f"{changed} of {len(leaves)} tensors changed, launches {counts}")
    log(f"[train] python -m repro_torch.launch.train {' '.join(map(str, argv))}: "
        f"{run['n_params'] / 1e9:.3f} B parameters, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (finite), grad norm {min(gnorms):.3f}-{max(gnorms):.3f} "
        f"(> 0), all {len(leaves)} parameter tensors changed; {ms:.1f} ms a step "
        f"(CUDA events, mean of steps 2-{steps}; step 1 {step_ms[0]:.1f} ms), "
        f"{tok_s:.0f} tokens/s, peak allocated {peak:.2f} GiB over the run "
        f"(weights, gradients, moments, activations); kernel launches "
        f"{sum(counts.values())} (the step differentiates the plain route); "
        f"{secs:.1f} s in all")

    # the guard: a loss on the kernel route over parameters that require
    # grad raises before any launch
    live = dict(params)
    live["embed"] = params["embed"].detach().requires_grad_(True)
    batch = synth_batch(cfg, 2, 16, DataState(0, 0), device="cuda")
    reset_counts()
    try:
        lm.lm_loss(cfg, live, batch, backend="auto")
        guard = None
    except RuntimeError as e:
        guard = str(e)
    after = read_counts()
    require(guard is not None and "require grad" in guard and not any(after.values()),
            f"the gradient guard: {guard!r}, launches {after}")
    log(f"[train] lm_loss(backend='auto') on parameters that require grad: "
        f"RuntimeError before any launch ({guard[:60]!r}...)")
    del live
    split = train_step_split(torch, cfg, run["params"], run["opt_state"], B, S)
    del params, run
    return {"losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
            "ms_per_step": ms, "tokens_per_s": tok_s, "peak_allocated_gib": peak,
            "changed": changed, "tensors": len(leaves), "launches": counts,
            "seconds": secs, "guard": guard, "split": split}


def train_rwkv(torch) -> dict:
    """rwkv6-3b's loss and gradients (``RWKV_TRAIN``) through the WKV
    scan's autograd function, which saves one float32 state a step, and
    through autograd over the plain loop, which saves three: the loss
    within the float32 tolerance (bit-equal expected: the forwards run the
    same ops), every gradient within it against its tensor's largest
    magnitude, and each route's ms a step (CUDA events, the second of two
    steps) and peak allocated memory over a step."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_model, layers, lm
    from repro_torch.train import DataState, synth_batch
    from repro_torch.train.optim import tree_map

    run = RWKV_TRAIN
    cfg = dataclasses.replace(get_config("rwkv6-3b"), n_layers=run["layers"],
                              dtype="float32")
    params = init_model(cfg, seed=run["seed"], device="cuda")
    batch = synth_batch(cfg, run["batch"], run["seq"], DataState(run["seed"], 0),
                        device="cuda")
    rw = cfg.rwkv
    H = cfg.d_model // rw.head_dim
    state_gb = run["batch"] * run["seq"] * H * rw.head_dim ** 2 * 4 / 1e9

    def step():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = lm.lm_loss(cfg, live, batch, backend="ref")
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(live))

    def route(scan) -> dict:
        saved, layers.wkv_scan = layers.wkv_scan, scan
        try:
            step()                                   # warm-up
            release(torch)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            loss, grads = step()
            ev[1].record()
            ev[1].synchronize()
            return {"loss": loss, "grads": grads, "ms": ev[0].elapsed_time(ev[1]),
                    "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
        finally:
            layers.wkv_scan = saved

    reset_counts()
    fn = route(layers.wkv_scan)
    counts = read_counts()
    loop = route(layers._rwkv_wkv_scan)
    worst = max(float(((g - w).abs() / (RWKV_ATOL + RWKV_RTOL * w.abs().max())).max())
                for g, w in zip(fn["grads"], loop["grads"]))
    dloss = float((fn["loss"] - loop["loss"]).abs())
    finite = bool(torch.isfinite(fn["loss"])) and all(
        bool(torch.isfinite(g).all()) for g in fn["grads"])
    require(finite and dloss <= RWKV_ATOL + RWKV_RTOL * float(loop["loss"].abs())
            and worst <= 1.0 and not any(counts.values()),
            f"rwkv6-3b train: loss {float(fn['loss'])} / {float(loop['loss'])}, "
            f"worst gradient {worst:.3f} of the tolerance, finite {finite}, "
            f"launches {counts}")
    smi = card_line()
    log(f"[train] rwkv6-3b ({run['layers']} of 32 layers, full width, float32, "
        f"{run['batch']}x{run['seq']} tokens, seed {run['seed']}): loss "
        f"{float(fn['loss']):.6f}, |dloss| {dloss:.3g} "
        f"({'bit-equal' if dloss == 0 else 'within tolerance'}); every gradient within "
        f"{worst:.3f} of rtol {RWKV_RTOL} (of its tensor's max) + atol {RWKV_ATOL}; "
        f"autograd function {fn['ms']:.1f} ms a step, peak {fn['peak_gb']:.2f} GB; "
        f"plain loop {loop['ms']:.1f} ms, peak {loop['peak_gb']:.2f} GB (loss and "
        f"gradients, CUDA events; peak allocated over the step); one state a step "
        f"{state_gb:.2f} GB a layer against three; kernel launches "
        f"{sum(counts.values())}; {smi}")
    return {"loss": float(fn["loss"]), "dloss": dloss, "worst_of_tolerance": worst,
            "function_ms": fn["ms"], "loop_ms": loop["ms"],
            "function_peak_gb": fn["peak_gb"], "loop_peak_gb": loop["peak_gb"],
            "state_gb_a_layer": state_gb, "launches": counts, "nvidia_smi": smi}


def train_step_split(torch, cfg, params, opt_state, B: int, S: int) -> dict:
    """Where a train step's time goes: the loss with its gradients and the
    AdamW update timed apart by CUDA events, then one whole step profiled
    by kernel (``torch.profiler``)."""
    from repro_torch.models import loss_fn
    from repro_torch.train import (DataState, OptimizerConfig, apply_updates,
                                   make_train_step, synth_batch)
    from repro_torch.train.optim import tree_map

    batch = synth_batch(cfg, B, S, DataState(0, 99), device="cuda")
    opt_cfg = OptimizerConfig(lr=3e-4)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    value = loss_fn(cfg)(cfg, live, batch, backend="ref")
    grads = torch.autograd.grad(value, tree_leaves(live))
    ev[1].record()
    apply_updates(opt_cfg, params, list(grads), opt_state)
    ev[2].record()
    ev[2].synchronize()
    grad_ms, update_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    del live, grads, value
    log(f"[train] stablelm-1.6b step split (CUDA events, one step): loss and "
        f"gradients {grad_ms:.1f} ms, AdamW update {update_ms:.1f} ms")
    step = make_train_step(cfg, opt_cfg, remat="none")
    prof = profile_step(torch, lambda: step(params, opt_state, batch),
                        tag="[train] stablelm-1.6b step:")
    return {"grad_ms": grad_ms, "update_ms": update_ms, **prof}


def train_microbatches(torch) -> dict:
    """``microbatches=2`` against 1 on reduced stablelm (bf16): the loss
    within 2e-2, the reference's own bound."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.train import (DataState, OptimizerConfig, init_opt_state,
                                   make_train_step, synth_batch)

    cfg = get_config("stablelm-1.6b", reduced=True)
    batch = synth_batch(cfg, 8, 32, DataState(2, 0), device="cuda")
    losses = []
    for mb in (1, 2):
        p = init_model(cfg, seed=2, device="cuda")
        _, _, m = make_train_step(cfg, OptimizerConfig(), microbatches=mb,
                                  remat="none")(p, init_opt_state(p), batch)
        losses.append(float(m["loss"]))
    d = abs(losses[0] - losses[1])
    require(d < 2e-2, f"microbatches: losses {losses}")
    log(f"[train] reduced stablelm, microbatches 2 against 1: loss {losses[1]:.5f} "
        f"against {losses[0]:.5f}, |d| {d:.2e} (< 2e-2)")
    return {"losses": losses, "diff": d}


def train_deterministic(torch, arch: str, reduced: bool) -> dict:
    """One train step in the default mode against the same step under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: an op
    with a nondeterministic CUDA default (atomics) either warns there or,
    where it has a deterministic variant, sums in another order: every
    parameter must come out bit-equal, and the warnings are reported."""
    import os
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.train import (DataState, OptimizerConfig, init_opt_state,
                                   make_train_step, synth_batch)

    cfg = get_config(arch, reduced=reduced)
    batch = synth_batch(cfg, 4, 32, DataState(0, 0), device="cuda")
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3), remat="none")
    runs = []
    caught: list = []
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    for deterministic in (False, True):
        p = init_model(cfg, seed=0, device="cuda")
        if deterministic:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                step(p, init_opt_state(p), batch)
                torch.cuda.synchronize()
            if deterministic:
                caught = sorted({str(x.message)[:120] for x in w})
        finally:
            torch.use_deterministic_algorithms(False)
            if env is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
        runs.append(tree_leaves(p))
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    require(same, f"{arch}: a train step under deterministic algorithms "
                  f"differs from the default one (warnings: {caught})")
    log(f"[train] {cfg.name}: one train step bit-equal with and without "
        f"torch.use_deterministic_algorithms; warnings there: "
        + ("; ".join(caught) if caught else "none"))
    return {"bit_equal": same, "warnings": caught}


def train_resume(torch, arch: str, reduced: bool, extra: list, tmp: Path) -> dict:
    """Through the launcher: 4 steps straight (saving at 2 and 4), then a
    restart from the straight run's step-2 checkpoint to step 4; the two
    step-4 checkpoints (every parameter, moment and the step) bit-equal."""
    import numpy as np

    from repro_torch.launch import train as train_cli

    d = tmp / f"resume_{arch}"
    a, b = d / "straight", d / "resumed"
    argv = ["--arch", arch, *(["--reduced"] if reduced else []), "--steps", 4,
            "--log-every", 1, *extra]
    reset_counts()
    _, _, secs_a = run_cli(torch, f"train_resume_{arch}_straight", train_cli.main,
                           argv + ["--ckpt-dir", a, "--ckpt-every", 2])
    b.mkdir(parents=True)
    shutil.copytree(a / "step_00000002", b / "step_00000002")
    (b / "LATEST").write_text("step_00000002")
    _, text, secs_b = run_cli(torch, f"train_resume_{arch}_resumed", train_cli.main,
                              argv + ["--ckpt-dir", b])
    counts = read_counts()
    with np.load(a / "step_00000004" / "arrays.npz") as za, \
            np.load(b / "step_00000004" / "arrays.npz") as zb:
        keys = sorted(za.files)
        same = keys == sorted(zb.files) and all(
            za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]) for k in keys)
        n_params = sum(1 for k in keys if k.startswith("params/"))
    shutil.rmtree(d)
    require("resumed from step 2" in text and same and not any(counts.values()),
            f"{arch} resume: bit-equal {same}, launches {counts}")
    name = arch + (" (reduced)" if reduced else "")
    log(f"[train] {name} resume through the launcher ({' '.join(map(str, extra))}): "
        f"4 steps straight against 2 + checkpoint + restore + 2, every array of "
        f"the step-4 checkpoints bit-equal ({n_params} parameter arrays, moments "
        f"and step; {len(keys)} in all); {secs_a:.1f} s and {secs_b:.1f} s")
    return {"bit_equal": same, "arrays": len(keys), "seconds": [secs_a, secs_b]}


def train_small_run(torch, tmp: Path) -> dict:
    import re

    from repro_torch.examples import train_small

    argv = ["--steps", TRAIN_SMALL_STEPS, "--ckpt-dir", tmp / "train_small"]
    reset_counts()
    try:
        _, text, secs = run_cli(torch, "train_small", train_small.main, argv)
        rc = 0
    except SystemExit as e:
        rc = e.code
        text = (ROOT / "chiprun_out" / "cli_train_small.log").read_text()
        secs = None
    m = re.search(r"loss ([0-9.]+) -> ([0-9.]+)", text)
    counts = read_counts()
    require(rc == 0 and m is not None and not any(counts.values()),
            f"train_small exited {rc}: {text[-400:]}")
    first, last = float(m.group(1)), float(m.group(2))
    log(f"[train] python -m repro_torch.examples.train_small --steps "
        f"{TRAIN_SMALL_STEPS} (qwen3-100m, batch 8x256): exit 0, loss {first:.3f} -> "
        f"{last:.3f} (mean of the last 20), {secs:.1f} s with 3 checkpoints")
    return {"rc": rc, "loss_first": first, "loss_last": last, "seconds": secs}


# ---------------------------------------------------------------------------
# phases 4-6: the main paths at full width
# ---------------------------------------------------------------------------
def credit(results: dict, path: str, counts: dict, *names: str) -> None:
    """Add one main path's launches of the kernels ``names`` to each
    kernel's total for the kernels line, and keep them per path."""
    for n in names:
        results["launches"][n] = results["launches"].get(n, 0) + counts[n]
        results["launches_by_path"].setdefault(n, {})[path] = counts[n]


def reset_counts() -> None:
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import template_eval as te

    am.approx_matmul_w4.launches = 0
    am.approx_matmul_w8.launches = 0
    am.approx_matmul_w8_direct.launches = 0
    fa.flash_attention.launches = 0
    te.template_eval.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import template_eval as te

    return {"approx_matmul_w4": am.approx_matmul_w4.launches,
            "approx_matmul_w8": am.approx_matmul_w8.launches,
            "approx_matmul_w8_direct": am.approx_matmul_w8_direct.launches,
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
    tel = eng.serve(profile, seed=0)
    counts = read_counts()
    credit(results, "fixed serve", counts, "approx_matmul_w4")
    require(counts["approx_matmul_w4"] > 0, "W4A4 serve launched no approx_matmul_w4")
    require(counts["flash_attention"] == 0, "decode ran the flash kernel")
    per_step = 3 * cfg.n_layers
    st = eng.static_step
    require(eng.trace_count == 1 and st.launches_per_replay == {"approx_matmul_w4": per_step},
            f"W4A4 serve captured {eng.trace_count}x, {st.launches_per_replay} a replay")
    log(f"[serve w4a4] {tel.n_batches} batches, approx_matmul_w4 launches "
        f"{counts['approx_matmul_w4']} ({per_step} a replay x {st.replays} replays "
        f"+ {counts['approx_matmul_w4'] - per_step * st.replays} in the warm-up "
        f"before the one capture)")
    for i, e in enumerate(tel.events):
        log(f"[serve w4a4] batch {i}: prefill {e['prefill_tok_s']} tok/s, "
            f"decode {e['decode_tok_s']} tok/s, {e['ms_per_step']:.2f} ms/step")
    results["serve_w4"] = list(tel.events)
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
    credit(results, "fixed W8A8 batch", counts, "approx_matmul_w8")
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


def profile_step(torch, decode, tag: str = "[step]") -> dict:
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
        log(f"{tag} profiler recorded no device time: not measured")
        return {"profile": "not measured"}
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    launches = sum(e.count for e in rows)
    log(f"{tag} profiled step: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms (idle {100 * (1 - busy_ms / wall_ms):.0f}%), "
        f"{launches} kernel launches")
    for e in top:
        log(f"{tag}   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
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
    credit(results, "forward_lm", counts, "flash_attention")
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
# the dry-run and the roofline
# ---------------------------------------------------------------------------
DRYRUN_CELLS = ([["--arch", "qwen3-4b", "--shape", s]
                 for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
                + [["--arch", "qwen3-4b", "--shape", "train_4k", "--multi-pod",
                    "--no-roofline"]]
                + [["--arch", arch, "--shape", "train_4k"]
                   for arch in ("mixtral-8x7b", "deepseek-v2-lite-16b", "rwkv6-3b")]
                + [["--arch", "hymba-1.5b", "--shape", "decode_32k"]])
# cells whose temporary plus argument bytes must fit the card: rwkv6-3b's
# train step held 152.63 GB a device before its WKV scan was split by
# value columns and saved one state a step
DRYRUN_FITS = {("rwkv6-3b", "train_4k")}
# cells whose temporary bytes a device may not pass the reference's
# (``tools/dryrun_memory.py --reference``): hymba-1.5b's decode held
# 5,086,059,784 while it repeated its KV heads where "model" splits no head
DRYRUN_REFERENCE_TEMP = {("hymba-1.5b", "decode_32k"): 4_558_231_104}
DRYRUN_TIMEOUT_S = 400
CARD_BYTES = 80e9          # the H100's HBM


def phase_dryrun(results: dict) -> None:
    """``python -m repro_torch.launch.dryrun`` for each cell of
    ``DRYRUN_CELLS`` and ``python -m repro_torch.experiments.hillclimb
    --step TAG`` for each iteration of the hill-climb, as subprocesses,
    all started together and each checked for exit code 0: qwen3-4b at
    full width on a fake 16x16 world for train, prefill and decode,
    ``long_500k``'s skip record, the 2x16x16 train step without the
    roofline, the MoE train steps of mixtral-8x7b and
    deepseek-v2-lite-16b and rwkv6-3b's train step on 16x16 (which must
    fit the card, ``DRYRUN_FITS``); then the hill-climb's nine ``train_4k``
    iterations of deepseek-v2-lite-16b, mixtral-8x7b and
    command-r-plus-104b.  The subprocesses see no card
    (``CUDA_VISIBLE_DEVICES`` empty): the dry-run runs on meta tensors by
    design."""
    import os

    from repro_torch.experiments.hillclimb import STEPS, add_record, picks

    out_dir = ROOT / "build" / "dryrun"
    perf_dir = ROOT / "build" / "perf_torch"
    for d in (out_dir, perf_dir):
        shutil.rmtree(d, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    commands = ([["-m", "repro_torch.launch.dryrun", *cell, "--out", str(out_dir)]
                 for cell in DRYRUN_CELLS]
                + [["-m", "repro_torch.experiments.hillclimb", "--step", tag,
                    "--out", str(perf_dir)] for _, _, tag, _ in STEPS])
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, *cmd], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in commands]
    try:
        outs = [p.communicate(timeout=DRYRUN_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for cmd, p, (stdout, stderr) in zip(commands, procs, outs):
        require(p.returncode == 0, f"{' '.join(cmd)} exited {p.returncode}: "
                                   f"{stdout[-400:]} {stderr[-800:]}")
    cells = []
    for cell in DRYRUN_CELLS:
        mesh = "2x16x16" if "--multi-pod" in cell else "16x16"
        rec = json.loads((out_dir / f"{cell[1]}__{cell[3]}__{mesh}.json").read_text())
        cells.append(rec)
        if rec["status"] == "skipped":
            require(cell[3] == "long_500k" and rec["reason"].startswith("long_500k skipped"),
                    f"dryrun {' '.join(cell)}: unexpected skip {rec}")
            log(f"[dryrun] {rec['arch']} {rec['shape']} {mesh}: skipped "
                f"({rec['reason']})")
            continue
        require(rec["status"] == "ok", f"dryrun {' '.join(cell)}: {rec}")
        mem = rec["memory_analysis"]
        held = mem["temp_size_in_bytes"] + mem["argument_size_in_bytes"]
        require((rec["arch"], rec["shape"]) not in DRYRUN_FITS or held < CARD_BYTES,
                f"dryrun {' '.join(cell)}: {held / 1e9:.2f} GB a device does not fit")
        ref_temp = DRYRUN_REFERENCE_TEMP.get((rec["arch"], rec["shape"]))
        require(ref_temp is None or mem["temp_size_in_bytes"] <= ref_temp,
                f"dryrun {' '.join(cell)}: temporary {mem['temp_size_in_bytes']} bytes a "
                f"device, past the reference's {ref_temp}")
        log(f"[dryrun] {rec['arch']} {rec['shape']} {mesh}: ok, {rec['chips']} chips; "
            f"per device {rec['hlo_flops']:.4g} FLOP, {rec['hlo_bytes']:.4g} B, "
            f"{rec['wire_bytes']:.4g} wire B, collectives {rec['collectives']}; "
            f"bottleneck {rec['bottleneck']}, roofline_fraction "
            f"{rec['roofline_fraction']:.4f} (modelled from counts and data-sheet "
            f"peaks); temp {mem['temp_size_in_bytes'] / 1e9:.2f} GB and arguments "
            f"{mem['argument_size_in_bytes'] / 1e9:.2f} GB a device of the card's "
            f"{CARD_BYTES / 1e9:.0f} GB; {rec['wall_s']:.1f} s on the host")
        if ref_temp is not None:
            log(f"[dryrun] {rec['arch']} {rec['shape']} {mesh}: temporary "
                f"{mem['temp_size_in_bytes']} bytes a device, the reference's "
                f"{ref_temp}")
    log(f"[dryrun] {len(cells)} cells and {len(STEPS)} hill-climb steps in {secs:.1f} s, "
        f"as {len(procs)} processes started together")
    results["dryrun"] = {"seconds": secs, "cells": cells}

    by_pair: dict = {}
    for arch, shape, tag, _ in STEPS:
        rec = json.loads((perf_dir / f"{arch}__{shape}__16x16__{tag}.json").read_text())
        require(rec["status"] == "ok", f"hillclimb {tag}: {rec}")
        add_record(by_pair, arch, shape, tag, rec)
        log(f"[hillclimb] {arch} {shape} {tag}: ok; modelled compute "
            f"{rec['t_compute']:.4g} s, memory {rec['t_memory']:.4g} s, collective "
            f"{rec['t_collective']:.4g} s, roofline_fraction "
            f"{rec['roofline_fraction']:.4f}; temp "
            f"{rec['memory_analysis']['temp_size_in_bytes'] / 1e9:.2f} GB a device; "
            f"{rec['wall_s']:.1f} s on the host")
    chosen = picks(by_pair, say=lambda line: log(f"[hillclimb] {line} (modelled)"))
    picks_by_arch = {arch: pick for (arch, _), pick in chosen.items()}
    results["hillclimb"] = {"records": [r for o in by_pair.values() for r in o.results],
                            "picks": picks_by_arch}


ROOFLINE_DECODE = {"rows": 8, "max_len": 512, "pos": 256}
ROOFLINE_FORWARD = (2, 512)
ROOFLINE_TRAIN = (8, 128)


def median_ms(torch, fn, calls: int, warmup: int = 1) -> float:
    """The median of ``calls`` calls, each timed by CUDA events."""
    import numpy as np

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return float(np.median(times))


def roofline_line(name: str, roof, ref_flops, want: int, ms: float, smi: str) -> dict:
    """Print one step's counted roofline beside its measured time."""
    share = roof.t_star * 1e3 / ms
    log(f"[roofline] {name}: counted {roof.hlo_flops:.6g} FLOP (independent count "
        f"{want:.6g}) and {roof.hlo_bytes:.4g} B a device"
        + (f" (plain route {ref_flops:.6g} FLOP)" if ref_flops is not None else "")
        + f"; model_flops {roof.model_flops:.4g}, useful_flops_ratio "
        f"{roof.useful_flops_ratio:.4f}; t* {roof.t_star * 1e3:.4f} ms, modelled step "
        f"{roof.t_step * 1e3:.4f} ms ({roof.bottleneck}), both from counts and "
        f"data-sheet peaks; measured {ms:.3f} ms (CUDA events, median), measured "
        f"share t*/measured {share:.4f}; {smi}")
    return {**roof.as_dict(), "t_step": roof.t_step, "measured_ms": ms,
            "measured_share": share, "plain_route_flops": ref_flops,
            "independent_flops": want}


def product_weights(cfg) -> int:
    """The weights of every product a token runs through, from the config
    alone: each layer's q, k, v and output projections and its three
    SwiGLU matrices, and the vocabulary head."""
    D, H, Hkv, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    return cfg.n_layers * (D * H * hd + 2 * D * Hkv * hd + H * hd * D + 3 * D * F) \
        + cfg.vocab_size * D


def phase_roofline(torch, cfg, params, results: dict) -> None:
    """``analysis.analyze`` on the card under ``parallel.activate
    (make_smoke_mesh())``, a world of one, with the parameters, caches and
    optimizer state as replicated DTensors, so that the model's ``shard``
    and ``fsdp_gather`` sites and the kernels' local-shard routes run:
    (a) the qwen3-4b W4A4 decode step at 8 rows, (b) ``forward_lm`` at B=2
    S=512 in bf16 through flash, (c) stablelm-1.6b's train step at 8x128.
    Each with its counted FLOPs and bytes, t*, the modelled step and the
    measured ms of the plain step.  The counted FLOPs equal an independent
    count from the config: 2 a product weight a token (6 in a train step),
    plus attention at 4 hd a (query, key) pair the causal mask leaves in a
    forward, a cache slot in decode, and the plain route's backward over
    all S^2 pairs; (a) and (b) count the same on the kernel route as on
    ``backend="ref"``; the DTensor logits of (a) and (b) and the loss of (c)
    equal the plain step's bit for bit; the W4A4 and flash kernels launch
    here."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import parallel
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import analysis, mesh
    from repro_torch.models import decode_fn, forward_fn, init_caches, init_model, loss_fn
    from repro_torch.train import (DataState, OptimizerConfig, init_opt_state,
                                   make_train_step, synth_batch)
    from repro_torch.train.optim import tree_map

    smi = card_line()
    out: dict = {}
    reset_counts()
    with mesh.local_world("cuda"):
        smoke = mesh.make_smoke_mesh()

        def rep(t):
            """``t`` as a replicated DTensor on the smoke mesh (its storage)."""
            return DTensor.from_local(t, smoke, [Replicate(), Replicate()],
                                      run_check=False)

        def on_mesh(fn, *args):
            with parallel.activate(smoke), implicit_replication():
                return fn(*args)

        def roof(name, fn, *args, **kw):
            return on_mesh(lambda: analysis.analyze(
                fn, *args, arch=name, shape=kw.pop("shape"), mesh_name="1x1", chips=1,
                **kw))

        def pairs(S: int) -> int:
            return S * (S + 1) // 2

        L, H, hd = cfg.n_layers, cfg.n_heads, cfg.hd
        params_d = tree_map(rep, params)

        # (a) the W4A4 decode step at 8 rows
        rows, max_len, pos = (ROOFLINE_DECODE[k] for k in ("rows", "max_len", "pos"))
        cfg4 = cfg.with_approx_mlp(4)
        w4 = torch.as_tensor(stacks(cfg.n_layers)[0], device="cuda")
        ops.check_luts(w4)
        caches = init_caches(cfg4, rows, max_len, device="cuda")
        caches_d = [tree_map(rep, c) for c in caches]
        gen = torch.Generator(device="cuda").manual_seed(3)
        tokens = torch.randint(0, cfg.vocab_size, (rows, 1), generator=gen, device="cuda")
        step = decode_fn(cfg4)

        def decode(backend="auto", p=params, c=caches):
            return step(cfg4, p, c, tokens, pos, luts=w4, backend=backend)[0]

        cache_bytes = sum(t.numel() * t.element_size() for c in caches for t in c.values())
        kw = dict(shape=f"decode {rows} rows", model_flops=analysis.model_flops_decode(
            cfg.n_active_params(), rows),
            model_bytes=2.0 * cfg.n_active_params() + cache_bytes)
        want = 2 * rows * product_weights(cfg) + L * 4 * hd * rows * H * max_len
        ra = roof(cfg.name, lambda: decode(p=params_d, c=caches_d), **kw)
        local = {"approx_matmul_w4": read_counts()["approx_matmul_w4"]}
        require(local["approx_matmul_w4"] > 0, "(a): no W4A4 launch on local shards")
        ra_ref = roof(cfg.name, lambda: decode("ref", params_d, caches_d), **kw)
        plain = decode()
        meshed = on_mesh(lambda: decode(p=params_d, c=caches_d).to_local())
        require(ra.hlo_flops == ra_ref.hlo_flops == want,
                f"decode: kernel route {ra.hlo_flops} FLOP, plain {ra_ref.hlo_flops}, "
                f"independent count {want}")
        require(torch.equal(plain, meshed), "decode logits differ under the smoke mesh")
        out["decode_w4a4"] = roofline_line(
            f"(a) {cfg.name} W4A4 decode step at {rows} rows (cache {max_len})", ra,
            ra_ref.hlo_flops, want, median_ms(torch, decode, 10), smi)
        del caches_d

        # (b) forward_lm through flash, exact MLP
        B, S = ROOFLINE_FORWARD
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
        fwd = forward_fn(cfg)

        def forward(backend="auto", p=params):
            return fwd(cfg, p, {"tokens": toks}, backend=backend, device="cuda")[0]

        kw = dict(shape=f"forward B={B} S={S}", model_flops=analysis.model_flops_decode(
            cfg.n_active_params(), B * S), model_bytes=2.0 * cfg.n_active_params())
        want = 2 * B * S * product_weights(cfg) + L * 4 * hd * B * H * pairs(S)
        with torch.no_grad():
            rb = roof(cfg.name, lambda: forward(p=params_d), **kw)
            local["flash_attention"] = read_counts()["flash_attention"]
            require(local["flash_attention"] > 0, "(b): no flash launch on local shards")
            rb_ref = roof(cfg.name, lambda: forward("ref", params_d), **kw)
            plain = forward()
            meshed = on_mesh(lambda: forward(p=params_d).to_local())
            require(rb.hlo_flops == rb_ref.hlo_flops == want,
                    f"forward: kernel route {rb.hlo_flops} FLOP, plain {rb_ref.hlo_flops}, "
                    f"independent count {want}")
            require(torch.equal(plain, meshed), "forward logits differ under the smoke mesh")
            out["forward"] = roofline_line(
                f"(b) {cfg.name} forward_lm B={B} S={S} bf16 through flash", rb,
                rb_ref.hlo_flops, want, median_ms(torch, forward, 5), smi)
        del plain, meshed, params_d
        counts = read_counts()
        credit(results, "roofline", counts, "approx_matmul_w4", "flash_attention")
        require(counts["approx_matmul_w4"] > 0 and counts["flash_attention"] > 0,
                f"[roofline] launches {counts}")

        # (c) stablelm-1.6b's train step at 8x128
        tcfg = get_config("stablelm-1.6b")
        tparams = init_model(tcfg, seed=0, device="cuda")
        opt = init_opt_state(tparams)
        B, S = ROOFLINE_TRAIN
        batch = synth_batch(tcfg, B, S, DataState(0, 0), device="cuda")
        train = make_train_step(tcfg, OptimizerConfig(), remat="none")
        with torch.no_grad():
            loss0 = loss_fn(tcfg)(tcfg, tparams, batch, backend="ref", device="cuda")
            loss1 = on_mesh(lambda: loss_fn(tcfg)(
                tcfg, tree_map(rep, tparams), batch, backend="ref",
                device="cuda").to_local())
        require(torch.equal(loss0, loss1), "train loss differs under the smoke mesh")
        # the DTensor step updates copies, so the plain step below is timed
        # on the parameters it started from
        Lt, Ht, hdt = tcfg.n_layers, tcfg.n_heads, tcfg.hd
        want = (6 * B * S * product_weights(tcfg)
                + Lt * hdt * B * Ht * (4 * pairs(S) + 8 * S * S))
        rc = roof(tcfg.name, train, tree_map(lambda t: rep(t.clone()), tparams),
                  tree_map(lambda t: rep(t.clone()), opt), batch, shape=f"train {B}x{S}",
                  model_flops=analysis.model_flops_train(tcfg.n_active_params(), B * S),
                  model_bytes=30.0 * tcfg.n_params())
        require(rc.hlo_flops == want,
                f"train: counted {rc.hlo_flops} FLOP, independent count {want}")
        out["train"] = roofline_line(
            f"(c) {tcfg.name} train step {B}x{S}", rc, None, want,
            median_ms(torch, lambda: train(tparams, opt, batch), 5), smi)
        del tparams, opt
    out["launches"] = counts
    out["launches_on_local_shards"] = local
    out["nvidia_smi"] = smi
    log(f"[roofline] launches in this phase: W4A4 {counts['approx_matmul_w4']}, "
        f"flash {counts['flash_attention']}; of them on local shards of replicated "
        f"DTensors, in the counted runs: W4A4 {local['approx_matmul_w4']}, flash "
        f"{local['flash_attention']}; "
        f"counted FLOPs of (a), (b) and (c) equal to the independent counts; logits of "
        f"(a) and (b) and the loss of (c) bit-equal under the smoke mesh")
    results["roofline"] = out


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
    results: dict = {"max_err": {}, "launches": {}, "launches_by_path": {}}
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
    phases = [("search serve", lambda: phase_search_serve(torch, cfg, params, library, results)),
              ("fleet", lambda: phase_fleet(torch, library, results)),
              ("plans", lambda: phase_plans(torch, cfg, params, library, results)),
              ("control", lambda: phase_control(torch, cfg, params, library, results)),
              ("continuous", lambda: phase_continuous(torch, cfg, params, library, results)),
              ("serve", lambda: phase_serve(torch, cfg, params, results)),
              ("forward", lambda: phase_forward(torch, cfg, params, results)),
              ("cli", lambda: phase_cli(torch, cfg, params, library, results)),
              ("gemma3", lambda: phase_gemma3(torch, library, results)),
              ("families", lambda: phase_families(torch, library, results)),
              ("train", lambda: phase_train(torch, results)),
              ("roofline", lambda: phase_roofline(torch, cfg, params, results)),
              ("dryrun", lambda: phase_dryrun(results))]
    for name, run in phases:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run()
        release(torch)
        peak = torch.cuda.max_memory_reserved() / 2**30
        log(f"[memory] {name}: {time.perf_counter() - t0:.1f} s, peak reserved "
            f"{peak:.2f} GiB")
        results.setdefault("phase", {})[name] = {
            "seconds": time.perf_counter() - t0, "max_memory_reserved_gib": peak}

    sources = {"approx_matmul_w4": ("src/repro_torch/kernels/csrc/approx_matmul.cu",
                                    "src/repro/kernels/approx_matmul.py:74"),
               "approx_matmul_w8": ("src/repro_torch/kernels/csrc/approx_matmul.cu",
                                    "src/repro/kernels/approx_matmul.py:88"),
               # no Pallas kernel takes an uncomposed (256, 256) table: the
               # reference leaves them to its plain version
               # (src/repro/kernels/approx_matmul.py:30-32)
               "approx_matmul_w8_direct": ("src/repro_torch/kernels/csrc/approx_matmul.cu",
                                           "src/repro/kernels/ref.py:64"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:31"),
               "template_eval": ("src/repro_torch/kernels/csrc/template_eval.cu",
                                 "src/repro/kernels/template_eval.py:30")}
    kernels = []
    for name, (src, replaces) in sources.items():
        t = next(r for r in results["timings"] if r["name"] == name
                 and r["shape"] == LINE_SHAPES.get(name, r["shape"]))
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": results["launches"][name],
                        "launches_by_path": results["launches_by_path"][name],
                        "max_abs_err": results["max_err"][name],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"], "shape": t["shape"],
                        **({"device_ms": t["device_ms"]} if "device_ms" in t else {})})
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} was not launched on its main path")
    results["kernels"] = kernels
    results["seconds"] = time.perf_counter() - t_start
    smi = card_line()
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
