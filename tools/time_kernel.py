#!/usr/bin/env python3
"""Time one checkout's kernel at the timed shapes of ``chip_smoke.py``, so
that two versions can be compared in turns in one call on one card:

    python3 tools/time_kernel.py flash path/to/checkout/src
    python3 tools/time_kernel.py template_eval path/to/checkout/src
    python3 tools/time_kernel.py search path/to/checkout/src [REPS]
    python3 tools/time_kernel.py ablations path/to/checkout/src
    python3 tools/time_kernel.py lut path/to/checkout/src

The ``repro_torch`` package is imported from the given ``src`` directory
(one process per checkout).  Prints one JSON line per shape or run:

- ``flash``: a call (CUDA events over 20 calls), the kernel alone
  (``torch.profiler``) and its max |err| against that checkout's plain
  version, at ``chip_smoke.FLASH_TIMED``;
- ``template_eval``: a call (CUDA events over 50 calls), the kernel alone
  (``torch.profiler``, 20 calls), the call less the kernel, and whether
  it is bit-equal to the plain version, at mul_i8 P = 65,536 and the
  search's mul_i8 P = 4096 and mul_i4 P = 512 (the inputs of
  ``chip_smoke.py``'s timed rows);
- ``search``: the wall time of each of ``chip_smoke.SEARCH_JOBS`` through
  the kernel, split into the generation loop and the harvest
  (``chip_smoke.run_split``), ``REPS`` times (default 10) after one run
  that builds and warms up;
- ``ablations``: the template_eval kernel alone at the same shapes as
  ``template_eval``, as built and with each of ``ABLATIONS`` (a design
  choice undone by a text substitution in that checkout's source), each
  built by ``nvcc`` into ``build/ablations/`` and called through its C
  entry point, four rounds in alternating order, each checked against
  the plain version;
- ``lut``: the LUT matmul kernels, a call (CUDA events over 50 calls) and
  whether it is bit-equal to that checkout's plain version: W4A4 and
  W8A8 (a composed table) at ``LUT_SHAPES``, and the direct kernel on the
  profiler's 8-bit probe at ``chip_smoke.DIRECT_SHAPES`` where the
  checkout has it.

Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

TE_SHAPES = [chip_smoke.TE_LARGE, ("mul_i8", 16, 4096), ("mul_i4", 8, 512)]
# the LUT matmuls at the kernels line's rows, the profiler's and a forward's
LUT_SHAPES = {"approx_matmul_w4": [(8, 2560, 9728), (128, 2560, 9728), (1024, 2560, 9728)],
              "approx_matmul_w8": [(4, 2560, 9728), (128, 2560, 9728), (1024, 2560, 9728)]}
_L8 = "? launch<8, {}>(l, se, t, e, wo, so, s, grid, smem, dev, st)"
_L32 = "? launch<32, {}>(l, se, t, e, wo, so, s, grid, smem, dev, st)"
_GROUPS = ("s.groups = n <= 8 ? 2 : 4 * s.kw;", "s.groups = 4 * s.kw;")
ABLATIONS = {
    "as built": [],
    # the n <= 8 kernels read four groups of the key word, as n <= 16 do
    "four groups at n <= 8": [_GROUPS, (_L8.format(2), _L8.format(4)),
                              (_L32.format(2), _L32.format(4))],
    # every n takes the kernel that loops over key words at run time
    "key loop everywhere": [_GROUPS, ("err = s.kw > 1     " + _L8.format(0),
                                      "err = true         " + _L8.format(0)),
                            ("err = s.kw > 1     " + _L32.format(0),
                             "err = true         " + _L32.format(0))],
    # every word's error over 32 planes, not kMaxM + 1 where it can
    "32 planes everywhere": [("if (wplanes[32] == 0u) {", "if (false) {")],
    # one product-list buffer instead of a slab's and the next one's
    "one list buffer": [
        ("reinterpret_cast<int*>(lists + 2 * s.C", "reinterpret_cast<int*>(lists + s.C"),
        ("uint32_t* list = lists + (it & 1) * s.C * s.mask_stride * (s.kw + 1);",
         "uint32_t* list = lists;"),
        ("2 * static_cast<size_t>(s.C) * s.mask_stride", "static_cast<size_t>(s.C) * s.mask_stride")],
}


def time_flash(torch, src: str) -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    for case in chip_smoke.FLASH_TIMED:
        _, _, _, _, _, _, _, window, causal = case
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = chip_smoke.flash_inputs(torch, gen, case)

        def call():
            return fa.flash_attention(q, k, v, causal=causal, window=window)

        err = float((call().float() - ref.flash_attention(
            q, k, v, causal=causal, window=window).float()).abs().max())
        print(json.dumps({
            "src": src, "case": chip_smoke.flash_tag(case),
            "ms": chip_smoke.time_ms(torch, call, iters=20),
            "device_ms": chip_smoke.kernel_device_ms(torch, call, "flash"),
            "max_abs_err": err}), flush=True)


def time_template_eval(torch, src: str) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels import template_eval as te

    for bench, T, P in TE_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(2)
        lits, sel, tt, ev = chip_smoke.te_inputs(
            torch, gen, (bench, T, P, "012", "01", "exact"), None)

        def call():
            return te.template_eval(lits, sel, tt, ev)

        got, want = call(), ref.template_eval(lits, sel, tt, ev)
        ms = chip_smoke.time_ms(torch, call, iters=50)
        dev_ms = chip_smoke.kernel_device_ms(torch, call, "template_eval_kernel")
        print(json.dumps({
            "src": src, "shape": [bench, T, P], "ms": ms, "device_ms": dev_ms,
            "call_minus_alone_ms": None if dev_ms is None else ms - dev_ms,
            "bit_equal": all(torch.equal(g, w) for g, w in zip(got, want))}),
            flush=True)


def time_search(torch, src: str, reps: int) -> None:
    from repro_torch.core.engine import SearchJob, get_engine

    for kind, bits, et, opts in chip_smoke.SEARCH_JOBS:
        job = SearchJob(kind, bits, et, "tensor", budget_s=chip_smoke.SEARCH_BUDGET_S)
        eng = get_engine("tensor", backend="auto", **opts)
        eng.run(job)
        for rep in range(reps):
            out, split = chip_smoke.run_split(torch, eng, job)
            print(json.dumps({"src": src, "job": job.describe(), "rep": rep,
                              "wall_s": out.wall_s, **split}), flush=True)


def time_ablations(torch, src: str) -> None:
    import ctypes
    import subprocess

    from repro_torch.kernels import _build, ref

    text = (Path(src) / "repro_torch/kernels/csrc/template_eval.cu").read_text()
    out = Path(__file__).resolve().parents[1] / "build" / "ablations"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(ABLATIONS.items()):
        variant = text
        for old, new in subs:
            if variant.count(old) != 1:
                sys.exit(f"ablation {name!r}: {old!r} is not once in the source")
            variant = variant.replace(old, new)
        (out / f"a{i}.cu").write_text(variant)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"liba{i}.so"),
               str(out / f"a{i}.cu")]
        procs[name] = (out / f"liba{i}.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on ablation {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.template_eval.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                                      + [ctypes.c_void_p])
        libs[name] = lib
    for rnd in range(4):
        for bench, T, P in TE_SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(2)
            lits, sel, tt, ev = chip_smoke.te_inputs(
                torch, gen, (bench, T, P, "012", "01", "exact"), None)
            want = ref.template_eval(lits, sel, tt, ev)
            wce, esum = torch.empty((2, P), dtype=torch.int32, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            row = {"src": src, "round": rnd, "shape": [bench, T, P]}
            for name in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
                def call(lib=libs[name]):
                    rc = lib.template_eval(
                        lits.data_ptr(), sel.data_ptr(), tt.data_ptr(), ev.data_ptr(),
                        wce.data_ptr(), esum.data_ptr(), P, T, lits.shape[2],
                        sel.shape[1], tt.shape[1], ev.shape[0], stream)
                    if rc != 0:
                        sys.exit(f"ablation {name!r}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                row[name] = {
                    "device_ms": chip_smoke.kernel_device_ms(
                        torch, call, "template_eval_kernel", iters=50),
                    "bit_equal": torch.equal(wce, want[0]) and torch.equal(esum, want[1])}
            print(json.dumps(row), flush=True)


def time_lut(torch, src: str) -> None:
    import numpy as np

    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import ref
    from repro_torch.precision.compose import tile_to_width

    gen = torch.Generator(device="cuda").manual_seed(0)

    def codes(shape, side):
        return torch.randint(0, side, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    tables = {"approx_matmul_w4": codes((16, 16), 226),
              "approx_matmul_w8": torch.as_tensor(
                  tile_to_width(codes((16, 16), 256).cpu().numpy()).astype(np.int32),
                  device="cuda")}
    shapes = dict(LUT_SHAPES)
    if hasattr(am, "approx_matmul_w8_direct"):
        exact = np.arange(256)[:, None] * np.arange(256)[None, :]
        tables["approx_matmul_w8_direct"] = torch.as_tensor(
            ((exact >> 8) << 8).astype(np.int32), device="cuda")
        shapes["approx_matmul_w8_direct"] = chip_smoke.DIRECT_SHAPES
    for name, table in tables.items():
        kernel, side = getattr(am, name), table.shape[-1]
        for M, K, N in shapes[name]:
            a, b = codes((M, K), side), codes((K, N), side)
            print(json.dumps({
                "src": src, "name": name, "shape": [M, K, N],
                "ms": chip_smoke.time_ms(torch, lambda: kernel(a, b, table), iters=50),
                "bit_equal": torch.equal(kernel(a, b, table),
                                         ref.approx_matmul(a, b, table))}), flush=True)


def main(what: str, src: str, reps: int = 10) -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_kernel: no CUDA device is present", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(src).resolve()))
    if what == "flash":
        time_flash(torch, src)
    elif what == "template_eval":
        time_template_eval(torch, src)
    elif what == "ablations":
        time_ablations(torch, src)
    elif what == "lut":
        time_lut(torch, src)
    else:
        time_search(torch, src, reps)
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (3, 4) or sys.argv[1] not in (
            "flash", "template_eval", "search", "ablations", "lut"):
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2], *[int(x) for x in sys.argv[3:]]))
