#!/usr/bin/env python3
"""Time the flash attention kernel of one checkout at the timed shapes of
``chip_smoke.py``, so that two versions can be compared in turns in one
call on one card:

    python3 tools/time_flash.py path/to/checkout/src

The ``repro_torch`` package is imported from the given ``src`` directory
(one process per checkout).  Prints one JSON line per shape: the kernel
per call (CUDA events over 20 calls), the kernel alone (``torch.profiler``)
and its max |err| against that checkout's plain version.  Needs a CUDA
card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def main(src: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_flash: no CUDA device is present", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(src).resolve()))
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
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
