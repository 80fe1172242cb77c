"""Kernel dispatch.

``backend="auto"`` launches the hand-written Hopper kernel for CUDA
tensors and the plain PyTorch version (:mod:`repro_torch.kernels.ref`)
for CPU tensors.  ``backend="ref"`` forces the plain version; the tests
and ``chip_smoke.py`` use it to hold a kernel against it.  There is no
fallback: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

from typing import Literal

import torch

from . import approx_matmul as _am
from . import flash_attention as _fa
from . import ref
from . import template_eval as _te

Backend = Literal["auto", "ref"]


def use_kernel(x: torch.Tensor, backend: Backend) -> bool:
    if backend == "ref":
        return False
    if backend != "auto":
        raise ValueError(f"unknown backend {backend!r}; 'auto' or 'ref'")
    return x.is_cuda


def template_eval(lits, sel, in_tt, exact_vals, *, backend: Backend = "auto"):
    """Population worst-case and total error; see
    :func:`repro_torch.kernels.ref.template_eval`."""
    if use_kernel(lits, backend):
        return _te.template_eval(lits, sel, in_tt, exact_vals)
    return ref.template_eval(lits, sel, in_tt, exact_vals)


def approx_matmul(a, b, lut, *, backend: Backend = "auto"):
    """LUT matmul; see :func:`repro_torch.kernels.ref.approx_matmul`."""
    if use_kernel(a, backend):
        return _am.approx_matmul(a, b, lut)
    return ref.approx_matmul(a, b, lut)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    backend: Backend = "auto"):
    """Blockwise attention; see :func:`repro_torch.kernels.ref.flash_attention`."""
    if use_kernel(q, backend):
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return ref.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


def check_luts(luts: torch.Tensor, *, backend: Backend = "auto") -> None:
    """Verify once, when a table or stack is adopted, what the kernels
    take on trust per call: a table bound for the kernel holds
    non-negative entries, an 8-bit one through its tile, and an 8-bit one
    is composed (:func:`repro_torch.kernels.approx_matmul.check_tables`)."""
    if use_kernel(luts, backend):
        _am.check_tables(luts)
