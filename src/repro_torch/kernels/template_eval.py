"""Wrapper of the hand-written population-scoring kernel
(``csrc/template_eval.cu``), which replaces the Pallas ``_kernel`` of
``repro/kernels/template_eval.py``; the source says how it is designed
and what bounds it on the H100.  CUDA tensors only: the plain version
for CPU tensors is :func:`repro_torch.kernels.ref.template_eval`, chosen
by :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("template_eval")
    lib.template_eval.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                                  + [ctypes.c_void_p])
    lib.template_eval.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, ndim: int) -> None:
    if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous() \
            or t.ndim != ndim:
        raise ValueError(
            f"{name} must be a contiguous {ndim}-D int32 CUDA tensor, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def template_eval(lits: torch.Tensor, sel: torch.Tensor, in_tt: torch.Tensor,
                  exact_vals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-candidate worst-case and total |err| on the card; semantics of
    :func:`repro_torch.kernels.ref.template_eval`."""
    _check(lits, "lits", 3)
    _check(sel, "sel", 3)
    _check(exact_vals, "exact_vals", 1)
    P, T, n = lits.shape
    m = sel.shape[1]
    if sel.shape != (P, m, T):
        raise ValueError(f"sel {tuple(sel.shape)} does not match lits "
                         f"{tuple(lits.shape)}: expected ({P}, m, {T})")
    if not 1 <= m <= 31:
        raise ValueError(f"{m} outputs: values are int32, so 1 <= m <= 31")
    _check(in_tt, "in_tt", 2)
    if in_tt.shape[0] != n:
        raise ValueError(f"in_tt {tuple(in_tt.shape)} must be ({n}, W): the "
                         f"packed words as int32 (ref.word_bits_int32)")
    W = in_tt.shape[1]
    S = exact_vals.shape[0]
    if not 0 < S <= 32 * W:
        raise ValueError(f"{S} assignments do not fit {W} packed words")
    if not (lits.device == sel.device == in_tt.device == exact_vals.device):
        raise ValueError("lits, sel, in_tt and exact_vals must lie on one device")
    wce = torch.empty(P, dtype=torch.int32, device=lits.device)
    esum = torch.empty(P, dtype=torch.int32, device=lits.device)
    lib = _lib()
    stream = torch.cuda.current_stream(lits.device).cuda_stream
    with torch.cuda.device(lits.device):
        rc = lib.template_eval(lits.data_ptr(), sel.data_ptr(), in_tt.data_ptr(),
                               exact_vals.data_ptr(), wce.data_ptr(),
                               esum.data_ptr(), P, T, n, m, W, S, stream)
    _build.check(lib, rc, "template_eval")
    template_eval.launches += 1
    return wce, esum


template_eval.launches = 0
