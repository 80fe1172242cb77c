"""Wrapper of the hand-written flash attention kernel
(``csrc/flash_attention.cu``), which replaces the Pallas ``_kernel`` of
``repro/kernels/flash_attention.py``; the source says how it is designed
and what bounds it on the H100.  CUDA tensors only: the plain version for
CPU tensors is :func:`repro_torch.kernels.ref.flash_attention`, chosen by
:mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

_KERNELS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    for name in _KERNELS.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.flash_attention_head_dims.argtypes = [ctypes.POINTER(ctypes.c_int),
                                              ctypes.c_int]
    lib.flash_attention_head_dims.restype = ctypes.c_int
    return lib


@functools.cache
def head_dims() -> tuple[int, ...]:
    """The head dims the kernels are built for, as the library reports."""
    buf = (ctypes.c_int * 8)()
    n = _lib().flash_attention_head_dims(buf, len(buf))
    return tuple(buf[:n])


def flash_attention(
    q: torch.Tensor,  # (B, H, Lq, D)
    k: torch.Tensor,  # (B, Hkv, Lk, D)
    v: torch.Tensor,  # (B, Hkv, Lk, D)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention on the card; semantics of
    :func:`repro_torch.kernels.ref.flash_attention`."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.ndim != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D CUDA tensor")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share one dtype and device")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:  # for TMA
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if q.dtype not in _KERNELS:
        raise ValueError(f"dtype {q.dtype} not taken; float32 or bfloat16")
    B, H, Lq, D = q.shape
    _, Hkv, Lk, _ = k.shape
    if D not in head_dims():
        raise ValueError(f"head dim {D} not taken; the kernels are built for "
                         f"{head_dims()}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"bad kv shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"for q {tuple(q.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if window is not None and (not isinstance(window, int) or window <= 0):
        raise ValueError(f"window must be None or a positive int, got {window!r}")
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    out = torch.empty_like(q)
    lib = _lib()
    fn = getattr(lib, _KERNELS[q.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, Hkv, Lq, Lk, D, scale, int(causal),
                -1 if window is None else window, stream)
    _build.check(lib, rc, _KERNELS[q.dtype])
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
