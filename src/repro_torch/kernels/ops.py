"""Kernel dispatch.

``backend="auto"`` launches the hand-written Hopper kernel for CUDA
tensors and the plain PyTorch version (:mod:`repro_torch.kernels.ref`)
for CPU tensors.  ``backend="ref"`` forces the plain version; the tests
and ``chip_smoke.py`` use it to hold a kernel against it.  There is no
fallback: a kernel that fails to build or launch raises.

The kernels are bound without autograd: their outputs carry no
``grad_fn``.  So :func:`use_kernel` refuses to launch one on inputs that
require grad while grad mode is on, where the launch would silently cut
the gradient; a loss to be differentiated takes ``backend="ref"``
(:mod:`repro_torch.train.step` does).

While a cost counter is active (:class:`repro_torch.launch.analysis.CostCounter`),
each call reports its work at the operations and bytes that the kernels'
bounds use, on either route, and the aten ops of a plain version inside
the call are not counted again: a ctypes launch is invisible to a
dispatch mode, and the kernel route and the plain route count the same.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Literal, NamedTuple

import numpy as np
import torch

from . import approx_matmul as _am
from . import flash_attention as _fa
from . import ref
from . import template_eval as _te

Backend = Literal["auto", "ref"]


def use_kernel(x: torch.Tensor, backend: Backend) -> bool:
    """Whether a call on ``x`` launches the kernel.  Raises rather than
    launch on an ``x`` that requires grad while grad mode is on, and never
    falls back to the plain version."""
    if backend == "ref":
        return False
    if backend != "auto":
        raise ValueError(f"unknown backend {backend!r}; 'auto' or 'ref'")
    if not x.is_cuda:
        return False
    refuse_grad(x)
    return True


def refuse_grad(*inputs: torch.Tensor) -> None:
    """Raise if grad mode is on and an input of a kernel launch requires
    grad: the kernel's output would cut the gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            "a kernel would launch on inputs that require grad; the kernels "
            "have no backward, so their outputs would cut the gradient. "
            "Differentiate the plain route (backend='ref'), or run the "
            "forward under torch.no_grad()")


def template_eval(lits, sel, in_tt, exact_vals, *, backend: Backend = "auto"):
    """Population worst-case and total error; see
    :func:`repro_torch.kernels.ref.template_eval`."""
    with _cost(lambda: template_eval_work(lits, sel, in_tt.shape[1],
                                          exact_vals.shape[0])):
        if use_kernel(lits, backend):
            return _te.template_eval(lits, sel, in_tt, exact_vals)
        return ref.template_eval(lits, sel, in_tt, exact_vals)


class RoutedLut(NamedTuple):
    """A table, or a stack of them, with its form on the kernel route
    (:func:`check_luts`'s answer: a bool for one table, a tuple along a
    stack's leading axis), as :func:`route_luts` adopts it and the models
    carry it to each layer's :func:`approx_matmul`."""

    table: torch.Tensor
    direct: bool | tuple[bool, ...]

    def layer(self, i: int) -> "RoutedLut":
        """Layer ``i``'s table with its form (the table itself if shared)."""
        if self.table.ndim == 2:
            return self
        return RoutedLut(self.table[i], self.direct[i])


def approx_matmul(a, b, lut, *, direct: bool | None = None,
                  backend: Backend = "auto"):
    """LUT matmul; see :func:`repro_torch.kernels.ref.approx_matmul`.  On
    the kernel route a (256, 256) table goes to the direct kernel where
    ``direct`` (its form from :func:`check_luts`), else to W8A8; without a
    form it is refused."""
    with _cost(lambda: approx_matmul_work(a, b, lut), a):
        if use_kernel(a, backend):
            refuse_grad(b)
            return _am.approx_matmul(a, b, lut, direct=direct)
        return ref.approx_matmul(a, b, lut)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    backend: Backend = "auto"):
    """Blockwise attention; see :func:`repro_torch.kernels.ref.flash_attention`.
    q (B, H, Lq, D), k and v (B, Hkv, Lk, D)."""
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    with _cost(lambda: attention_work(B, H, Lq, Hkv, D, Lk, q.element_size(),
                                      causal, window), q):
        if use_kernel(q, backend):
            refuse_grad(k, v)
            return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                       scale=scale)
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)


# ---------------------------------------------------------------------------
# cost accounting: the work each kernel's bound prices
# ---------------------------------------------------------------------------
COUNTER = None   # the active CostCounter, set by the counter itself


def _cost(work, like=None):
    """A scope that reports ``work()`` -> (operations, bytes) to the active
    counter and hides the aten ops inside it, ``work``'s own included;
    nothing without a counter."""
    if COUNTER is None:
        return nullcontext()
    return COUNTER.kernel(work, like=like)


def attention_cost(q, k, window, causal: bool = True):
    """:func:`_cost` for attention with q (B, Lq, H, D) and k (B, Lk, Hkv,
    D), end-aligned, priced as :func:`flash_attention` prices it."""
    if COUNTER is None:
        return nullcontext()
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    return _cost(lambda: attention_work(B, H, Lq, Hkv, D, Lk, q.element_size(),
                                        causal, window), q)


def attention_pairs(Lq: int, Lk: int, causal: bool, window) -> int:
    """The (query, key) pairs the mask leaves, queries aligned to the end
    of the keys: query i sees key j when j <= i + Lk - Lq (causal) and
    j > i + Lk - Lq - window."""
    pos = np.arange(Lq, dtype=np.int64) + (Lk - Lq)
    hi = np.minimum(pos, Lk - 1) if causal else np.full(Lq, Lk - 1)
    lo = np.maximum(pos - int(window) + 1, 0) if window else np.zeros(Lq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_work(B, H, Lq, Hkv, D, Lk, itemsize, causal, window):
    """4 D operations a (query, key) pair the mask leaves a head; q and v
    read once and the output written once (q-sized), k and v read once."""
    ops = 4.0 * B * H * D * attention_pairs(Lq, Lk, causal, window)
    return ops, float(itemsize * (2 * B * H * Lq * D + 2 * B * Hkv * Lk * D))


def approx_matmul_work(a, b, lut):
    """2 M K N operations a LUT product, twice at W8A8 (a 256-side table);
    a, b and the table read once, the int32 product written once."""
    M, K = a.shape
    N = b.shape[1]
    planes = 2 if lut.shape[-1] == 256 else 1
    nbytes = 4 * (M * K + K * N + M * N) + 4 * lut.shape[-1] ** 2
    return planes * 2.0 * M * K * N, float(nbytes)


def template_eval_work(lits, sel, W: int, S: int):
    """What this population needs, per (candidate, word): one AND per
    literal that is not IGNORE in a product some output selects, one OR
    per selected (output, product), and 10 (m + 1) for the bit-sliced
    error; the parameter rows, the words and the exact values read once,
    two int32 results per candidate written once."""
    P, T, n = lits.shape
    m = sel.shape[1]
    used = (sel != 0).any(dim=1)                                   # (P, T)
    lit_ops = int((((lits == ref.USE) | (lits == ref.NEG)) & used[:, :, None]).sum())
    or_ops = int((sel != 0).sum())
    nbytes = P * (T * n + m * T) * 4 + n * W * 4 + S * 4 + 8 * P
    return float(W * (lit_ops + or_ops + P * 10 * (m + 1))), float(nbytes)


def check_luts(luts: torch.Tensor, *, backend: Backend = "auto"):
    """The form of each table in ``luts`` on the kernel route, decided
    once, when a table or stack is adopted, so that no call reads a table
    back (:func:`repro_torch.kernels.approx_matmul.check_tables`: ``None``
    for (16, 16) tables, else whether each (256, 256) one goes to the
    direct kernel); ``None`` on the plain route.  Any int32 table is
    taken."""
    if use_kernel(luts, backend):
        return _am.check_tables(luts)
    return None


def route_luts(luts, *, backend: Backend = "auto"):
    """Adopt ``luts`` (a table, a stack, or a ``{bits: stack}`` dict of
    them): each tensor with its forms (:func:`check_luts`) as a
    :class:`RoutedLut`, or as it is where no form is needed ((16, 16)
    tables, the plain route).  Reads the tables back once, here, so that
    no call does."""
    if isinstance(luts, dict):
        return {b: route_luts(t, backend=backend) for b, t in luts.items()}
    forms = check_luts(luts, backend=backend)
    return luts if forms is None else RoutedLut(luts, forms)


def launch_counters() -> tuple:
    """The kernel wrappers, each counting the launches of its kernel in
    its ``launches`` attribute.  A CUDA graph replays kernels without
    calling their wrappers, so whoever replays one credits these counts
    (:class:`repro_torch.serving.engine.ServingEngine` does)."""
    return (_am.approx_matmul_w4, _am.approx_matmul_w8,
            _am.approx_matmul_w8_direct, _fa.flash_attention, _te.template_eval)
