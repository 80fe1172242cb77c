"""Wrappers of the hand-written LUT matmul kernels (``csrc/approx_matmul.cu``).

``approx_matmul_w4`` replaces the Pallas ``_kernel`` and
``approx_matmul_w8`` the Pallas ``_kernel8`` of
``repro/kernels/approx_matmul.py``; ``approx_matmul_w8_direct`` takes
any ``(256, 256)`` table, which the Pallas kernels do not (``_kernel8``
takes composed tables only).  The source says how each is designed and
what bounds it on the H100.  All take CUDA tensors only: the plain
version for CPU tensors is :func:`repro_torch.kernels.ref.approx_matmul`,
chosen by :mod:`repro_torch.kernels.ops`.

The first two run the lookup as a product of u8 operands on the tensor
cores, one pass over K for each byte of the table's widest entry: a
``(16, 16)`` table, or the ``(16, 16)`` generator tile of a composed
``(256, 256)`` table (the W8A8 kernel recovers the tile itself, on the
device).  Byte tables take one pass, entries up to 65,535 two.  The
direct kernel looks every product up in a u16 plane of the table's
offsets from its least entry, one pass a plane.  Every sum is exact
modulo 2^32 for any int32 table, as the plain version's.  The W8A8
kernel gives wrong sums for a table that is not composed, so which of
the two a side-256 table goes to is decided once, when a caller adopts
it (:func:`check_tables` returns each table's form), and carried to each
call; a side-256 call without a form is refused.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..precision.widths import get_width
from . import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("approx_matmul")
    for fn in (lib.approx_matmul_w4, lib.approx_matmul_w8, lib.approx_matmul_w8_direct):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def extract_tile(lut: torch.Tensor) -> torch.Tensor:
    """Torch twin of :func:`repro_torch.precision.compose.extract_tile`
    over any leading axes: exact integer inversion of the nibble
    shift-add, with floor division (C's ``/`` would truncate)."""
    def fdiv(x, d):
        return torch.div(x, d, rounding_mode="floor")

    t00 = fdiv(lut[..., 0, 0], 289)[..., None]
    tx0 = fdiv(lut[..., :16, 0] - 272 * t00, 17)
    t0y = fdiv(lut[..., 0, :16] - 272 * t00, 17)
    return (lut[..., :16, :16] - 16 * (tx0[..., :, None] + t0y[..., None, :])
            - 256 * t00[..., None])


def tile_to_width(tile: torch.Tensor) -> torch.Tensor:
    """Torch twin of :func:`repro_torch.precision.compose.tile_to_width`
    at 8 bits, over any leading axes."""
    c = torch.arange(256, device=tile.device)
    lo, hi = c & 15, c >> 4

    def t(x, y):
        return tile[..., x[:, None], y[None, :]]

    return t(lo, lo) + 16 * (t(lo, hi) + t(hi, lo)) + 256 * t(hi, hi)


def is_composed(lut: torch.Tensor) -> torch.Tensor:
    """Whether each ``(256, 256)`` table in ``lut`` (any leading axes) is
    exactly ``tile_to_width(extract_tile(table))``: a bool tensor over the
    leading axes, on the tables' device."""
    if lut.shape[-2:] != (256, 256):
        raise ValueError(f"expected (..., 256, 256) tables, got {tuple(lut.shape)}")
    return (tile_to_width(extract_tile(lut)) == lut).flatten(-2).all(-1)


def check_tables(luts: torch.Tensor):
    """Each table's form for the kernel route, from ``luts`` (any leading
    axes): ``None`` for ``(16, 16)`` tables, which have one kernel; for
    ``(256, 256)`` tables whether each goes to the direct kernel (it is
    not composed from a tile), a bool for one table, a tuple of bools
    along the leading axis of a stack.  Any int32 entry is taken.  Reads
    the tables back to the host, so it runs once per adopted stack."""
    side = luts.shape[-1]
    if side == 16 and luts.shape[-2:] == (16, 16):
        return None
    if side != 256:
        raise ValueError(f"expected (..., 16, 16) or (..., 256, 256) tables, "
                         f"got {tuple(luts.shape)}")
    direct = (~is_composed(luts)).tolist()
    return tuple(direct) if isinstance(direct, list) else direct


def _check_int32(t: torch.Tensor, name: str) -> None:
    if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous int32 CUDA tensor, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def _launch(name: str, a: torch.Tensor, b: torch.Tensor, table: torch.Tensor,
            bits: int) -> torch.Tensor:
    spec = get_width(bits)
    _check_int32(a, "a")
    _check_int32(b, "b")
    _check_int32(table, "table")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad operand shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if table.shape != (spec.side, spec.side):
        raise ValueError(f"expected a ({spec.side}, {spec.side}) table, got "
                         f"{tuple(table.shape)}")
    if not (a.device == b.device == table.device):
        raise ValueError("a, b and the table must lie on one device")
    M, K = a.shape
    N = b.shape[1]
    if K > spec.max_k:
        raise ValueError(f"K = {K} exceeds the overflow-free int32 depth "
                         f"{spec.max_k} at width {bits}")
    lib = _lib()
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        rc = getattr(lib, name)(a.data_ptr(), b.data_ptr(), table.data_ptr(),
                                out.data_ptr(), M, K, N, stream)
    _build.check(lib, rc, name)
    return out


def approx_matmul_w4(a: torch.Tensor, b: torch.Tensor,
                     lut: torch.Tensor) -> torch.Tensor:
    """``sum_k LUT[a[m,k], b[k,n]]`` for codes in [0, 16) and a (16, 16)
    int32 table, on the card."""
    out = _launch("approx_matmul_w4", a, b, lut, 4)
    approx_matmul_w4.launches += 1
    return out


def approx_matmul_w8(a: torch.Tensor, b: torch.Tensor,
                     lut: torch.Tensor) -> torch.Tensor:
    """``sum_k LUT8[a[m,k], b[k,n]]`` for codes in [0, 256) and a composed
    (256, 256) int32 table, on the card (through its generator tile)."""
    out = _launch("approx_matmul_w8", a, b, lut, 8)
    approx_matmul_w8.launches += 1
    return out


def approx_matmul_w8_direct(a: torch.Tensor, b: torch.Tensor,
                            lut: torch.Tensor) -> torch.Tensor:
    """``sum_k LUT8[a[m,k], b[k,n]]`` for codes in [0, 256) and any
    (256, 256) int32 table, on the card (a lookup a product)."""
    out = _launch("approx_matmul_w8_direct", a, b, lut, 8)
    approx_matmul_w8_direct.launches += 1
    return out


approx_matmul_w4.launches = 0
approx_matmul_w8.launches = 0
approx_matmul_w8_direct.launches = 0


def approx_matmul(a: torch.Tensor, b: torch.Tensor, lut: torch.Tensor, *,
                  direct: bool | None = None) -> torch.Tensor:
    """The kernel for the table: side 16 -> W4A4; side 256 -> the direct
    kernel where ``direct`` (the form :func:`check_tables` gave), else
    W8A8.  A side-256 table without a form is refused: reading the
    table here would stall every call, and a captured graph not at all."""
    side = lut.shape[-1]
    if side == 16:
        return approx_matmul_w4(a, b, lut)
    if side == 256:
        if direct is None:
            raise ValueError(
                "a (256, 256) table on the kernel route needs its form "
                "(ops.check_luts, or a stack adopted by ops.route_luts)")
        return (approx_matmul_w8_direct if direct else approx_matmul_w8)(a, b, lut)
    raise ValueError(f"unsupported LUT side {side}; expected 16 or 256")
