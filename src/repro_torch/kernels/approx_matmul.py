"""Wrappers of the hand-written LUT matmul kernels (``csrc/approx_matmul.cu``).

``approx_matmul_w4`` replaces the Pallas ``_kernel`` and
``approx_matmul_w8`` the Pallas ``_kernel8`` of
``repro/kernels/approx_matmul.py``; the source says how each is designed
and what bounds it on the H100.  Both take CUDA tensors only: the plain
version for CPU tensors is :func:`repro_torch.kernels.ref.approx_matmul`,
chosen by :mod:`repro_torch.kernels.ops`.

Both kernels run the lookup as a product of u8 operands on the tensor
cores, one pass over K for each byte of the table's widest entry: a
``(16, 16)`` table, or the ``(16, 16)`` generator tile of a composed
``(256, 256)`` table (the W8A8 kernel recovers the tile itself, on the
device).  Byte tables take one pass, entries up to 65,535 two; the sum
is exact modulo 2^32 for any int32 table, as the plain version's.  The
W8A8 kernel gives wrong sums for a table that is not composed; callers
verify a stack once when they adopt it (:func:`check_tables`), not on
every call.
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
    for fn in (lib.approx_matmul_w4, lib.approx_matmul_w8):
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


def check_composed(lut: torch.Tensor) -> None:
    """Raise unless every ``(256, 256)`` table in ``lut`` (any leading
    axes) is exactly ``tile_to_width(extract_tile(table))``.  Reads the
    result back to the host, so it runs once per adopted stack."""
    if lut.shape[-2:] != (256, 256):
        raise ValueError(f"expected (..., 256, 256) tables, got {tuple(lut.shape)}")
    if not torch.equal(tile_to_width(extract_tile(lut)), lut):
        raise ValueError(
            "8-bit table is not composed from a 16x16 tile; the W8A8 kernel "
            "takes only tile_to_width images (backend='ref' takes any table)")


def check_tables(luts: torch.Tensor) -> None:
    """Raise unless every table in ``luts`` (any leading axes) is in the
    kernels' contract: side 16, or side 256 composed from a tile, with
    non-negative entries (the tile's at W8A8), as the products of
    unsigned codes are.  Entries past 255 are taken, at one more pass
    over K a byte.  Reads the tables back to the host, so it runs once
    per adopted stack."""
    side = luts.shape[-1]
    if side == 256:
        check_composed(luts)
        luts = extract_tile(luts)
    elif luts.shape[-2:] != (16, 16):
        raise ValueError(f"expected (..., 16, 16) or (..., 256, 256) tables, "
                         f"got {tuple(luts.shape)}")
    lo = int(luts.min())
    if lo < 0:
        what = "tile" if side == 256 else "table"
        raise ValueError(
            f"{what} entry {lo} is negative; the LUT matmul kernels take "
            f"tables of non-negative products (backend='ref' takes any table)")


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


approx_matmul_w4.launches = 0
approx_matmul_w8.launches = 0


def approx_matmul(a: torch.Tensor, b: torch.Tensor,
                  lut: torch.Tensor) -> torch.Tensor:
    """The kernel for the table's width: 16 -> W4A4, 256 -> W8A8."""
    side = lut.shape[-1]
    if side == 16:
        return approx_matmul_w4(a, b, lut)
    if side == 256:
        return approx_matmul_w8(a, b, lut)
    raise ValueError(f"unsupported LUT side {side}; expected 16 or 256")
