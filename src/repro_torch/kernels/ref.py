"""Plain PyTorch versions of the hand-written kernels.

Each function is the semantic definition its kernel is held against, on
the card in ``chip_smoke.py`` and against ``repro.kernels.ref`` in the
CPU tests.  The kernel wrappers (:mod:`repro_torch.kernels.ops`) run
these for tensors that lie on the CPU.
"""

from __future__ import annotations

import math

import torch

# the gather materialises an (rows, K, N) index and product per chunk;
# rows are chunked so one chunk stays under about this many bytes
_GATHER_BYTES = 1 << 30

USE, NEG = 0, 1
ALL_ONES = 0xFFFFFFFF


def words64(in_tt: torch.Tensor) -> torch.Tensor:
    """Packed truth-table words as int64 holding 0 ... 2**32 - 1.

    PyTorch's ``uint32`` has ``&`` and ``|`` on the CPU but no ``~``,
    ``>>`` or comparison, so the plain version carries each word in an
    int64 and writes ``~x`` as ``x ^ 0xFFFFFFFF``.  Takes uint32 words,
    or int32 words with the same bits (the kernel's view), or int64 ones.
    """
    w = in_tt.to(torch.int64)
    return w & ALL_ONES if in_tt.dtype == torch.int32 else w


def word_bits_int32(in_tt: torch.Tensor) -> torch.Tensor:
    """Packed words (uint32, int32 or int64 holding 0 ... 2**32 - 1) as an
    int32 tensor with the same 32 bits: the form the kernel reads as
    ``uint32_t``.  Converted once, where the words are made."""
    if in_tt.dtype == torch.int32:
        return in_tt.contiguous()
    w = words64(in_tt)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32).contiguous()


def template_eval(
    lits: torch.Tensor,        # (P, T, n) int32 in {USE, NEG, IGNORE}
    sel: torch.Tensor,         # (P, m, T) int32 in {0, 1}
    in_tt: torch.Tensor,       # (n, W) packed input truth tables (words64)
    exact_vals: torch.Tensor,  # (S,) int32 exact value per assignment
) -> tuple[torch.Tensor, torch.Tensor]:  # (P,) worst-case, (P,) total |err|
    """Per candidate, the worst-case and the total |err| of its SHARED
    template sum-of-products over all ``S`` input assignments, in int32."""
    P, T, n = lits.shape
    m = sel.shape[1]
    W = in_tt.shape[1]
    S = exact_vals.shape[0]

    tt = words64(in_tt)[None, None, :, :]               # (1, 1, n, W)
    use_term = torch.where((lits == USE)[..., None], tt, ALL_ONES)
    neg_term = torch.where((lits == NEG)[..., None], tt ^ ALL_ONES, ALL_ONES)
    comb = use_term & neg_term                           # (P, T, n, W)
    prods = comb[:, :, 0, :]
    for j in range(1, n):
        prods = prods & comb[:, :, j, :]                 # (P, T, W)

    masked = torch.where((sel != 0)[..., None], prods[:, None, :, :], 0)
    outs = masked[:, :, 0, :]
    for t in range(1, T):
        outs = outs | masked[:, :, t, :]                 # (P, m, W)

    shifts = torch.arange(32, device=lits.device)
    bits = (outs[..., None] >> shifts) & 1
    bits = bits.reshape(P, m, W * 32)[:, :, :S].to(torch.int32)   # (P, m, S)
    weights = (1 << torch.arange(m, device=lits.device, dtype=torch.int32))
    vals = (bits * weights[None, :, None]).sum(dim=1, dtype=torch.int32)
    err = (vals - exact_vals.to(torch.int32)[None, :]).abs()
    return err.max(dim=1).values, err.sum(dim=1, dtype=torch.int32)


def approx_matmul(
    a: torch.Tensor,     # (M, K) int32, values in [0, side)
    b: torch.Tensor,     # (K, N) int32, values in [0, side)
    lut: torch.Tensor,   # (side, side) int32 approximate product table
) -> torch.Tensor:       # (M, N) int32: sum_k LUT[a[m,k], b[k,n]]
    """LUT matmul by gather, for any square table (composed or not).

    A full-width prefill gathers (M, K, N) = (1024, 2560, 9728) products,
    about 100 GB at once, so rows go in chunks that each stay under
    ``_GATHER_BYTES`` (int64 index plus int32 product per element); the
    sums are the same integers.
    """
    M, K = a.shape
    N = b.shape[1]
    side = lut.shape[-1]
    flat = lut.reshape(-1)
    bb = b.long()[None, :, :]
    rows = max(1, _GATHER_BYTES // max(1, 12 * K * N))
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    for m0 in range(0, M, rows):
        idx = a[m0:m0 + rows].long()[:, :, None] * side + bb
        out[m0:m0 + rows] = flat[idx].sum(dim=1, dtype=torch.int32)
    return out


def approx_matmul_two_level(
    a: torch.Tensor,     # (M, K) int32, values in [0, 256)
    b: torch.Tensor,     # (K, N) int32, values in [0, 256)
    tile: torch.Tensor,  # (16, 16) int32, the composed table's generator
) -> torch.Tensor:
    """Tile form of the 8-bit product: four nibble-plane 16x16 LUT
    matmuls combined by shift-add.  Equals ``approx_matmul(a, b,
    tile_to_width(tile))`` for any tile."""
    def s(x, y):
        return approx_matmul(x, y, tile)

    al, ah = a & 15, a >> 4
    bl, bh = b & 15, b >> 4
    return s(al, bl) + ((s(al, bh) + s(ah, bl)) << 4) + (s(ah, bh) << 8)


def flash_attention(
    q: torch.Tensor,  # (B, H, Lq, D)
    k: torch.Tensor,  # (B, Hkv, Lk, D)
    v: torch.Tensor,  # (B, Hkv, Lk, D)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention with queries aligned to the end of the kv sequence.

    Logits, softmax and the weighted sum run in float32 and the result is
    cast to ``q.dtype`` — the kernel's own arithmetic.  (The JAX oracle
    keeps bf16 inputs in bf16; the two agree within the 2e-2 bf16
    tolerance the reference's kernel tests use.)
    """
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kf, vf = k.float(), v.float()
    if Hkv != H:  # GQA: expand kv heads
        kf = kf.repeat_interleave(H // Hkv, dim=1)
        vf = vf.repeat_interleave(H // Hkv, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    qi = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
    ki = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)
