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


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 holding 0 ... 2**32 - 1 (``__popc``)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & ALL_ONES) >> 24


def template_eval_bitsliced(
    lits: torch.Tensor,        # (P, T, n) int32
    sel: torch.Tensor,         # (P, m, T) int32
    in_tt: torch.Tensor,       # (n, W) packed words (words64)
    exact_vals: torch.Tensor,  # (S,) int32
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`template_eval` computed the way ``csrc/template_eval.cu``
    computes it, on 32-lane words, so that the kernel's arithmetic is
    exercised where there is no card (the tests; no path of the port
    calls it).  Steps, as in the kernel:

    - each product is compressed to a key, one base-3 code per group of
      four inputs (USE 0, NEG 1, any other literal 2, as IGNORE), four
      groups to a key word, and the mask of the outputs that select it
      (any nonzero ``sel``); a product no output selects is never formed;
    - a table per (word, group) holds the AND of every code's literals,
      so a product is the AND of one table entry per group: two groups
      for ``n <= 8``, else four per key word of 16 inputs (groups past
      ``n`` are all-ones at IGNORE);
    - the outputs are the value's bit planes for 32 lanes at once; the
      exact value's planes are subtracted with a borrow ripple over
      ``max_m + 1`` planes (``max_m`` = 8 or 32, the kernel's register
      count) in a word whose exact values all lie in [0, 2**max_m), else
      over 32 planes, which is int32 wraparound as in the reference;
    - a conditional negate by the sign plane (XOR, then a ripple +1),
      lanes at or past ``S`` cleared;
    - the max by a scan from the top plane over the lanes whose |err| is
      not negative (only INT_MIN is), INT_MIN where there are none; the
      sum as the popcount of each plane shifted by its weight, mod 2**32.
    """
    P, T, n = lits.shape
    m = sel.shape[1]
    W = in_tt.shape[1]
    S = exact_vals.shape[0]
    dev = lits.device
    groups = 2 if n <= 8 else 4 * ((n + 15) // 16)
    max_m = 8 if m <= 8 else 32

    # tables: (W, groups, 81) words, entry = AND of the code's literals
    code = torch.arange(81, device=dev)
    digits = [(code // 3 ** q) % 3 for q in range(4)]
    tt = words64(in_tt)
    tables = torch.full((W, groups, 81), ALL_ONES, dtype=torch.int64, device=dev)
    for j in range(n):
        x = tt[j][:, None]                                   # (W, 1)
        d = digits[j % 4][None, :]
        term = torch.where(d == 0, x, torch.where(d == 1, x ^ ALL_ONES, ALL_ONES))
        tables[:, j // 4] &= term

    # mask compression: keys and the outputs each product feeds
    digit = torch.where(lits == USE, 0, torch.where(lits == NEG, 1, 2))
    digit = torch.cat([digit, torch.full((P, T, 4 * groups - n), 2, device=dev,
                                         dtype=digit.dtype)], dim=2)
    keys = (digit.reshape(P, T, groups, 4).long()
            * torch.tensor([1, 3, 9, 27], device=dev)).sum(-1)       # (P, T, groups)
    feeds = ((sel != 0).long() << torch.arange(m, device=dev)[:, None]).sum(1)  # (P, T)

    prods = torch.full((P, T, W), ALL_ONES, dtype=torch.int64, device=dev)
    for g in range(groups):
        prods &= tables[:, g, :].T[keys[:, :, g]]            # (P, T, W)
    outs = []
    for o in range(max_m):
        picked = torch.where((((feeds >> o) & 1) != 0)[..., None], prods, 0)
        word = torch.zeros((P, W), dtype=torch.int64, device=dev)
        for t in range(T):
            word |= picked[:, t]
        outs.append(word)                                    # (P, W)

    # the exact values' bit planes, 32 lanes a word; lanes past S hold 0
    ev = exact_vals.to(torch.int64) & ALL_ONES
    ev = torch.cat([ev, ev.new_zeros(32 * W - S)]).reshape(W, 32)
    lane = torch.arange(32, device=dev)
    planes = [(((ev >> b) & 1) << lane).sum(1) for b in range(32)]  # (W,) each
    left = S - 32 * torch.arange(W, device=dev)
    valid = torch.where(left >= 32, ALL_ONES,
                        (1 << left.clamp(0, 31)) - 1)        # (W,)
    word_max, total = _word_errors(outs, planes, valid, 32)
    if max_m < 32:
        # a word whose exact values all lie below 2**max_m needs max_m + 1
        # planes; the kernel decides so word by word
        narrow = (ev >> max_m == 0).all(1)[None, :]
        fast = _word_errors(outs, planes, valid, max_m + 1)
        word_max = torch.where(narrow, fast[0], word_max)
        total = torch.where(narrow, fast[1], total)
    esum = total.sum(1) & ALL_ONES
    esum = torch.where(esum >= 1 << 31, esum - (1 << 32), esum)
    return word_max.max(1).values.to(torch.int32), esum.to(torch.int32)


def _word_errors(outs: list[torch.Tensor], planes: list[torch.Tensor],
                 valid: torch.Tensor, n_planes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per (candidate, word): the max |val - exact| over the valid lanes
    (INT_MIN where none is valid or every valid |err| is INT_MIN) and their
    sum mod 2**32, over ``n_planes`` planes of the difference."""
    diff, borrow = [], torch.zeros_like(outs[0])
    for b in range(n_planes):
        v = outs[b] if b < len(outs) else torch.zeros_like(borrow)
        e = planes[b][None, :]
        diff.append(v ^ e ^ borrow)
        borrow = ((v ^ ALL_ONES) & (e | borrow)) | (e & borrow)
    neg = diff[-1]
    carry = neg
    total = torch.zeros_like(borrow)
    for b in range(n_planes):
        x = diff[b] ^ neg
        diff[b] = (x ^ carry) & valid
        carry = carry & x
        total += _popcount32(diff[b]) << b
    lanes = valid & (diff[-1] ^ ALL_ONES)
    best = torch.zeros_like(borrow)
    cand = lanes
    for b in range(n_planes - 2, -1, -1):
        hit = cand & diff[b]
        found = hit != 0
        best |= found.long() << b
        cand = torch.where(found, hit, cand)
    return torch.where(lanes != 0, best, -(1 << 31)), total

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
    tolerance the reference's kernel tests use.)  A row that sees no key
    (causal with Lk < Lq) gives 0, the kernel's guarded zero denominator,
    where the JAX oracle's softmax of no logits gives NaN.
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
    probs = torch.softmax(logits, dim=-1).masked_fill(~mask.any(-1, keepdim=True), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)
