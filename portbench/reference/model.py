"""The plain reference: a teacher-forced forward in float32 with plain
PyTorch operations, layer by layer, from the configuration's keys and the
benchmark's own weights and table.  It imports nothing of the program.

It is a frozen copy of the semantics the program serves:

- RMSNorm ``x * rsqrt(mean(x^2) + eps) * (1 + w)``;
- rotary embeddings on the half-split of each head (all of the head
  dimension, base ``rope_theta``), positions from 0;
- causal multi-head attention with ``1 / sqrt(head dim)`` scaling;
- a SwiGLU FFN ``w2(silu(w1 x) * w3 x)``;
- the b-bit LUT product (W4A4 or W8A8, by the table's width) on every
  layer's three FFN products:
  activations quantized by row and weights by column to codes
  ``round(x / s) + c`` with ``c = 2**(b-1)`` and ``s = amax / (c - 1)``,
  the table summed over the codes, the exact correction
  ``- c sum(a) - c sum(b) + c^2 K`` and the two scales.

The table sums are exact integers (float32 matmuls of one-hot rows, TF32
off, combined in float64), so the only departure from the program's
integers is where a code itself rounds differently in float32 than in
the program's dtype.

``precision="fp8"`` is the control: every matrix product's operands
(weights per tensor, activations per row) rounded through float8 e4m3
first, the step below the configuration's bfloat16.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Arith:
    """float32 arithmetic, or the float8 control's."""

    def __init__(self, precision: str | None) -> None:
        if precision not in (None, "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def _q8(self, x: torch.Tensor, dim) -> torch.Tensor:
        if not self.fp8:
            return x
        amax = x.abs().amax(dim=dim, keepdim=True) if dim is not None else x.abs().max()
        s = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
        return (x / s).to(torch.float8_e4m3fn).to(F32) * s

    def w(self, t: torch.Tensor) -> torch.Tensor:
        """A weight in this arithmetic (per tensor)."""
        return self._q8(t.to(F32), None)

    def a(self, x: torch.Tensor) -> torch.Tensor:
        """An activation in this arithmetic (per row)."""
        return self._q8(x, -1)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.a(x), self.w(w))


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w.to(F32))


def rope(x, pos, theta):
    """x (B, S, H, d) rotated at positions ``pos`` (S,)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=F32, device=x.device) / half))
    ang = pos.to(F32)[:, None] * freqs
    c, s = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def causal_attention(q, k, v, scale):
    """q, k (B, S, H, dq), v (B, S, H, dv) -> (B, S, H * dv)."""
    S = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(q.shape[0], S, -1)


def quant(x, dim, bits):
    """Symmetric ``bits``-bit codes ``round(x / s) + 2**(bits-1)`` with
    ``s = amax / (2**(bits-1) - 1)`` along ``dim``, and the scales."""
    qmax = (1 << (bits - 1)) - 1
    amax = x.abs().amax(dim=dim, keepdim=True)
    s = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    return torch.clamp(torch.round(x / s), -qmax, qmax).to(torch.int64) + qmax + 1, s


def lut_linear(x, w, table, ar: Arith):
    """(M, K) x (K, N) through the table, exactly as integers: the table
    is its block composed over ``block_bits``-bit chunks of the codes, so
    the sum is the chunk pairs' block sums, shifted; each block sum is a
    float32 product of one-hot rows against the block's rows gathered by
    the weight chunks, exact below 2**24."""
    x, w = ar.a(x), ar.w(w)
    bits, bb = table.target_bits, table.block_bits
    qa, sa = quant(x, -1, bits)
    qw, sw = quant(w, 0, bits)
    K = x.shape[-1]
    block = torch.as_tensor(table.block, dtype=F32, device=x.device)
    mask = (1 << bb) - 1
    raw = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float64, device=x.device)
    for i in range(bits // bb):
        ai = (qa >> (bb * i)) & mask
        for j in range(bits // bb):
            bj = (qw >> (bb * j)) & mask
            part = torch.zeros(x.shape[0], w.shape[1], dtype=F32, device=x.device)
            for c in range(1 << bb):
                rows = ai == c
                if rows.any():
                    part += torch.matmul(rows.to(F32), block[c][bj])
            raw += part.double() * float(1 << (bb * (i + j)))
    c = float(1 << (bits - 1))
    corr = (raw - c * qa.sum(-1, keepdim=True).double()
            - c * qw.sum(0, keepdim=True).double() + c * c * K)
    return corr.to(F32) * sa * sw


def silu(x):
    return x * torch.sigmoid(x)


def ffn(p, x, table, ar: Arith):
    if table is None:
        return ar.mm(silu(ar.mm(x, p["w1"])) * ar.mm(x, p["w3"]), p["w2"])
    h = silu(lut_linear(x, p["w1"], table, ar)) * lut_linear(x, p["w3"], table, ar)
    return lut_linear(h, p["w2"], table, ar)


def attention(cfg, p, x, ar: Arith):
    B, S, _ = x.shape
    H = int(cfg["num_attention_heads"])
    theta = float(cfg["rope_theta"])
    pos = torch.arange(S, device=x.device)
    flat = x.reshape(B * S, -1)
    Hkv = int(cfg.get("num_key_value_heads", H))
    hd = int(cfg.get("head_dim") or x.shape[-1] // H)
    q = rope(ar.mm(flat, p["wq"]).reshape(B, S, H, hd), pos, theta)
    k = rope(ar.mm(flat, p["wk"]).reshape(B, S, Hkv, hd), pos, theta)
    v = ar.mm(flat, p["wv"]).reshape(B, S, Hkv, hd)
    k = k.repeat_interleave(H // Hkv, dim=2)
    v = v.repeat_interleave(H // Hkv, dim=2)
    out = causal_attention(q, k, v, 1.0 / math.sqrt(hd))
    return ar.mm(out.reshape(B * S, -1), p["wo"]).reshape(B, S, -1)


def eps_of(cfg) -> float:
    return float(cfg.get("rms_norm_eps", cfg.get("layer_norm_eps", 1e-6)))


@torch.no_grad()
def forward(cfg: dict, params: dict, tokens: torch.Tensor, table,
            precision: str | None = None) -> torch.Tensor:
    """Logits (B, S, V) in float32 of ``tokens`` (B, S), teacher-forced.
    ``table`` is the :class:`portbench.loader.Table` the LUT products go
    through, or None for exact MLPs."""
    no_tf32()
    ar = Arith(precision)
    eps = eps_of(cfg)
    B, S = tokens.shape
    x = ar.a(params["embed"][tokens].to(F32))
    for lp in params["layers"]:
        x = x + attention(cfg, lp["attn"], rmsnorm(x, lp["ln1"], eps), ar)
        h = rmsnorm(x, lp["ln2"], eps).reshape(B * S, -1)
        x = x + ffn(lp["ffn"], h, table, ar).reshape(B, S, -1)
    x = rmsnorm(x, params["ln_f"], eps)
    return ar.mm(x.reshape(B * S, -1), params["lm_head"]).reshape(B, S, -1)
