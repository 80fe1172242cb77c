"""The one generator of traffic: it reads a mix's parameters from
``portbench/traffic/<name>.json`` and makes the requests of a run from
``--seed``.

A mix gives the batch the fixed engine serves back to back, the prompt
lengths (``uniform:lo-hi``) and the length every prompt is padded to,
the output length, the Zipf exponent of the prompt tokens, and the
public source its lengths follow.

Every seed gets the same work: the multiset of prompt lengths is drawn
from a fixed stream, and the seed only permutes it and draws the tokens.
So two seeds differ in order and in content, not in the amount of work.

Token drawing is copied from ``repro_torch/serving/loadgen.py``
(``synth_requests``: ``zipf(1.2)`` ranks minus one, clipped to the
vocabulary).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_FIXED = 0x5EED          # the stream of the multisets shared by every seed
_PERM = 0x9E3779B1       # the seed's permutation of them
_TOK = 0x70C5            # the seed's prompt tokens


@dataclass(frozen=True)
class Req:
    rid: int
    tokens: np.ndarray        # (len,) int32


def _seed(seed: int) -> int:
    return int(seed) % (1 << 63)


def _draw_lengths(spec: str, n: int, rng: np.random.Generator) -> np.ndarray:
    kind, _, span = spec.partition(":")
    lo, _, hi = span.partition("-")
    if kind != "uniform" or not 1 <= int(lo) <= int(hi):
        raise ValueError(f"bad prompt length spec {spec!r}; uniform:lo-hi")
    return rng.integers(int(lo), int(hi) + 1, size=n)


def lengths(mix: dict, n: int, seed: int, stream: int = 0) -> np.ndarray:
    """``n`` prompt lengths: a fixed multiset in the seed's order."""
    fixed = _draw_lengths(mix["prompt_dist"], n,
                          np.random.default_rng([_FIXED, stream]))
    perm = np.random.default_rng([_seed(seed), _PERM, stream]).permutation(n)
    out = fixed[perm]
    if n and out.max() > mix["prompt_len"]:
        raise ValueError(f"prompt lengths reach {out.max()}, past the mix's "
                         f"prompt_len {mix['prompt_len']}")
    return out


def tokens(mix: dict, vocab: int, seed: int, rid: int, length: int) -> np.ndarray:
    rng = np.random.default_rng([_seed(seed), _TOK, rid])
    ranks = rng.zipf(float(mix.get("zipf_a", 1.2)), size=int(length))
    return np.minimum(ranks - 1, vocab - 1).astype(np.int32)


def batch(mix: dict, vocab: int, seed: int, index: int) -> list[Req]:
    """Batch ``index`` of a mix: ``mix["batch"]`` requests."""
    n = int(mix["batch"])
    lens = lengths(mix, n, seed, stream=index)
    return [Req(index * n + i, tokens(mix, vocab, seed, index * n + i, lens[i]))
            for i in range(n)]
