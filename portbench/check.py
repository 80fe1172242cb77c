"""The output check: the tokens the timed path served, against the plain
reference run over the same prompts.

A sample of the finished requests is drawn from the seed, the longest
prompt always among them.  The reference runs once over each prompt (as
the program saw it: zero-padded by the fixed engine) followed by its
served tokens, and reads each served token's gap: how far its logit lies
below the reference's best at its position.  Under greedy decoding a
sound program serves the reference's best token or one within rounding
of it.  The number compared is the mean gap over the sample's served
tokens; the widest gap, the share off the best and the distinct tokens
are reported beside it.

The control (:func:`control_gap`) is the same reference in float8: at
each position it reads the gap of the token the lower precision puts
first.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import model as ref


def pick(pool: list, n: int, seed: int) -> list:
    """``n`` of the finished requests ``(prompt, served, prompt length)``:
    the one with the longest prompt (the first such) and the rest drawn
    from the seed."""
    if not pool:
        return []
    longest = max(range(len(pool)), key=lambda i: pool[i][2])
    rest = [i for i in range(len(pool)) if i != longest]
    rng = np.random.default_rng([int(seed) % (1 << 63), 0xC4EC])
    chosen = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [pool[longest]] + [pool[rest[i]] for i in sorted(chosen)]


def _batch(sample: list, device) -> tuple[torch.Tensor, list]:
    rows = [np.concatenate([p, s[:-1]]) for p, s, _ in sample]
    S = max(len(r) for r in rows)
    toks = np.zeros((len(rows), S), np.int64)
    for i, r in enumerate(rows):
        toks[i, :len(r)] = r
    # the logits at position p predict the token served at p + 1
    where = [(i, len(p) - 1, s) for i, (p, s, _) in enumerate(sample)]
    return torch.as_tensor(toks, device=device), where


def _gaps(logits: torch.Tensor, where: list, picked=None) -> tuple[np.ndarray, np.ndarray]:
    """Each compared token's gap below the reference's best, and the
    tokens themselves."""
    out, toks = [], []
    for i, p0, served in where:
        z = logits[i, p0:p0 + len(served)]
        tok = (torch.as_tensor(served, device=z.device).long() if picked is None
               else picked[i, p0:p0 + len(served)])
        out.append((z.max(-1).values - z.gather(-1, tok[:, None])[:, 0]).cpu().numpy())
        toks.append(tok.cpu().numpy())
    if not out:
        return np.zeros(0), np.zeros(0)
    return np.concatenate(out), np.concatenate(toks)


def _summary(g: np.ndarray, toks: np.ndarray) -> dict:
    if not len(g):
        return {"mean_gap": float("inf"), "tokens": 0}
    return {"mean_gap": float(g.mean()), "max_gap": float(g.max()),
            "off_best": float((g > 0).mean()), "distinct": int(len(np.unique(toks))),
            "tokens": int(len(g))}


def served_gap(cfg: dict, params: dict, table, sample: list, device) -> dict:
    """The reference's gaps of the served tokens: their mean, the widest,
    the share off the best, the distinct tokens and how many."""
    toks, where = _batch(sample, device)
    logits = ref.forward(cfg, params, toks, table)
    return _summary(*_gaps(logits, where))


def control_gap(cfg: dict, params: dict, table, sample: list, device) -> dict:
    """The float8 control's reading on the same prompts and tokens: the
    reference's gap of the token the control puts first, at every
    position a served token was compared."""
    toks, where = _batch(sample, device)
    picked = ref.forward(cfg, params, toks, table, precision="fp8").argmax(-1)
    logits = ref.forward(cfg, params, toks, table)
    return _summary(*_gaps(logits, where, picked))
