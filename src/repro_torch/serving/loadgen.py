"""Deterministic synthetic load: own copy of the part of
``repro.serving.loadgen`` the engine serves, so that both engines serve
the same request stream from the same ``(profile, seed)``.

A :class:`LoadProfile` is a per-tick arrival count plus fixed request
shapes; :func:`synth_requests` materialises it with numpy, bit-identical
on any machine.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# prompt-length RNG salt: lengths ride their own stream, so turning a
# distribution on never changes which tokens a request draws
_LEN_SALT = 0x1E57


@dataclass(frozen=True)
class Request:
    """One synthetic serving request: a prompt to greedily extend."""

    rid: int
    tokens: np.ndarray      # (prompt_len,) int32 prompt
    arrived_tick: int = 0
    qos_class: str = "std"


@dataclass(frozen=True)
class LoadProfile:
    """Arrivals per tick plus the (fixed) request geometry.

    ``class_mix`` optionally tags requests with a QoS class drawn from
    ``((name, fraction), ...)``; ``prompt_dist`` optionally draws prompt
    lengths in ``[1, prompt_len]`` as ``("uniform", lo, hi)`` or
    ``("bimodal", lo, hi)``.
    """

    name: str
    arrivals: tuple[int, ...]
    prompt_len: int = 16
    gen_len: int = 32
    class_mix: tuple[tuple[str, float], ...] | None = None
    prompt_dist: tuple | None = None

    @property
    def n_ticks(self) -> int:
        return len(self.arrivals)

    @property
    def total_requests(self) -> int:
        return int(sum(self.arrivals))


def steady(ticks: int, per_tick: int, *, prompt_len: int = 16,
           gen_len: int = 32, class_mix=None,
           prompt_dist=None) -> LoadProfile:
    return LoadProfile("steady", (per_tick,) * ticks, prompt_len, gen_len,
                       class_mix, prompt_dist)


def _draw_lengths(dist: tuple, n: int, rng: np.random.Generator
                  ) -> np.ndarray:
    kind, lo, hi = dist
    if kind == "uniform":
        return rng.integers(lo, hi + 1, size=n)
    if kind == "bimodal":
        mode = rng.integers(0, 2, size=n)
        jitter = rng.integers(0, max(1, (hi - lo) // 4) + 1, size=n)
        return np.where(mode == 0, np.minimum(lo + jitter, hi),
                        np.maximum(hi - jitter, lo))
    raise ValueError(f"unknown prompt-length distribution {kind!r}")


def synth_requests(profile: LoadProfile, vocab_size: int,
                   seed: int = 0) -> list[list[Request]]:
    """The request stream: ``out[tick]`` is that tick's arrivals.  Prompts
    are Zipf-ish tokens from an RNG seeded per ``(seed, tick)``; classes
    and lengths ride their own salted streams, so they never change the
    tokens a request draws."""
    names = probs = None
    if profile.class_mix:
        names = [n for n, _ in profile.class_mix]
        probs = np.asarray([f for _, f in profile.class_mix],
                           dtype=np.float64)
        probs = probs / probs.sum()
    out: list[list[Request]] = []
    rid = 0
    for tick, n in enumerate(profile.arrivals):
        rng = np.random.default_rng((seed, tick))
        crng = np.random.default_rng((seed, tick, 0xC1A5))
        lens = None
        if profile.prompt_dist is not None:
            lrng = np.random.default_rng((seed, tick, _LEN_SALT))
            lens = _draw_lengths(profile.prompt_dist, n, lrng)
        reqs = []
        for i in range(n):
            ranks = rng.zipf(1.2, size=profile.prompt_len).astype(np.int64)
            tokens = np.minimum(ranks - 1, vocab_size - 1).astype(np.int32)
            if lens is not None:
                tokens = tokens[: int(lens[i])]
            cls = (names[crng.choice(len(names), p=probs)]
                   if names is not None else "std")
            reqs.append(Request(rid=rid, tokens=tokens, arrived_tick=tick,
                                qos_class=cls))
            rid += 1
        out.append(reqs)
    return out
