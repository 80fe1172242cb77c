"""Deterministic synthetic load: own copy of ``repro.serving.loadgen``,
so that both engines serve the same request stream from the same
``(profile, seed)``.

A :class:`LoadProfile` is a per-tick arrival count plus fixed request
shapes; :func:`synth_requests` materialises it with numpy, bit-identical
on any machine.  Three shapes cover the controller's regimes: ``steady``
(constant arrivals), ``ramp`` (linearly growing) and ``spike`` (a burst
over a baseline).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Request", "LoadProfile", "steady", "ramp", "spike",
           "make_profile", "synth_requests", "parse_prompt_dist",
           "PROFILES", "PROMPT_DISTS"]

PROFILES = ("steady", "ramp", "spike")
PROMPT_DISTS = ("uniform", "bimodal")

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


def ramp(ticks: int, peak: int, *, prompt_len: int = 16,
         gen_len: int = 32, class_mix=None, prompt_dist=None) -> LoadProfile:
    """0 -> ``peak`` arrivals, linearly over ``ticks`` ticks."""
    arr = tuple(int(round(peak * (t + 1) / ticks)) for t in range(ticks))
    return LoadProfile("ramp", arr, prompt_len, gen_len, class_mix,
                       prompt_dist)


def spike(ticks: int, base: int, peak: int, *, at: int | None = None,
          width: int | None = None, prompt_len: int = 16,
          gen_len: int = 32, class_mix=None,
          prompt_dist=None) -> LoadProfile:
    """``base`` arrivals with a ``peak`` burst of ``width`` ticks at ``at``."""
    at = ticks // 3 if at is None else at
    width = max(1, ticks // 4) if width is None else width
    arr = tuple(peak if at <= t < at + width else base for t in range(ticks))
    return LoadProfile("spike", arr, prompt_len, gen_len, class_mix,
                       prompt_dist)


def parse_prompt_dist(spec: str, prompt_len: int) -> tuple:
    """A prompt-length spec -> a :class:`LoadProfile.prompt_dist` tuple.

    ``"uniform:4-16"`` draws each request's length uniformly in [4, 16];
    ``"bimodal:4-16"`` draws half near 4 and half near 16.  Bounds must
    fit ``[1, prompt_len]``."""
    try:
        kind, _, rng = spec.partition(":")
        lo_s, _, hi_s = rng.partition("-")
        lo, hi = int(lo_s), int(hi_s)
    except ValueError:
        raise ValueError(
            f"bad prompt-length spec {spec!r}; expected kind:lo-hi, e.g. "
            f"uniform:4-16 (kinds: {PROMPT_DISTS})") from None
    if kind not in PROMPT_DISTS:
        raise ValueError(
            f"unknown prompt-length distribution {kind!r}; "
            f"known: {PROMPT_DISTS}")
    if not 1 <= lo <= hi <= prompt_len:
        raise ValueError(
            f"prompt-length bounds {lo}-{hi} must satisfy "
            f"1 <= lo <= hi <= prompt_len ({prompt_len})")
    return (kind, lo, hi)


def make_profile(kind: str, *, ticks: int, per_tick: int,
                 prompt_len: int = 16, gen_len: int = 32,
                 class_mix=None, prompt_dist=None) -> LoadProfile:
    """One of :data:`PROFILES` at a given scale.  ``per_tick`` is the
    steady rate / ramp peak / spike peak (spike base is 1)."""
    if kind == "steady":
        return steady(ticks, per_tick, prompt_len=prompt_len, gen_len=gen_len,
                      class_mix=class_mix, prompt_dist=prompt_dist)
    if kind == "ramp":
        return ramp(ticks, per_tick, prompt_len=prompt_len, gen_len=gen_len,
                    class_mix=class_mix, prompt_dist=prompt_dist)
    if kind == "spike":
        return spike(ticks, 1, per_tick, prompt_len=prompt_len,
                     gen_len=gen_len, class_mix=class_mix,
                     prompt_dist=prompt_dist)
    raise ValueError(f"unknown load profile {kind!r}; known: {PROFILES}")


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
