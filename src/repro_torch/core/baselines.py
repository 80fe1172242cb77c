"""Comparison baselines (paper §IV): the MUSCAT-like and MECALS-like
circuit rewrites and the random sound cloud.

Own copy of ``repro.core.baselines``, numpy over the port's circuits,
miter, synthesis and templates.  The mechanisms are re-implemented against
the exhaustive miter, so every result is sound by construction:

* :func:`muscat_like` -- greedy gate-to-constant substitution (each gate
  tried at 0 and at 1) in randomized orders with restarts, kept when the
  circuit stays sound; the smallest synthesized area wins.
* :func:`mecals_like` -- wire substitution (SASIMI-style): a gate's output
  replaced by a constant, or by an earlier signal or its negation when
  that stays sound and lowers the area.
* :func:`random_sound` -- the red-dot cloud: uniformly random SHARED
  template instantiations filtered for soundness.

With the same ``seed`` and a wall budget that does not bind, each returns
the reference's circuits node for node.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from .circuits import Circuit, Gate, Op, unpack_bits
from .synth import area, synthesize
from .templates import SharedTemplate, TemplateParams

__all__ = ["muscat_like", "mecals_like", "random_sound", "BaselineResult"]


@dataclass
class BaselineResult:
    circuit: Circuit
    area: float
    wce: int
    wall_s: float


def _with_const(circuit: Circuit, node: int, value: bool) -> Circuit:
    c = Circuit(
        n_inputs=circuit.n_inputs,
        nodes=list(circuit.nodes),
        outputs=list(circuit.outputs),
        name=circuit.name,
    )
    c.nodes[node] = Gate(Op.CONST1 if value else Op.CONST0)
    return c


def _wce(circuit: Circuit, exact_values: np.ndarray) -> int:
    vals = circuit.eval_words().astype(np.int64)
    return int(np.abs(vals - exact_values.astype(np.int64)).max())


def muscat_like(
    exact: Circuit,
    et: int,
    *,
    restarts: int = 4,
    seed: int = 0,
    wall_budget_s: float = 120.0,
) -> BaselineResult:
    """Greedy sound gate-to-constant pruning with randomized restarts."""
    exact_values = exact.eval_words()
    t0 = time.time()
    rng = np.random.default_rng(seed)
    best = synthesize(exact)
    best_area = area(best, presynthesized=True)

    for _ in range(restarts):
        cur = Circuit(
            n_inputs=exact.n_inputs,
            nodes=list(exact.nodes),
            outputs=list(exact.outputs),
            name=f"{exact.name}_muscat",
        )
        improved = True
        while improved and time.time() - t0 < wall_budget_s:
            improved = False
            order = rng.permutation(np.arange(exact.n_inputs, len(cur.nodes)))
            for node in order:
                if cur.nodes[node].op in (Op.CONST0, Op.CONST1, Op.INPUT):
                    continue
                for value in (False, True):
                    cand = _with_const(cur, int(node), value)
                    if _wce(cand, exact_values) <= et:
                        cur = cand
                        improved = True
                        break
        syn = synthesize(cur)
        a = area(syn, presynthesized=True)
        if a < best_area:
            best, best_area = syn, a

    return BaselineResult(best, best_area, _wce(best, exact_values), time.time() - t0)


def mecals_like(
    exact: Circuit,
    et: int,
    *,
    seed: int = 0,
    wall_budget_s: float = 120.0,
) -> BaselineResult:
    """Sound wire-substitution (replace gate output by existing signal /
    its negation / a constant), greedy on synthesized area."""
    exact_values = exact.eval_words()
    t0 = time.time()
    cur = Circuit(
        n_inputs=exact.n_inputs,
        nodes=list(exact.nodes),
        outputs=list(exact.outputs),
        name=f"{exact.name}_mecals",
    )
    rng = np.random.default_rng(seed)

    def try_substitutions() -> bool:
        tables = cur.node_tables()
        n_nodes = len(cur.nodes)
        # candidate pairs ranked by truth-table Hamming similarity
        order = rng.permutation(np.arange(cur.n_inputs, n_nodes))
        for node in order:
            if cur.nodes[node].op in (Op.CONST0, Op.CONST1, Op.INPUT):
                continue
            tt = tables[node]
            # try constants first (cheapest), then similar earlier signals
            for value in (False, True):
                cand = _with_const(cur, int(node), value)
                if _wce(cand, exact_values) <= et:
                    _commit(cand)
                    return True
            for other in range(int(node)):
                if other == node:
                    continue
                same = tt == tables[other]
                if bool(same.all()):
                    continue  # identical — structural hashing handles it
                for negate in (False, True):
                    cand = Circuit(
                        n_inputs=cur.n_inputs,
                        nodes=list(cur.nodes),
                        outputs=list(cur.outputs),
                        name=cur.name,
                    )
                    if negate:
                        cand.nodes[int(node)] = Gate(Op.NOT, (other,))
                    else:
                        cand.nodes[int(node)] = Gate(Op.BUF, (other,))
                    if _wce(cand, exact_values) <= et:
                        before = area(cur)
                        if area(cand) < before:
                            _commit(cand)
                            return True
            if time.time() - t0 > wall_budget_s:
                return False
        return False

    committed = {"c": cur}

    def _commit(cand: Circuit) -> None:
        committed["c"] = cand

    while time.time() - t0 < wall_budget_s:
        cur = committed["c"]
        if not try_substitutions():
            break
    cur = synthesize(committed["c"])
    return BaselineResult(
        cur, area(cur, presynthesized=True), _wce(cur, exact_values), time.time() - t0
    )


def random_sound(
    exact: Circuit,
    et: int,
    *,
    count: int = 1000,
    pit: int | None = None,
    batch: int = 4096,
    max_batches: int = 200,
    seed: int = 0,
) -> list[tuple[float, dict[str, int]]]:
    """Sample random shared-template instantiations, keep the sound ones.

    Returns ``[(synthesized_area, proxies), ...]`` — the paper's red-dot
    cloud.  Vectorized over the whole batch via the template's bit-packed
    evaluation, so filtering is cheap even at low hit rates.
    """
    n, m = exact.n_inputs, exact.n_outputs
    tpl = SharedTemplate(n, m, pit=pit if pit is not None else 2 * m)
    exact_values = exact.eval_words().astype(np.int64)
    rng = np.random.default_rng(seed)
    kept: list[tuple[float, dict[str, int]]] = []

    for _ in range(max_batches):
        if len(kept) >= count:
            break
        lits = rng.integers(0, 3, size=(batch, tpl.pit, n), dtype=np.int8)
        sel = rng.random((batch, m, tpl.pit)) < rng.uniform(0.2, 0.6)
        # vectorized eval: products (batch, T, W) -> outputs (batch, m, W)
        prods = tpl._product_tables(lits)
        masked = np.where(sel[..., None], prods[:, None, :, :], np.uint32(0))
        outs = masked[:, :, 0, :].copy()
        for t in range(1, tpl.pit):
            outs |= masked[:, :, t, :]
        # values per assignment
        bits = unpack_bits(outs, 1 << n)  # (batch, m, S)
        weights = (np.int64(1) << np.arange(m, dtype=np.int64))[None, :, None]
        vals = (bits.astype(np.int64) * weights).sum(axis=1)  # (batch, S)
        wce = np.abs(vals - exact_values[None, :]).max(axis=1)
        for idx in np.nonzero(wce <= et)[0]:
            if len(kept) >= count:
                break
            p = TemplateParams(lits[idx], sel[idx])
            circ = tpl.instantiate(p)
            kept.append((area(circ), tpl.proxies(p)))
    return kept
