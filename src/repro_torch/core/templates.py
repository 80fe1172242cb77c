"""The paper's SHARED sum-of-products template.

Own copy of the shared half of ``repro.core.templates``.  One *global*
pool of ``T`` products; a literal selector per (product, input) decides
whether input ``j`` enters product ``t`` as-is (``USE``), negated
(``NEG``) or not at all (``IGNORE``, constant 1), and per-(output,
product) selection bits decide which pooled products feed each output
sum, so product logic is shared across outputs as a synthesized
multi-output netlist shares subexpressions.

Parameter encoding: ``lits`` int8 ``(T, n)`` in {USE=0, NEG=1, IGNORE=2};
``sel`` bool ``(m, T)``.  Proxies: ``PIT`` = products used by >= 1
output, ``ITS`` = max products feeding any single sum.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .circuits import ALL_ONES, Circuit, Op, input_truth_tables

USE, NEG, IGNORE = 0, 1, 2

__all__ = ["USE", "NEG", "IGNORE", "TemplateParams", "SharedTemplate"]


@dataclass
class TemplateParams:
    """A concrete parameter assignment."""

    lits: np.ndarray  # int8, {USE, NEG, IGNORE}
    sel: np.ndarray   # bool


class SharedTemplate:
    """The paper's shared template: one global product pool (Eq. 2)."""

    def __init__(self, n_inputs: int, n_outputs: int, pit: int):
        self.n_inputs = n_inputs
        self.n_outputs = n_outputs
        self.pit = pit  # T: structural size of the product pool

    def _product_tables(self, lits: np.ndarray) -> np.ndarray:
        """Truth tables of products.  ``lits``: (..., n) -> tables (..., W)."""
        tt = input_truth_tables(self.n_inputs)  # (n, W)
        use = np.where(lits[..., None] == USE, tt, ALL_ONES)
        neg = np.where(lits[..., None] == NEG, ~tt, ALL_ONES)
        comb = use & neg  # IGNORE contributes all-ones
        out = comb[..., 0, :].copy()
        for j in range(1, self.n_inputs):
            out &= comb[..., j, :]
        return out

    def eval_outputs(self, params: TemplateParams) -> np.ndarray:
        """Packed output truth tables ``(m, W)`` for a parameter assignment."""
        prods = self._product_tables(params.lits)  # (T, W)
        masked = np.where(params.sel[..., None], prods[None, :, :], np.uint32(0))
        out = masked[:, 0, :].copy()
        for t in range(1, self.pit):
            out |= masked[:, t, :]
        return out

    def _emit_product(self, c: Circuit, lit_row: np.ndarray) -> int | None:
        """Emit AND-of-literals for one product; None => constant-1 product."""
        terms: list[int] = []
        for j in range(self.n_inputs):
            if lit_row[j] == USE:
                terms.append(j)
            elif lit_row[j] == NEG:
                terms.append(c.add(Op.NOT, j))
        if not terms:
            return None
        if len(terms) == 1:
            return terms[0]
        return c.add(Op.AND, *terms)

    @staticmethod
    def _emit_sum(c: Circuit, terms: list[int | None]) -> int:
        """OR of product nodes; None (const-1 product) saturates the sum."""
        if any(t is None for t in terms):
            return c.const(True)
        ids = [t for t in terms if t is not None]
        if not ids:
            return c.const(False)
        if len(ids) == 1:
            return ids[0]
        return c.add(Op.OR, *ids)

    def instantiate(self, params: TemplateParams, name: str = "approx") -> Circuit:
        """Materialize the parameter assignment as a gate netlist."""
        c = Circuit.empty(self.n_inputs, name=name)
        used = params.sel.any(axis=0)  # (T,) -- only materialize used products
        prod_nodes: dict[int, int | None] = {}
        for t in range(self.pit):
            if used[t]:
                prod_nodes[t] = self._emit_product(c, params.lits[t])
        for i in range(self.n_outputs):
            terms = [prod_nodes[t] for t in range(self.pit) if params.sel[i, t]]
            c.mark_output(self._emit_sum(c, terms))
        return c

    def proxies(self, params: TemplateParams) -> dict[str, int]:
        used = params.sel.any(axis=0)
        pit = int(used.sum())
        its = int(params.sel.sum(axis=-1).max(initial=0))
        return {"PIT": pit, "ITS": its}
