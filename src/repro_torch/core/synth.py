"""Light logic synthesis + standard-cell area model.

Own copy of ``repro.core.synth``: the subset of synthesis that sets the
*relative area ordering* of sum-of-products netlists -- binarization of
n-ary AND/OR into balanced trees, constant propagation and boolean
simplification, buffer / double-negation forwarding, structural hashing
(the pass that rewards product sharing), single-use NOT+AND/OR fusion
into NAND/NOR, and dead-gate elimination.  Area is the sum of Nangate
45nm X1 cell areas (µm²) over live logic gates.
"""

from __future__ import annotations

from .circuits import Circuit, Gate, Op

__all__ = ["synthesize", "binarize", "area", "NANGATE45_AREA"]

# Nangate Open Cell Library 45nm, X1 drive strength, cell area in µm².
NANGATE45_AREA: dict[Op, float] = {
    Op.NOT: 0.532,
    Op.BUF: 0.798,
    Op.AND: 1.064,
    Op.OR: 1.064,
    Op.NAND: 0.798,
    Op.NOR: 0.798,
    Op.XOR: 1.596,
    Op.XNOR: 1.596,
    Op.INPUT: 0.0,
    Op.CONST0: 0.0,
    Op.CONST1: 0.0,
}


def binarize(circuit: Circuit) -> Circuit:
    """Split n-ary AND/OR gates into balanced binary trees (a raw n-ary
    netlist is not a standard-cell netlist; all area numbers are post-
    binarization)."""
    out = Circuit.empty(circuit.n_inputs, name=circuit.name)
    remap: list[int] = list(range(circuit.n_inputs))

    def tree(op: Op, ids: list[int]) -> int:
        while len(ids) > 1:
            nxt = []
            for a, b in zip(ids[::2], ids[1::2]):
                nxt.append(out.add(op, a, b))
            if len(ids) % 2:
                nxt.append(ids[-1])
            ids = nxt
        return ids[0]

    for i, g in enumerate(circuit.nodes):
        if g.op is Op.INPUT:
            continue
        args = [remap[a] for a in g.args]
        if g.op in (Op.AND, Op.OR) and len(args) > 2:
            remap.append(tree(g.op, args))
        elif g.op in (Op.NAND, Op.NOR) and len(args) > 2:
            base = Op.AND if g.op is Op.NAND else Op.OR
            remap.append(out.add(Op.NOT, tree(base, args)))
        else:
            remap.append(out.add(g.op, *args))
    out.outputs = [remap[o] for o in circuit.outputs]
    return out


def _simplify_once(circuit: Circuit) -> tuple[Circuit, bool]:
    """One pass of const-prop + forwarding + structural hashing + DCE."""
    out = Circuit.empty(circuit.n_inputs, name=circuit.name)
    remap: list[int] = list(range(circuit.n_inputs))
    kind: list[str] = ["var"] * circuit.n_inputs  # 'var' | 'c0' | 'c1'
    cache: dict[tuple, int] = {}
    changed = False

    def emit(op: Op, *args: int) -> int:
        key = (op, tuple(sorted(args)) if op in (Op.AND, Op.OR, Op.XOR, Op.NAND, Op.NOR, Op.XNOR) else tuple(args))
        if key in cache:
            return cache[key]
        nid = out.add(op, *args)
        cache[key] = nid
        kind.append("var")
        return nid

    def emit_const(v: bool) -> int:
        key = ("const", v)
        if key in cache:
            return cache[key]
        nid = out.const(v)
        cache[key] = nid
        kind.append("c1" if v else "c0")
        return nid

    for i, g in enumerate(circuit.nodes):
        if g.op is Op.INPUT:
            continue
        if g.op is Op.CONST0:
            remap.append(emit_const(False))
            continue
        if g.op is Op.CONST1:
            remap.append(emit_const(True))
            continue
        args = [remap[a] for a in g.args]
        kinds = [kind[a] for a in args]

        if g.op is Op.BUF:
            remap.append(args[0])
            changed = True
            continue
        if g.op is Op.NOT:
            a = args[0]
            if kinds[0] == "c0":
                remap.append(emit_const(True)); changed = True
            elif kinds[0] == "c1":
                remap.append(emit_const(False)); changed = True
            elif out.nodes[a].op is Op.NOT:  # double negation
                remap.append(out.nodes[a].args[0]); changed = True
            else:
                remap.append(emit(Op.NOT, a))
            continue
        if g.op in (Op.AND, Op.OR):
            absorb = "c0" if g.op is Op.AND else "c1"   # dominating constant
            neutral = "c1" if g.op is Op.AND else "c0"  # identity constant
            if any(k == absorb for k in kinds):
                remap.append(emit_const(g.op is Op.OR)); changed = True
                continue
            live = sorted({a for a, k in zip(args, kinds) if k != neutral})
            if len(live) < len(args):
                changed = True
            if not live:
                remap.append(emit_const(g.op is Op.AND))  # empty AND=1, OR=0
                continue
            if len(live) == 1:
                remap.append(live[0])
                continue
            # x op x covered by the sorted-set dedup above (live is a set)
            remap.append(emit(g.op, *live))
            continue
        if g.op in (Op.XOR, Op.XNOR):
            a, b = args
            ka, kb = kinds
            base_is_xor = g.op is Op.XOR
            if ka in ("c0", "c1") and kb in ("c0", "c1"):
                v = (ka == "c1") ^ (kb == "c1")
                remap.append(emit_const(v if base_is_xor else not v)); changed = True
                continue
            if ka in ("c0", "c1") or kb in ("c0", "c1"):
                cval = (ka == "c1") if ka in ("c0", "c1") else (kb == "c1")
                var = b if ka in ("c0", "c1") else a
                inv = cval ^ (not base_is_xor)
                remap.append(emit(Op.NOT, var) if inv else var)
                changed = True
                continue
            if a == b:
                remap.append(emit_const(not base_is_xor)); changed = True
                continue
            remap.append(emit(g.op, a, b))
            continue
        if g.op in (Op.NAND, Op.NOR):
            base = Op.AND if g.op is Op.NAND else Op.OR
            # lower to NOT(base) and let fusion re-pack later
            nid = emit(base, *sorted(set(args))) if len(set(args)) > 1 else args[0]
            remap.append(emit(Op.NOT, nid))
            changed = True
            continue
        raise ValueError(f"unexpected op {g.op}")  # pragma: no cover

    out.outputs = [remap[o] for o in circuit.outputs]
    return out, changed


def _fuse_inverters(circuit: Circuit) -> Circuit:
    """NOT(AND) -> NAND, NOT(OR) -> NOR, NOT(XOR) -> XNOR, when the inner
    gate has no other fanout (single-use)."""
    fanout = circuit.fanout_counts()
    out = Circuit.empty(circuit.n_inputs, name=circuit.name)
    remap: dict[int, int] = {i: i for i in range(circuit.n_inputs)}
    fused_inner: set[int] = set()
    fuse_map = {Op.AND: Op.NAND, Op.OR: Op.NOR, Op.XOR: Op.XNOR}

    # first decide which NOT gates fuse
    fuses: dict[int, tuple[Op, tuple[int, ...]]] = {}
    for i, g in enumerate(circuit.nodes):
        if g.op is Op.NOT:
            inner = circuit.nodes[g.args[0]]
            if inner.op in fuse_map and fanout[g.args[0]] == 1:
                fuses[i] = (fuse_map[inner.op], inner.args)
                fused_inner.add(g.args[0])

    for i, g in enumerate(circuit.nodes):
        if g.op is Op.INPUT:
            continue
        if i in fused_inner and i not in [o for o in circuit.outputs]:
            remap[i] = -1  # dead; nothing should reference it afterwards
            continue
        if i in fuses:
            op, inner_args = fuses[i]
            remap[i] = out.add(op, *[remap[a] for a in inner_args])
        else:
            remap[i] = out.add(g.op, *[remap[a] for a in g.args])
    out.outputs = [remap[o] for o in circuit.outputs]
    return out


def _dce(circuit: Circuit) -> Circuit:
    """Drop gates not reachable from the outputs."""
    live = circuit.live_nodes()
    out = Circuit.empty(circuit.n_inputs, name=circuit.name)
    remap: dict[int, int] = {i: i for i in range(circuit.n_inputs)}
    for i, g in enumerate(circuit.nodes):
        if g.op is Op.INPUT or not live[i]:
            continue
        remap[i] = out.add(g.op, *[remap[a] for a in g.args])
    out.outputs = [remap[o] for o in circuit.outputs]
    return out


def synthesize(circuit: Circuit, max_iters: int = 8) -> Circuit:
    """Run the pass pipeline to a fixpoint (bounded)."""
    c = binarize(circuit)
    for _ in range(max_iters):
        c, changed = _simplify_once(c)
        if not changed:
            break
    c = _dce(c)
    c = _fuse_inverters(c)
    c = _dce(c)
    return c


def area(circuit: Circuit, *, presynthesized: bool = False) -> float:
    """Nangate-45nm-equivalent cell area (µm²) after light synthesis."""
    c = circuit if presynthesized else synthesize(circuit)
    live = c.live_nodes()
    total = 0.0
    for i, g in enumerate(c.nodes):
        if live[i]:
            total += NANGATE45_AREA.get(g.op, 0.0)
    return round(total, 4)
