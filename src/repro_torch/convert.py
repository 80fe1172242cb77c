"""Objects of the JAX package, as numpy, into the port's types.

Model weights: ``params_from_jax(jax.tree.map(np.asarray, params))`` gives the port the
weights the reference computes on, so the two are compared on the same
weights and never on two random inits.  The reference stacks per-layer
parameters on a leading axis of ``params["layers"]``; the port keeps one
dict per layer.  Dtypes are kept: a bfloat16 array (numpy's ``ml_dtypes``
type) becomes a ``torch.bfloat16`` tensor bit for bit.

Search objects: :func:`circuit_from_jax`, :func:`template_params_from_jax`
and :func:`signature_from_jax` carry a netlist, a parameter assignment
and an operator signature across through numpy arrays and the operator
store's dict format, so the tests hand both packages the same ones.  They
read attributes only and import nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.circuits import Circuit
from .core.templates import TemplateParams
from .device import resolve_device
from .library.store import OperatorSignature, circuit_from_dict


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tree(x, device: torch.device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):   # MoE's "shared": a list of FFN dicts
        return [_tree(v, device) for v in x]
    return _tensor(x, device)


def params_from_jax(tree: dict[str, Any], *,
                    device: str | torch.device = "cuda") -> dict[str, Any]:
    """A numpy copy of a reference LM parameter tree -> port parameters on
    ``device``.  Top-level entries (``embed``, ``lm_head``, ``vis_proj``,
    ...) pass through; the stacked ``layers`` split into one dict a layer,
    lists (MoE's shared experts) kept as lists."""
    dev = resolve_device(device)
    out = {k: _tree(v, dev) for k, v in tree.items() if k != "layers"}
    stacked = tree["layers"]
    n_layers = len(stacked["ln1"])
    out["layers"] = [_tree(_index(stacked, i), dev) for i in range(n_layers)]
    return out


def _index(x, i: int):
    if isinstance(x, dict):
        return {k: _index(v, i) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_index(v, i) for v in x]
    return np.asarray(x)[i]


def circuit_from_jax(c) -> Circuit:
    """A ``repro.core.circuits.Circuit`` -> the port's, through the
    store's dict format."""
    return circuit_from_dict({
        "n_inputs": c.n_inputs,
        "nodes": [[g.op.value, list(g.args)] for g in c.nodes],
        "outputs": list(c.outputs),
        "name": c.name,
    })


def template_params_from_jax(p) -> TemplateParams:
    """A ``repro.core.templates.TemplateParams`` -> the port's."""
    return TemplateParams(np.array(p.lits, dtype=np.int8),
                          np.array(p.sel, dtype=bool))


def signature_from_jax(s) -> OperatorSignature:
    """A ``repro.library.store.OperatorSignature`` -> the port's."""
    return OperatorSignature(s.op_kind, int(s.bits), s.error_metric,
                             int(s.threshold))
