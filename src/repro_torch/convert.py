"""Objects of the JAX package, as numpy, into the port's types.

Model weights: ``params_from_jax(jax.tree.map(np.asarray, params))`` gives the port the
weights the reference computes on, so the two are compared on the same
weights and never on two random inits.  The reference stacks per-layer
parameters on a leading axis of ``params["layers"]`` (the encoder–decoder
family: ``"enc_layers"`` and ``"dec_layers"``); the port keeps one dict
per layer.  Dtypes are kept: a bfloat16 array (numpy's ``ml_dtypes``
type) becomes a ``torch.bfloat16`` tensor bit for bit.
:func:`opt_state_from_jax` carries the optimizer's moments and step
across the same way.

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
    a = np.array(a, order="C")        # a contiguous copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(x, device: torch.device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):   # MoE's "shared": a list of FFN dicts
        return [_tree(v, device) for v in x]
    return _tensor(x, device)


# the reference's entries that stack one layer's parameters per row
STACKED = ("layers", "enc_layers", "dec_layers")


def params_from_jax(tree: dict[str, Any], *,
                    device: str | torch.device = "cuda") -> dict[str, Any]:
    """A numpy copy of a reference parameter tree -> port parameters on
    ``device``.  Top-level entries (``embed``, ``lm_head``, ``vis_proj``,
    ...) pass through; each stacked entry (``layers``, or the
    encoder–decoder's ``enc_layers`` and ``dec_layers``) splits into one
    dict a layer, lists (MoE's shared experts) kept as lists."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if k in STACKED:
            n_layers = len(v["ln1"])
            out[k] = [_tree(_index(v, i), dev) for i in range(n_layers)]
        else:
            out[k] = _tree(v, dev)
    return out


def opt_state_from_jax(state: dict[str, Any], *,
                       device: str | torch.device = "cuda") -> dict[str, Any]:
    """A numpy copy of the reference's AdamW state (``mu``, ``nu``: float32
    trees shaped like the parameters; ``step``: int32) -> the port's
    (:func:`repro_torch.train.optim.init_opt_state`)."""
    dev = resolve_device(device)
    return {"mu": params_from_jax(state["mu"], device=dev),
            "nu": params_from_jax(state["nu"], device=dev),
            "step": _tensor(np.asarray(state["step"], dtype=np.int32), dev)}


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
