"""Parameters of the JAX package, as numpy, into the port's layout.

``params_from_jax(jax.tree.map(np.asarray, params))`` gives the port the
weights the reference computes on, so the two are compared on the same
weights and never on two random inits.  The reference stacks per-layer
parameters on a leading axis of ``params["layers"]``; the port keeps one
dict per layer.  Dtypes are kept: a bfloat16 array (numpy's ``ml_dtypes``
type) becomes a ``torch.bfloat16`` tensor bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tree(x, device: torch.device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    return _tensor(x, device)


def params_from_jax(tree: dict[str, Any], *,
                    device: str | torch.device = "cuda") -> dict[str, Any]:
    """A numpy copy of a reference LM parameter tree -> port parameters on
    ``device``."""
    dev = resolve_device(device)
    out = {k: _tree(v, dev) for k, v in tree.items() if k != "layers"}
    stacked = tree["layers"]
    n_layers = len(stacked["ln1"])
    out["layers"] = [_tree(_index(stacked, i), dev) for i in range(n_layers)]
    return out


def _index(x, i: int):
    if isinstance(x, dict):
        return {k: _index(v, i) for k, v in x.items()}
    return np.asarray(x)[i]
