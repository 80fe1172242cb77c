"""Atomic, digest-verified, resumable checkpoints, in the reference's
layout and protocol, so that a checkpoint written by either package
restores in the other.

Layout::

    <dir>/step_<N>/arrays.npz       # every array under its logical path
    <dir>/step_<N>/meta.json        # step, data state, extra, crc
    <dir>/LATEST                    # atomically updated pointer

Protocol (one writer): write into ``step_<N>.tmp``, fsync, then
``rename``; ``LATEST`` is replaced through ``LATEST.tmp``.  A crashed
writer never corrupts the previous checkpoint.  The digest is a crc32
over the arrays in sorted key order.

Arrays sit under the reference's logical paths: the per-layer tensors of
``layers`` (``enc_layers``, ``dec_layers``) stacked on a leading axis, as
the reference keeps them (``params/layers/attn/wq``,
``opt/mu/dec_layers/cross/wk``, ``opt/step``, ...), list entries under
their index, and bfloat16 upcast to float32 (exact; npz cannot hold
bfloat16).
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any

import numpy as np
import torch

from ..convert import STACKED


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()             # exact upcast; restore rounds back exactly
    return t.cpu().numpy()


def _flatten(tree: Any, prefix: str, out: dict[str, np.ndarray],
             layers: list | None = None) -> None:
    """Add ``tree``'s arrays to ``out`` under ``prefix``.  Inside a stacked
    entry, ``layers`` holds the entry's per-layer trees, each shaped like
    ``tree``, whose leaves stack on a leading axis."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            if layers is None and k in STACKED and isinstance(v, list):
                _flatten(v[0], path, out, v)
            else:
                _flatten(v, path, out, None if layers is None
                         else [lp[k] for lp in layers])
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out, None if layers is None
                     else [lp[i] for lp in layers])
    elif layers is None:
        out[prefix] = _numpy(tree)
    else:
        out[prefix] = np.stack([_numpy(t) for t in layers])


def _rebuild(like: Any, prefix: str, arrays: dict[str, np.ndarray],
             row: int | None = None) -> Any:
    """A tree shaped like ``like`` from ``arrays``, each tensor on its
    leaf's device and in its dtype; inside a stacked entry, row ``row``."""
    if isinstance(like, dict):
        out = {}
        for k, v in like.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            if row is None and k in STACKED and isinstance(v, list):
                out[k] = [_rebuild(lp, path, arrays, i) for i, lp in enumerate(v)]
            else:
                out[k] = _rebuild(v, path, arrays, row)
        return out
    if isinstance(like, (list, tuple)):
        return [_rebuild(v, f"{prefix}/{i}", arrays, row) for i, v in enumerate(like)]
    arr = arrays[prefix] if row is None else arrays[prefix][row]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{prefix}: checkpoint shape {arr.shape}, "
                         f"expected {tuple(like.shape)}")
    return torch.from_numpy(np.array(arr)).to(
        device=like.device, dtype=like.dtype)


def flatten(params: Any, opt_state: Any) -> dict[str, np.ndarray]:
    """Every array of a checkpoint under its logical path."""
    arrays: dict[str, np.ndarray] = {}
    _flatten(params, "params", arrays)
    _flatten(opt_state, "opt", arrays)
    return arrays


def _digest(arrays: dict[str, np.ndarray]) -> int:
    crc = 0
    for k in sorted(arrays):
        crc = zlib.crc32(arrays[k].tobytes(), zlib.crc32(k.encode(), crc))
    return crc


def save(directory: str, step: int, params: Any, opt_state: Any,
         data_state: dict | None = None, extra: dict | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = flatten(params, opt_state)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {
        "step": step,
        "data_state": data_state or {},
        "extra": extra or {},
        "crc": _digest(arrays),
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    latest_tmp = os.path.join(directory, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> int | None:
    pointer = os.path.join(directory, "LATEST")
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    return int(name.split("_")[-1])


def restore(directory: str, params_like: Any, opt_like: Any,
            step: int | None = None) -> tuple[Any, Any, dict, int]:
    """Restore into the structure of ``params_like`` and ``opt_like``,
    each tensor on its counterpart's device and in its dtype.  Returns
    (params, opt_state, meta, step); raises :class:`IOError` when the
    digest does not match."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    folder = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(folder, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(folder, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    if _digest(arrays) != meta["crc"]:
        raise IOError(f"checkpoint {folder} failed digest verification")
    return (_rebuild(params_like, "params", arrays),
            _rebuild(opt_like, "opt", arrays), meta, step)
