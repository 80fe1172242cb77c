"""Random weights of a configuration, made on the device from the seed.

The benchmark makes the weights itself and hands the same tensors to the
program and to the plain reference.  They are drawn in a few large calls
of one ``torch.Generator`` on the device, in the dtype they are served
in (one flat buffer), and every leaf is a view of its buffer,
scaled in place: a matrix by ``1 / sqrt(fan_in)``, a norm's weight by
0.1 (the program's norms scale by ``1 + w``).  :meth:`Weights.fill`
draws a new seed into the same buffers, so anything that holds their
addresses (a captured CUDA graph) stays valid.

The tree is the layout ``repro_torch.models.lm`` reads: ``embed``,
``lm_head``, ``ln_f`` and ``layers``, each layer ``ln1``, ``ln2``, an
``attn`` (``wq wk wv wo``) and an ``ffn`` (``w1 w3 w2``).
"""

from __future__ import annotations

import math

import torch

from .counts import Dims, dims

_CHUNK = 1 << 28   # elements a draw


def leaves(cfg: dict) -> list[tuple[tuple, tuple, str, float]]:
    """(path, shape, scale) of every leaf."""
    d: Dims = dims(cfg)
    D = d.D
    out: list[tuple[tuple, tuple, float]] = []

    def mat(path, shape, fan_in):
        out.append((path, shape, 1.0 / math.sqrt(fan_in)))

    mat(("embed",), (d.V, D), D)
    for i in range(d.L):
        p = ("layers", i)
        out.append((p + ("ln1",), (D,), 0.1))
        out.append((p + ("ln2",), (D,), 0.1))
        a = p + ("attn",)
        mat(a + ("wq",), (D, d.H * d.hd), D)
        mat(a + ("wk",), (D, d.Hkv * d.hd), D)
        mat(a + ("wv",), (D, d.Hkv * d.hd), D)
        mat(a + ("wo",), (d.H * d.hd, D), d.H * d.hd)
        f = p + ("ffn",)
        mat(f + ("w1",), (D, d.F), D)
        mat(f + ("w3",), (D, d.F), D)
        mat(f + ("w2",), (d.F, D), d.F)
    out.append((("ln_f",), (D,), 0.1))
    mat(("lm_head",), (D, d.V), D)
    return out


class Weights:
    """The weights of ``cfg`` on ``device``, in ``cfg["serve_dtype"]``."""

    def __init__(self, cfg: dict, device) -> None:
        self.device = torch.device(device)
        self.leaves = leaves(cfg)
        size = sum(math.prod(shape) for _, shape, _ in self.leaves)
        self.buffer = torch.empty(size, dtype=getattr(torch, cfg["serve_dtype"]),
                                  device=self.device)
        self.params: dict = {"layers": [{} for _ in range(dims(cfg).L)]}
        offset = 0
        self._views = []
        for path, shape, scale in self.leaves:
            n = math.prod(shape)
            view = self.buffer[offset:offset + n].view(shape)
            offset += n
            self._views.append((view, scale))
            _put(self.params, path, view)

    def fill(self, seed: int) -> None:
        gen = torch.Generator(device=self.device).manual_seed(int(seed) % (1 << 63))
        for start in range(0, self.buffer.numel(), _CHUNK):
            self.buffer[start:start + _CHUNK].normal_(generator=gen)
        for view, scale in self._views:
            view.mul_(scale)


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
        elif key not in node:
            node[key] = [] if isinstance(nxt, int) else {}
        node = node[key]
    node[path[-1]] = value
