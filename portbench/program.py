"""The system under test: ``repro_torch``'s model configuration and its
fixed-batch serving engine, built from a configuration file.  This is the only
module of the benchmark that imports the program.

The configuration file names the program's architecture id
(``repro_torch.configs``), its depth and dtype; every key the program
has a field for is checked against the file before anything runs, so the
program serves the model the file states.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# the file's key -> a function of the program's ModelConfig
_FIELDS = {
    "hidden_size": lambda c: c.d_model,
    "num_attention_heads": lambda c: c.n_heads,
    "num_key_value_heads": lambda c: c.n_kv_heads,
    "vocab_size": lambda c: c.vocab_size,
    "num_hidden_layers": lambda c: c.n_layers,
    "rope_theta": lambda c: c.rope_theta,
    "rms_norm_eps": lambda c: c.norm_eps,
    "layer_norm_eps": lambda c: c.norm_eps,
    "tie_word_embeddings": lambda c: c.tie_embeddings,
    "intermediate_size": lambda c: c.d_ff,
    "serve_dtype": lambda c: c.dtype,
}


def model_config(cfg: dict, table=None):
    """The program's ``ModelConfig`` for the configuration file ``cfg``,
    with the LUT path on, at the width of ``table`` (a
    :class:`portbench.loader.Table`), when the file names one."""
    from repro_torch.configs import get_config

    mc = get_config(cfg["arch"], reduced=bool(cfg.get("arch_reduced", False)))
    mc = dataclasses.replace(mc, n_layers=int(cfg["num_hidden_layers"]),
                             dtype=cfg["serve_dtype"])
    for key, get in _FIELDS.items():
        if key in cfg:
            _same(cfg, key, get(mc))
    if table is not None:
        mc = mc.with_approx_mlp(table.target_bits)
    return mc


def _same(cfg: dict, key: str, have) -> None:
    want = cfg[key]
    if isinstance(have, float) or isinstance(want, float):
        ok = abs(float(have) - float(want)) <= 1e-12 * max(1.0, abs(float(want)))
    else:
        ok = have == want
    if not ok:
        raise ValueError(f"{cfg['name']}: the file's {key} is {want!r}, the "
                         f"program's {cfg['arch']} has {have!r}")


def stack(mc, table):
    """The per-layer (L, side, side) stack of one table, or None."""
    if table is None:
        return None
    return np.broadcast_to(table.lut, (mc.n_layers,) + table.lut.shape).copy()


def fixed_engine(mc, params, mix: dict, table, device):
    from repro_torch.serving.engine import ServingEngine

    return ServingEngine(mc, params, batch=int(mix["batch"]),
                         prompt_len=int(mix["prompt_len"]),
                         gen_len=int(mix["gen_len"]), luts=stack(mc, table),
                         device=device)


def request(rid: int, tokens: np.ndarray):
    from repro_torch.serving.loadgen import Request

    return Request(rid=rid, tokens=tokens)
