"""Architecture registry of the port: ``get_config(arch)`` resolves the
architectures ported so far; the others raise until their family is
ported.  Each module defines ``CONFIG`` (the published configuration)
and ``REDUCED`` (a same-family miniature for CPU tests)."""

from __future__ import annotations

from importlib import import_module

from ..models.config import ModelConfig

_ARCH_MODULES = {
    "qwen3-4b": "qwen3_4b",
    "stablelm-1.6b": "stablelm_1_6b",
}

# architectures of the JAX package whose families are not ported yet
_NOT_PORTED = (
    "mixtral-8x7b", "deepseek-v2-lite-16b", "command-r-plus-104b",
    "gemma3-1b", "whisper-tiny", "rwkv6-3b", "internvl2-1b", "hymba-1.5b",
)

ARCH_IDS = list(_ARCH_MODULES)


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported to PyTorch yet; ported: {ARCH_IDS}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = import_module(f".{_ARCH_MODULES[arch]}", __package__)
    return mod.REDUCED if reduced else mod.CONFIG
